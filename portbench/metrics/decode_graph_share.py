"""decode_graph_share: The share of the window's decode steps that replayed
the decode plan as one CUDA graph (``backend/plan.py``
``ExecutionPlan.execute``'s plan-cache executor, ``backend/graph.py``): 100 ×
the count of the program's ``plan.graph`` spans over the count of its
``engine.decode`` spans, in %. A program without ``plan.graph`` spans gives
None, and the metric is left out."""


def read(ctx):
    graphs, steps = ctx.spans.get("plan.graph"), ctx.spans.get("engine.decode")
    if not graphs or not steps:
        return None
    return 100.0 * len(graphs) / len(steps)
