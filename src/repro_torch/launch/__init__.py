"""repro_torch.launch — the launchers: ``serve`` (batched generation with
the continuous-batching engine), ``train`` (one-card training) and
``steps`` (the step builders both share).  The mesh and dry-run launchers
come with the port's mesh slice."""
