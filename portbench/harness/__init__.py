"""The yardstick of ``portbench``: what every cell shares.

Later changes to the program leave this package as it is: the traffic
generator (``traffic``), the closed loops (``engine``, ``server``),
the reading of the profiler's trace (``timeline``), the arithmetic of
percentiles and rates (``stats``), the card's published peaks and the
roofline and mfu formulas (``peaks``), and one run of one cell (``cell``).

What belongs to one configuration, traffic mix or per-layer metric lives in
files of its own beside this package (``configs/``, ``traffic/``,
``metrics/``, ``work/``, ``reference/``), found by the name that
``BENCHMARK.json`` gives it.
"""
