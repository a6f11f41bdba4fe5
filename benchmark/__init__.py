"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, cell, driver or per-layer
metric sits in a file of its own (``configs/``, ``workloads/``,
``drivers/``, ``metrics/``, ``reference/``), found by the name that
``BENCHMARK.json`` or the cell's file gives it.
"""
