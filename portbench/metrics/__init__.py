"""Per-layer metrics, one module each, found by the metric's name in
``BENCHMARK.json`` (``<name>.py`` here).  Each holds ``read(run)``, which
returns the metric's value from the run's window, profile and counts, or
``None`` when the run holds nothing for it to read."""
