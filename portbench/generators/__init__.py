"""Matrix generators, one module each, found by the ``generator`` name a
configuration file gives: ``make(cfg, seed) -> portbench.inputs.CSR``."""
