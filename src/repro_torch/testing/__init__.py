"""Seeded traffic traces for the serving simulator."""

from repro_torch.testing.traces import ARRIVAL_PATTERNS, make_trace, zipf_weights

__all__ = ["ARRIVAL_PATTERNS", "make_trace", "zipf_weights"]
