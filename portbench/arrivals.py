"""Seeded open-loop arrivals with a fixed count: Poisson arrivals, as the
program's ``repro_torch.testing.traces.make_trace`` draws them (copied, so
that the yardstick cannot move with the program).

A stretch of ``seconds`` at ``rate`` holds ``round(rate * seconds)``
arrivals whatever the seed: the exponential gaps are drawn once from a
fixed stream and scaled to fill the stretch, and the seed only permutes
them, so every seed offers the same work in another order.
"""

from __future__ import annotations

import numpy as np

from portbench.inputs import host_rng

PATTERNS = ("poisson",)


def offsets(pattern: str, rate: float, seconds: float, seed: int, stream: int) -> np.ndarray:
    """Arrival times in seconds from the start of the stretch, ascending,
    the first at 0 and all before ``seconds``."""
    if pattern not in PATTERNS:
        raise ValueError(f"arrivals must be one of {PATTERNS}, got {pattern!r}")
    if rate <= 0 or seconds <= 0:
        raise ValueError(f"rate and seconds must be > 0, got {rate} and {seconds}")
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(0).exponential(1.0, size=n)
    gaps = host_rng(seed, stream).permutation(gaps * (seconds / gaps.sum()))
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
