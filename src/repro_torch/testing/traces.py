"""Seeded traffic-trace generators for the serving simulator.

Every generator is a pure function of its ``seed`` (via
``np.random.default_rng``), so a trace -- and therefore the entire
simulation it drives -- replays bit-for-bit.  Fingerprint popularity is
Zipf-skewed (``weight(i) = 1 / (i + 1)**skew`` over the class list), the
regime the plan/compute/exchange LRU caches are designed for: a few hot
classes that should stay resident and a long tail that churns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request

ARRIVAL_PATTERNS = ("poisson", "burst", "uniform")


def zipf_weights(n: int, skew: float = 1.0) -> np.ndarray:
    """Normalized Zipf popularity over ``n`` classes (``skew=0`` = uniform)."""
    if n < 1:
        raise ValueError(f"need at least one class, got {n}")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), skew)
    return w / w.sum()


def make_trace(
    seed: int,
    n_requests: int,
    fps: Sequence[str],
    *,
    pattern: str = "poisson",
    rate: float = 1000.0,
    skew: float = 1.0,
    burst: int = 8,
    kinds: Optional[Dict[str, str]] = None,
    t0: float = 0.0,
) -> List[Request]:
    """A seeded request trace over fingerprint classes ``fps``.

    ``pattern`` shapes the arrival process at mean ``rate`` requests/s:

    * ``"poisson"`` -- exponential inter-arrival gaps (open-system load);
    * ``"burst"`` -- groups of ``burst`` simultaneous arrivals, groups
      spaced to preserve the mean rate (the coalescer's best case and the
      admission controller's worst);
    * ``"uniform"`` -- evenly spaced arrivals (steady trickle; the
      coalescing window, not lane depth, decides batch width).

    Fingerprints draw i.i.d. from :func:`zipf_weights` over ``fps`` in the
    given order (first = hottest).  ``kinds`` optionally maps fp -> request
    kind (default ``"spmv"``).
    """
    if pattern not in ARRIVAL_PATTERNS:
        raise ValueError(f"pattern must be one of {ARRIVAL_PATTERNS}, got {pattern!r}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    rng = np.random.default_rng(seed)
    fps = list(fps)
    picks = rng.choice(len(fps), size=n_requests, p=zipf_weights(len(fps), skew))
    if pattern == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n_requests)
        arrivals = t0 + np.cumsum(gaps)
    elif pattern == "uniform":
        arrivals = t0 + (np.arange(n_requests, dtype=np.float64) + 1.0) / rate
    else:  # burst: group g lands together at the mean time of its members
        group = np.arange(n_requests) // burst
        arrivals = t0 + (group + 1.0) * (burst / rate)
    kinds = kinds or {}
    return [
        Request(
            arrival=float(arrivals[i]),
            rid=i,
            fp=fps[int(picks[i])],
            kind=kinds.get(fps[int(picks[i])], "spmv"),
        )
        for i in range(n_requests)
    ]
