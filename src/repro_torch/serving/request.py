"""Serving-front-end request model.

A request names *which* exchange workload it belongs to (its fingerprint
class) and *when* it arrived (virtual seconds on the simulator's clock, or
wall seconds in a live front-end); the payload itself stays with the
executor.  Two requests with the same fingerprint are coalescable: they ride
one plan, one exchange, and one fused SpMM at the combined payload width
(:meth:`repro_torch.sparse.spmv.DistributedSpMV.matmat`), which is the serving
layer's whole throughput lever -- the paper's message-count vs. message-size
tradeoff, decided per batch instead of per matrix.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.perfmodel import PatternStats


@dataclasses.dataclass(frozen=True, order=True)
class Request:
    """One tenant request.  Ordered by ``(arrival, rid)`` so traces sort
    deterministically regardless of generator interleaving."""

    arrival: float  # seconds on the serving clock
    rid: int  # unique id (trace order)
    fp: str  # fingerprint class (coalescing key)
    kind: str = "spmv"  # "spmv" | "solve" | "moe" (executor routing only)

    @property
    def deadline(self) -> float:
        """Placeholder so schedulers can treat requests uniformly; the real
        deadline is ``arrival + window`` with the batcher's window."""
        return self.arrival


@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    """One fingerprint class: the static facts the scheduler needs.

    ``stats`` are the paper's Table 7 parameters for the class's exchange
    pattern -- what :func:`repro_torch.core.advisor.advise_stats` ranks strategies
    from, at the *coalesced* payload width.  ``base_width`` is the payload
    width of a single request (1 column for an SpMV solve; ``d_model`` for a
    MoE dispatch, since every routed token ships a d_model-wide activation
    row); a batch of ``w`` requests runs at ``payload_width = base_width * w``.
    ``bytes_per_request`` is the device memory one request's payload pins
    while the batch is resident (the memory-budget unit).
    """

    fp: str
    stats: PatternStats
    bytes_per_request: int
    base_width: int = 1
    kind: str = "spmv"

    def __post_init__(self) -> None:
        if self.bytes_per_request < 1:
            raise ValueError(
                f"bytes_per_request must be >= 1, got {self.bytes_per_request}"
            )
        if self.base_width < 1:
            raise ValueError(f"base_width must be >= 1, got {self.base_width}")

    @staticmethod
    def from_pattern(pattern, fp=None, elem_bytes: int = 4, kind: str = "spmv"):
        """Class for an :class:`repro_torch.comm.ExchangePattern` (SpMV/SpMM halo).

        One request = one right-hand-side column: its resident bytes are the
        local rows plus the halo buffer, across all ranks.
        """
        topo = pattern.topo
        per_rank = pattern.local_size + pattern.max_recv_size()
        return WorkloadClass(
            fp=fp if fp is not None else pattern.fingerprint(),
            stats=pattern.to_comm_pattern(elem_bytes=elem_bytes).stats(),
            bytes_per_request=max(per_rank * topo.nranks * elem_bytes, 1),
            base_width=1,
            kind=kind,
        )

    @staticmethod
    def from_routing(counts, ppn: int, d_model: int, fp: str, elem_bytes: int = 4):
        """Class for a MoE dispatch hop with measured routing ``counts``.

        ``counts[s, d]`` are routed tokens per (src shard, dst shard); one
        request is one token batch, shipping ``d_model`` features per token
        (``base_width = d_model`` -- the advisor's byte terms scale with the
        activation row, as :func:`repro_torch.launch.serve.dispatch_advice`
        scales them).
        """
        import numpy as np

        from repro_torch.core.perfmodel import dispatch_stats

        c = np.asarray(counts, dtype=np.int64)
        stats = dispatch_stats(c, ppn=ppn, elem_bytes=elem_bytes)
        tokens = int(c.sum())
        return WorkloadClass(
            fp=fp,
            stats=stats,
            bytes_per_request=max(tokens * d_model * elem_bytes, 1),
            base_width=d_model,
            kind="moe",
        )
