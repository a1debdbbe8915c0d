"""Node-aware MoE token dispatch: routing histograms -> exchange patterns.

The port of ``repro.models.moe_dispatch``.  The router's per-batch
(src shard -> dst shard, token count) assignment *is* the paper's irregular
point-to-point pattern, regenerated every step.  This module is the bridge
between that dynamic traffic and the static exchange planner:

* :func:`repro_torch.comm.block_pattern` turns a per-pair width matrix into
  the element-level :class:`~repro_torch.comm.ExchangePattern` of a ragged
  tiled all-to-all (capacity-based dispatch makes the communication *shape*
  a pure function of the counts, independent of token values);
* :class:`RoutingBucketer` quantizes measured counts to capacity-slot
  granularity and keeps a high-water width matrix, so fluctuating-but-
  stationary load skew maps onto ONE pattern object -- its memoized
  ``fingerprint()`` keys the plan / program caches, and growth beyond the
  high-water mark is an *incremental* re-plan (widen to the union) instead
  of a cold plan per batch;
* :func:`recv_maps` precomputes, on the host, the per-rank gather that
  splices the exchange's canonical receive layout back into the dense
  ``[nranks * cap]`` slot layout the capacity dispatch math expects --
  making the exchange-backed path bitwise identical to the flat all-to-all
  (a block transpose of the stacked ranks);
* :class:`ExpertLoadHistogram` accumulates the measured count matrices and
  feeds them to :func:`repro_torch.core.advise_routing` (the paper's
  model-driven strategy selection, driven by real traffic);
* :class:`MoEDispatcher` ties it together for ``MoELayer``: per-step it
  buckets the counts, resolves the strategy (fixed or ``"auto"`` via the
  advisor), and hands back memoized
  :class:`~repro_torch.comm.IrregularExchange` instances for the dispatch
  and return hops, on the dispatcher's device -- over stacked ranks, or,
  given an :class:`~repro_torch.comm.topology.ExchangeGroup` (the
  counterpart of the reference's ``mesh=``), for this process's rank of a
  ``torch.distributed`` world.

Everything but the exchanges is numpy and bitwise the reference's.
``strategy="auto"`` ranks on the reference's default machine,
``tpu_v5e_pod``, so the port picks what the reference picks: the port has
no H100 constants (ROADMAP A.6.1, after the port).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.comm import (
    ExchangePattern,
    IrregularExchange,
    PodTopology,
    STRATEGY_NAMES,
    block_pattern,
    exchange_for,
    quantize_widths,
)
from repro_torch.core import EXECUTABLE_STRATEGY, advise_routing
from repro_torch.core.device import DeviceLike


def recv_maps(
    topo: PodTopology, block: int, widths: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Per-rank splice maps from canonical exchange recv to slot layout.

    For the :func:`~repro_torch.comm.block_pattern` with width matrix ``widths``
    (``widths[s, d]`` = slots ``s`` ships to ``d``), rank ``r``'s exchange
    output is the src-major concatenation of the shipped prefixes, padded to
    the pattern-wide halo width ``H``.  The dispatch math instead wants the
    dense tiled-all-to-all layout ``recv[s * block + j] =`` slot ``j`` of
    ``s``'s block for ``r``.  Returns ``(maps, H)`` where ``maps[r]`` is an
    ``[nranks * block]`` int32 gather into the concatenation
    ``[own send buffer | halo | one sentinel row]``:

    * own block (``s == r``): index ``s * block + j`` into the send buffer
      (the all-to-all diagonal never leaves the device);
    * shipped slots (``j < widths[s, r]``): ``nranks * block + offset`` into
      the halo;
    * unshipped slots: ``nranks * block + H`` -- the sentinel row, which the
      caller fills with the same dead-slot value (zero row / sentinel expert
      id) the baseline's send buffer carries there, keeping the two paths
      bitwise identical.
    """
    n = topo.nranks
    w = np.asarray(widths, dtype=np.int64)
    if w.shape != (n, n):
        raise ValueError(f"widths must be [{n}, {n}], got {w.shape}")
    if (w < 0).any() or (w > block).any():
        raise ValueError(f"widths must lie in [0, {block}]")
    recv_sizes = w.sum(axis=0) - np.diag(w)
    H = int(recv_sizes.max(initial=0))
    maps = np.full((n, n * block), n * block + H, dtype=np.int32)
    for r in range(n):
        off = 0
        for s in range(n):
            base = s * block
            if s == r:
                maps[r, base : base + block] = np.arange(
                    base, base + block, dtype=np.int32
                )
                continue
            k = int(w[s, r])
            maps[r, base : base + k] = n * block + off + np.arange(k, dtype=np.int32)
            off += k
    return maps, H


@dataclasses.dataclass(frozen=True)
class RoutingBundle:
    """One bucketed routing pattern: both hops plus their splice maps."""

    widths: np.ndarray  # [n, n] high-water slot widths (diagonal zeroed)
    pattern_dispatch: ExchangePattern
    pattern_return: ExchangePattern
    map_dispatch: np.ndarray  # [n, n*block] int32 (see recv_maps)
    map_return: np.ndarray
    halo_dispatch: int
    halo_return: int


class RoutingBucketer:
    """High-water width bucketing for per-batch routing counts.

    ``step(counts)`` quantizes the measured per-pair counts to ``quantum``
    slots and compares against the running high-water width matrix.  Counts
    at or under the mark reuse the cached :class:`RoutingBundle` -- the SAME
    pattern objects, so their memoized fingerprints hit the module-level
    plan / executor / exchange caches.  Growth widens the mark to the union
    and rebuilds once (the incremental re-plan).  Shrinkage never re-plans:
    a superset pattern is always safe because unshipped-but-planned slots
    carry the dead-slot sentinel values, which the splice maps reproduce.
    """

    def __init__(self, topo: PodTopology, block: int, quantum: int = 8) -> None:
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.topo = topo
        self.block = block
        self.quantum = quantum
        self.high_water = np.zeros((topo.nranks, topo.nranks), dtype=np.int64)
        self.bundle: Optional[RoutingBundle] = None
        self.steps = 0
        self.replans = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of steps served by the cached bundle."""
        return 1.0 - self.replans / self.steps if self.steps else 0.0

    def step(self, counts: np.ndarray) -> Tuple[RoutingBundle, bool]:
        """Bucket one batch's counts; returns ``(bundle, replanned)``."""
        self.steps += 1
        q = quantize_widths(counts, self.quantum, self.block)
        np.fill_diagonal(q, 0)  # own block never leaves the device
        if self.bundle is not None and (q <= self.high_water).all():
            return self.bundle, False
        self.high_water = np.maximum(self.high_water, q)
        w = self.high_water.copy()
        map_d, halo_d = recv_maps(self.topo, self.block, w)
        map_r, halo_r = recv_maps(self.topo, self.block, w.T)
        self.bundle = RoutingBundle(
            widths=w,
            pattern_dispatch=block_pattern(self.topo, self.block, w),
            pattern_return=block_pattern(self.topo, self.block, w.T),
            map_dispatch=map_d,
            map_return=map_r,
            halo_dispatch=halo_d,
            halo_return=halo_r,
        )
        self.replans += 1
        return self.bundle, True


class ExpertLoadHistogram:
    """EMA of measured per-pair routed-token counts (the advisor's input).

    The paper's performance models are only as good as the traffic estimate
    they are fed; *Improving Performance Models for Irregular Point-to-Point
    Communication* motivates measuring it.  ``update`` folds one batch's
    ``[nranks, nranks]`` count matrix into an exponential moving average;
    ``advise`` ranks strategies for the smoothed histogram.
    """

    def __init__(self, nranks: int, decay: float = 0.9) -> None:
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.nranks = nranks
        self.decay = decay
        self.counts = np.zeros((nranks, nranks), dtype=np.float64)
        self.updates = 0

    def update(self, counts: np.ndarray) -> None:
        c = np.asarray(counts, dtype=np.float64)
        if c.shape != (self.nranks, self.nranks):
            raise ValueError(
                f"counts must be [{self.nranks}, {self.nranks}], got {c.shape}"
            )
        if self.updates == 0:
            self.counts = c.copy()
        else:
            self.counts = self.decay * self.counts + (1.0 - self.decay) * c
        self.updates += 1

    def advise(
        self,
        ppn: int,
        payload_width: int = 1,
        machine: str = "tpu_v5e_pod",
        wire=None,
    ):
        """Rank strategies for the smoothed histogram (see ``advise_routing``)."""
        counts = np.rint(self.counts).astype(np.int64)
        return advise_routing(
            counts, ppn=ppn, payload_width=payload_width, machine=machine, wire=wire
        )


@dataclasses.dataclass(frozen=True)
class DispatchStep:
    """Everything one MoE batch needs to run its two exchange hops.

    ``exchange_dispatch`` / ``exchange_return`` are ``None`` when the hop's
    pattern has no cross-device needs (e.g. every token routed to its own
    shard): the splice maps then read only the local send buffer and the
    sentinel row, and no collective runs at all.
    """

    bundle: RoutingBundle
    strategy: str
    exchange_dispatch: Optional[IrregularExchange]
    exchange_return: Optional[IrregularExchange]


class MoEDispatcher:
    """Per-layer routing-aware exchange front-end for ``MoELayer``.

    Holds one :class:`RoutingBucketer` per capacity (decode and prefill
    batches bucket separately), the :class:`ExpertLoadHistogram`, and the
    strategy / wire configuration.  ``step(counts, block)`` is the per-batch
    entry point; everything it returns is memoized so a stationary routing
    distribution costs one quantize + one dict hit per batch.

    ``strategy="auto"`` re-runs the advisor on the bucketed width matrix
    whenever the bucketer re-plans (traffic changed enough to matter) and
    keeps the previous choice otherwise.
    """

    def __init__(
        self,
        topo: PodTopology,
        strategy: str = "auto",
        wire: str = "none",
        quantum: int = 8,
        device: DeviceLike = None,
        message_cap_bytes: int = 16384,
        machine: str = "tpu_v5e_pod",
        decay: float = 0.9,
        group=None,
    ) -> None:
        if strategy != "auto" and strategy not in STRATEGY_NAMES:
            raise ValueError(
                f"strategy must be 'auto' or one of {STRATEGY_NAMES}, got {strategy!r}"
            )
        self.topo = topo
        self.strategy = strategy
        self.wire = wire
        self.quantum = quantum
        self.device = device
        #: every rank of the group steps with the same counts, so its
        #: exchanges are built collectively in one order
        self.group = group
        self.message_cap_bytes = message_cap_bytes
        self.machine = machine
        self.histogram = ExpertLoadHistogram(topo.nranks, decay=decay)
        self._bucketers: Dict[int, RoutingBucketer] = {}
        self._strategies: Dict[int, str] = {}

    def bucketer(self, block: int) -> RoutingBucketer:
        if block not in self._bucketers:
            self._bucketers[block] = RoutingBucketer(
                self.topo, block, quantum=min(self.quantum, block)
            )
        return self._bucketers[block]

    def _resolve_strategy(self, widths: np.ndarray, payload_width: int) -> str:
        if self.strategy != "auto":
            return self.strategy
        adv = advise_routing(
            widths,
            ppn=self.topo.ppn,
            payload_width=payload_width,
            machine=self.machine,
        )
        return EXECUTABLE_STRATEGY[adv.best.strategy]

    def _exchange(self, pattern: ExchangePattern, strategy: str):
        if not pattern.needs:
            return None
        return exchange_for(
            pattern,
            strategy,
            device=self.device,
            message_cap_bytes=self.message_cap_bytes,
            wire=self.wire,
            group=self.group,
        )

    def step(
        self, counts: np.ndarray, block: int, payload_width: int = 1
    ) -> DispatchStep:
        """Bucket one batch's measured counts and return its exchanges.

        Exchange instances come from :func:`repro_torch.comm.exchange_for` every
        step, so the module-level cache counters (``exchange_hits`` /
        ``exchange_misses`` in :func:`repro_torch.comm.cache_stats`) directly
        measure the bucketing's plan-cache effectiveness: a reused bundle's
        memoized fingerprints make both lookups O(1) dict hits.  The
        advisor (``strategy="auto"``) only re-runs when the bucketer
        re-planned -- i.e. when the traffic actually changed.
        """
        counts = np.asarray(counts)
        self.histogram.update(counts)
        bundle, replanned = self.bucketer(block).step(counts)
        strategy = self._strategies.get(block)
        if replanned or strategy is None:
            strategy = self._resolve_strategy(bundle.widths, payload_width)
            self._strategies[block] = strategy
        return DispatchStep(
            bundle=bundle,
            strategy=strategy,
            exchange_dispatch=self._exchange(bundle.pattern_dispatch, strategy),
            exchange_return=self._exchange(bundle.pattern_return, strategy),
        )
