"""Execute node-aware strategy stage programs on stacked ranks.

:class:`IrregularExchange` takes an :class:`~repro_torch.comm.exchange.ExchangePattern`
and a strategy name, plans the static stage program (setup time, like the
paper's Algorithm 1 / communicator construction), fuses it
(:mod:`repro_torch.comm.fusion`), and runs it over one stacked tensor that
holds every rank on one device:

    ``local [nranks, L]       ->  canonical recv buffer [nranks, H]``
    ``local [nranks, L, k...] ->  [nranks, H, k...]``  (batched payloads)

The collectives become index moves on that tensor (the same layout as
:func:`repro_torch.comm.exchange.execute_numpy`, which is its oracle):

* a gather reads a ``[local | buf | 0]`` scratch whose last slot is an
  all-zero row at the PAD sentinel ``L + w_max``, so PAD reads deliver 0;
* ``a2a_local`` / ``a2a_pod`` are the block transposes of ``execute_numpy``;
* a ``PermuteWorld`` round is ``out[dsts] = send[srcs]``.

Every index is turned, once per plan and device, into a flat index into the
scratch, so each gather is one ``index_select``.  Plans and lowered
programs live in module-level LRU caches keyed by
``(pattern fingerprint, strategy, message_cap, elem_bytes, fused)`` (plus
the device for programs); inspect with :func:`cache_stats`, reset with
:func:`clear_caches`.

Split-phase execution (:meth:`IrregularExchange.start`) runs the inter-pod
sub-exchange on a side CUDA stream while the on-pod one runs on the current
stream; :meth:`ExchangeHandle.finish` makes the current stream wait and
merges the two, bitwise equal to the barrier call.

This slice runs ``wire="none"`` only: lossy wire codecs, ``verify``,
``faults`` and ``health`` raise ``NotImplementedError`` until the
faults/verify/codecs slice of the port (ROADMAP A.1).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import wire as wire_mod
from repro_torch.comm.exchange import (
    ExchangePattern,
    SplitPhase,
    StagePlan,
    lower_program,
    plan,
    split_phase,
)
from repro_torch.comm.fusion import fuse
from repro_torch.core.device import DeviceLike, as_device_tensor, resolve_device

#: the ROADMAP item that brings what this slice leaves out
LATER = "the faults/verify/codecs slice of the port (ROADMAP A.1)"


def not_yet(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it arrives with {LATER}")


# ---------------------------------------------------------------------------
# Lowered program on a device
# ---------------------------------------------------------------------------


class _Program:
    """A lowered stage program with its indices as flat device tensors.

    The scratch is ``[nranks, E, *feat]`` with ``E = L + w_max + 1``: the
    rank's ``local`` block, the buffer region, and one all-zero slot at the
    PAD sentinel.  Index ``i`` of rank ``r`` becomes ``r * E + i``.
    """

    def __init__(self, sp: StagePlan, device: torch.device):
        lp = lower_program(sp)
        topo = sp.pattern.topo
        self.topo = topo
        self.L = lp.local_size
        self.out_size = lp.out_size
        self.E = lp.local_size + lp.w_max + 1
        n = topo.nranks
        base = np.arange(n, dtype=np.int64)[:, None] * self.E

        def flat(idx: np.ndarray) -> torch.Tensor:
            return torch.as_tensor((idx.astype(np.int64) + base).reshape(-1), device=device)

        self.steps: List[tuple] = []
        ai = 0
        for op in lp.ops:
            kind = op[0]
            if kind == "gather":
                self.steps.append(("gather", op[1], flat(lp.arrays[ai])))
                ai += 1
            elif kind in ("a2a_local", "a2a_pod"):
                _, buflen, has_idx = op
                idx = None
                if has_idx:
                    idx = flat(lp.arrays[ai])
                    ai += 1
                self.steps.append((kind, buflen, idx))
            elif kind == "permute":
                _, rounds, blks, _inter = op
                rnds = []
                for perm, blk in zip(rounds, blks):
                    sel = flat(lp.arrays[ai])
                    ai += 1
                    srcs = torch.as_tensor([s for s, _ in perm], dtype=torch.int64, device=device)
                    dsts = torch.as_tensor([d for _, d in perm], dtype=torch.int64, device=device)
                    rnds.append((blk, sel, srcs, dsts))
                self.steps.append(("permute", sum(blks), rnds))
            else:
                raise TypeError(f"unknown op {op!r}")

    def run(self, local: torch.Tensor) -> torch.Tensor:
        """``local [n, L, *feat] -> [n, out_size, *feat]`` (contiguous)."""
        topo, L, E = self.topo, self.L, self.E
        n, ppn, npods = topo.nranks, topo.ppn, topo.npods
        feat = tuple(local.shape[2:])
        ext = local.new_zeros((n, E) + feat)
        ext[:, :L] = local
        flat = ext.view((n * E,) + feat)

        def take(idx: torch.Tensor, width: int) -> torch.Tensor:
            return flat.index_select(0, idx).view((n, width) + feat)

        for kind, width, arg in self.steps:
            if kind == "gather":
                ext[:, L : L + width] = take(arg, width)
            elif kind in ("a2a_local", "a2a_pod"):
                seg = take(arg, width) if arg is not None else ext[:, L : L + width].clone()
                if kind == "a2a_local":
                    blocks = seg.view((npods, ppn, ppn, width // ppn) + feat).transpose(1, 2)
                else:
                    blocks = seg.view((npods, ppn, npods, width // npods) + feat).transpose(0, 2)
                ext[:, L : L + width] = blocks.reshape((n, width) + feat)
            else:  # permute
                parts = []
                for blk, sel, srcs, dsts in arg:
                    send = take(sel, blk)
                    out = send.new_zeros(send.shape)
                    if len(srcs):
                        out.index_copy_(0, dsts, send.index_select(0, srcs))
                    parts.append(out)
                if parts:
                    ext[:, L : L + width] = torch.cat(parts, dim=1)
        return ext[:, L : L + self.out_size].contiguous()


# ---------------------------------------------------------------------------
# Plan / program caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    plan_hits: int = 0
    plan_misses: int = 0
    exec_hits: int = 0
    exec_misses: int = 0
    #: local-compute program cache (repro_torch.sparse.spmv, keyed by
    #: (pattern fingerprint, payload width k, device))
    compute_hits: int = 0
    compute_misses: int = 0
    #: split-phase decomposition + merge cache, keyed by pattern fingerprint
    split_hits: int = 0
    split_misses: int = 0
    #: LRU evictions per cache; for a cache whose capacity never shrank,
    #: ``evictions == misses - live entries`` (see :func:`cache_sizes`)
    plan_evictions: int = 0
    exec_evictions: int = 0
    split_evictions: int = 0
    compute_evictions: int = 0


_stats = CacheStats()
_PLAN_CACHE: "OrderedDict[tuple, StagePlan]" = OrderedDict()
_EXEC_CACHE: "OrderedDict[tuple, _Program]" = OrderedDict()
#: split-phase decompositions + merges, keyed by pattern fingerprint
_SPLIT_CACHE: "OrderedDict[str, tuple]" = OrderedDict()
#: external LRUs (the SpMV compute cache) reset by clear_caches()
_EXTERNAL_CACHES: List[OrderedDict] = []
PLAN_CACHE_MAX = 256
EXEC_CACHE_MAX = 64


def cache_stats() -> CacheStats:
    """Snapshot of plan/program/compute cache hit counters."""
    return dataclasses.replace(_stats)


def cache_sizes() -> Dict[str, int]:
    """Live entry counts per module cache."""
    return {
        "plan": len(_PLAN_CACHE),
        "exec": len(_EXEC_CACHE),
        "split": len(_SPLIT_CACHE),
        "external": sum(len(c) for c in _EXTERNAL_CACHES),
    }


def set_cache_limits(plan: Optional[int] = None, exec_: Optional[int] = None) -> Dict[str, int]:
    """Resize the module LRU capacities, trimming oldest-first immediately.

    ``None`` leaves a cap unchanged; the split-phase cache shares ``plan``'s
    cap (one decomposition per resident pattern).  Returns the caps in force.
    """
    global PLAN_CACHE_MAX, EXEC_CACHE_MAX
    for name, value in (("plan", plan), ("exec_", exec_)):
        if value is not None and value < 1:
            raise ValueError(f"{name} cache limit must be >= 1, got {value}")
    if plan is not None:
        PLAN_CACHE_MAX = plan
        _trim(_PLAN_CACHE, plan, "plan_evictions")
        _trim(_SPLIT_CACHE, plan, "split_evictions")
    if exec_ is not None:
        EXEC_CACHE_MAX = exec_
        _trim(_EXEC_CACHE, exec_, "exec_evictions")
    return {"plan": PLAN_CACHE_MAX, "exec": EXEC_CACHE_MAX}


def register_cache(cache: OrderedDict) -> None:
    """Register an external LRU so :func:`clear_caches` resets it too."""
    if not any(c is cache for c in _EXTERNAL_CACHES):
        _EXTERNAL_CACHES.append(cache)


def clear_caches() -> None:
    global _stats
    for cache in (_PLAN_CACHE, _EXEC_CACHE, _SPLIT_CACHE, *_EXTERNAL_CACHES):
        cache.clear()
    _stats = CacheStats()


def _trim(cache: OrderedDict, max_size: int, evict_stat: str) -> None:
    while len(cache) > max_size:
        cache.popitem(last=False)
        setattr(_stats, evict_stat, getattr(_stats, evict_stat) + 1)


def _lru_get(cache: OrderedDict, key, max_size: int, build, stat: str):
    """LRU lookup that counts ``<stat>_hits`` / ``_misses`` / ``_evictions``."""
    if key in cache:
        cache.move_to_end(key)
        setattr(_stats, stat + "_hits", getattr(_stats, stat + "_hits") + 1)
        return cache[key]
    val = cache[key] = build()
    setattr(_stats, stat + "_misses", getattr(_stats, stat + "_misses") + 1)
    _trim(cache, max_size, stat + "_evictions")
    return val


def compute_cached(cache: OrderedDict, key, max_size: int, build):
    """LRU get for a registered local-compute cache (``compute_*`` stats)."""
    return _lru_get(cache, key, max_size, build, "compute")


def _plan_key(pattern, strategy, message_cap_bytes, elem_bytes, fuse_program) -> tuple:
    return (pattern.fingerprint(), strategy, message_cap_bytes, elem_bytes, fuse_program)


def planned(
    pattern: ExchangePattern,
    strategy: str,
    message_cap_bytes: int = 16384,
    elem_bytes: int = 4,
    fuse_program: bool = True,
) -> StagePlan:
    """Plan (and optionally fuse) with module-level memoization."""
    key = _plan_key(pattern, strategy, message_cap_bytes, elem_bytes, fuse_program)

    def build():
        sp = plan(strategy, pattern, message_cap_bytes=message_cap_bytes, elem_bytes=elem_bytes)
        return fuse(sp) if fuse_program else sp

    return _lru_get(_PLAN_CACHE, key, PLAN_CACHE_MAX, build, "plan")


def _program(sp: StagePlan, plan_key: tuple, device: torch.device) -> _Program:
    return _lru_get(
        _EXEC_CACHE, plan_key + (str(device),), EXEC_CACHE_MAX,
        lambda: _Program(sp, device), "exec",
    )


# ---------------------------------------------------------------------------
# Split-phase merge
# ---------------------------------------------------------------------------


class _Merge:
    """Per-rank gather assembling the full canonical buffer from the two
    phase outputs (a port of the reference's ``_build_merge``); the index
    maps go to each device on first use there."""

    def __init__(self, sp: SplitPhase):
        self._sp = sp
        self._maps: Dict[str, tuple] = {}

    def _on(self, device: torch.device) -> tuple:
        maps = self._maps.get(str(device))
        if maps is None:
            sp = self._sp
            maps = self._maps[str(device)] = tuple(
                torch.as_tensor(a, device=device)
                for a in (sp.from_local, sp.valid, sp.local_idx.astype(np.int64),
                          sp.remote_idx.astype(np.int64))
            )
        return maps

    def __call__(self, local_out: torch.Tensor, remote_out: torch.Tensor) -> torch.Tensor:
        mask, valid, li, ri = self._on(local_out.device)
        feat = tuple(local_out.shape[2:])
        expand = mask.shape + (1,) * len(feat)

        def take(buf, idx):
            idx = idx.clamp(max=buf.shape[1] - 1).view(expand).expand(idx.shape + feat)
            return torch.gather(buf, 1, idx)

        lo = take(local_out, li)
        merged = torch.where(mask.view(expand), lo, take(remote_out, ri))
        return torch.where(valid.view(expand), merged, torch.zeros_like(lo))


def _split_phase_cached(pattern: ExchangePattern) -> tuple:
    def build():
        sp = split_phase(pattern)
        return sp, _Merge(sp)

    return _lru_get(_SPLIT_CACHE, pattern.fingerprint(), PLAN_CACHE_MAX, build, "split")


@dataclasses.dataclass
class ExchangeHandle:
    """An in-flight two-phase exchange (see :meth:`IrregularExchange.start`).

    ``local_halo`` is the on-pod phase result, queued on the current stream;
    the inter-pod phase runs on ``stream`` (a side CUDA stream, or ``None``
    on the CPU, where it already ran).  :meth:`finish` merges both phases
    into the full canonical recv buffer -- bitwise the barrier result.
    """

    local_halo: torch.Tensor
    remote_halo: torch.Tensor
    _merge: object
    stream: Optional["torch.cuda.Stream"] = None
    _done: Optional[torch.Tensor] = None

    def finish(self) -> torch.Tensor:
        """Wait for the inter-pod phase and return ``[nranks, H, *feat]``."""
        if self._done is None:
            if self.stream is not None:
                current = torch.cuda.current_stream(self.remote_halo.device)
                current.wait_stream(self.stream)
                # made on the side stream, read on this one from here on
                self.remote_halo.record_stream(current)
            self._done = self._merge(self.local_halo, self.remote_halo)
        return self._done


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IrregularExchange:
    """A planned irregular exchange for one strategy over stacked ranks.

    Args:
      pattern: the element-level communication pattern.
      strategy: "standard" | "two_step" | "three_step" | "split" (or
        "local" for a pod-local pattern).
      device: where the exchange runs; ``None`` means the CUDA device.
      message_cap_bytes: Split's user cap (Algorithm 1 input).
      elem_bytes: element width used for cap arithmetic / byte accounting.
      fuse_program: run the :mod:`repro_torch.comm.fusion` rewrites.
      wire, verify, faults, health: kept for signature parity; anything
        but the defaults raises ``NotImplementedError`` in this slice.

    Example::

        import numpy as np
        from repro_torch.comm import IrregularExchange, PodTopology, random_pattern

        topo = PodTopology(npods=2, ppn=4)
        pat = random_pattern(np.random.default_rng(0), topo, local_size=6)
        ex = IrregularExchange(pat, "two_step", device="cpu")
        local = np.ones((topo.nranks, 6), np.float32)
        halo = ex(local)                       # barrier: [nranks, H]
        handle = ex.start(local)               # split-phase
        assert (handle.finish() == halo).all()
    """

    pattern: ExchangePattern
    strategy: str
    device: DeviceLike = None
    message_cap_bytes: int = 16384
    elem_bytes: int = 4
    fuse_program: bool = True
    wire: str = "none"
    verify: bool = False
    faults: Optional[object] = None
    health: Optional[object] = None

    def __post_init__(self) -> None:
        wire_mod.check_codec(self.wire)
        if self.wire != "none":
            raise not_yet(f"wire codec {self.wire!r}")
        if self.verify:
            raise not_yet("verify=True")
        if self.faults is not None:
            raise not_yet("faults=")
        if self.health is not None:
            raise not_yet("health=")
        self.device = resolve_device(self.device)
        key = _plan_key(
            self.pattern, self.strategy, self.message_cap_bytes,
            self.elem_bytes, self.fuse_program,
        )
        self.plan: StagePlan = planned(
            self.pattern, self.strategy, self.message_cap_bytes,
            self.elem_bytes, self.fuse_program,
        )
        self._program = _program(self.plan, key, self.device)
        self._two_phase: Optional[tuple] = None
        self._side_stream = None

    # ------------------------------------------------------------------
    def __call__(self, local) -> torch.Tensor:
        """``local [nranks, L, *feat] -> canonical recv [nranks, H, *feat]``.

        Trailing feature dims (multi-vector SpMM ``k``, per-token features)
        ride along under the same plan.
        """
        local = as_device_tensor(local, self.device)
        n, L = self.pattern.topo.nranks, self.pattern.local_size
        if local.ndim < 2 or tuple(local.shape[:2]) != (n, L):
            raise ValueError(f"expected [{n}, {L}, *feat], got {tuple(local.shape)}")
        return self._program.run(local)

    # ------------------------------------------------------------------
    def start(self, local) -> ExchangeHandle:
        """Begin a split-phase exchange.

        The pattern is factored (:func:`repro_torch.comm.exchange.split_phase`)
        into an inter-pod sub-pattern, planned with this exchange's strategy,
        and an on-pod one.  On CUDA the inter-pod phase is queued first, on a
        side stream that waits for the work that made ``local``; the on-pod
        phase follows on the current stream, so work queued after ``start()``
        (the diag-block product) overlaps the inter-pod phase.  On the CPU the
        two phases run one after the other.  Both sub-exchanges and the merge
        come from the module caches and are memoized on the instance.
        """
        if self._two_phase is None:
            sp, merge = _split_phase_cached(self.pattern)
            common = dict(device=self.device, elem_bytes=self.elem_bytes,
                          fuse_program=self.fuse_program)
            self._two_phase = (
                IrregularExchange(sp.remote, self.strategy,
                                  message_cap_bytes=self.message_cap_bytes, **common),
                IrregularExchange(sp.local, "local", **common),
                merge,
            )
        remote_ex, local_ex, merge = self._two_phase
        local = as_device_tensor(local, self.device)
        if self.device.type != "cuda":
            remote = remote_ex(local)
            return ExchangeHandle(local_ex(local), remote, merge)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            remote = remote_ex(local)
        # read on the side stream: keep its memory until that work is done
        local.record_stream(side)
        return ExchangeHandle(local_ex(local), remote, merge, stream=side)

    # ------------------------------------------------------------------
    def reference(self, local: np.ndarray) -> np.ndarray:
        return self.pattern.reference(local)

    @property
    def wire_bytes(self) -> Tuple[int, int]:
        """(intra-pod, inter-pod) bytes on the wire incl. padding."""
        return wire_mod.scaled_wire_bytes(self.plan, self.wire, self.elem_bytes)

    @property
    def payload_bytes(self) -> Tuple[int, int]:
        """(intra-pod, inter-pod) useful payload bytes."""
        return (self.plan.intra_pod_bytes, self.plan.inter_pod_bytes)


STRATEGY_NAMES = ("standard", "two_step", "three_step", "split")
