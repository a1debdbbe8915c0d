"""Setup-time planning for irregular element exchanges.

This is the executable heart of the paper: an irregular
"who needs which elements from whom" pattern (e.g. the SpMV halo, MoE token
routing) is compiled, at setup time, into a static **stage program** -- a
sequence of gathers and collectives -- one program per node-aware strategy
(Standard / 3-Step / 2-Step / Split).  The stage program is then executed by
:mod:`repro_torch.comm.strategies` over the stacked ``[nranks, ...]`` tensor,
optionally after the rewrites in :mod:`repro_torch.comm.fusion`.

Planning is *verified by construction*: a symbolic token simulator runs the
same stage semantics over ``(owner, element)`` tokens, so the planner can
resolve "where does token t live in rank r's buffer right now" exactly, and
tests can assert every strategy delivers the canonical receive layout.

The planner's symbolic state is **vectorized**: tokens are encoded as int64
codes ``owner * local_size + elem`` (``PAD_CODE = -1``), buffers are dense
``[nranks, buflen]`` arrays, and every stage transition / position lookup /
byte-accounting sweep is a numpy array op.

Stage semantics (mirrored exactly by the torch executor):

* ``Gather(idx)``      -- per rank: ``new_buf[k] = ext[idx[k]]`` where
  ``ext = concat(current_buf, original_local)`` and ``idx == len(ext)`` is a
  PAD sentinel (delivers 0).
* ``A2ALocal()``       -- all-to-all over the pod-local axis on the
  ``[ppn, blk]`` view of the buffer (a block transpose on stacked ranks).  An optional fused ``idx`` (installed
  by the fusion pass) applies a Gather to ``ext`` first.
* ``A2APod()``         -- all-to-all over the pod axis on ``[npods, blk]``,
  with the same optional fused input ``idx``.
* ``PermuteWorld(...)``-- rounds of world-level permutes; each round the
  sender selects ``sel[round]`` from ``ext`` and the received blocks are
  concatenated into the new buffer.

For overlapped execution, :func:`split_phase` factors a pattern into its
on-pod and inter-pod sub-patterns (the two phases of
:meth:`repro_torch.comm.strategies.IrregularExchange.start`), and
:func:`merge_split_phase` is the numpy oracle for reassembling the full
canonical buffer from the two phase outputs.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm import wire as wire_codec
from repro_torch.comm.topology import PodTopology
from repro_torch.core.patterns import CommPattern, Message

Token = Tuple[int, int]  # (owner rank, element index)

#: PAD marker in token-code arrays (token codes are ``owner * L + elem``).
PAD_CODE = -1

_EMPTY = np.zeros((0,), dtype=np.int64)


# ---------------------------------------------------------------------------
# Pattern
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Need:
    """Rank ``dst`` needs elements ``idx`` of rank ``src``'s local buffer."""

    dst: int
    src: int
    idx: Tuple[int, ...]

    def __post_init__(self) -> None:
        if list(self.idx) != sorted(set(self.idx)):
            raise ValueError("Need.idx must be sorted and unique")


@dataclasses.dataclass(frozen=True)
class ExchangePattern:
    """Static irregular exchange pattern over a pod topology."""

    topo: PodTopology
    local_size: int
    needs: Tuple[Need, ...]

    def __post_init__(self) -> None:
        seen = set()
        for n in self.needs:
            if (n.dst, n.src) in seen:
                raise ValueError(f"duplicate need for (dst={n.dst}, src={n.src})")
            seen.add((n.dst, n.src))
            if n.src == n.dst:
                raise ValueError("self-needs are not communication")
            if n.idx and max(n.idx) >= self.local_size:
                raise ValueError("need index out of range")

    # -- canonical receive layout -------------------------------------
    def needs_of(self, dst: int) -> List[Need]:
        return sorted((n for n in self.needs if n.dst == dst), key=lambda n: n.src)

    def recv_size(self, dst: int) -> int:
        return sum(len(n.idx) for n in self.needs_of(dst))

    def max_recv_size(self) -> int:
        return max((self.recv_size(r) for r in range(self.topo.nranks)), default=0)

    def canonical_tokens(self, dst: int) -> List[Token]:
        out: List[Token] = []
        for n in self.needs_of(dst):
            out.extend((n.src, e) for e in n.idx)
        return out

    def canonical_code_rows(self) -> List[np.ndarray]:
        """``canonical_codes`` for every rank, in one pass over ``needs``."""
        acc: List[List[Need]] = [[] for _ in range(self.topo.nranks)]
        for n in self.needs:
            acc[n.dst].append(n)
        out = []
        for row in acc:
            row.sort(key=lambda n: n.src)
            parts = [
                n.src * self.local_size + np.asarray(n.idx, dtype=np.int64)
                for n in row
            ]
            out.append(np.concatenate(parts) if parts else _EMPTY)
        return out

    def fingerprint(self) -> str:
        """Stable content hash: cache / CSV key for this exact pattern.

        Hashes one flat int64 buffer -- header ``(npods, ppn, local_size,
        n_needs)``, then a ``(dst, src, len)`` triple per need in
        ``(dst, src)`` order, then every need's indices concatenated -- so
        the digest is a bijective, need-order-invariant function of the
        pattern at the cost of a single numpy conversion + hash pass,
        instead of O(total indices) Python string formatting.  This is on
        the per-batch path for dynamic (MoE routing) patterns.  The digest
        is memoized on the instance: patterns are frozen, so repeated
        cache lookups under the same pattern hash nothing.
        """
        cached = getattr(self, "_fp_memo", None)
        if cached is not None:
            return cached
        rows = sorted(self.needs, key=lambda n: (n.dst, n.src))
        buf = [self.topo.npods, self.topo.ppn, self.local_size, len(rows)]
        for n in rows:
            buf.append(n.dst)
            buf.append(n.src)
            buf.append(len(n.idx))
        for n in rows:
            buf.extend(n.idx)
        fp = hashlib.sha1(np.asarray(buf, dtype=np.int64).tobytes()).hexdigest()
        object.__setattr__(self, "_fp_memo", fp)
        return fp

    # -- derived views -------------------------------------------------
    def dedup_for_pod(self, src: int, dst_pod: int) -> List[int]:
        """Union of elements of ``src`` needed by any rank in ``dst_pod``
        (the node-aware data-redundancy elimination, paper §2.3)."""
        elems: set = set()
        for n in self.needs:
            if n.src == src and self.topo.pod_of(n.dst) == dst_pod:
                elems.update(n.idx)
        return sorted(elems)

    def to_comm_pattern(self, elem_bytes: int = 4) -> CommPattern:
        """Byte-level view for the performance models / advisor."""
        msgs = [
            Message(n.src, n.dst, len(n.idx) * elem_bytes)
            for n in self.needs
            if n.idx
        ]
        return CommPattern.from_messages(self.topo.nranks, self.topo.ppn, msgs)

    # -- reference oracle ----------------------------------------------
    def reference(self, local: np.ndarray) -> np.ndarray:
        """Numpy oracle: ``local [nranks, L] -> canonical recv [nranks, H]``."""
        nranks, H = self.topo.nranks, self.max_recv_size()
        out = np.zeros((nranks, H) + local.shape[2:], dtype=local.dtype)
        for r in range(nranks):
            toks = self.canonical_tokens(r)
            for k, (owner, e) in enumerate(toks):
                out[r, k] = local[owner, e]
        return out


def random_pattern(
    rng: np.random.Generator,
    topo: PodTopology,
    local_size: int,
    p_connect: float = 0.5,
    max_elems: Optional[int] = None,
) -> ExchangePattern:
    """Random irregular pattern for property tests."""
    max_elems = max_elems or local_size
    needs = []
    for dst in range(topo.nranks):
        for src in range(topo.nranks):
            if src == dst or rng.random() > p_connect:
                continue
            k = int(rng.integers(1, max_elems + 1))
            idx = np.sort(rng.choice(local_size, size=min(k, local_size), replace=False))
            needs.append(Need(dst, src, tuple(int(i) for i in idx)))
    return ExchangePattern(topo=topo, local_size=local_size, needs=tuple(needs))


# ---------------------------------------------------------------------------
# All-to-all-shaped (routing) patterns and count bucketing
# ---------------------------------------------------------------------------


def block_pattern(
    topo: PodTopology,
    block: int,
    widths: Optional[np.ndarray] = None,
) -> ExchangePattern:
    """The element-level pattern of a (possibly ragged) tiled all-to-all.

    Every rank's local buffer is ``nranks`` destination blocks of ``block``
    slots; rank ``s`` sends the first ``widths[s, d]`` slots of its ``d``-th
    block to rank ``d`` (``widths=None`` means full blocks -- the flat
    all-to-all).  This is exactly the shape of capacity-based MoE token
    dispatch: the router fills block ``d`` with the tokens bound for shard
    ``d``, and ``widths`` is the (quantized) per-pair token count, so skewed
    routing ships only the occupied slot prefix per pair.

    Self blocks never appear (they stay on-device); the canonical receive
    layout is src-major, matching the tiled all-to-all's block order minus
    the self block.
    """
    n = topo.nranks
    if widths is None:
        w = np.full((n, n), block, dtype=np.int64)
    else:
        w = np.asarray(widths, dtype=np.int64)
        if w.shape != (n, n):
            raise ValueError(f"widths must be [{n}, {n}], got {w.shape}")
        if (w < 0).any() or (w > block).any():
            raise ValueError(f"widths must lie in [0, {block}]")
    needs = []
    for d in range(n):
        base = d * block
        for s in range(n):
            k = int(w[s, d])
            if s == d or k == 0:
                continue
            needs.append(Need(dst=d, src=s, idx=tuple(range(base, base + k))))
    return ExchangePattern(topo=topo, local_size=n * block, needs=tuple(needs))


def quantize_widths(counts: np.ndarray, quantum: int, cap: int) -> np.ndarray:
    """Bucket per-pair token counts up to ``quantum``-slot granularity.

    ``counts[s, d]`` is the measured number of tokens rank ``s`` routed to
    rank ``d`` this batch; the result is the per-pair slot width to actually
    exchange: counts are clipped to the capacity ``cap`` (tokens beyond it
    were dropped anyway), then rounded UP to a multiple of ``quantum`` (and
    re-clipped to ``cap``).  Rounding up makes the width a safe upper bound
    on the occupied slot prefix, and quantization collapses nearby counts
    onto the same width so fingerprint-keyed plan caches hit under
    fluctuating-but-stationary load skew.  Zero counts stay zero (the pair
    drops out of the pattern entirely).
    """
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    c = np.minimum(np.asarray(counts, dtype=np.int64), cap)
    if (c < 0).any():
        raise ValueError("counts must be non-negative")
    q = -(-c // quantum) * quantum  # ceil to quantum
    return np.minimum(q, cap)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Gather:
    idx: np.ndarray  # [nranks, K] int32; idx == len(ext) means PAD


@dataclasses.dataclass(frozen=True)
class A2ALocal:
    buflen: int  # divisible by ppn
    #: optional fused input layout (a Gather folded in by repro_torch.comm.fusion)
    idx: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class A2APod:
    buflen: int  # divisible by npods
    idx: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class PermuteWorld:
    #: rounds[r] = tuple of (src_rank, dst_rank) pairs (a partial permutation)
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...]
    #: per-round block length
    blks: Tuple[int, ...]
    #: sel[round] = [nranks, blks[round]] indices into ext (PAD = len(ext))
    sels: Tuple[np.ndarray, ...]
    #: inter[round] = True iff every pair in the round crosses pods -- the
    #: stage metadata wire codecs key on (a mixed round stays full
    #: precision; ``None`` means unclassified and is treated as on-pod)
    inter: Optional[Tuple[bool, ...]] = None


Stage = object  # union of the four dataclasses above


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A full strategy program plus bookkeeping for benchmarks/tests."""

    strategy: str
    pattern: ExchangePattern
    stages: Tuple[Stage, ...]
    out_size: int
    #: payload bytes moved (excluding padding) per fabric, per whole machine
    intra_pod_bytes: int
    inter_pod_bytes: int
    #: bytes actually on the wire including padding (what XLA would move)
    wire_intra_pod_bytes: int
    wire_inter_pod_bytes: int
    #: True once repro_torch.comm.fusion rewrote the stage program
    fused: bool = False


# ---------------------------------------------------------------------------
# Program lowering (ext-once execution layout)
# ---------------------------------------------------------------------------


def rebase_indices(idx: np.ndarray, w: int, L: int, sentinel: int) -> np.ndarray:
    """Re-base stage indices from ``ext = [buf(w) | local(L)]`` coordinates
    onto the fixed ``[local(L) | buf(W_max)]`` scratch layout.

    PADs (``idx >= w + L``) map to ``sentinel`` (one past the scratch), which
    ``.get(mode='fill')`` turns into zeros.
    """
    idx = np.asarray(idx)
    out = np.full(idx.shape, sentinel, dtype=np.int32)
    np.copyto(out, (idx + L).astype(np.int32), where=idx < w)
    np.copyto(out, (idx - w).astype(np.int32), where=(idx >= w) & (idx < w + L))
    return out


@dataclasses.dataclass(frozen=True)
class LoweredProgram:
    """A stage program lowered to interpreter ops + re-based index arrays.

    The value half of a traceable exchange: ``ops`` is a static tuple of
    interpreter opcodes (hashable -- safe to close over inside ``jit``) and
    ``arrays`` is the pytree of per-rank ``[nranks, ...]`` int32 index
    arrays the ops address, every one re-based onto the single
    ``[local(L) | buf(W_max)]`` scratch so no stage re-concatenates
    ``[buf, local]``.  Built by :func:`lower_program`; interpreted per shard
    by the pure ``run`` callable of
    :class:`repro_torch.comm.strategies.TraceableExchange`.
    """

    ops: Tuple[tuple, ...]
    arrays: Tuple[np.ndarray, ...]
    w_max: int
    local_size: int
    out_size: int


def lower_program(sp: StagePlan) -> LoweredProgram:
    """Lower a planned stage program to its traceable ext-once form.

    Returns a :class:`LoweredProgram` whose every index array addresses the
    ``[local | buf]`` scratch of width ``L + W_max`` directly.
    """
    L = sp.pattern.local_size
    widths: List[int] = []
    w = 0
    for st in sp.stages:
        if isinstance(st, Gather):
            w = st.idx.shape[1]
        elif isinstance(st, (A2ALocal, A2APod)):
            w = st.buflen
        elif isinstance(st, PermuteWorld):
            w = sum(st.blks)
        else:
            raise TypeError(f"unknown stage {st!r}")
        widths.append(w)
    w_max = max(widths, default=0)
    w_max = max(w_max, sp.out_size)
    sentinel = L + w_max

    ops: List[tuple] = []
    arrays: List[np.ndarray] = []
    w = 0
    for st in sp.stages:
        if isinstance(st, Gather):
            arrays.append(rebase_indices(st.idx, w, L, sentinel))
            w = st.idx.shape[1]
            ops.append(("gather", w))
        elif isinstance(st, (A2ALocal, A2APod)):
            kind = "a2a_local" if isinstance(st, A2ALocal) else "a2a_pod"
            has_idx = st.idx is not None
            if has_idx:
                arrays.append(rebase_indices(st.idx, w, L, sentinel))
            ops.append((kind, st.buflen, has_idx))
            w = st.buflen
        elif isinstance(st, PermuteWorld):
            for sel in st.sels:
                arrays.append(rebase_indices(sel, w, L, sentinel))
            inter = st.inter if st.inter is not None else (False,) * len(st.blks)
            ops.append(("permute", st.rounds, st.blks, inter))
            w = sum(st.blks)
    return LoweredProgram(
        ops=tuple(ops),
        arrays=tuple(arrays),
        w_max=w_max,
        local_size=L,
        out_size=sp.out_size,
    )


# ---------------------------------------------------------------------------
# Symbolic simulator, token-list flavor (the legacy planner's state)
# ---------------------------------------------------------------------------

PAD: Optional[Token] = None


def _token_gather(stage_idx, buf, local):
    new = []
    for r in range(len(buf)):
        ext = buf[r] + list(local[r])
        row = []
        for i in stage_idx[r]:
            row.append(PAD if i >= len(ext) else ext[int(i)])
        new.append(row)
    return new


def simulate_stage(
    topo: PodTopology,
    stage: Stage,
    buf: List[List[Optional[Token]]],
    local: List[List[Token]],
) -> List[List[Optional[Token]]]:
    nranks, ppn, npods = topo.nranks, topo.ppn, topo.npods
    if isinstance(stage, Gather):
        return _token_gather(stage.idx, buf, local)
    if isinstance(stage, A2ALocal):
        if stage.idx is not None:
            buf = _token_gather(stage.idx, buf, local)
        blk = stage.buflen // ppn
        new = [[PAD] * stage.buflen for _ in range(nranks)]
        for p in range(npods):
            for l in range(ppn):
                r = topo.rank_of(p, l)
                for j in range(ppn):
                    src = topo.rank_of(p, j)
                    new[r][j * blk : (j + 1) * blk] = buf[src][l * blk : (l + 1) * blk]
        return new
    if isinstance(stage, A2APod):
        if stage.idx is not None:
            buf = _token_gather(stage.idx, buf, local)
        blk = stage.buflen // npods
        new = [[PAD] * stage.buflen for _ in range(nranks)]
        for p in range(npods):
            for l in range(ppn):
                r = topo.rank_of(p, l)
                for q in range(npods):
                    src = topo.rank_of(q, l)
                    new[r][q * blk : (q + 1) * blk] = buf[src][p * blk : (p + 1) * blk]
        return new
    if isinstance(stage, PermuteWorld):
        new = [[] for _ in range(nranks)]
        for rnd, (perm, blk, sel) in enumerate(zip(stage.rounds, stage.blks, stage.sels)):
            send = []
            for r in range(nranks):
                ext = buf[r] + list(local[r])
                send.append(
                    [PAD if i >= len(ext) else ext[int(i)] for i in sel[r]]
                )
            got = {d: send[s] for s, d in perm}
            for r in range(nranks):
                new[r].extend(got.get(r, [PAD] * blk))
        return new
    raise TypeError(f"unknown stage {stage!r}")


def simulate(plan: StagePlan) -> List[List[Optional[Token]]]:
    topo = plan.pattern.topo
    local = [
        [(r, e) for e in range(plan.pattern.local_size)]
        for r in range(topo.nranks)
    ]
    buf: List[List[Optional[Token]]] = [[] for _ in range(topo.nranks)]
    for stage in plan.stages:
        buf = simulate_stage(topo, stage, buf, local)
    return buf


# ---------------------------------------------------------------------------
# Symbolic simulator, vectorized token-code flavor (used by the planner)
# ---------------------------------------------------------------------------


def _gather_codes(ext: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``out[r, k] = ext[r, idx[r, k]]`` with ``idx >= E`` -> PAD_CODE."""
    n, E = ext.shape
    if E == 0:
        return np.full(idx.shape, PAD_CODE, dtype=np.int64)
    safe = np.minimum(idx, E - 1)
    out = ext[np.arange(n)[:, None], safe]
    return np.where(idx >= E, PAD_CODE, out)


def simulate_stage_codes(
    topo: PodTopology,
    stage: Stage,
    buf: np.ndarray,  # [nranks, W] int64 token codes, PAD_CODE = -1
    local: np.ndarray,  # [nranks, L]
) -> np.ndarray:
    nranks, ppn, npods = topo.nranks, topo.ppn, topo.npods
    if isinstance(stage, Gather):
        return _gather_codes(np.concatenate([buf, local], axis=1), np.asarray(stage.idx))
    if isinstance(stage, (A2ALocal, A2APod)):
        if stage.idx is not None:
            buf = _gather_codes(
                np.concatenate([buf, local], axis=1), np.asarray(stage.idx)
            )
        if isinstance(stage, A2ALocal):
            blk = stage.buflen // ppn
            b = buf.reshape(npods, ppn, ppn, blk)
            return b.transpose(0, 2, 1, 3).reshape(nranks, stage.buflen)
        blk = stage.buflen // npods
        b = buf.reshape(npods, ppn, npods, blk)
        return b.transpose(2, 1, 0, 3).reshape(nranks, stage.buflen)
    if isinstance(stage, PermuteWorld):
        ext = np.concatenate([buf, local], axis=1)
        parts = []
        for perm, blk, sel in zip(stage.rounds, stage.blks, stage.sels):
            send = _gather_codes(ext, np.asarray(sel))
            out = np.full((nranks, blk), PAD_CODE, dtype=np.int64)
            if perm:
                srcs = [s for s, _ in perm]
                dsts = [d for _, d in perm]
                out[dsts] = send[srcs]
            parts.append(out)
        if not parts:
            return np.zeros((nranks, 0), dtype=np.int64)
        return np.concatenate(parts, axis=1)
    raise TypeError(f"unknown stage {stage!r}")


def local_codes(pattern: ExchangePattern) -> np.ndarray:
    """``[nranks, L]`` token codes of every rank's own elements."""
    n, L = pattern.topo.nranks, pattern.local_size
    return (np.arange(n, dtype=np.int64)[:, None] * L + np.arange(L)[None, :]).reshape(
        n, L
    )


def simulate_codes(plan: StagePlan) -> np.ndarray:
    """Run the whole stage program over token codes; final ``[nranks, W]``."""
    topo = plan.pattern.topo
    local = local_codes(plan.pattern)
    buf = np.zeros((topo.nranks, 0), dtype=np.int64)
    for stage in plan.stages:
        buf = simulate_stage_codes(topo, stage, buf, local)
    return buf


# ---------------------------------------------------------------------------
# Numpy value executor (host oracle for the fused/unfused programs)
# ---------------------------------------------------------------------------


def _take_fill(ext: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Value gather with 0-fill for PAD; ``ext [n, E, *feat]``."""
    n, E = ext.shape[:2]
    if E == 0:
        return np.zeros((n,) + idx.shape[1:] + ext.shape[2:], dtype=ext.dtype)
    safe = np.minimum(idx, E - 1)
    out = ext[np.arange(n)[:, None], safe]
    out[idx >= E] = 0
    return out


def execute_numpy(
    plan: StagePlan,
    local: np.ndarray,
    wire: str = "none",
    *,
    faults=None,
    fault_call: int = 0,
    verify: bool = False,
) -> np.ndarray:
    """Execute a stage program in numpy: ``local [n, L, *feat] -> [n, H, *feat]``.

    Exact (bit-identical) data movement; the host oracle of the torch
    executor (:class:`repro_torch.comm.strategies.IrregularExchange`).  Used
    to verify that fused and unfused programs deliver identical values.

    ``wire`` selects the inter-pod codec (:mod:`repro_torch.comm.wire`): payloads
    crossing pods -- every non-diagonal ``A2APod`` block and every inter-pod
    ``PermuteWorld`` round -- are encode/decode round-tripped exactly the
    way the torch executor does, while on-pod hops stay full precision.
    ``wire="none"`` (the default) is the unchanged bit-exact movement.

    ``faults`` (a :class:`repro_torch.comm.faults.FaultPlan`) injects seeded
    deterministic corruption into the decoded DCI-crossing wire blocks --
    bitwise identical to the torch executor under the same plan --
    gated by ``faults.active(fault_call)``.  ``verify=True`` computes the
    per-wire-block check values of :mod:`repro_torch.comm.faults` before the
    codec round-trip and validates them after decode+injection, raising a
    structured :class:`repro_torch.comm.faults.ExchangeIntegrityError` at the
    first violating hop; fault-free verified runs return the same values
    as unverified ones.
    """
    wire_codec.check_codec(wire)
    # local import: repro_torch.comm.faults imports this module's stage types
    from repro_torch.comm import faults as faults_mod

    cf = None
    if faults is not None and faults.active(fault_call):
        cf = faults_mod.compile_faults(plan, wire, faults)
    topo = plan.pattern.topo
    nranks, ppn, npods = topo.nranks, topo.ppn, topo.npods
    local = np.asarray(local)
    feat = local.shape[2:]
    encoded = wire_codec.applies(wire, local.dtype)
    buf = np.zeros((nranks, 0) + feat, dtype=local.dtype)
    for op_i, stage in enumerate(plan.stages):
        if isinstance(stage, Gather):
            buf = _take_fill(np.concatenate([buf, local], axis=1), np.asarray(stage.idx))
        elif isinstance(stage, (A2ALocal, A2APod)):
            if stage.idx is not None:
                buf = _take_fill(
                    np.concatenate([buf, local], axis=1), np.asarray(stage.idx)
                )
            if isinstance(stage, A2ALocal):
                blk = stage.buflen // ppn
                b = buf.reshape((npods, ppn, ppn, blk) + feat)
                buf = b.transpose((0, 2, 1, 3) + tuple(range(4, 4 + len(feat)))).reshape(
                    (nranks, stage.buflen) + feat
                )
            else:
                blk = stage.buflen // npods
                b = buf.reshape((npods, ppn, npods, blk) + feat)
                axes = tuple(range(3, b.ndim))
                pre = faults_mod.block_check_np(b, axes) if verify else None
                # the inter-pod hop: round-trip off-diagonal blocks through
                # the wire codec (diagonal blocks never cross pods)
                b = wire_codec.roundtrip_pod_blocks_np(b, wire)
                if cf is not None:
                    for inj in cf.for_hop(op_i, None):
                        b = faults_mod.apply_injection_np(
                            b, inj.np_mask, inj.kind, inj.value
                        )
                if verify:
                    post = faults_mod.block_check_np(b, axes)
                    nelem = blk * int(np.prod(feat, dtype=np.int64))
                    faults_mod.raise_if_violated(
                        faults_mod.check_violation(pre, post, nelem, wire, encoded),
                        strategy=plan.strategy,
                        codec=wire,
                        stage_kind="a2a_pod",
                        op_index=op_i,
                    )
                buf = b.transpose((2, 1, 0, 3) + tuple(range(4, 4 + len(feat)))).reshape(
                    (nranks, stage.buflen) + feat
                )
        elif isinstance(stage, PermuteWorld):
            ext = np.concatenate([buf, local], axis=1)
            inters = (
                stage.inter if stage.inter is not None else (False,) * len(stage.blks)
            )
            parts = []
            for ri, (perm, blk, sel, inter) in enumerate(
                zip(stage.rounds, stage.blks, stage.sels, inters)
            ):
                send = _take_fill(ext, np.asarray(sel))
                if inter:
                    check = verify and bool(perm)
                    axes = tuple(range(1, send.ndim))
                    pre = faults_mod.block_check_np(send, axes) if check else None
                    # one wire block per sending rank
                    send = wire_codec.roundtrip_np(send, wire, block_ndim=send.ndim - 1)
                    if cf is not None:
                        for inj in cf.for_hop(op_i, ri):
                            send = faults_mod.apply_injection_np(
                                send, inj.np_mask, inj.kind, inj.value
                            )
                    if check:
                        post = faults_mod.block_check_np(send, axes)
                        nelem = blk * int(np.prod(feat, dtype=np.int64))
                        faults_mod.raise_if_violated(
                            faults_mod.check_violation(pre, post, nelem, wire, encoded),
                            strategy=plan.strategy,
                            codec=wire,
                            stage_kind="permute",
                            op_index=op_i,
                            round_index=ri,
                        )
                out = np.zeros((nranks, blk) + feat, dtype=local.dtype)
                if perm:
                    srcs = [s for s, _ in perm]
                    dsts = [d for _, d in perm]
                    out[dsts] = send[srcs]
                parts.append(out)
            buf = (
                np.concatenate(parts, axis=1)
                if parts
                else np.zeros((nranks, 0) + feat, dtype=local.dtype)
            )
        else:
            raise TypeError(f"unknown stage {stage!r}")
    if cf is not None and cf.delay_s > 0.0:
        import time

        time.sleep(cf.delay_s)  # the injected slow-hop latency
    return buf[:, : plan.out_size]


# ---------------------------------------------------------------------------
# Vectorized planner
# ---------------------------------------------------------------------------


def _pad_rows(rows: Sequence[np.ndarray], width: Optional[int] = None) -> np.ndarray:
    """Stack ragged code rows into ``[len(rows), W]`` with PAD_CODE fill."""
    n = len(rows)
    lens = np.fromiter((len(x) for x in rows), dtype=np.int64, count=n)
    W = int(lens.max()) if n else 0
    if width is not None:
        W = width
    W = max(W, 1)
    out = np.full((n, W), PAD_CODE, dtype=np.int64)
    if n and lens.sum():
        mask = np.arange(W)[None, :] < lens[:, None]
        out[mask] = np.concatenate([np.asarray(r, dtype=np.int64) for r in rows if len(r)])
    return out


def _dedup_codes(pattern: ExchangePattern) -> Dict[Tuple[int, int], np.ndarray]:
    """All (src rank, dst pod) deduped element unions in one pass over needs."""
    topo = pattern.topo
    acc: Dict[Tuple[int, int], set] = defaultdict(set)
    for n in pattern.needs:
        acc[(n.src, topo.pod_of(n.dst))].update(n.idx)
    return {
        k: np.fromiter(sorted(v), dtype=np.int64, count=len(v))
        for k, v in acc.items()
    }


class _Planner:
    """Builds stages while tracking the symbolic buffer state (token codes)."""

    def __init__(self, pattern: ExchangePattern):
        self.pattern = pattern
        self.topo = pattern.topo
        self.L = pattern.local_size
        n = self.topo.nranks
        self.ntok = n * self.L
        self.local = local_codes(pattern)
        self.buf = np.zeros((n, 0), dtype=np.int64)
        self.canon = pattern.canonical_code_rows()
        self.max_recv = max((len(c) for c in self.canon), default=0)
        self.stages: List[Stage] = []
        self.intra_payload = 0
        self.inter_payload = 0
        self.wire_intra = 0
        self.wire_inter = 0
        self._lut: Optional[np.ndarray] = None

    # -- symbolic state ------------------------------------------------
    @property
    def ext_len(self) -> int:
        return self.buf.shape[1] + self.L

    def _apply(self, stage: Stage) -> None:
        self.stages.append(stage)
        self.buf = simulate_stage_codes(self.topo, stage, self.buf, self.local)
        self._lut = None

    def _pos_lut(self) -> np.ndarray:
        """``lut[r, code]`` = first position of token ``code`` in rank ``r``'s
        ext buffer, or ``ext_len`` (the PAD sentinel) when not held."""
        if self._lut is not None:
            return self._lut
        ext = np.concatenate([self.buf, self.local], axis=1)
        n, E = ext.shape
        lut = np.full((n, max(self.ntok, 1)), E, dtype=np.int64)
        if E and self.ntok:
            rows = np.repeat(np.arange(n), E)
            cols = np.tile(np.arange(E), n)
            codes = ext.reshape(-1)
            valid = codes >= 0
            # min over duplicate writes = first occurrence
            np.minimum.at(lut, (rows[valid], codes[valid]), cols[valid])
        self._lut = lut
        return lut

    def _map_codes(self, want: np.ndarray) -> np.ndarray:
        """Token codes ``[n, K]`` (PAD_CODE allowed) -> Gather/sel indices."""
        n = want.shape[0]
        E = self.ext_len
        lut = self._pos_lut()
        idx = lut[np.arange(n)[:, None], np.maximum(want, 0)]
        missing = (want >= 0) & (idx >= E)
        if missing.any():
            r, k = map(int, np.argwhere(missing)[0])
            code = int(want[r, k])
            tok = (code // self.L, code % self.L) if self.L else code
            raise AssertionError(f"planner bug: token {tok} not held by rank {r}")
        idx = np.where(want < 0, E, idx)
        return idx.astype(np.int32)

    # -- stage emitters ---------------------------------------------------
    def gather_codes(self, want: np.ndarray) -> None:
        self._apply(Gather(idx=self._map_codes(want)))

    def a2a_local(self, elem_bytes: int) -> None:
        n, W = self.buf.shape
        ppn, npods = self.topo.ppn, self.topo.npods
        assert W % ppn == 0
        blk = W // ppn
        nonpad = (self.buf.reshape(npods, ppn, ppn, blk) >= 0).sum(axis=3)
        # self block (j == l) does not hit the wire
        diag = int(np.einsum("pll->", nonpad))
        self.intra_payload += (int(nonpad.sum()) - diag) * elem_bytes
        self.wire_intra += n * (ppn - 1) * blk * elem_bytes
        self._apply(A2ALocal(buflen=W))

    def a2a_pod(self, elem_bytes: int) -> None:
        n, W = self.buf.shape
        ppn, npods = self.topo.ppn, self.topo.npods
        assert W % npods == 0
        blk = W // npods
        nonpad = (self.buf.reshape(npods, ppn, npods, blk) >= 0).sum(axis=3)
        diag = int(np.einsum("qlq->", nonpad))
        self.inter_payload += (int(nonpad.sum()) - diag) * elem_bytes
        self.wire_inter += n * (npods - 1) * blk * elem_bytes
        self._apply(A2APod(buflen=W))

    def permute_world(
        self,
        rounds: List[Dict[int, Tuple[int, np.ndarray]]],
        elem_bytes: int,
    ) -> None:
        """``rounds[i][src] = (dst, codes)``: src sends those tokens to dst."""
        n = self.topo.nranks
        perm_list, blks, sels, inters = [], [], [], []
        for rnd in rounds:
            blk = max((len(c) for _, c in rnd.values()), default=0)
            blk = max(blk, 1)
            want = np.full((n, blk), PAD_CODE, dtype=np.int64)
            perm = []
            crossings = []
            for s in sorted(rnd):
                dst, codes = rnd[s]
                perm.append((s, dst))
                want[s, : len(codes)] = codes
                payload = len(codes) * elem_bytes
                crosses = self.topo.pod_of(s) != self.topo.pod_of(dst)
                crossings.append(crosses)
                if crosses:
                    self.inter_payload += payload
                    self.wire_inter += blk * elem_bytes
                else:
                    self.intra_payload += payload
                    self.wire_intra += blk * elem_bytes
            perm_list.append(tuple(perm))
            blks.append(blk)
            sels.append(self._map_codes(want))
            inters.append(bool(crossings) and all(crossings))
        self._apply(
            PermuteWorld(
                rounds=tuple(perm_list),
                blks=tuple(blks),
                sels=tuple(sels),
                inter=tuple(inters),
            )
        )

    # -- shared epilogue ---------------------------------------------------
    def redistribute_and_finish(self, elem_bytes: int, extra_local_direct: bool) -> None:
        """Intra-pod redistribution (local_Rcomm) + canonical projection.

        Block ``j`` of each rank's redistribution buffer = tokens this rank
        holds that rank ``(mypod, j)`` needs, optionally including this
        rank's *own* elements (the paper's ``local_comm`` merged in).
        """
        topo = self.topo
        n, L = topo.nranks, self.L
        lut = self._pos_lut()
        E = self.ext_len
        held = lut < E  # [n, ntok]
        blocks: List[np.ndarray] = []
        for r in range(n):
            p = topo.pod_of(r)
            hr = held[r]
            if not extra_local_direct and L:
                hr = hr.copy()
                hr[r * L : (r + 1) * L] = False
            for j in range(topo.ppn):
                d = topo.rank_of(p, j)
                c = self.canon[d]
                m = hr[c] if len(c) else np.zeros((0,), dtype=bool)
                if d == r and L:
                    # self block stays on-device; own local elements are
                    # always reachable via ext, so exclude them.
                    m = m & (c // L != r)
                blocks.append(c[m])
        want = _pad_rows(blocks).reshape(n, -1)
        self.gather_codes(want)
        self.a2a_local(elem_bytes)
        self.finish_canonical()

    def finish_canonical(self) -> None:
        self.gather_codes(_pad_rows(self.canon, width=max(self.max_recv, 1)))

    def build(self, strategy: str) -> StagePlan:
        pat = self.pattern
        # verify delivery: every rank's canonical prefix must be in place
        n, H = self.buf.shape
        want = _pad_rows(self.canon, width=H)
        lens = np.fromiter((len(c) for c in self.canon), dtype=np.int64, count=n)
        mask = np.arange(H)[None, :] < lens[:, None]
        ok = (self.buf == want) | ~mask
        if not ok.all():
            r = int(np.argwhere(~ok)[0, 0])
            raise AssertionError(f"strategy {strategy}: rank {r} canonical mismatch")
        return StagePlan(
            strategy=strategy,
            pattern=pat,
            stages=tuple(self.stages),
            out_size=max(self.max_recv, 1),
            intra_pod_bytes=self.intra_payload,
            inter_pod_bytes=self.inter_payload,
            wire_intra_pod_bytes=self.wire_intra,
            wire_inter_pod_bytes=self.wire_inter,
        )


# ---------------------------------------------------------------------------
# Strategy planners
# ---------------------------------------------------------------------------


def plan_standard(pattern: ExchangePattern, elem_bytes: int = 4) -> StagePlan:
    """Standard communication: dense per-(src,dst) exchange.

    Both redundancies of paper Fig 2.2 are present: every (src, dst) pair
    gets its own message slot, and the same element is sent once per
    requesting rank.
    """
    topo = pattern.topo
    pl = _Planner(pattern)
    n, L = topo.nranks, pattern.local_size
    by_pair: Dict[Tuple[int, int], np.ndarray] = {}
    for nd in pattern.needs:
        by_pair[(nd.src, nd.dst)] = nd.src * L + np.asarray(nd.idx, dtype=np.int64)
    B = max((len(v) for v in by_pair.values()), default=0)
    B = max(B, 1)

    # layout [npods, ppn, B] by destination (pod, local)
    blocks = [by_pair.get((r, d), _EMPTY) for r in range(n) for d in range(n)]
    pl.gather_codes(_pad_rows(blocks, width=B).reshape(n, n * B))
    pl.a2a_pod(elem_bytes)
    # transpose [q, j, B] -> [j, q, B] so A2ALocal blocks are contiguous
    want = (
        pl.buf.reshape(n, topo.npods, topo.ppn, B)
        .transpose(0, 2, 1, 3)
        .reshape(n, n * B)
    )
    pl.gather_codes(want)
    pl.a2a_local(elem_bytes)
    pl.finish_canonical()
    return pl.build("standard")


def plan_two_step(pattern: ExchangePattern, elem_bytes: int = 4) -> StagePlan:
    """2-Step: per-(src rank -> dst pod) fused, deduped messages to the
    pod-rank pair, then intra-pod redistribution (paper §2.3.2)."""
    topo = pattern.topo
    pl = _Planner(pattern)
    n, L = topo.nranks, pattern.local_size
    dedup = _dedup_codes(pattern)
    fused = {
        (r, p): r * L + dedup.get((r, p), _EMPTY)
        for r in range(n)
        for p in range(topo.npods)
    }
    B = max((len(v) for v in fused.values()), default=0)
    B = max(B, 1)

    blocks = [
        fused[(r, p)] if p != topo.pod_of(r) else _EMPTY
        for r in range(n)
        for p in range(topo.npods)
    ]
    pl.gather_codes(_pad_rows(blocks, width=B).reshape(n, topo.npods * B))
    pl.a2a_pod(elem_bytes)
    pl.redistribute_and_finish(elem_bytes, extra_local_direct=True)
    return pl.build("two_step")


def plan_three_step(pattern: ExchangePattern, elem_bytes: int = 4) -> StagePlan:
    """3-Step: intra-pod gather to the pair agent, single fused inter-pod
    message per pod pair, intra-pod redistribution (paper §2.3.1)."""
    topo = pattern.topo
    pl = _Planner(pattern)
    n, L = topo.nranks, pattern.local_size
    dedup = _dedup_codes(pattern)
    # deduped contribution of each rank to each foreign pod
    contrib = {
        (r, p): r * L + dedup.get((r, p), _EMPTY)
        for r in range(n)
        for p in range(topo.npods)
        if p != topo.pod_of(r)
    }

    # step 1: route contributions to the (src pod, dst pod) agent
    blocks: List[np.ndarray] = []
    for r in range(n):
        q = topo.pod_of(r)
        per_agent: List[List[np.ndarray]] = [[] for _ in range(topo.ppn)]
        for p in range(topo.npods):
            if p == q:
                continue
            per_agent[topo.agent_local(q, p)].append(contrib[(r, p)])
        blocks.extend(
            np.concatenate(b) if b else _EMPTY for b in per_agent
        )
    pl.gather_codes(_pad_rows(blocks).reshape(n, -1))
    pl.a2a_local(elem_bytes)

    # step 2: one fused message per pod pair, spread over shifts
    rounds = []
    for d in topo.pod_shift_rounds():
        rnd: Dict[int, Tuple[int, np.ndarray]] = {}
        for q in range(topo.npods):
            p = (q + d) % topo.npods
            a = topo.agent_local(q, p)
            src = topo.rank_of(q, a)
            dst = topo.rank_of(p, a)
            toks = [contrib[(topo.rank_of(q, l), p)] for l in range(topo.ppn)]
            rnd[src] = (dst, np.unique(np.concatenate(toks))) if toks else (dst, _EMPTY)
        rounds.append(rnd)
    pl.permute_world(rounds, elem_bytes)
    pl.redistribute_and_finish(elem_bytes, extra_local_direct=True)
    return pl.build("three_step")


def _greedy_rounds(
    chunks: List[Tuple[int, int, np.ndarray]]
) -> List[Dict[int, Tuple[int, np.ndarray]]]:
    """Edge-color the chunk multigraph into rounds where every rank sends
    and receives at most one chunk (largest chunks first)."""
    remaining = sorted(chunks, key=lambda c: -len(c[2]))
    rounds = []
    while remaining:
        used_s, used_d = set(), set()
        rnd: Dict[int, Tuple[int, np.ndarray]] = {}
        rest = []
        for s, d, toks in remaining:
            if s in used_s or d in used_d:
                rest.append((s, d, toks))
                continue
            used_s.add(s)
            used_d.add(d)
            rnd[s] = (d, toks)
        rounds.append(rnd)
        remaining = rest
    return rounds


def plan_split(
    pattern: ExchangePattern,
    message_cap_bytes: int,
    elem_bytes: int = 4,
) -> StagePlan:
    """Split node-aware communication (paper §2.3.3 / Algorithm 1).

    Inter-pod volume is deduped and conglomerated per (origin pod -> dest
    pod), split into chunks of at most the effective ``message_cap`` (lines
    12-17), balanced over on-pod senders/receivers (line 18), exchanged, and
    redistributed.
    """
    topo = pattern.topo
    pl = _Planner(pattern)
    n, L = topo.nranks, pattern.local_size
    dedup = _dedup_codes(pattern)

    # per recv pod: per origin pod: owner-major deduped token list
    chunks: List[Tuple[int, int, np.ndarray]] = []  # (sender, receiver, codes)
    stage0_rows: List[List[List[np.ndarray]]] = [
        [[] for _ in range(topo.ppn)] for _ in range(n)
    ]
    for recv_pod in range(topo.npods):
        per_origin: Dict[int, np.ndarray] = {}
        for origin in range(topo.npods):
            if origin == recv_pod:
                continue
            toks = [
                topo.rank_of(origin, l) * L
                + dedup.get((topo.rank_of(origin, l), recv_pod), _EMPTY)
                for l in range(topo.ppn)
            ]
            cat = np.concatenate(toks) if toks else _EMPTY
            if len(cat):
                per_origin[origin] = cat
        if not per_origin:
            continue
        vols = {o: len(t) * elem_bytes for o, t in per_origin.items()}
        total = sum(vols.values())
        biggest = max(vols.values())
        # Algorithm 1, lines 12-17
        if biggest < message_cap_bytes:
            cap = biggest  # conglomerate: one message per origin pod
        elif total / message_cap_bytes > topo.ppn:
            cap = -(-total // topo.ppn)  # ceil
        else:
            cap = message_cap_bytes
        cap_elems = max(cap // elem_bytes, 1)

        raw: List[Tuple[int, np.ndarray]] = []  # (origin, chunk codes)
        for origin in sorted(per_origin):
            toks = per_origin[origin]
            for i in range(0, len(toks), cap_elems):
                raw.append((origin, toks[i : i + cap_elems]))
        # line 18: receives descending from local 0; sends from local ppn-1
        raw.sort(key=lambda t: -len(t[1]))
        send_counter: Dict[int, int] = defaultdict(int)
        for i, (origin, toks) in enumerate(raw):
            receiver = topo.rank_of(recv_pod, i % topo.ppn)
            k = send_counter[origin]
            sender = topo.rank_of(origin, topo.ppn - 1 - (k % topo.ppn))
            send_counter[origin] += 1
            chunks.append((sender, receiver, toks))
            # stage 0 (local_Scomm): owners stage chunk bytes on the sender
            owners = toks // L if L else toks * 0
            j = topo.local_of(sender)
            for owner in np.unique(owners):
                if int(owner) != sender:
                    stage0_rows[int(owner)][j].append(toks[owners == owner])

    blocks = [
        np.concatenate(b) if b else _EMPTY
        for row in stage0_rows
        for b in row
    ]
    pl.gather_codes(_pad_rows(blocks).reshape(n, -1))
    pl.a2a_local(elem_bytes)
    pl.permute_world(_greedy_rounds(chunks), elem_bytes)
    pl.redistribute_and_finish(elem_bytes, extra_local_direct=True)
    return pl.build("split")


def plan_local(pattern: ExchangePattern, elem_bytes: int = 4) -> StagePlan:
    """Intra-pod-only program: one gather + one ``A2ALocal`` + projection.

    This is the on-node phase of the split-phase (overlap) exchange: every
    need must be pod-local.  All four node-aware strategies degenerate to the
    same program for pod-local data -- the node-aware rewrites only touch
    inter-node traffic -- so the local phase has a single planner.
    """
    topo = pattern.topo
    for n in pattern.needs:
        if topo.pod_of(n.src) != topo.pod_of(n.dst):
            raise ValueError(
                f"plan_local requires a pod-local pattern; need "
                f"{n.dst}<-{n.src} crosses pods"
            )
    pl = _Planner(pattern)
    pl.redistribute_and_finish(elem_bytes, extra_local_direct=True)
    return pl.build("local")


PLANNERS: Dict[str, Callable[..., StagePlan]] = {
    "standard": plan_standard,
    "two_step": plan_two_step,
    "three_step": plan_three_step,
    "split": plan_split,
    "local": plan_local,
}


def plan(strategy: str, pattern: ExchangePattern, *, message_cap_bytes: int = 16384, elem_bytes: int = 4) -> StagePlan:
    if strategy == "split":
        return plan_split(pattern, message_cap_bytes, elem_bytes)
    try:
        return PLANNERS[strategy](pattern, elem_bytes)
    except KeyError as e:
        raise KeyError(f"unknown strategy {strategy!r}; known: {sorted(PLANNERS)}") from e


# ---------------------------------------------------------------------------
# Split-phase decomposition (the overlap-capable two-phase exchange)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SplitPhase:
    """A pattern factored into an on-pod phase and an inter-pod phase.

    ``local`` holds the needs whose source is on the destination's own pod
    (deliverable with intra-pod communication only, :func:`plan_local`);
    ``remote`` holds the inter-pod needs (planned by any node-aware
    strategy).  The merge maps route each slot of the *full* canonical recv
    buffer to its position in the phase that delivers it:

    ``merged[r, j] = local_out[r, local_idx[r, j]]``  if ``from_local[r, j]``
    else ``remote_out[r, remote_idx[r, j]]``.

    Because both sub-patterns keep the full pattern's src-major canonical
    ordering, each phase's canonical buffer is a subsequence of the full one
    and the merge is a pure per-rank gather -- no communication.
    """

    full: ExchangePattern
    local: ExchangePattern
    remote: ExchangePattern
    from_local: np.ndarray  # [nranks, H] bool
    local_idx: np.ndarray  # [nranks, H] int32 into the local phase's buffer
    remote_idx: np.ndarray  # [nranks, H] int32 into the remote phase's buffer
    #: slots past a rank's canonical length are zero-filled, like the
    #: barrier executor's PAD handling
    valid: np.ndarray  # [nranks, H] bool


def split_phase(pattern: ExchangePattern) -> SplitPhase:
    """Factor ``pattern`` into its on-pod and inter-pod sub-patterns."""
    topo = pattern.topo
    loc: List[Need] = []
    rem: List[Need] = []
    for n in pattern.needs:
        (loc if topo.pod_of(n.src) == topo.pod_of(n.dst) else rem).append(n)
    local = ExchangePattern(
        topo=topo, local_size=pattern.local_size, needs=tuple(loc)
    )
    remote = ExchangePattern(
        topo=topo, local_size=pattern.local_size, needs=tuple(rem)
    )
    nranks = topo.nranks
    L = pattern.local_size
    H = max(pattern.max_recv_size(), 1)
    from_local = np.zeros((nranks, H), dtype=bool)
    local_idx = np.zeros((nranks, H), dtype=np.int32)
    remote_idx = np.zeros((nranks, H), dtype=np.int32)
    valid = np.zeros((nranks, H), dtype=bool)
    for r, codes in enumerate(pattern.canonical_code_rows()):
        n = len(codes)
        if not n:
            continue
        is_local = (codes // L) // topo.ppn == topo.pod_of(r)
        valid[r, :n] = True
        from_local[r, :n] = is_local
        local_idx[r, :n] = np.cumsum(is_local) - 1
        remote_idx[r, :n] = np.cumsum(~is_local) - 1
    np.maximum(local_idx, 0, out=local_idx)
    np.maximum(remote_idx, 0, out=remote_idx)
    return SplitPhase(
        full=pattern,
        local=local,
        remote=remote,
        from_local=from_local,
        local_idx=local_idx,
        remote_idx=remote_idx,
        valid=valid,
    )


def merge_split_phase(
    sp: SplitPhase, local_out: np.ndarray, remote_out: np.ndarray
) -> np.ndarray:
    """Numpy oracle for the split-phase merge: phase outputs -> full buffer.

    ``local_out`` / ``remote_out`` are the two phases' canonical buffers
    (e.g. from :func:`execute_numpy` on their plans); the result is
    bit-identical to executing the unsplit plan.
    """
    n, H = sp.from_local.shape
    feat = local_out.shape[2:]
    rows = np.arange(n)[:, None]
    lo = local_out[rows, np.minimum(sp.local_idx, local_out.shape[1] - 1)]
    ro = remote_out[rows, np.minimum(sp.remote_idx, remote_out.shape[1] - 1)]
    expand = (n, H) + (1,) * len(feat)
    mask = sp.from_local.reshape(expand)
    valid = sp.valid.reshape(expand)
    return np.where(valid, np.where(mask, lo, ro), np.zeros_like(lo))
