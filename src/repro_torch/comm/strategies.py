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

The inter-pod hops -- the ``A2APod`` blocks and the inter-pod
``PermuteWorld`` rounds -- are where the wire lives.  There, and only there:

* a lossy codec (``wire="bf16" | "f16" | "int8"``) encodes the sender's wire
  blocks, the index move carries the encoded payload (and the int8 scales),
  and the receiver decodes it; the own-pod ``A2APod`` block never crossed
  pods and stays at full precision;
* ``verify=True`` takes the check triple of each sender block before
  encoding, moves it with the payload, and compares it with the triple of
  the received block after decoding (one device-to-host read per call);
* a :class:`~repro_torch.comm.faults.FaultPlan` corrupts received blocks
  with masks compiled once per (plan, codec, fault plan) and kept on the
  device.

All of it is bitwise the numpy oracle ``execute_numpy(wire=, faults=,
verify=)``.  A failed check raises
:class:`~repro_torch.comm.faults.ExchangeIntegrityError` through the
retry -> codec demotion -> strategy re-advise ladder
(:func:`repro_torch.comm.faults.run_ladder`).

Split-phase execution (:meth:`IrregularExchange.start`) runs the inter-pod
sub-exchange (with its codec, checks and faults) on a side CUDA stream
while the on-pod one runs on the current stream;
:meth:`ExchangeHandle.finish` makes the current stream wait, settles the
checks and merges the two, bitwise equal to the barrier call.

``IrregularExchange(group=...)`` runs the same program with one rank per
process (:class:`~repro_torch.comm.topology.ExchangeGroup`): ``local [1, L,
*feat] -> [1, H, *feat]``, its hops real gloo collectives staged through
host memory (:class:`_RankProgram`), bitwise this rank's row of the stacked
call.  Its split phase leaves the inter-pod program's first hop in flight
(``async_op=True``) while the on-pod program runs, and ``finish()`` runs the
inter-pod program's other hops.  Checks and faults run there too: each
sender's check triples cross the hop in the payload's own bytes, the
receiver computes each hop's violation, and a guarded call ends with one
all-reduce MAX of the violations over the world, so every rank raises the
same :class:`~repro_torch.comm.faults.ExchangeIntegrityError` (or none) and
takes the same rung of the ladder.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.comm import compression
from repro_torch.comm import faults as faults_mod
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
from repro_torch.comm.hops import Hop, run_hops
from repro_torch.core.device import DeviceLike, as_device_tensor, device_for_rank, resolve_device

_EPS32 = float(np.finfo(np.float32).eps)

_WIRE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}


# ---------------------------------------------------------------------------
# Wire codecs, checks and injections on the device
# ---------------------------------------------------------------------------


def _codec_applies(codec: str, dtype: torch.dtype) -> bool:
    """:func:`repro_torch.comm.wire.applies` for a torch dtype: floating
    payloads strictly wider than the wire type are encoded."""
    w = wire_mod.WIRE_ITEMSIZE[wire_mod.check_codec(codec)]
    return w is not None and dtype.is_floating_point and dtype.itemsize > w


def _encode_blocks(blocks: torch.Tensor, codec: str):
    """Encode ``[nblocks, nelem]`` wire blocks; returns ``(payload, scale)``.

    bf16/f16 saturate *finite* overflow to the wire type's max and let
    ``+/-inf`` and ``nan`` through the cast (round to nearest even, as
    :func:`repro_torch.comm.wire.roundtrip_np`).  int8 takes one float32
    scale per block over its finite magnitudes and ships non-finite
    elements as :data:`~repro_torch.comm.wire.INT8_NONFINITE`.
    """
    if codec in _WIRE_DTYPES:
        fmax = wire_mod.WIRE_FMAX[codec]
        sat = torch.where(torch.isfinite(blocks), blocks.clamp(-fmax, fmax), blocks)
        return sat.to(_WIRE_DTYPES[codec]), None
    f = blocks.float()
    scale = compression.int8_scale(compression.finite_amax(f, dim=1), wire_mod.QMAX)
    q = compression.int8_quantize(
        f, scale[:, None], wire_mod.QMAX, nonfinite_code=wire_mod.INT8_NONFINITE
    )
    return q, scale


def _decode_blocks(payload: torch.Tensor, scale: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Inverse of :func:`_encode_blocks` after the move."""
    if scale is None:
        return payload.to(dtype)
    return compression.int8_dequantize(
        payload, scale[:, None], nonfinite_code=wire_mod.INT8_NONFINITE
    ).to(dtype)


def _wire_check(blocks: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`repro_torch.comm.faults.block_check_np`: the
    ``(sum |finite x|, nonfinite count, finite amax)`` triple of each row of
    ``[nblocks, nelem]``, as ``[nblocks, 3]`` float32.

    The magnitudes are laid out as a fresh contiguous ``[nblocks, nelem]``
    tensor padded with zeros to a 16-byte row, so every row of the sender's
    and the receiver's tensor is summed by the same reduction in the same
    order: a block that only moved gives a bitwise equal sum.
    """
    f = blocks.float()
    finite = torch.isfinite(f)
    mag = torch.where(finite, f.abs(), torch.zeros((), device=f.device))
    pad = (-mag.shape[1]) % 4
    if pad:
        mag = torch.nn.functional.pad(mag, (0, pad))
    s = mag.sum(dim=1)
    c = (~finite).sum(dim=1).float()
    a = mag.amax(dim=1) if mag.shape[1] else torch.zeros_like(s)
    return torch.stack([s, c, a], dim=-1)


def _check_violation(pre: torch.Tensor, post: torch.Tensor, nelem: int, codec: str,
                     encoded: bool) -> torch.Tensor:
    """Torch twin of :func:`repro_torch.comm.faults.check_violation`, reduced
    to the hop's worst block (``> 0`` means the check failed)."""
    s0, c0, a0 = pre.unbind(-1)
    s1, c1 = post[:, 0], post[:, 1]
    if encoded:
        rel = wire_mod.REL_ERROR_BOUND[codec]
        floor = wire_mod.ABS_ERROR_FLOOR[codec]
        tol = nelem * (rel * a0 + floor) * 1.0625 + 64.0 * _EPS32 * (s0 + 1.0)
    else:
        tol = torch.zeros_like(s0)
    drift = (s1.double() - s0.double()).abs() - tol.double()
    viol = torch.where(c1 != c0, torch.full_like(drift, float("inf")), drift)
    return viol.max()


def _apply_injection(x: torch.Tensor, mask: torch.Tensor, kind: str, value: float) -> torch.Tensor:
    """Torch twin of :func:`repro_torch.comm.faults.apply_injection_np`."""
    m = mask.view(mask.shape + (1,) * (x.ndim - mask.ndim))
    if kind == "zero":
        return torch.where(m, torch.zeros((), dtype=x.dtype, device=x.device), x)
    v = torch.full((), value, dtype=x.dtype, device=x.device)
    if kind == "corrupt":
        return torch.where(m, v, x)
    if kind == "perturb":
        return torch.where(m, x * v, x)
    raise ValueError(f"unknown injection kind {kind!r}")


def _faults_on_device(cache: dict, sp: StagePlan, device: torch.device, codec: str, faults,
                      rank: Optional[int] = None) -> tuple:
    """``(injections, delay_s)`` of ``faults`` compiled against ``sp`` and
    ``codec``, memoized in ``cache`` per (codec, fault plan): injections map
    ``(op_index, round_index)`` to ``((kind, receiver mask, value), ...)``
    with the masks on ``device`` -- every receiver's, or only ``rank``'s
    row (a process group's rank)."""
    key = (codec, faults.fingerprint())
    got = cache.get(key)
    if got is None:
        cf = faults_mod.compile_faults(sp, codec, faults)
        grouped: Dict[tuple, list] = {}
        for inj in cf.injections:
            mask = inj.dev_mask if rank is None else inj.dev_mask[rank]
            grouped.setdefault((inj.op_index, inj.round_index), []).append(
                (inj.kind, torch.as_tensor(mask, device=device), inj.value)
            )
        got = cache[key] = ({k: tuple(v) for k, v in grouped.items()}, cf.delay_s)
    return got


def _wire_hop(send: torch.Tensor, move: Callable, codec: str, encoded: bool, verify: bool,
              injections, recv_shape: tuple, own_pod: Optional[int] = None):
    """One inter-pod hop of ``[nblocks, nelem]`` sender blocks.

    ``move`` is the hop's index move (it carries any ``[nblocks, ...]``
    tensor from the sender's block order to the receiver's).  Returns the
    received blocks (same shape) and the hop's violation (``None`` unless
    ``verify``).  ``own_pod`` (the pod count of an ``A2APod`` hop) restores
    each rank's own-pod block at full precision; ``recv_shape`` is the
    receiver layout the fault masks address.
    """
    pre = _wire_check(send) if verify else None
    if encoded and send.numel():
        payload, scale = _encode_blocks(send, codec)
        got = _decode_blocks(move(payload), None if scale is None else move(scale), send.dtype)
        if own_pod is not None:
            i = torch.arange(own_pod, device=send.device)
            gv = got.view((own_pod, -1, own_pod) + tuple(got.shape[1:]))
            gv[i, :, i] = send.view(gv.shape)[i, :, i]
    else:
        got = move(send)
    for kind, mask, value in injections:
        got = _apply_injection(got.view(recv_shape), mask, kind, value).view(got.shape)
    if not verify:
        return got, None
    return got, _check_violation(move(pre), _wire_check(got), send.shape[1], codec, encoded)


# ---------------------------------------------------------------------------
# Lowered program on a device
# ---------------------------------------------------------------------------


class _Program:
    """A lowered stage program with its indices as flat device tensors.

    The scratch is ``[nranks, E, *feat]`` with ``E = L + w_max + 1``: the
    rank's ``local`` block, the buffer region, and one all-zero slot at the
    PAD sentinel.  Index ``i`` of rank ``r`` becomes ``r * E + i``.

    ``hops`` lists the inter-pod hops a verified run checks, in program
    order: ``(op_index, stage_kind, round_index)``, the columns of
    :meth:`run`'s violation vector.
    """

    def __init__(self, sp: StagePlan, device: torch.device):
        lp = lower_program(sp)
        topo = sp.pattern.topo
        self.sp = sp
        self.device = device
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
                _, rounds, blks, inters = op
                rnds = []
                for perm, blk, inter in zip(rounds, blks, inters):
                    sel = flat(lp.arrays[ai])
                    ai += 1
                    srcs = torch.as_tensor([s for s, _ in perm], dtype=torch.int64, device=device)
                    dsts = torch.as_tensor([d for _, d in perm], dtype=torch.int64, device=device)
                    rnds.append((blk, sel, srcs, dsts, bool(inter)))
                self.steps.append(("permute", sum(blks), rnds))
            else:
                raise TypeError(f"unknown op {op!r}")
        self.hops: Tuple[tuple, ...] = tuple(
            (op_index, stage_kind, round_index)
            for _, op_index, stage_kind, round_index, _, _ in faults_mod.iter_inter_hops(sp)
        )
        self._faults: Dict[tuple, tuple] = {}

    def faults_on_device(self, codec: str, faults) -> tuple:
        """``(injections, delay_s)`` of ``faults`` compiled against this plan
        and ``codec``: injections map ``(op_index, round_index)`` to
        ``((kind, receiver mask on the device, value), ...)``.  Compiled in
        numpy and moved to the device once per (codec, fault plan)."""
        return _faults_on_device(self._faults, self.sp, self.device, codec, faults)

    def run(self, local: torch.Tensor, codec: str = "none", verify: bool = False,
            injections: Optional[Dict[tuple, tuple]] = None):
        """``local [n, L, *feat] -> ([n, out_size, *feat], viols)``.

        ``viols`` is ``None`` unless ``verify``; then it is a ``[len(hops)]``
        float64 tensor of each checked hop's worst violation (``> 0`` failed).
        """
        topo, L, E = self.topo, self.L, self.E
        n, ppn, npods = topo.nranks, topo.ppn, topo.npods
        feat = tuple(local.shape[2:])
        nfeat = int(np.prod(feat, dtype=np.int64))
        encoded = _codec_applies(codec, local.dtype)
        wired = encoded or verify or bool(injections)
        injections = injections or {}
        viols: List[torch.Tensor] = []
        ext = local.new_zeros((n, E) + feat)
        ext[:, :L] = local
        flat = ext.view((n * E,) + feat)

        def take(idx: torch.Tensor, width: int) -> torch.Tensor:
            return flat.index_select(0, idx).view((n, width) + feat)

        for op_i, (kind, width, arg) in enumerate(self.steps):
            if kind == "gather":
                ext[:, L : L + width] = take(arg, width)
            elif kind in ("a2a_local", "a2a_pod"):
                seg = take(arg, width) if arg is not None else ext[:, L : L + width].clone()
                if kind == "a2a_local":
                    blocks = seg.view((npods, ppn, ppn, width // ppn) + feat).transpose(1, 2)
                    ext[:, L : L + width] = blocks.reshape((n, width) + feat)
                    continue
                blk = width // npods
                if not wired:
                    blocks = seg.view((npods, ppn, npods, blk) + feat).transpose(0, 2)
                    ext[:, L : L + width] = blocks.reshape((n, width) + feat)
                    continue

                def pod_move(t: torch.Tensor) -> torch.Tensor:
                    rest = tuple(t.shape[1:])
                    return t.view((npods, ppn, npods) + rest).transpose(0, 2).reshape(t.shape)

                got, viol = _wire_hop(
                    seg.reshape(n * npods, blk * nfeat), pod_move, codec, encoded, verify,
                    injections.get((op_i, None), ()), (n, npods, blk) + feat, own_pod=npods,
                )
                if viol is not None:
                    viols.append(viol)
                ext[:, L : L + width] = got.view((n, width) + feat)
            else:  # permute
                parts = []
                for ri, (blk, sel, srcs, dsts, inter) in enumerate(arg):
                    send = take(sel, blk)
                    if not len(srcs):
                        parts.append(torch.zeros_like(send))
                        continue

                    def perm_move(t: torch.Tensor, srcs=srcs, dsts=dsts) -> torch.Tensor:
                        out = t.new_zeros(t.shape)
                        out.index_copy_(0, dsts, t.index_select(0, srcs))
                        return out

                    if not (inter and wired):
                        parts.append(perm_move(send))
                        continue
                    got, viol = _wire_hop(
                        send.reshape(n, blk * nfeat), perm_move, codec, encoded, verify,
                        injections.get((op_i, ri), ()), (n, blk) + feat,
                    )
                    if viol is not None:
                        viols.append(viol)
                    parts.append(got.view((n, blk) + feat))
                if parts:
                    ext[:, L : L + width] = torch.cat(parts, dim=1)
        out = ext[:, L : L + self.out_size].contiguous()
        if not verify:
            return out, None
        if not viols:
            return out, torch.zeros(0, dtype=torch.float64, device=local.device)
        return out, torch.stack(viols)


def _bytes_on_device(parts) -> torch.Tensor:
    """``[rows, ...]`` tensors as one ``[rows, nbytes]`` uint8 tensor on their
    device (each row's bytes in ``parts`` order): what a hop carries."""
    rows = [p.reshape(p.shape[0], -1).view(torch.uint8) for p in parts]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def _from_bytes(raw: torch.Tensor, like) -> list:
    """Inverse of :func:`_bytes_on_device` for tensors shaped and typed as
    ``like`` (each ``(shape, dtype)``), on ``raw``'s device."""
    if len(like) == 1:  # the whole buffer: fresh, so aligned for any dtype
        (shape, dtype), = like
        return [raw.view(dtype).reshape(shape)]
    out, at = [], 0
    for shape, dtype in like:
        n = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        # a fresh buffer, so the view starts aligned for its dtype
        part = torch.empty((raw.shape[0], n), dtype=torch.uint8, device=raw.device)
        out.append(part.copy_(raw[:, at : at + n]).view(dtype).reshape(shape))
        at += n
    return out


class _RankProgram:
    """:class:`_Program` for the one rank this process holds, over an
    :class:`~repro_torch.comm.topology.ExchangeGroup`.

    The scratch is ``[E, *feat]`` (this rank's ``local`` block, the buffer
    region and the zero PAD slot) and every index array is this rank's row
    of :func:`lower_program`'s.  The hops are real collectives over gloo,
    staged through host memory: the send blocks are gathered (and encoded)
    on the device, copied to the host as bytes, moved, copied back and
    decoded.

    * ``a2a_local`` / ``a2a_pod``: one ``all_to_all_single`` of equal splits
      of ``[groups, blk, *feat]`` on the rank's ``local`` / ``pod`` group;
      under a lossy codec the own-pod block keeps the sender's full
      precision;
    * a ``permute`` round: one ``batch_isend_irecv`` on the world, tagged
      with the program's ``tag``, the op and the round (so a split-phase
      exchange's two programs never match each other's messages); a rank
      that receives nothing in a round gets zeros, as ``ppermute`` gives.

    On an inter-pod hop of a checked call the sender's check triple of each
    wire block (:func:`_wire_check`, taken before encoding) crosses in the
    same bytes as the payload and its int8 scales (one :func:`_bytes_on_device`
    layout for all of them); the receiver decodes, applies this rank's row
    of the fault masks (:meth:`faults_on_device`), and computes the hop's
    violation from its own triple of what arrived.  On-pod hops are never
    checked, and a rank that receives nothing in a hop records 0 for it.

    :meth:`segments` is the program split at its hops: the device work
    between two hops reads and writes only tensors that stay put, so the
    fused solve captures a CUDA graph around each stretch and stages the
    hops between the replays, and :meth:`IrregularExchange.start` can leave
    the inter-pod program's first hop in flight while the on-pod program
    runs.
    """

    def __init__(self, sp: StagePlan, device: torch.device, group, tag: int):
        lp = lower_program(sp)
        self.sp = sp
        self.device = device
        self.group = group
        self.topo = sp.pattern.topo
        self.L = lp.local_size
        self.out_size = lp.out_size
        self.E = lp.local_size + lp.w_max + 1
        r = group.rank

        def row(idx: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(idx[r].astype(np.int64), device=device)

        self.ops: List[tuple] = []
        ai = 0
        for op_i, op in enumerate(lp.ops):
            kind = op[0]
            if kind == "gather":
                self.ops.append(("gather", op[1], row(lp.arrays[ai])))
                ai += 1
            elif kind in ("a2a_local", "a2a_pod"):
                _, buflen, has_idx = op
                idx = None
                if has_idx:
                    idx = row(lp.arrays[ai])
                    ai += 1
                self.ops.append((kind, buflen, idx))
            else:  # permute
                _, rounds, blks, inters = op
                rnds = []
                for ri, (perm, blk, inter) in enumerate(zip(rounds, blks, inters)):
                    dst = next((d for s, d in perm if s == r), None)
                    src = next((s for s, d in perm if d == r), None)
                    rnds.append((blk, row(lp.arrays[ai]), dst, src, bool(inter),
                                 (tag << 24) | (op_i << 12) | ri))
                    ai += 1
                self.ops.append(("permute", sum(blks), rnds))
        #: the checked hops, in :class:`_Program`'s order (the columns of
        #: :meth:`segments`'s violation vector)
        self.hops: Tuple[tuple, ...] = tuple(
            (op_index, stage_kind, round_index)
            for _, op_index, stage_kind, round_index, _, _ in faults_mod.iter_inter_hops(sp)
        )
        self._hop_at = {(op_index, round_index): j for j, (op_index, _, round_index) in enumerate(self.hops)}
        self._faults: Dict[tuple, tuple] = {}

    def faults_on_device(self, codec: str, faults) -> tuple:
        """``(injections, delay_s)`` as :meth:`_Program.faults_on_device`,
        each mask this rank's receiver row."""
        return _faults_on_device(self._faults, self.sp, self.device, codec, faults, rank=self.group.rank)

    def segments(self, local: torch.Tensor, codec: str, verify: bool = False,
                 injections: Optional[Dict[tuple, tuple]] = None):
        """The program as a hop generator (:mod:`repro_torch.comm.hops`):
        the device work up to each hop, then a :class:`~repro_torch.comm.hops.Hop`
        that sends device bytes made here and fills device tensors read
        after it (an unencoded hop lands straight in the scratch); a
        ``permute`` op yields one hop, empty where this rank moves nothing.
        Returns ``([1, out_size, *feat], viols)``: ``viols`` is ``None``
        unless ``verify``, else this rank's ``[len(hops)]`` float64
        violations on the device (``> 0`` failed)."""
        topo, L, E, device = self.topo, self.L, self.E, self.device
        feat = tuple(local.shape[2:])
        nfeat = int(np.prod(feat, dtype=np.int64))
        encoded = _codec_applies(codec, local.dtype)
        injections = injections or {}
        viols = [torch.zeros((), dtype=torch.float64, device=device)] * len(self.hops)
        ext = local.new_zeros((E,) + feat)
        ext[:L] = local[0]

        def take(idx: torch.Tensor, width: int) -> torch.Tensor:
            return ext.index_select(0, idx).view((width,) + feat)

        def pack(blocks: torch.Tensor, wired: bool) -> list:
            """``[n, blk * nfeat]`` blocks -> the tensors that cross the hop:
            on a wired inter-pod hop the encoded payload, its int8 scales and
            the blocks' check triples, else the blocks themselves."""
            if not wired:
                return [blocks]
            parts = [blocks]
            if encoded:
                payload, scale = _encode_blocks(blocks, codec)
                parts = [payload] if scale is None else [payload, scale]
            if verify:
                parts.append(_wire_check(blocks))
            return parts

        def unpack(raw: torch.Tensor, parts: list, dtype) -> tuple:
            """Received bytes laid out as :func:`pack`'s ``parts``: the
            decoded blocks and the sender's check triples (or ``None``)."""
            got = _from_bytes(raw, [(tuple(p.shape), p.dtype) for p in parts])
            pre = got.pop() if verify else None
            if not encoded:
                return got[0], pre
            return _decode_blocks(got[0], got[1] if len(got) > 1 else None, dtype), pre

        def settle(got: torch.Tensor, pre, key: tuple, recv_shape: tuple) -> torch.Tensor:
            """Hop ``key``'s injections on the received blocks, then its violation."""
            for kind, mask, value in injections.get(key, ()):
                got = _apply_injection(got.view(recv_shape), mask, kind, value).view(got.shape)
            if verify:
                viols[self._hop_at[key]] = _check_violation(pre, _wire_check(got), got.shape[1], codec,
                                                            encoded)
            return got

        def landing(dest: torch.Tensor) -> torch.Tensor:
            """``dest``'s bytes: where an unencoded hop lands."""
            return dest.view(-1).view(torch.uint8)

        for op_i, (kind, width, arg) in enumerate(self.ops):
            if kind == "gather":
                ext[L : L + width] = take(arg, width)
            elif kind in ("a2a_local", "a2a_pod"):
                seg = take(arg, width) if arg is not None else ext[L : L + width]
                if not width:
                    continue
                groups = topo.npods if kind == "a2a_pod" else topo.ppn
                blk = width // groups
                blocks = seg.reshape(groups, blk * nfeat)
                wired = kind == "a2a_pod" and (encoded or verify or (op_i, None) in injections)
                parts = pack(blocks, wired)
                send = _bytes_on_device(parts)
                recv = torch.empty_like(send) if wired else landing(ext[L : L + width])
                yield Hop("a2a", (send,), (recv,),
                          group=self.group.pod if kind == "a2a_pod" else self.group.local)
                if not wired:
                    continue
                got, pre = unpack(recv, parts, blocks.dtype)
                if encoded:  # the own-pod block never crossed pods: full precision
                    me = self.group.pod_index
                    got[me] = blocks[me]
                got = settle(got, pre, (op_i, None), (groups, blk) + feat)
                ext[L : L + width] = got.view((width,) + feat)
            else:  # permute
                transfers, pending, at = [], [], L
                for ri, (blk, sel, dst, src, inter, tag) in enumerate(arg):
                    dest, at = ext[at : at + blk], at + blk
                    if not blk:
                        continue
                    if dst is None and src is None:
                        pending.append((dest, None, None, None, None))
                        continue
                    send = take(sel, blk)
                    if dst == self.group.rank:  # a pair of one rank: no hop
                        pending.append((dest, send, None, None, None))
                        continue
                    key = (op_i, ri)
                    wired = inter and (encoded or verify or key in injections)
                    parts = pack(send.reshape(1, blk * nfeat), wired)
                    recv = None
                    if src is not None:
                        nbytes = sum(p[0].numel() * p.dtype.itemsize for p in parts)
                        recv = (torch.empty((1, nbytes), dtype=torch.uint8, device=device) if wired
                                else landing(dest))
                    transfers.append((_bytes_on_device(parts) if dst is not None else None, dst, recv, src,
                                      tag))
                    pending.append((dest, None, recv, parts if wired else None, key))
                yield Hop("p2p", transfers=tuple(transfers))
                for dest, own, recv, parts, key in pending:
                    if own is not None:
                        dest.copy_(own)
                    elif recv is None:  # nothing arrives: zeros, as ppermute gives
                        dest.zero_()
                    elif parts is not None:  # an unencoded hop landed in dest already
                        got, pre = unpack(recv, parts, dest.dtype)
                        got = settle(got, pre, key, (dest.shape[0],) + feat)
                        dest.copy_(got.view(dest.shape))
        # a view of this call's own scratch: contiguous, as the kernels want
        out = ext[L : L + self.out_size].unsqueeze(0)
        if not verify:
            return out, None
        if not viols:
            return out, torch.zeros(0, dtype=torch.float64, device=device)
        return out, torch.stack(viols)

    def steps(self, local: torch.Tensor, codec: str, verify: bool = False,
              injections: Optional[Dict[tuple, tuple]] = None):
        """:meth:`segments` with each hop issued here: yields each hop's
        pending works, resumes after the caller waited on them, and returns
        what :meth:`segments` returns (one yield per hop on every rank, so a
        split-phase exchange stops at the same hop everywhere)."""
        seg = self.segments(local, codec, verify, injections)
        try:
            hop = next(seg)
            while True:
                works, land = hop.stage()
                yield works
                land()
                hop = seg.send(None)
        except StopIteration as stop:
            return stop.value

    def run(self, local: torch.Tensor, codec: str = "none", verify: bool = False,
            injections: Optional[Dict[tuple, tuple]] = None):
        """``local [1, L, *feat] -> ([1, out_size, *feat], viols)``, each hop
        waited on before the next (:meth:`segments`)."""
        return run_hops(self.segments(local, codec, verify, injections))


def _agree_on_violations(viols: np.ndarray) -> np.ndarray:
    """Every rank's ``[len(hops)]`` violations reduced to the world's MAX by
    one all-reduce on the host, so every rank raises the same error or
    none.  A NaN (a check that cannot be read) counts as ``inf``, a failure,
    whatever gloo's MAX would make of it."""
    import torch.distributed as dist

    t = torch.from_numpy(np.where(np.isnan(viols), np.inf, viols).astype(np.float64))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.numpy()


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
    #: whole-instance front door for per-batch pattern producers
    #: (:func:`exchange_for`); a hit means zero planning work for the batch
    exchange_hits: int = 0
    exchange_misses: int = 0
    #: LRU evictions per cache; for a cache whose capacity never shrank,
    #: ``evictions == misses - live entries`` (see :func:`cache_sizes`)
    plan_evictions: int = 0
    exec_evictions: int = 0
    split_evictions: int = 0
    exchange_evictions: int = 0
    compute_evictions: int = 0
    #: fused whole-solve entries (``_FUSED_CACHE``, filled by
    #: :mod:`repro_torch.solve.fused`: one operator's captured CUDA graphs and
    #: their static buffers per (pattern, solver, strategy, codec, dtype,
    #: maxiter, ...)); a miss is a warm-up and a capture
    fused_hits: int = 0
    fused_misses: int = 0
    fused_evictions: int = 0


_stats = CacheStats()
_PLAN_CACHE: "OrderedDict[tuple, StagePlan]" = OrderedDict()
_EXEC_CACHE: "OrderedDict[tuple, _Program]" = OrderedDict()
#: split-phase decompositions + merges, keyed by pattern fingerprint
_SPLIT_CACHE: "OrderedDict[str, tuple]" = OrderedDict()
#: constructed IrregularExchange instances (per-batch dynamic-pattern callers)
_EXCHANGE_CACHE: "OrderedDict[tuple, IrregularExchange]" = OrderedDict()
#: fused whole-solve entries (:mod:`repro_torch.solve.fused`)
_FUSED_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
#: external LRUs (the SpMV compute cache) reset by clear_caches()
_EXTERNAL_CACHES: List[OrderedDict] = []
PLAN_CACHE_MAX = 256
EXEC_CACHE_MAX = 64
EXCHANGE_CACHE_MAX = 64
FUSED_CACHE_MAX = 32


def cache_stats() -> CacheStats:
    """Snapshot of plan/program/compute cache hit counters."""
    return dataclasses.replace(_stats)


def cache_sizes() -> Dict[str, int]:
    """Live entry counts per module cache."""
    return {
        "plan": len(_PLAN_CACHE),
        "exec": len(_EXEC_CACHE),
        "split": len(_SPLIT_CACHE),
        "exchange": len(_EXCHANGE_CACHE),
        "fused": len(_FUSED_CACHE),
        "external": sum(len(c) for c in _EXTERNAL_CACHES),
    }


def set_cache_limits(plan: Optional[int] = None, exec_: Optional[int] = None,
                     exchange: Optional[int] = None, fused: Optional[int] = None) -> Dict[str, int]:
    """Resize the module LRU capacities, trimming oldest-first immediately.

    ``None`` leaves a cap unchanged; the split-phase cache shares ``plan``'s
    cap (one decomposition per resident pattern).  Returns the caps in force.
    """
    global PLAN_CACHE_MAX, EXEC_CACHE_MAX, EXCHANGE_CACHE_MAX, FUSED_CACHE_MAX
    for name, value in (("plan", plan), ("exec_", exec_), ("exchange", exchange), ("fused", fused)):
        if value is not None and value < 1:
            raise ValueError(f"{name} cache limit must be >= 1, got {value}")
    if plan is not None:
        PLAN_CACHE_MAX = plan
        _trim(_PLAN_CACHE, plan, "plan_evictions")
        _trim(_SPLIT_CACHE, plan, "split_evictions")
    if exec_ is not None:
        EXEC_CACHE_MAX = exec_
        _trim(_EXEC_CACHE, exec_, "exec_evictions")
    if exchange is not None:
        EXCHANGE_CACHE_MAX = exchange
        _trim(_EXCHANGE_CACHE, exchange, "exchange_evictions")
    if fused is not None:
        FUSED_CACHE_MAX = fused
        _trim(_FUSED_CACHE, fused, "fused_evictions")
    return {"plan": PLAN_CACHE_MAX, "exec": EXEC_CACHE_MAX, "exchange": EXCHANGE_CACHE_MAX,
            "fused": FUSED_CACHE_MAX}


def register_cache(cache: OrderedDict) -> None:
    """Register an external LRU so :func:`clear_caches` resets it too."""
    if not any(c is cache for c in _EXTERNAL_CACHES):
        _EXTERNAL_CACHES.append(cache)


def clear_caches() -> None:
    global _stats
    for cache in (_PLAN_CACHE, _EXEC_CACHE, _SPLIT_CACHE, _EXCHANGE_CACHE, _FUSED_CACHE, *_EXTERNAL_CACHES):
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


def fused_cached(key, build):
    """LRU get for the fused whole-solve cache (``fused_*`` stats); the
    entries are :mod:`repro_torch.solve.fused`'s captured solves."""
    return _lru_get(_FUSED_CACHE, key, FUSED_CACHE_MAX, build, "fused")


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


def _rank_program(sp: StagePlan, plan_key: tuple, device: torch.device, group, tag: int) -> _RankProgram:
    return _lru_get(
        _EXEC_CACHE, plan_key + (str(device), id(group), group.rank, tag), EXEC_CACHE_MAX,
        lambda: _RankProgram(sp, device, group, tag), "exec",
    )


def _check_plans_agree(group, key: tuple) -> None:
    """Every rank of ``group``'s world must run the same plan, checks,
    faults and ladder, or the ranks' collectives would not match and the
    world would hang: all-gather a hash of ``key`` and raise on every rank,
    naming the ranks that differ."""
    import hashlib
    from collections import Counter

    import torch.distributed as dist

    mine = int.from_bytes(hashlib.sha1(repr(key).encode()).digest()[:8], "little", signed=True)
    got = [torch.zeros(1, dtype=torch.int64) for _ in range(group.topo.nranks)]
    dist.all_gather(got, torch.tensor([mine], dtype=torch.int64))
    hashes = [int(t) for t in got]
    common = Counter(hashes).most_common(1)[0][0]
    odd = [r for r, h in enumerate(hashes) if h != common]
    if odd:
        raise RuntimeError(
            f"the ranks' exchange plans differ: ranks {odd} planned another exchange than ranks "
            f"{[r for r, h in enumerate(hashes) if h == common]} (pattern, strategy, cap, "
            f"element bytes, fusion, codec, checks, fault plan, retries and fallback must "
            f"agree on every rank)"
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

    def __call__(self, local_out: torch.Tensor, remote_out: torch.Tensor,
                 rank: Optional[int] = None) -> torch.Tensor:
        """Merge ``[nranks, H, *feat]`` phase outputs, or under a process
        group ``[1, H, *feat]`` ones with world rank ``rank``'s maps."""
        maps = self._on(local_out.device)
        if rank is not None:
            maps = tuple(m[rank : rank + 1] for m in maps)
        mask, valid, li, ri = maps
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
    on the CPU, where it already ran).  Under a process group
    ``remote_halo`` is ``None`` until :meth:`finish` has run the inter-pod
    program's remaining hops.  :meth:`finish` settles the inter-pod
    phase's checks (through the recovery ladder, when it has any) and merges
    both phases into the full canonical recv buffer -- bitwise the barrier
    result.
    """

    local_halo: torch.Tensor
    remote_halo: Optional[torch.Tensor]
    _merge: object
    stream: Optional["torch.cuda.Stream"] = None
    _settle: Optional[Callable[[], torch.Tensor]] = None
    _pending: Tuple[torch.Tensor, ...] = ()
    _done: Optional[torch.Tensor] = None

    def finish(self) -> torch.Tensor:
        """Wait for the inter-pod phase and return ``[nranks, H, *feat]``."""
        if self._done is None:
            if self.stream is not None:
                current = torch.cuda.current_stream(self.remote_halo.device)
                current.wait_stream(self.stream)
                # made on the side stream, read on this one from here on
                for t in (self.remote_halo, *self._pending):
                    t.record_stream(current)
            if self._settle is not None:
                self.remote_halo = self._settle()
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
      wire: inter-pod wire codec, one of
        :data:`repro_torch.comm.wire.WIRE_CODECS`; lossy codecs touch only
        the blocks that cross pods, ``"none"`` is the exact movement.
      verify: check every inter-pod wire block after it arrives; a failed
        check raises :class:`~repro_torch.comm.faults.ExchangeIntegrityError`
        through the recovery ladder.
      faults: a seeded :class:`~repro_torch.comm.faults.FaultPlan` injected
        into the inter-pod blocks.
      health: the :class:`~repro_torch.comm.faults.HealthTracker` the ladder
        records into (created when ``verify`` or ``faults`` is set).
      max_retries, fallback: the ladder's retries of the configured pair, and
        whether it may then demote the codec and re-advise the strategy.
      group: an :class:`~repro_torch.comm.topology.ExchangeGroup`: this
        process holds one rank, ``local [1, L, *feat] -> [1, H, *feat]``,
        on ``device`` (left out, ``cuda:(rank % device_count)``), and the
        hops are gloo collectives.  Every rank constructs the exchange at
        once; a rank whose plan, checks, fault plan or ladder settings
        differ raises on every rank.  A checked call ends with one
        all-reduce of the violations, so every rank takes the same rung of
        the ladder.

    Example::

        import numpy as np
        from repro_torch.comm import IrregularExchange, PodTopology, random_pattern

        topo = PodTopology(npods=2, ppn=4)
        pat = random_pattern(np.random.default_rng(0), topo, local_size=6)
        ex = IrregularExchange(pat, "two_step", device="cpu", verify=True)
        local = np.ones((topo.nranks, 6), np.float32)
        halo = ex(local)                       # barrier: [nranks, H], checked
        handle = ex.start(local)               # split-phase
        assert (handle.finish() == halo).all()
        lossy = IrregularExchange(pat, "two_step", device="cpu", wire="int8")(local)
    """

    pattern: ExchangePattern
    strategy: str
    device: DeviceLike = None
    message_cap_bytes: int = 16384
    elem_bytes: int = 4
    fuse_program: bool = True
    wire: str = "none"
    verify: bool = False
    faults: Optional[faults_mod.FaultPlan] = None
    health: Optional[faults_mod.HealthTracker] = None
    max_retries: int = 1
    fallback: bool = True
    group: Optional[object] = None

    def __post_init__(self) -> None:
        wire_mod.check_codec(self.wire)
        key = _plan_key(
            self.pattern, self.strategy, self.message_cap_bytes,
            self.elem_bytes, self.fuse_program,
        )
        if self.group is not None:
            if self.group.topo != self.pattern.topo:
                raise ValueError(f"the group is {self.group.topo}, the pattern {self.pattern.topo}")
            self.device = (device_for_rank(self.group.rank) if self.device is None
                           else resolve_device(self.device))
            _check_plans_agree(self.group, key + (
                self.wire, self.verify, None if self.faults is None else self.faults.fingerprint(),
                self.max_retries, self.fallback))
        else:
            self.device = resolve_device(self.device)
        self.plan: StagePlan = planned(
            self.pattern, self.strategy, self.message_cap_bytes,
            self.elem_bytes, self.fuse_program,
        )
        if self.group is None:
            self._program = _program(self.plan, key, self.device)
        else:
            # the on-pod phase of a split exchange overlaps the inter-pod
            # one: its messages carry a tag of their own
            self._program = _rank_program(self.plan, key, self.device, self.group,
                                          tag=int(self.strategy == "local"))
        if self.health is None and (self.verify or self.faults is not None):
            self.health = faults_mod.HealthTracker()
        self._two_phase: Optional[tuple] = None
        self._side_stream = None
        self._variants: Dict[tuple, "IrregularExchange"] = {}
        self._calls = 0
        #: RecoveryPath.key of the most recent recovered call, or None
        self.last_recovery: Optional[str] = None

    @property
    def guarded(self) -> bool:
        """Whether calls run through the recovery ladder (verify or faults)."""
        return self.verify or self.faults is not None

    # ------------------------------------------------------------------
    def __call__(self, local) -> torch.Tensor:
        """``local [nranks, L, *feat] -> canonical recv [nranks, H, *feat]``.

        Trailing feature dims (multi-vector SpMM ``k``, per-token features)
        ride along under the same plan.  With ``verify`` or ``faults`` the
        call runs through the recovery ladder; otherwise it is one pass of
        the program, with no host synchronisation.
        """
        local = self._checked(local)
        with tracing.span("repro_torch.exchange.run"), tracing.stream_interval("exchange", self.device):
            if not self.guarded:
                return self._program.run(local, self.wire)[0]
            return self._guarded_call(local)

    def _checked(self, local) -> torch.Tensor:
        local = as_device_tensor(local, self.device)
        n = 1 if self.group is not None else self.pattern.topo.nranks
        L = self.pattern.local_size
        if local.ndim < 2 or tuple(local.shape[:2]) != (n, L):
            raise ValueError(f"expected [{n}, {L}, *feat], got {tuple(local.shape)}")
        return local

    # -- verification + recovery ---------------------------------------
    def _injections(self, call_index: int) -> tuple:
        """``(injections, delay_s)`` of physical attempt ``call_index``: the
        compiled faults when the FaultPlan's call gating says so."""
        if self.faults is not None and self.faults.active(call_index):
            return self._program.faults_on_device(self.wire, self.faults)
        return None, 0.0

    def _launch(self, local: torch.Tensor, call_index: int) -> tuple:
        """Queue one physical attempt (the faulted program when the
        FaultPlan's call gating says so).  Returns ``(out, viols, delay_s)``
        without waiting for the device."""
        injections, delay = self._injections(call_index)
        out, viols = self._program.run(local, self.wire, self.verify, injections)
        return out, viols, delay

    def _settle(self, out: torch.Tensor, viols: Optional[torch.Tensor], delay: float) -> torch.Tensor:
        """Finish an attempt: the injected slow-hop latency (slept on every
        rank of a group), then the one device-to-host read of its
        violations; under a group the ranks agree on them first
        (:func:`_agree_on_violations`), so all raise or none does."""
        if delay > 0.0:
            time.sleep(delay)
        if viols is not None and viols.numel():
            v = viols.cpu().numpy()
            self._raise_from_viols(v if self.group is None else _agree_on_violations(v))
        return out

    def _raw_call(self, local: torch.Tensor, call_index: int) -> torch.Tensor:
        return self._settle(*self._launch(local, call_index))

    def _raise_from_viols(self, viols: np.ndarray) -> None:
        bad = viols > 0.0
        if not bad.any():
            return
        j = int(np.argmax(bad))
        op_index, stage_kind, round_index = self._program.hops[j]
        raise faults_mod.ExchangeIntegrityError(
            strategy=self.plan.strategy,
            codec=self.wire,
            stage_kind=stage_kind,
            op_index=op_index,
            round_index=round_index,
            violation=float(viols[j]),
        )

    def _variant(self, strategy: str, wire: str) -> "IrregularExchange":
        if strategy == self.strategy and wire == self.wire:
            return self
        key = (strategy, wire)
        v = self._variants.get(key)
        if v is None:
            # under a group every rank builds it at the same rung (the ranks
            # agreed on the violations), so its plan check is collective
            v = self._variants[key] = IrregularExchange(
                self.pattern, strategy, device=self.device,
                message_cap_bytes=self.message_cap_bytes, elem_bytes=self.elem_bytes,
                fuse_program=self.fuse_program, wire=wire, verify=self.verify,
                faults=self.faults, health=self.health, max_retries=0, fallback=False,
                group=self.group,
            )
        return v

    def _guarded_call(self, local: torch.Tensor,
                      pending: Optional[Callable[[], tuple]] = None) -> torch.Tensor:
        """Run the ladder; ``pending`` completes a first attempt already
        begun by :meth:`start` (returning its ``(out, viols, delay_s)``),
        settled here as the ladder's first try."""

        def attempt(strategy: str, wire: str):
            nonlocal pending
            if pending is not None:
                first, pending = pending, None
                return self._settle(*first())
            idx = self._calls
            self._calls += 1
            return self._variant(strategy, wire)._raw_call(local, idx)

        out, path = faults_mod.run_ladder(
            attempt,
            strategy=self.strategy,
            wire=self.wire,
            health=self.health,
            max_retries=self.max_retries,
            fallback=self.fallback,
            choose_alternative=faults_mod.advise_alternative(self.pattern, self.elem_bytes),
        )
        if path is not None:
            self.last_recovery = path.key
        return out

    # ------------------------------------------------------------------
    def start(self, local) -> ExchangeHandle:
        """Begin a split-phase exchange.

        The pattern is factored (:func:`repro_torch.comm.exchange.split_phase`)
        into an inter-pod sub-pattern, planned with this exchange's strategy,
        codec, checks and faults, and an on-pod one at full precision.  On
        CUDA the inter-pod phase is queued first, on a side stream that waits
        for the work that made ``local``; the on-pod phase follows on the
        current stream, so work queued after ``start()`` (the diag-block
        product) overlaps the inter-pod phase.  Its checks are read, and the
        recovery ladder run if they failed, in :meth:`ExchangeHandle.finish`.
        On the CPU the two phases run one after the other.  Both
        sub-exchanges and the merge come from the module caches and are
        memoized on the instance.
        """
        if self._two_phase is None:
            sp, merge = _split_phase_cached(self.pattern)
            common = dict(device=self.device, elem_bytes=self.elem_bytes,
                          fuse_program=self.fuse_program, group=self.group)
            self._two_phase = (
                # faults only ever hit inter-pod segments, so the guard
                # rails ride on the inter-pod phase alone
                IrregularExchange(sp.remote, self.strategy,
                                  message_cap_bytes=self.message_cap_bytes,
                                  wire=self.wire, verify=self.verify, faults=self.faults,
                                  health=self.health, max_retries=self.max_retries,
                                  fallback=self.fallback, **common),
                IrregularExchange(sp.local, "local", **common),
                merge,
            )
        remote_ex, local_ex, merge = self._two_phase
        local = self._checked(local)
        if self.group is not None:
            # the inter-pod program's first hop goes in flight, the on-pod
            # program runs to its end, and finish() runs the rest (a
            # guarded call: then agrees on the violations and runs the
            # ladder's further rungs as barrier calls)
            injections, delay = None, 0.0
            if remote_ex.guarded:
                injections, delay = remote_ex._injections(remote_ex._calls)
                remote_ex._calls += 1
            steps = remote_ex._program.segments(local, remote_ex.wire, remote_ex.verify, injections)
            try:
                # one first hop on every rank (an empty one too), so a
                # split-phase exchange stops at the same hop everywhere
                first, done = next(steps).stage(), None
            except StopIteration as stop:
                first, done = None, stop.value

            def drive() -> tuple:
                return done if first is None else run_hops(steps, first)

            def settle() -> torch.Tensor:
                if not remote_ex.guarded:
                    return drive()[0]
                return remote_ex._guarded_call(local, lambda: (*drive(), delay))

            rank = self.group.rank
            return ExchangeHandle(local_ex(local), None, lambda lo, ro: merge(lo, ro, rank),
                                  _settle=settle)

        def launch_remote() -> tuple:
            if not remote_ex.guarded:
                return remote_ex(local), None
            idx = remote_ex._calls
            remote_ex._calls += 1
            pending = remote_ex._launch(local, idx)
            return pending[0], pending

        side = None
        if self.device.type == "cuda":
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            side = self._side_stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                remote, pending = launch_remote()
            # read on the side stream: keep its memory until that work is done
            local.record_stream(side)
        else:
            remote, pending = launch_remote()
        if pending is None:
            return ExchangeHandle(local_ex(local), remote, merge, stream=side)
        return ExchangeHandle(
            local_ex(local), remote, merge, stream=side,
            _settle=lambda: remote_ex._guarded_call(local, lambda: pending),
            _pending=tuple(t for t in pending[:2] if t is not None),
        )

    # ------------------------------------------------------------------
    def reference(self, local: np.ndarray) -> np.ndarray:
        return self.pattern.reference(local)

    @property
    def wire_bytes(self) -> Tuple[int, int]:
        """(intra-pod, inter-pod) bytes on the wire incl. padding, the
        inter-pod bytes at the codec's width (plus int8 scales)."""
        return wire_mod.scaled_wire_bytes(self.plan, self.wire, self.elem_bytes)

    @property
    def payload_bytes(self) -> Tuple[int, int]:
        """(intra-pod, inter-pod) useful payload bytes."""
        return (self.plan.intra_pod_bytes, self.plan.inter_pod_bytes)


STRATEGY_NAMES = ("standard", "two_step", "three_step", "split")


def exchange_for(
    pattern: ExchangePattern,
    strategy: str,
    *,
    device: DeviceLike = None,
    message_cap_bytes: int = 16384,
    elem_bytes: int = 4,
    wire: str = "none",
    group=None,
) -> IrregularExchange:
    """Memoized :class:`IrregularExchange` constructor for dynamic callers.

    Per-batch pattern producers (MoE routing) re-request an exchange every
    step.  This front-door LRU returns the *same* instance for an equal
    ``(fingerprint, strategy, caps, wire, device)`` request, so hot routing
    buckets cost one dict lookup.  The key holds the resolved device
    (``None`` means the CUDA device).  Cleared by :func:`clear_caches`.

    Under an :class:`~repro_torch.comm.topology.ExchangeGroup` (``group``)
    the key also holds this rank and the group's process groups: a miss
    builds the exchange, which is collective (every rank checks the plans
    agree), and a hit does not, so every rank must request the same
    patterns in the same order.
    """
    device = device_for_rank(group.rank) if device is None and group is not None else resolve_device(device)
    key = (pattern.fingerprint(), strategy, message_cap_bytes, elem_bytes, wire, str(device))
    if group is not None:
        key += (group.rank, id(group.local), id(group.pod))
    return _lru_get(
        _EXCHANGE_CACHE, key, EXCHANGE_CACHE_MAX,
        lambda: IrregularExchange(pattern, strategy, device=device, message_cap_bytes=message_cap_bytes,
                                  elem_bytes=elem_bytes, wire=wire, group=group),
        "exchange",
    )
