"""Wire formats for the irregular exchange's inter-pod (DCI) hop.

The paper's models make the inter-node *bandwidth* term the dominant cost
once node-aware strategies have capped inter-node message counts: every
byte crossing the slow fabric costs ``beta_inter >> beta_intra``.  A wire
codec shrinks exactly those bytes -- and only those bytes:

* the plan compiler marks which stages cross pods (``A2APod`` by
  construction; ``PermuteWorld`` rounds via their ``inter`` flags),
* the executor encodes the payload right before the inter-pod collective
  and decodes right after it, leaving every on-pod hop (``A2ALocal``,
  gathers, the pod-local redistribution) at full precision,
* the destination's *own-pod* block of an ``A2APod`` never crossed DCI, so
  it is delivered bit-exactly even under a lossy codec.

Codecs
------
``none``   identity -- the executor runs the exact pre-codec program
           (bitwise identical delivery).
``bf16``   ``f32 -> bfloat16`` truncation on the wire (2x fewer DCI bytes
           for f32 payloads).  Exact for bf16-representable values;
           otherwise relative error <= ``2**-8`` per element.  *Finite*
           f32 magnitudes above bf16's max (~3.39e38) saturate to it so a
           large-but-valid value never overflows on the wire; true
           ``+/-inf`` and ``nan`` are bf16-representable and propagate
           bit-faithfully (divergence must stay visible to ``isfinite``
           guards downstream).
``f16``    ``f32 -> float16`` (2x).  Relative error <= ``2**-11`` for
           values in f16's normal range; *finite* magnitudes beyond f16's
           max saturate to ``+/-65504`` on the wire while ``+/-inf`` and
           ``nan`` propagate, values below the normal range degrade to
           the absolute subnormal step ``2**-24``.
``int8``   blockwise linear int8 quantization with one float32 scale per
           wire block (an ``A2APod`` destination block or a
           ``PermuteWorld`` send block): ~4x fewer DCI bytes for f32.
           Absolute error <= ``scale/2``, i.e. relative to the block's max
           magnitude at most ``0.5/127`` -- the pinned bound below.  The
           scale is taken over the block's *finite* magnitudes; non-finite
           elements ship as the reserved code :data:`INT8_NONFINITE` and
           decode to ``nan`` (int8 cannot carry ``inf``), so one diverging
           element never poisons its finite neighbors.

A codec only *applies* to floating payloads wider than its wire type
(:func:`applies`): a bfloat16 payload rides a ``bf16`` wire untouched, and
integer payloads are never encoded.

This module is numpy-only on purpose: the numpy executor
(:func:`repro_torch.comm.exchange.execute_numpy`) and the plan-level byte
accounting (:func:`scaled_wire_bytes`) must run without devices.  It needs
no ``ml_dtypes`` either: the bfloat16 cast is done on the float32 bits
(:func:`round_to_bf16`), the same round-to-nearest-even cast torch makes.  The
torch executor (:mod:`repro_torch.comm.strategies`) encodes and decodes on the
device, bitwise equal to these round-trips.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: executable wire codecs, in ranking order
WIRE_CODECS = ("none", "bf16", "f16", "int8")

#: wire bytes per element (None = payload's own width)
WIRE_ITEMSIZE = {"none": None, "bf16": 2, "f16": 2, "int8": 1}

#: int8 quantization range: symmetric [-QMAX, QMAX]
QMAX = 127.0

#: bytes of side information (the float32 scale) shipped per int8 wire block
INT8_SCALE_BYTES = 4

#: reserved int8 wire code for a non-finite element (outside the symmetric
#: quantization range [-QMAX, QMAX]); decodes to ``nan``
INT8_NONFINITE = -128

#: pinned per-element error bounds (see module docstring): casts are
#: relative to |x|, int8 is relative to the wire block's max magnitude
REL_ERROR_BOUND = {
    "none": 0.0,
    "bf16": 2.0 ** -8,
    "f16": 2.0 ** -11,
    "int8": 0.5 / QMAX,
}

#: absolute error floor: the wire type's smallest subnormal step (values
#: below the normal range quantize to multiples of it, so the relative
#: bound above only holds down to this magnitude)
ABS_ERROR_FLOOR = {
    "none": 0.0,
    "bf16": 2.0 ** -133,
    "f16": 2.0 ** -24,
    "int8": 0.0,
}


def check_codec(codec: str) -> str:
    if codec not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {codec!r}; known: {WIRE_CODECS}")
    return codec


def wire_itemsize(codec: str, elem_bytes: int) -> int:
    """Bytes per element on the DCI wire (never wider than the payload)."""
    w = WIRE_ITEMSIZE[check_codec(codec)]
    return elem_bytes if w is None or w >= elem_bytes else w


def _is_floating(dt: np.dtype) -> bool:
    """Floating-point check that also recognizes ml_dtypes extension floats
    (``np.dtype(bfloat16).kind`` is ``'V'``, not ``'f'``)."""
    if dt.kind == "f":
        return True
    try:
        import ml_dtypes

        return dt == np.dtype(ml_dtypes.bfloat16)
    except ImportError:  # pragma: no cover - ml_dtypes ships with jax
        return False


def applies(codec: str, dtype) -> bool:
    """Whether ``codec`` actually encodes a payload of ``dtype``.

    Floating payloads only (including bfloat16), and only when the wire
    type is strictly narrower than the payload -- a bf16 payload on a
    ``bf16`` wire (or any payload under ``none``) passes through untouched,
    but the same payload IS quantized by the ``int8`` wire.
    """
    w = WIRE_ITEMSIZE[check_codec(codec)]
    if w is None:
        return False
    dt = np.dtype(dtype)
    return _is_floating(dt) and dt.itemsize > w


# ---------------------------------------------------------------------------
# Numpy round-trips (the oracle for the device encode/decode)
# ---------------------------------------------------------------------------


#: largest finite value of each narrow wire type
WIRE_FMAX = {"bf16": float.fromhex("0x1.fep127"), "f16": 65504.0}


def round_to_bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), as float32.

    The cast torch's ``.to(torch.bfloat16)`` and ``ml_dtypes`` make, done on
    the float32 bits so the oracle needs numpy alone (wider inputs are
    rounded to float32 first, as torch converts them).  ``+/-inf`` stay
    infinite and ``nan`` stays ``nan``.

    >>> round_to_bf16(np.float32([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])).tolist()
    [1.0, 1.015625]
    """
    f = np.ascontiguousarray(x, dtype=np.float32)
    u = f.view(np.uint32)
    up = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    r = ((u + up) & np.uint32(0xFFFF0000)).view(np.float32)
    return np.where(np.isnan(f), f, r)


def roundtrip_np(x: np.ndarray, codec: str, block_ndim: int) -> np.ndarray:
    """Encode+decode ``x`` the way the wire would, without moving it.

    The trailing ``block_ndim`` axes form one wire block (one scale for the
    int8 codec); leading axes index independent blocks.  Inter-pod data
    movement is a permutation of whole blocks, so round-tripping before the
    move equals moving the encoded payload and decoding after -- this is
    what lets :func:`repro_torch.comm.exchange.execute_numpy` stay a faithful
    oracle of the device executor.

    >>> import numpy as np
    >>> roundtrip_np(np.float32([1.5, 0.25]), "bf16", 1).tolist()
    [1.5, 0.25]
    >>> x = np.float32([[1.0, 1e-4]])
    >>> abs(roundtrip_np(x, "int8", 1)[0, 1]) <= 0.5 / 127
    True
    >>> roundtrip_np(np.float32([np.inf, 1.5]), "bf16", 1).tolist()
    [inf, 1.5]
    >>> rt = roundtrip_np(np.float32([[-np.inf, 2.0]]), "int8", 1)
    >>> bool(np.isnan(rt[0, 0])), float(rt[0, 1])
    (True, 2.0)
    """
    if not applies(codec, x.dtype):
        return x
    if codec in ("bf16", "f16"):
        # saturate finite overflow only: a finite f32 above the wire max
        # must not become inf, but a true inf/nan must stay non-finite
        # (both wire types represent them) so divergence remains visible
        fmax = WIRE_FMAX[codec]
        sat = np.where(np.isfinite(x), np.clip(x, -fmax, fmax), x)
        if codec == "f16":
            return sat.astype(np.float16).astype(x.dtype)
        return round_to_bf16(sat).astype(x.dtype)
    # int8: one float32 scale per block, taken over finite magnitudes so a
    # single inf/nan cannot poison the block; non-finite elements ship as
    # the reserved INT8_NONFINITE code and decode to nan
    f = x.astype(np.float32)
    axes = tuple(range(x.ndim - block_ndim, x.ndim))
    finite = np.isfinite(f)
    mag = np.where(finite, np.abs(f), 0.0)
    amax = np.max(mag, axis=axes, keepdims=True) if f.size else f
    scale = np.maximum(amax / QMAX, np.finfo(np.float32).tiny)
    q = np.clip(np.round(np.where(finite, f, 0.0) / scale), -QMAX, QMAX)
    q = np.where(finite, q, INT8_NONFINITE).astype(np.int8)
    deq = np.where(
        q == INT8_NONFINITE, np.float32(np.nan), q.astype(np.float32) * scale
    )
    return deq.astype(x.dtype)


def roundtrip_pod_blocks_np(b: np.ndarray, codec: str) -> np.ndarray:
    """Round-trip an ``A2APod`` buffer view ``[npods, ppn, npods, blk, *feat]``.

    Each ``(src pod, local, dst pod)`` block is one wire block; the
    diagonal ``dst == src`` blocks never cross DCI and stay bit-exact.
    """
    if not applies(codec, b.dtype):
        return b
    rt = roundtrip_np(b, codec, block_ndim=b.ndim - 3)
    rt = np.ascontiguousarray(rt)
    i = np.arange(b.shape[0])
    rt[i, :, i] = b[i, :, i]
    return rt


# ---------------------------------------------------------------------------
# Plan-level byte accounting
# ---------------------------------------------------------------------------


def scaled_wire_bytes(plan, codec: str, elem_bytes: int = 4) -> Tuple[int, int]:
    """(intra-pod, inter-pod) wire bytes of ``plan`` under ``codec``.

    ``codec="none"`` returns the planner's own accounting verbatim.  For a
    real codec the walk re-derives the same padding-inclusive sums with the
    inter-pod hops costed at :func:`wire_itemsize` (plus
    :data:`INT8_SCALE_BYTES` of side information per int8 wire block);
    intra-pod hops are untouched.  This is the number
    :attr:`repro_torch.comm.strategies.IrregularExchange.wire_bytes` reports.
    """
    check_codec(codec)
    if codec == "none":
        return (plan.wire_intra_pod_bytes, plan.wire_inter_pod_bytes)
    # local import: repro_torch.comm.exchange imports this module's helpers
    from repro_torch.comm.exchange import A2ALocal, A2APod, Gather, PermuteWorld

    topo = plan.pattern.topo
    n, ppn, npods = topo.nranks, topo.ppn, topo.npods
    wsize = wire_itemsize(codec, elem_bytes)
    scale_extra = INT8_SCALE_BYTES if codec == "int8" else 0
    intra = inter = 0
    for st in plan.stages:
        if isinstance(st, Gather):
            continue
        if isinstance(st, A2ALocal):
            intra += n * (ppn - 1) * (st.buflen // ppn) * elem_bytes
        elif isinstance(st, A2APod):
            blk = st.buflen // npods
            inter += n * (npods - 1) * (blk * wsize + scale_extra)
        elif isinstance(st, PermuteWorld):
            inters = st.inter if st.inter is not None else (False,) * len(st.blks)
            for perm, blk, enc in zip(st.rounds, st.blks, inters):
                for s, d in perm:
                    if topo.pod_of(s) != topo.pod_of(d):
                        if enc:
                            inter += blk * wsize + scale_extra
                        else:
                            inter += blk * elem_bytes
                    else:
                        intra += blk * elem_bytes
        else:
            raise TypeError(f"unknown stage {st!r}")
    return (intra, inter)
