"""Flash attention (forward): a hand-written CUDA kernel and its plain version.

:func:`flash_attention` computes softmax attention for ``q [B, Sq, H, Dqk]``
over ``k [B, Sk, KV, Dqk]`` and ``v [B, Sk, KV, Dv]`` with grouped query
heads (query head ``h`` reads KV head ``h // (H // KV)``), a causal and/or
sliding-window mask built from absolute positions (query ``i`` sits at key
position ``i + Sk - Sq``), a float32 online softmax and the output
``[B, Sq, H, Dv]`` in ``q``'s dtype.  The value width may differ from the
query/key width, as MLA's does (192 / 128).  It replaces the Pallas kernel
``flash_attention_kernel`` of ``src/repro/kernels/flash_attention.py``; the
CUDA source is ``csrc/flash_attention.cu``, which also says what bounds it
on an H100: bfloat16 runs on the tensor cores, float32 exactly on the CUDA
cores.  The kernel is compiled for the width pairs in :data:`HEAD_PAIRS`:
every multiple of 16 up to 128 for q, k and v alike, and the unequal pairs
of the served MLA configs; :func:`head_dims_supported` is the predicate,
pure Python, that the wrapper checks on a CUDA tensor.  Three routes serve
them (:func:`kernel_route`): bfloat16 at the pairs of :data:`WGMMA_PAIRS`
runs Hopper's wgmma + TMA kernel, bfloat16 at every other pair the
``mma.sync`` kernel, float32 the CUDA-core kernel.

A tensor on the CPU goes to the plain PyTorch version
(:func:`attention_ref`, the batched form of ``repro.kernels.ref.attention``);
a CUDA tensor goes to the kernel, or the call raises.  The wrapper counts its
kernel launches in ``flash_attention.launches``, in
``flash_attention.by_shape`` per (q, k, v shape, causal, window), and in
``flash_attention.by_route`` per route.

Rows that see no key at all (causal with ``Sq > Sk``) are outside the
contract: the plain version averages every value there, the kernel writes
zeros.  They never occur on the model's path.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild

#: (q/k width, v width) pairs the kernel is compiled for: every multiple of
#: 16 up to 128 for all three (``REPRO_HEAD_DIMS`` in the CUDA source), and
#: the MLA pairs of deepseek-v2-lite-16b at its full / 100m presets and at
#: its tiny one (``REPRO_HEAD_PAIRS``)
HEAD_PAIRS = tuple((d, d) for d in range(16, 129, 16)) + ((192, 128), (48, 32))
#: the pairs whose bfloat16 runs the wgmma kernel (``REPRO_WGMMA_PAIRS``):
#: every pair the served configs use at full size -- widths of whole 128-byte
#: swizzle rows, and stablelm-3b's 80 in 32-byte ones
WGMMA_PAIRS = ((64, 64), (80, 80), (128, 128), (192, 128))
NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def head_dims_supported(qk_dim: int, v_dim: int) -> bool:
    """Whether the CUDA kernel takes q/k heads ``qk_dim`` wide with v heads
    ``v_dim`` wide."""
    return (qk_dim, v_dim) in HEAD_PAIRS


def kernel_route(qk_dim: int, v_dim: int, dtype: torch.dtype) -> str:
    """The CUDA kernel that runs ``(qk_dim, v_dim)`` in ``dtype``: "wgmma"
    (bfloat16 at :data:`WGMMA_PAIRS`), "mma" (bfloat16 at the other pairs of
    :data:`HEAD_PAIRS`) or "f32"."""
    if not head_dims_supported(qk_dim, v_dim):
        raise ValueError(f"flash_attention: ({qk_dim}, {v_dim}) is not a pair the kernel takes: {HEAD_PAIRS}")
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "wgmma" if (qk_dim, v_dim) in WGMMA_PAIRS else "mma"
    raise TypeError(f"flash_attention: no kernel for {dtype}")


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with every score materialised.

    q: ``[B, Sq, H, Dqk]``; k: ``[B, Sk, KV, Dqk]``; v: ``[B, Sk, KV, Dv]``
    (GQA by repeat) -> ``[B, Sq, H, Dv]``.  Scores in float32, probabilities
    cast to ``q``'s dtype before the value product; ``scale`` defaults to
    ``1/sqrt(Dqk)``.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            "flash_attention: q must be [B, Sq, H, Dqk], k [B, Sk, KV, Dqk] and v [B, Sk, KV, Dv], got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}"
        )
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: batch/head_dim of k {tuple(k.shape)} differ from q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not group over {KV} KV heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q/k/v must all be float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: inputs lie on several devices: {sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kbuild.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_flash_attention.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
        lib.repro_flash_attention.restype = i
        lib.repro_flash_attention_bf16_mma.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
        lib.repro_flash_attention_bf16_mma.restype = i
        _LIB = lib
    return _LIB


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``q [B, Sq, H, Dqk]`` over ``k [B, Sk, KV, Dqk]`` and
    ``v [B, Sk, KV, Dv]`` -> ``[B, Sq, H, Dv]``."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    B, Sq, H, D = q.shape
    Dv = v.shape[3]
    if not head_dims_supported(D, Dv):
        raise ValueError(
            f"flash_attention: head_dim {D} (q/k) / {Dv} (v) is not a pair the kernel takes: {HEAD_PAIRS}"
        )
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start on a 16-byte boundary")
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().repro_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, D, Dv, int(causal), int(window or 0), float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError_t {err}")
    flash_attention.launches += 1
    flash_attention.by_shape[tuple(q.shape), tuple(k.shape), tuple(v.shape), bool(causal), window] += 1
    flash_attention.by_route[kernel_route(D, Dv, q.dtype)] += 1
    return out


flash_attention.launches = 0
flash_attention.by_shape = collections.Counter()
flash_attention.by_route = collections.Counter()


def flash_attention_mma(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The bfloat16 ``mma.sync`` kernel at any pair of :data:`HEAD_PAIRS`,
    also where :func:`flash_attention` runs the wgmma kernel: for holding
    and timing the two routes side by side.  CUDA bfloat16 tensors only; no
    serving or training path calls it, and it counts no launch."""
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or not head_dims_supported(D, Dv):
        raise ValueError(f"flash_attention_mma: CUDA bfloat16 at a pair of {HEAD_PAIRS} only")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_mma: q, k and v must start on a 16-byte boundary")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    err = _library().repro_flash_attention_bf16_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KV, D, Dv,
        int(causal), int(window or 0), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_mma: kernel launch failed with cudaError_t {err}")
    return out
