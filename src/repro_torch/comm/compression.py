"""Lossy compression for the inter-pod hop: the ONE int8 quantizer, in torch.

The port's twin of the reference's ``repro/comm/compression.py``.  Both
int8 consumers route through the three primitives below, so scale
arithmetic and round-trip semantics cannot drift apart:

* :class:`Compressor` -- the error-feedback reduction compressor
  (:func:`repro_torch.comm.hierarchical.psum_hierarchical` /
  :func:`~repro_torch.comm.hierarchical.dot_hierarchical`): one scale agreed
  over the pods of a stacked ``[npods, ...]`` payload (the reference's
  ``pmax`` over the pod axis), carrying the payload's own dtype;
* the exchange wire codec (``wire="int8"`` in
  :mod:`repro_torch.comm.strategies`): one float32 scale per wire block,
  moved beside the int8 payload.

``scale = max(amax / qmax, tiny)`` over the *finite* magnitudes
(:func:`finite_amax`), ``q = clip(round(x / scale), -qmax, qmax)`` with
round-half-to-even, and ``q * scale`` back.  The divisions divide by a
tensor on the payload's device: torch turns a division by a Python scalar
on CUDA into a multiply by its reciprocal, which is not bitwise the
division the numpy oracle (:func:`repro_torch.comm.wire.roundtrip_np`)
makes.

Non-finite elements never poison their finite neighbours: they are masked
out of the scale and of the division.  A permutation-moved payload (the
wire) ships them as the reserved ``nonfinite_code``, which decodes to
``nan``; a summed payload (the :class:`Compressor`) saturates ``+/-inf`` to
``sign(x) * qmax`` and sends ``nan`` as 0, and the error-feedback residual
keeps the non-finite value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def finite_amax(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Max magnitude over the *finite* elements of ``x`` (0 where none are).

    ``dim=None`` reduces everything.  A reduction over an empty extent
    gives 0, as the reference's ``max(..., initial=0)`` checks do.
    """
    mag = torch.where(torch.isfinite(x), x.abs(), torch.zeros((), dtype=x.dtype, device=x.device))
    if dim is None:
        return mag.amax() if mag.numel() else mag.new_zeros(())
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    if any(mag.shape[d] == 0 for d in dims):
        return mag.sum(dim=dims, keepdim=keepdim)  # zeros of the reduced shape
    return mag.amax(dim=dims, keepdim=keepdim)


def int8_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Quantization scale for a payload of max magnitude ``amax``, in
    ``amax``'s dtype, never below that dtype's smallest normal number (an
    all-zero payload keeps a positive scale)."""
    q = torch.full_like(amax, qmax)
    return torch.clamp_min(amax / q, torch.finfo(amax.dtype).tiny)


def int8_quantize(
    x: torch.Tensor, scale: torch.Tensor, qmax: float, nonfinite_code: Optional[int] = None
) -> torch.Tensor:
    """Linear int8 quantization under ``scale`` (broadcast against ``x``).

    Non-finite elements are masked out of the division and become
    ``nonfinite_code`` when one is given (permutation-moved payloads), else
    ``sign(x) * qmax`` with ``nan -> 0`` (summable payloads).
    """
    finite = torch.isfinite(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(torch.where(finite, x, zero) / scale), -qmax, qmax)
    if nonfinite_code is None:
        fallback = torch.where(torch.isnan(x), zero, torch.sign(x) * qmax)
    else:
        fallback = torch.full((), float(nonfinite_code), dtype=q.dtype, device=x.device)
    return torch.where(finite, q, fallback).to(torch.int8)


def int8_dequantize(
    q: torch.Tensor, scale: torch.Tensor, nonfinite_code: Optional[int] = None
) -> torch.Tensor:
    """Dequantize an int8/int32 payload; the result carries ``scale.dtype``.

    The product is taken at float32 or wider so an int32 *sum* of codes stays
    exact, and only the result rounds to ``scale.dtype``.  With
    ``nonfinite_code``, elements carrying that code decode to ``nan``.
    """
    wide = torch.promote_types(scale.dtype, torch.float32)
    deq = q.to(wide) * scale.to(wide)
    if nonfinite_code is not None:
        deq = torch.where(q == nonfinite_code, torch.full((), float("nan"), dtype=wide, device=q.device), deq)
    return deq.to(scale.dtype)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """int8 quantizer with one scale shared by every pod of a stacked payload."""

    bits: int = 8

    @property
    def qmax(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def compress(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize ``x`` (``[npods, ...]``, one slice per pod) with one scale
        agreed over all pods (the max of their finite magnitudes).  The scale
        keeps ``x``'s floating dtype, so a bf16 payload round-trips as bf16."""
        scale = int8_scale(finite_amax(x), self.qmax)
        return int8_quantize(x, scale, self.qmax), scale

    def decompress(self, q_sum: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """Dequantize back to the payload's own dtype (``scale`` carries it)."""
        return int8_dequantize(q_sum, scale)

    def wire_bytes(self, x: torch.Tensor) -> int:
        """Bytes one pod puts on the inter-pod hop for ``x`` (``[npods, ...]``)."""
        return (x.numel() // max(x.shape[0], 1)) * self.bits // 8
