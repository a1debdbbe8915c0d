"""Pod-aware hierarchical collectives on stacked ranks.

The port's twin of the reference's ``repro/comm/hierarchical.py``.  The
paper's node-aware schemes keep inter-node traffic on the cheap local
fabric first and move as little as possible over the expensive one; for the
*regular* collectives the same decomposition is

    all-reduce(pod x local) -> reduce-scatter(local) -> all-reduce(pod)
                            -> all-gather(local)

so each rank puts only ``1/ppn`` of the bytes on the inter-pod hop.  An
optional int8 :class:`~repro_torch.comm.compression.Compressor` shrinks that
hop only.

Here every rank lives in one stacked tensor whose leading axes are
``[npods, ppn]`` (rank ``p * ppn + l``), so each collective is a reduction or
an index move over those axes, and every function returns the stacked
per-rank result (replicated results as a broadcast view).
:func:`dot_hierarchical_group` is the same reduction tree over a process
group of one rank per process
(:class:`~repro_torch.comm.topology.ExchangeGroup`), run on the host;
:func:`dot_tree_steps` is that tree as a hop generator on the rank's device,
for the fused solve.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.compression import Compressor, int8_dequantize, int8_quantize, int8_scale
from repro_torch.comm.hops import Hop, run_hops
from repro_torch.comm.topology import PodTopology


def _ranks(x: torch.Tensor, topo: PodTopology) -> torch.Tensor:
    """``x`` as ``[npods, ppn, *rest]`` (leading ``[nranks]`` or ``[npods, ppn]``)."""
    if tuple(x.shape[:2]) == (topo.npods, topo.ppn):
        return x
    if x.shape[0] != topo.nranks:
        raise ValueError(f"expected [{topo.nranks}, ...] or [{topo.npods}, {topo.ppn}, ...], "
                         f"got {tuple(x.shape)}")
    return x.reshape((topo.npods, topo.ppn) + tuple(x.shape[1:]))


def psum_hierarchical(
    x: torch.Tensor,
    topo: PodTopology,
    compressor: Optional[Compressor] = None,
    residual: Optional[torch.Tensor] = None,
):
    """All-reduce over every rank as RS(local) -> AR(pod) -> AG(local).

    ``x`` is ``[npods, ppn, *S]``, one leaf per rank.  Returns the reduced
    ``[npods, ppn, *S]`` (every rank holds the same sum) and, with a
    ``compressor``, the new per-rank error-feedback residual
    ``[npods, ppn, m]`` (``m = ceil(prod(S) / ppn)``; pass it back as
    ``residual`` next step).  The compressed hop agrees one scale per shard
    over the pods, as the reference's ``pmax`` over the pod axis does.
    """
    xr = _ranks(x, topo)
    npods, ppn = topo.npods, topo.ppn
    shape = tuple(xr.shape[2:])
    flat = xr.reshape(npods, ppn, -1)
    size = flat.shape[2]
    pad = (-size) % ppn
    if pad:
        flat = torch.cat([flat, flat.new_zeros((npods, ppn, pad))], dim=2)
    m = flat.shape[2] // ppn
    # reduce-scatter over the local axis: shard j of pod p sums every local
    # rank's j-th slice
    shard = flat.reshape(npods, ppn, ppn, m).sum(dim=1)  # [npods, ppn(j), m]
    new_residual = None
    if compressor is not None:
        if residual is not None:
            shard = shard + residual.reshape(shard.shape)
        # one scale per shard j, agreed over the pods
        per_j = shard.transpose(0, 1)  # [ppn, npods, m]
        qs, scales = zip(*(compressor.compress(per_j[j]) for j in range(ppn)))
        q = torch.stack(qs, dim=1)  # [npods, ppn, m]
        scale = torch.stack(scales).reshape(1, ppn, 1)
        reduced = compressor.decompress(q.to(torch.int32).sum(dim=0), scale[0])  # [ppn, m]
        new_residual = shard - compressor.decompress(q.to(torch.int32), scale)
    else:
        reduced = shard.sum(dim=0)  # all-reduce over pods: [ppn, m]
    full = reduced.reshape(-1)[:size].reshape(shape)  # all-gather over local
    out = full.expand((npods, ppn) + shape)
    if compressor is not None:
        return out, new_residual
    return out


def psum_flat(x: torch.Tensor, topo: PodTopology) -> torch.Tensor:
    """Baseline: one flat all-reduce over every rank (the standard scheme)."""
    xr = _ranks(x, topo)
    return xr.reshape((topo.nranks,) + tuple(xr.shape[2:])).sum(dim=0).expand(xr.shape)


def dot_hierarchical(
    x: torch.Tensor,
    y: torch.Tensor,
    topo: PodTopology,
    compressor: Optional[Compressor] = None,
) -> torch.Tensor:
    """Global ``<x, y>`` over stacked ``[nranks, ...]`` operands, node-aware.

    Each rank reduces its slice, the partials sum within each pod, and one
    scalar per pod crosses the inter-pod hop -- int8-quantized with a
    ``compressor`` (about ``1/(2 qmax)`` relative error per reduction, so it
    perturbs Krylov convergence; it exists to keep the reduction path
    byte-compatible with the compressed gradient path).  Sums run in the
    operands' dtype; returns a 0-d tensor on their device.
    """
    part = (x * y).reshape(topo.nranks, -1).sum(dim=1)
    pods = part.reshape(topo.npods, topo.ppn).sum(dim=1)  # on-pod, full precision
    if compressor is None:
        return pods.sum()
    q, scale = compressor.compress(pods)
    return compressor.decompress(q.to(torch.int32).sum(), scale)


#: numpy's float64 add-reduction, which :func:`ordered_sum` follows: the
#: row in buffers of ``np.getbufsize()`` (8192) elements added left to right
#: onto 0, each buffer summed pairwise in blocks of at most ``PW_BLOCKSIZE``
#: (128) elements with eight accumulators
_NP_BUFFER = 8192
_NP_BLOCK = 128


def _pairwise(a: torch.Tensor) -> torch.Tensor:
    """numpy's ``pairwise_sum`` of each length-``m`` row of ``a [rows, B,
    m]``: ``[rows, B]``."""
    rows, nb, m = a.shape
    if m < 8:
        s = a.new_zeros((rows, nb))
        for i in range(m):
            s = s + a[:, :, i]
        return s
    if m <= _NP_BLOCK:
        k8 = m - m % 8
        blocks = a[:, :, :k8].reshape(rows, nb, k8 // 8, 8)
        r = blocks[:, :, 0]
        for i in range(1, k8 // 8):
            r = r + blocks[:, :, i]
        r = r[..., 0::2] + r[..., 1::2]
        r = r[..., 0::2] + r[..., 1::2]
        s = r[..., 0] + r[..., 1]
        for i in range(k8, m):
            s = s + a[:, :, i]
        return s
    half = m // 2
    half -= half % 8
    if 2 * half == m:  # both halves alike: one batch of twice the rows
        h = _pairwise(a.reshape(rows, nb * 2, half)).view(rows, nb, 2)
        return h[..., 0] + h[..., 1]
    return _pairwise(a[:, :, :half]) + _pairwise(a[:, :, half:])


def ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """Row sums of ``v [rows, n]`` in numpy's order (``v.numpy().sum(axis=1)``
    of float64 rows, bitwise): ``[rows]`` on ``v``'s device.

    Every add is one elementwise tensor op, so the sum is the same bits on
    the host and on the card, and a CUDA graph can hold it: the reduction
    tree's partials and levels take it on both sides of a process group's
    fused solve (:mod:`repro_torch.solve.fused`).
    """
    rows, n = v.shape
    full, rest = divmod(n, _NP_BUFFER)
    sums = []
    if full:
        sums.append(_pairwise(v[:, : full * _NP_BUFFER].reshape(rows, full, _NP_BUFFER)))
    if rest:
        sums.append(_pairwise(v[:, full * _NP_BUFFER :].reshape(rows, 1, rest)))
    out = v.new_zeros(rows)
    for s in sums:
        for j in range(s.shape[1]):
            out = out + s[:, j]
    return out


def dot_tree_steps(partial: torch.Tensor, group, compressor: Optional[Compressor] = None):
    """The reduction tree over a process group as a hop generator
    (:mod:`repro_torch.comm.hops`): ``partial`` is this rank's ``[1]``
    float64 share of ``<x, y>`` on its device, and the generator returns
    the world sum, a 0-d float64 tensor there, the same bits on every rank.

    The ``ppn`` partials of this rank's pod are all-gathered over
    ``group.local`` and summed in index order (the pod sum), then the
    ``npods`` pod sums over ``group.pod``: one scalar per pod crosses the
    inter-pod groups, and each level sums in numpy's order
    (:func:`ordered_sum`), so the result is bitwise ``_tree_sum`` of the
    gathered partials.  With a ``compressor`` the pod sum is int8-quantized
    on the inter-pod hop under one scale agreed over the pods (an all-reduce
    MAX of the finite magnitudes,
    :func:`~repro_torch.comm.compression.int8_scale`'s formula), and the
    ``int32`` codes are summed over ``group.pod`` and dequantized.
    """
    topo = group.topo
    local = partial.new_empty(topo.ppn)
    yield Hop("all_gather", (partial,), (local,), group=group.local)
    pod = ordered_sum(local.view(1, -1))
    if compressor is None:
        pods = partial.new_empty(topo.npods)
        yield Hop("all_gather", (pod,), (pods,), group=group.pod)
        return ordered_sum(pods.view(1, -1))[0]
    amax = torch.where(torch.isfinite(pod), pod.abs(), torch.zeros_like(pod))
    yield Hop("all_reduce", (amax,), (amax,), group=group.pod, op="max")
    scale = int8_scale(amax[0], compressor.qmax)
    q = int8_quantize(pod, scale, compressor.qmax).to(torch.int32)
    yield Hop("all_reduce", (q,), (q,), group=group.pod, op="sum")
    return int8_dequantize(q[0], scale)


def dot_hierarchical_group(partial: float, group, compressor: Optional[Compressor] = None) -> float:
    """:func:`dot_hierarchical` over a process group: ``partial`` is this
    rank's float64 share of ``<x, y>``, and every rank returns the world sum
    of :func:`dot_tree_steps` (run on the host), bitwise the stacked
    partials' rank -> pod -> world tree (``NumpyReductions``) without a
    ``compressor``; every rank holds the same bits either way.
    """
    mine = torch.tensor([float(partial)], dtype=torch.float64)
    return float(run_hops(dot_tree_steps(mine, group, compressor)))


def all_gather_hierarchical(x: torch.Tensor, topo: PodTopology) -> torch.Tensor:
    """All-gather of per-rank shards ``[npods, ppn, blk, ...]``: across pods
    first (the small shards cross the inter-pod hop), then within each pod.

    Every rank receives ``[ppn * npods * blk, ...]`` in the reference's
    order (local rank major, then pod); returned as ``[npods, ppn, ...]``.
    """
    xr = _ranks(x, topo)
    rest = tuple(xr.shape[3:])
    blk = xr.shape[2]
    gathered = xr.transpose(0, 1).reshape((topo.ppn * topo.npods * blk,) + rest)
    return gathered.expand((topo.npods, topo.ppn) + tuple(gathered.shape))


def all_to_all_hierarchical(x: torch.Tensor, topo: PodTopology) -> torch.Tensor:
    """All-to-all over every rank, decomposed 3-Step style.

    ``x`` is ``[npods, ppn, nranks * blk, ...]``: each rank's blocks for every
    destination rank, destination-major.  Step 1 moves, per destination pod,
    all of a rank's blocks for that pod in one inter-pod exchange; step 2
    redistributes within the destination pod.  The result equals the flat
    all-to-all (``out[d][s] = x[s][d]``).
    """
    xr = _ranks(x, topo)
    npods, ppn = topo.npods, topo.ppn
    rest = tuple(xr.shape[3:])
    blk = xr.shape[2] // (npods * ppn)
    # [p, l, q, (j, b)]: fuse per destination pod q, exchange over pods
    y = xr.reshape((npods, ppn, npods, ppn * blk) + rest).transpose(0, 2)
    # rank (p, l) now holds, from each source pod q, blocks for (p, j)
    y = y.reshape((npods, ppn, npods, ppn, blk) + rest).transpose(2, 3)  # [p, l, j, q, b]
    # exchange within the pod: rank (p, j) gathers slot j from every (p, l)
    y = y.transpose(1, 2)  # [p, j, l, q, b]
    # destination-major sources: (q, l)
    y = y.transpose(2, 3)  # [p, j, q, l, b]
    return y.reshape((npods, ppn, npods * ppn * blk) + rest)


# ---------------------------------------------------------------------------
# Gradient-tree synchronisation for data-parallel loops
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(part) for part in t)
        return next(it)

    return build(tree)


def init_residuals(grads, topo: PodTopology):
    """Zero error-feedback residuals matching :func:`sync_grad_tree`'s shards:
    ``[npods, ppn, ceil(size / ppn)]`` per ``[npods, ppn, *S]`` leaf."""

    def zeros(g: torch.Tensor) -> torch.Tensor:
        size = _ranks(g, topo)[0, 0].numel()
        return g.new_zeros((topo.npods, topo.ppn, -(-size // topo.ppn)))

    return _rebuild(grads, [zeros(g) for g in _leaves(grads)])


def sync_grad_tree(
    grads,
    topo: PodTopology,
    mode: str = "hierarchical",
    compressor: Optional[Compressor] = None,
    residuals=None,
):
    """Average a tree (dicts, lists, tuples) of stacked per-rank gradients.

    Leaves are ``[npods, ppn, *S]`` local-batch gradients; returns the global
    average in the same layout.  ``mode`` is ``"flat"`` (one joint
    all-reduce) or ``"hierarchical"`` (the paper's decomposition).  With a
    ``compressor`` (hierarchical only), returns ``(grads, new_residuals)``:
    error feedback on the inter-pod hop.
    """
    if mode not in ("flat", "hierarchical"):
        raise ValueError(f"mode must be 'flat' or 'hierarchical', got {mode!r}")
    n = topo.nranks

    def one(leaf: torch.Tensor, res: Optional[torch.Tensor]) -> Tuple[torch.Tensor, object]:
        if mode == "flat":
            return psum_flat(leaf, topo) / n, res
        if compressor is not None:
            out, new_res = psum_hierarchical(leaf, topo, compressor, res)
            return out / n, new_res
        return psum_hierarchical(leaf, topo) / n, res

    leaves = _leaves(grads)
    res = _leaves(residuals) if residuals is not None else [None] * len(leaves)
    outs = [one(g, r) for g, r in zip(leaves, res)]
    new_g = _rebuild(grads, [o[0] for o in outs])
    if compressor is not None:
        return new_g, _rebuild(grads, [o[1] for o in outs])
    return new_g
