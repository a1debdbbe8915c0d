"""Node-aware reductions for the Krylov solvers.

Every dot product / norm inside :mod:`repro_torch.solve.krylov` goes through
one of these backends, so the solver's scalar traffic follows the paper's
hierarchy: reduce on the cheap on-pod fabric first, cross the expensive
inter-pod hop once per pod.

* :class:`TorchReductions` -- the tree (rank partials -> per-pod sums ->
  world sum) in float64 on the operator's device
  (:func:`repro_torch.comm.hierarchical.dot_hierarchical`), optionally with
  the per-pod partials int8-compressed on the inter-pod hop
  (:class:`repro_torch.comm.compression.Compressor`); one ``.item()`` per
  dot.  :func:`traceable_dot` is the same tree with no host read, for
  solvers that keep their scalars on the device.
* :class:`NumpyReductions` -- the same tree on the host, in numpy's order.
* :class:`GroupReductions` -- the tree over a process group of one rank
  per process (:func:`repro_torch.comm.hierarchical.dot_hierarchical_group`):
  each rank's float64 partial (taken on the host) is summed over its pod's
  ``local`` group, and one scalar per pod crosses the ``pod`` groups
  (int8-quantized with a ``compressor``).  The partial and both levels sum
  in :class:`NumpyReductions`' order, so every rank holds the same bits and
  takes the same branch in the solver.

:func:`fused_dot` is the dot a fused solve carries on the device: over a
process group in :class:`GroupReductions`' order, so the fused solve's
scalars are the grouped host loop's, bitwise.

All are deterministic, so residual histories are bitwise reproducible
across strategies and barrier-vs-overlap execution.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comm.compression import Compressor
from repro_torch.comm.hierarchical import (
    dot_hierarchical,
    dot_hierarchical_group,
    dot_tree_steps,
    ordered_sum,
)
from repro_torch.comm.hops import no_hops
from repro_torch.comm.topology import PodTopology


def _tree_sum(part: np.ndarray, topo: PodTopology) -> float:
    """Per-rank float64 partials summed per pod, then over the pods."""
    return float(part.reshape(topo.npods, topo.ppn).sum(axis=1).sum())


def _host64(a) -> torch.Tensor:
    """``a`` (an array, or a tensor on any device) as a float64 host tensor."""
    t = a.detach().cpu() if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.double()


@dataclasses.dataclass(frozen=True)
class NumpyReductions:
    """Hierarchical dot products on the host in numpy's order (rank -> pod
    -> world).

    Partials are accumulated in float64 regardless of the vector dtype; a
    tensor on a device is copied to the host first.  Each rank's partial
    is summed by :func:`~repro_torch.comm.hierarchical.ordered_sum`, numpy
    2.0's row sum (the reference's ``NumpyReductions``) pinned: numpy 2.3
    sums a row longer than 8192 elements in another order, so the port's
    stacked, grouped and fused solves share these bits on any numpy.
    """

    topo: PodTopology

    def dot(self, x: np.ndarray, y: np.ndarray) -> float:
        """``<x, y>`` for ``[nranks, L]`` operands, hierarchical order."""
        x = _host64(x)
        y = x if y is x else _host64(y)
        part = ordered_sum((x * y).reshape(self.topo.nranks, -1)).numpy()  # per rank
        return _tree_sum(part, self.topo)

    def norm(self, x: np.ndarray) -> float:
        return float(np.sqrt(max(self.dot(x, x), 0.0)))


def traceable_dot(
    topo: PodTopology, compressor: Optional[Compressor] = None
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The hierarchical dot product as a device callable:
    ``dot(x, y) -> 0-d float64 tensor`` for ``[nranks, L]`` operands, with no
    host read (the reference's ``traceable_dot`` for fused solvers).
    ``compressor`` int8-quantizes the per-pod partials on the inter-pod hop."""

    def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return dot_hierarchical(x.double(), y.double(), topo, compressor)

    return dot


@dataclasses.dataclass(frozen=True)
class TorchReductions:
    """The :class:`NumpyReductions` tree in float64 on the operands' device.

    Each :meth:`dot` brings one scalar back to the host (one ``.item()``),
    as the reference's device reductions do.  ``compressor`` quantizes the
    inter-pod hop int8 (about 0.4% error per reduction: it perturbs Krylov
    convergence, so it is off unless the surrounding system already runs
    compressed reductions).
    """

    topo: PodTopology
    compressor: Optional[Compressor] = None

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> float:
        """``<x, y>`` for ``[nranks, L]`` operands, hierarchical order."""
        return float(self.traceable()(x, y).item())

    def traceable(self) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """This backend's tree as a device callable (:func:`traceable_dot`)."""
        return traceable_dot(self.topo, self.compressor)

    def norm(self, x: torch.Tensor) -> float:
        return float(np.sqrt(max(self.dot(x, x), 0.0)))


@dataclasses.dataclass(frozen=True)
class GroupReductions:
    """The hierarchical tree over a process group of one rank per process.

    Each :meth:`dot` copies this rank's ``[1, L]`` operands to the host
    (gloo's collectives take host tensors, so the partial goes there
    anyway; one copy is one operation on the card, where the float64 casts,
    product and sum are ~35, and a card shared by every rank's process pays
    per operation), takes its float64 partial there in
    :class:`NumpyReductions`' order, and reduces it on-pod, then over the
    pods
    (:func:`~repro_torch.comm.hierarchical.dot_hierarchical_group`): without
    a ``compressor`` bitwise :class:`NumpyReductions` of the stacked
    operands; with one, the pod sums int8-quantized on the inter-pod hop
    as :class:`TorchReductions` quantizes them.  Every rank gets the same
    bits.
    """

    topo: PodTopology
    group: object  # repro_torch.comm.topology.ExchangeGroup
    compressor: Optional[Compressor] = None

    def partial(self, x: torch.Tensor, y: torch.Tensor) -> float:
        """This rank's float64 share of ``<x, y>`` (``[1, L]`` operands), in
        :class:`NumpyReductions`' order (:func:`~repro_torch.comm.hierarchical.ordered_sum`,
        which the fused solve takes on the device)."""
        x = _host64(x)
        return float(ordered_sum(x * (x if y is x else _host64(y)))[0])

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> float:
        return dot_hierarchical_group(self.partial(x, y), self.group, self.compressor)

    def norm(self, x: torch.Tensor) -> float:
        return float(np.sqrt(max(self.dot(x, x), 0.0)))


def fused_dot(op, compressor: Optional[Compressor] = None):
    """The hierarchical dot a fused solve of ``op`` carries, as a hop
    generator function (:mod:`repro_torch.comm.hops`) ``dot(x, y)`` that
    returns a 0-d float64 tensor on the operands' device (int8-quantized on
    the inter-pod hop with a ``compressor``).

    * an operator over a process group: this rank's partial in numpy's
      order (:func:`~repro_torch.comm.hierarchical.ordered_sum`) on the
      device, then the tree over the group
      (:func:`~repro_torch.comm.hierarchical.dot_tree_steps`): the order of
      :class:`GroupReductions`, so the fused scalars are the grouped host
      loop's bitwise;
    * stacked ranks: :func:`traceable_dot`, which yields no hop.
    """
    group = getattr(op, "group", None)
    if group is not None:
        def dot(x: torch.Tensor, y: torch.Tensor):
            xd = x.double()
            yd = xd if y is x else y.double()
            part = ordered_sum((xd * yd).reshape(1, -1))
            return (yield from dot_tree_steps(part, group, compressor))

        return dot
    tree = traceable_dot(op.topo, compressor)

    def dot(x: torch.Tensor, y: torch.Tensor):
        return (yield from no_hops(tree(x, y)))

    return dot


def default_reductions(op) -> "TorchReductions | NumpyReductions | GroupReductions":
    """The reduction backend matching an operator's executor: the group's
    for an operator over a process group, the torch tree for an operator
    with a ``device`` (the port's
    :class:`repro_torch.sparse.spmv.DistributedSpMV`), numpy otherwise."""
    if getattr(op, "group", None) is not None:
        return GroupReductions(op.topo, op.group)
    if isinstance(getattr(op, "device", None), torch.device):
        return TorchReductions(op.topo)
    return NumpyReductions(op.topo)
