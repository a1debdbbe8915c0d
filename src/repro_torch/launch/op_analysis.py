"""Op-level analysis of one eager call: the roofline inputs of the dry-run.

The port's counterpart of ``repro.launch.hlo_analysis``.  The reference
parses the compiled HLO of a jitted program and weights each loop body by
its trip count.  The port has no HLO: it runs eagerly, so it counts the
program as it runs.  :func:`analyze` calls ``fn`` under one
``TorchDispatchMode`` that sees every aten op, loop iterations included,
and works the same on meta tensors (nothing is allocated: the dry-run) and
on real tensors on the card.  It counts, per chip:

* ``flops``      -- 2*M*N*K summed over every matrix product (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``; ``matmul`` and ``einsum`` reach these),
  by ``torch.utils.flop_counter``'s formulas.  Elementwise FLOPs are not
  counted, as in the reference.
* ``mem_bytes``  -- 2 x the bytes of every storage an op allocates: each
  produced tensor written once and read once, the reference's rule at
  fusion boundaries applied at eager op boundaries.  Views, in-place ops and
  no-op casts return a storage that already exists and add nothing (the
  reference's ``_SKIP_MEM_OPS``).
* ``collective_by_kind`` / ``collective_ops`` -- the operand bytes of every
  collective the chip issues, by the reference's kind names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-broadcast``), and their count; ``{}`` and 0 for a program on
  one device.
* ``argument_bytes`` -- the storages of the arguments, each once;
  ``peak_bytes`` -- the most bytes live at once in storages the call
  allocated (a storage is freed when its last tensor dies);
  ``output_bytes`` -- what the call returns that it allocated.  The
  arguments are registered before the call, so a view or a no-op ``.to()``
  of one counts nothing.

**Under DTensor** (a sharded program on a ``DeviceMesh``), every number is
one chip's, as the reference's HLO is after SPMD partitioning.  The mode
declines every op on DTensors (it returns ``NotImplemented``), so DTensor
dispatches it, and what DTensor then runs -- the op on this chip's local
shards, and the collectives of each redistribution -- comes back through the
mode on plain tensors and is counted.  The global-shape ops that DTensor's
sharding propagation runs under its own ``FakeTensorMode`` to learn output
shapes are passed through uncounted.  Arguments and outputs count their
local shards' storages.

A mesh of device type ``"cpu"`` (the dry-run's fake process group, which
needs no card) would make DTensor turn each ``Shard(i) -> Shard(j)``
redistribution into an all-gather and a chunk, because gloo has no
all-to-all.  A CUDA mesh issues one all-to-all there.  :func:`analyze`
counts what a CUDA mesh issues: while it runs, DTensor's
``shard_dim_alltoall`` issues the all-to-all op itself on every mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
#: the matrix products whose FLOPs are counted (``torch.utils.flop_counter``'s formulas)
MATMULS = (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm)

#: collective ops (the name after the namespace) -> the reference's kind names
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


@dataclasses.dataclass
class OpStats:
    flops: float
    mem_bytes: float
    collective_by_kind: Dict[str, float]
    collective_ops: int
    argument_bytes: int
    peak_bytes: int
    output_bytes: int
    #: (op, shape and dtype of what it allocated) -> [bytes by the 2x rule, calls]
    contributors: Dict[Tuple[str, str], List[float]] = dataclasses.field(repr=False, default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective_by_kind.values())

    @property
    def temp_bytes(self) -> int:
        """Bytes live at the peak beyond what the call returns."""
        return self.peak_bytes - self.output_bytes


@dataclasses.dataclass
class CollectiveStats:
    by_kind: Dict[str, float]
    op_count: int

    @property
    def total_bytes(self) -> float:
        return sum(self.by_kind.values())


def _tensors(tree) -> List[torch.Tensor]:
    """The plain tensors of ``tree``, each DTensor by its local shard."""
    out = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)]
    return [t for t in out if isinstance(t, torch.Tensor) and t.layout == torch.strided]


def _collective(func) -> str:
    """The reference's kind name of a collective op, or ``""``."""
    ns, _, name = func.overloadpacket._qualified_op_name.partition("::")
    return COLLECTIVES.get(name, "") if ns in _COLLECTIVE_NAMESPACES else ""


@contextlib.contextmanager
def _cuda_collectives():
    """DTensor's ``Shard(i) -> Shard(j)`` as the all-to-all a CUDA mesh issues,
    on every mesh (see the module docstring)."""
    from torch.distributed.tensor import placement_types

    original = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


class _Trace(TorchDispatchMode):
    """Counts FLOPs and bytes of every op, and the bytes live in the storages
    the traced call allocated."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.mem_bytes = 0.0
        self.live = 0
        self.peak = 0
        self.known: Dict[int, int] = {}  # storage -> bytes it counts (0: not this call's)
        self.finalizers: List[weakref.finalize] = []
        self.contributors: Dict[Tuple[str, str], List[float]] = defaultdict(lambda: [0.0, 0])
        self.collective_by_kind: Dict[str, float] = defaultdict(float)
        self.collective_ops = 0

    def watch(self, storage: torch.UntypedStorage, nbytes: int) -> None:
        key = storage._cdata
        self.known[key] = nbytes
        self.live += nbytes
        self.finalizers.append(weakref.finalize(storage, self._free, key))

    def _free(self, key: int) -> None:
        self.live -= self.known.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)  # DTensor's shape propagation: not run on the chip
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it, on local shards, through this mode
        kind = _collective(func)
        if kind:
            self.collective_by_kind[kind] += sum(t.nbytes for t in _tensors(args[0]))
            self.collective_ops += 1
        for t in _tensors((args, kwargs)):  # made before the call: not this call's
            st = t.untyped_storage()
            if st._cdata not in self.known:
                self.watch(st, 0)
        out = func(*args, **kwargs)
        if func.overloadpacket in MATMULS:
            self.flops += flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        new = 0
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in self.known:
                self.watch(st, st.nbytes())
                new += st.nbytes()
                c = self.contributors[(str(func.overloadpacket), f"{t.dtype} {list(t.shape)}")]
                c[0] += 2.0 * st.nbytes()
                c[1] += 1
        self.mem_bytes += 2.0 * new
        self.peak = max(self.peak, self.live)
        return out


def analyze(fn: Callable, *args: Any, **kwargs: Any) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once under the trace; its :class:`OpStats`."""
    trace = _Trace()
    arguments = {}
    for t in _tensors((args, kwargs)):
        st = t.untyped_storage()
        arguments[st._cdata] = st.nbytes()
        if st._cdata not in trace.known:
            trace.watch(st, 0)
    try:
        with _cuda_collectives(), trace:
            out = fn(*args, **kwargs)
        returned = {t.untyped_storage()._cdata for t in _tensors(out)}
        output_bytes = sum(trace.known.get(key, 0) for key in returned)
    finally:
        for f in trace.finalizers:
            f.detach()
    return OpStats(
        flops=trace.flops, mem_bytes=trace.mem_bytes, collective_by_kind=dict(trace.collective_by_kind),
        collective_ops=trace.collective_ops,
        argument_bytes=sum(arguments.values()), peak_bytes=trace.peak, output_bytes=output_bytes,
        contributors=dict(trace.contributors),
    )


def analyze_collectives(fn: Callable, *args: Any, **kwargs: Any) -> CollectiveStats:
    st = analyze(fn, *args, **kwargs)
    return CollectiveStats(by_kind=st.collective_by_kind, op_count=st.collective_ops)


def top_contributors(stats: OpStats, k: int = 12) -> List[Tuple[float, float, str, str]]:
    """The ``k`` largest memory contributors of an analysed call:
    ``(bytes, calls, op, shape)``, each op and result shape summed over its calls."""
    out = [(b, n, op, shape) for (op, shape), (b, n) in stats.contributors.items()]
    out.sort(reverse=True)
    return out[:k]
