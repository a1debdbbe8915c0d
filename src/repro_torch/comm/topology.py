"""Pod topology helpers: the paper's node hierarchy.

A :class:`PodTopology` describes a machine as ``npods`` pods of ``ppn``
ranks (the paper's nodes of PPN processes).  World rank ``r`` lives on pod
``r // ppn`` with pod-local rank ``r % ppn``.  In the port every rank is one
row of a stacked ``[nranks, ...]`` tensor on one device, laid out row-major
over ``("pod", "local")``, or, under an :class:`ExchangeGroup`, one process
of a ``torch.distributed`` world.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

POD_AXIS = "pod"
LOCAL_AXIS = "local"
WORLD_AXES: Tuple[str, str] = (POD_AXIS, LOCAL_AXIS)


@dataclasses.dataclass(frozen=True)
class PodTopology:
    npods: int
    ppn: int  # chips per pod

    @property
    def nranks(self) -> int:
        return self.npods * self.ppn

    def pod_of(self, rank: int) -> int:
        return rank // self.ppn

    def local_of(self, rank: int) -> int:
        return rank % self.ppn

    def rank_of(self, pod: int, local: int) -> int:
        return pod * self.ppn + local

    # ------------------------------------------------------------------
    def agent_local(self, src_pod: int, dst_pod: int) -> int:
        """Pod-local rank of the 3-Step agent for the (src, dst) pod pair.

        The paper pairs "all processes with a receiving process on distinct
        nodes [to] ensure every process remains active"; ``(src+dst) % ppn``
        spreads agent duty over pod-local ranks so different pod pairs use
        different chips.
        """
        return (src_pod + dst_pod) % self.ppn

    def pod_shift_rounds(self) -> List[int]:
        """Inter-pod exchange rounds: pod shifts ``1 .. npods-1``."""
        return list(range(1, self.npods))



# ---------------------------------------------------------------------------
# A real process group: one process per rank
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeGroup:
    """This process's place in a ``torch.distributed`` world of one rank per
    process: the counterpart of the reference's ``("pod", "local")`` mesh
    (``make_exchange_mesh``), built by :func:`make_exchange_group`.

    ``local`` joins the ``ppn`` ranks of this rank's pod (the ``a2a_local``
    hops), ``pod`` the ``npods`` ranks of its pod-local index (the
    ``a2a_pod`` hops); world rank ``r`` is ``topo.rank_of(pod, local)``,
    pod-major.  Every group is gloo or staged (:data:`BACKENDS`); the
    exchange hands them host tensors either way.
    """

    topo: PodTopology
    rank: int
    local: object  # torch.distributed.ProcessGroup
    pod: object
    backend: str = "gloo"

    @property
    def pod_index(self) -> int:
        return self.topo.pod_of(self.rank)

    @property
    def local_index(self) -> int:
        return self.topo.local_of(self.rank)


#: the backends an exchange group runs over: gloo, and the group that
#: stages every collective through host memory around gloo
#: (:mod:`repro_torch.comm.staged`), whose collectives also take CUDA tensors
BACKENDS: Tuple[str, ...] = ("gloo", "staged")


def check_backend(backend: str) -> None:
    """Only :data:`BACKENDS` run: NCCL raises, naming its ROADMAP item."""
    if backend == "nccl":
        raise NotImplementedError(
            "the NCCL transport is ROADMAP A.6.3b item 5: one card cannot hold a NCCL world of two "
            f"ranks, so only the backends {BACKENDS} (staged through host memory) run"
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the exchange runs over one of {BACKENDS}")


def make_exchange_group(topo: PodTopology, backend: str = "gloo", timeout=None) -> ExchangeGroup:
    """Split the default process group into the ``local`` and ``pod``
    subgroups of ``topo``; every rank of the world calls it at once.

    The world must hold exactly ``topo.nranks`` processes.  Each subgroup
    list is built with ``new_subgroups_by_enumeration`` over every pod (or
    local index) in order, so every rank creates every group in the same
    order.  ``timeout`` (a ``timedelta``) bounds each subgroup's
    collectives; ``None`` takes ``torch.distributed``'s default.
    """
    import torch.distributed as dist

    check_backend(backend)
    if backend == "staged":
        from repro_torch.comm.staged import register

        register()
    if not dist.is_initialized():
        raise RuntimeError("make_exchange_group needs an initialised torch.distributed world")
    world = dist.get_world_size()
    if world != topo.nranks:
        raise ValueError(f"{topo} needs a world of {topo.nranks} processes, this one has {world}")
    kw = dict(backend=backend) if timeout is None else dict(backend=backend, timeout=timeout)
    local, _ = dist.new_subgroups_by_enumeration(
        [[topo.rank_of(p, l) for l in range(topo.ppn)] for p in range(topo.npods)], **kw
    )
    pod, _ = dist.new_subgroups_by_enumeration(
        [[topo.rank_of(p, l) for p in range(topo.npods)] for l in range(topo.ppn)], **kw
    )
    return ExchangeGroup(topo=topo, rank=dist.get_rank(), local=local, pod=pod, backend=backend)


def exchange_group_of_mesh(mesh) -> ExchangeGroup:
    """The :class:`ExchangeGroup` of a ``("pod", "local")`` ``DeviceMesh``
    over the whole default world, made of the mesh's own ``local`` and
    ``pod`` dimension groups (no new subgroup): the counterpart of the
    reference's ``make_exchange_mesh`` mesh handed to an exchange.

    The exchange addresses world ranks as ``topo.rank_of(pod, local)``, so
    the mesh must lay the world out pod-major, as ``init_device_mesh`` does.
    Equal meshes give equal groups (their process groups are the mesh's).
    """
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names or ())
    if names != WORLD_AXES:
        raise ValueError(f"an exchange group needs a {WORLD_AXES} mesh, got axes {names}")
    # first, before any collective: a group of another backend (the dry-run's
    # fake one, NCCL) would fail later inside its own collectives
    backend = dist.get_backend(mesh.get_group("local"))
    check_backend(backend)
    topo = PodTopology(npods=mesh.size(0), ppn=mesh.size(1))
    world = dist.get_world_size()
    if world != topo.nranks:
        raise ValueError(f"the {topo.npods}x{topo.ppn} mesh must span the world; this one has {world} processes")
    layout = mesh.mesh.reshape(-1).tolist()
    if layout != [topo.rank_of(p, l) for p in range(topo.npods) for l in range(topo.ppn)]:
        raise ValueError(f"the mesh lays the ranks out as {layout}, not pod-major")
    return ExchangeGroup(topo=topo, rank=dist.get_rank(), local=mesh.get_group("local"),
                         pod=mesh.get_group("pod"), backend=backend)
