"""Mesh builders: the reference's production meshes as ``DeviceMesh``, and the launchers' mesh.

``make_production_mesh`` is a function (not a module-level constant) so that
importing this module touches no device or process-group state, as in the
reference.  It builds over the default process group, which the caller
initialises with the mesh's world size: a real one (NCCL on 256 or 512
cards) or, for the dry-run, a fake group of that size in one process
(:func:`init_fake_world`).
"""

from __future__ import annotations

import math
from typing import Tuple

#: the reference's meshes: (shape, axis names)
SINGLE_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = ((16, 16), ("data", "model"))
MULTI_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = ((2, 16, 16), ("pod", "data", "model"))


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of the 16x16 pod or the 2x16x16 pair of pods."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 ``("data", "model")`` mesh, or 2 pods x 16 x 16 = 512 chips over
    ``("pod", "data", "model")``, on the default process group, whose world
    size must be the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_shape(multi_pod)
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh needs a default process group of world size "
            f"{need}; none is initialised"
        )
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh needs a default process group of world size "
            f"{need}; this one has {dist.get_world_size()}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """The default process group as a fake group of ``world_size`` in this
    process, standing at ``rank``: collectives move no data (their outputs
    are left uninitialised) but have their real shapes, so a program's
    shapes, memory and FLOPs are those of that rank."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


#: the collectives of a DTensor program that plain gloo has no CUDA path
#: for, as ``repro_torch.launch.world.probe_collectives`` found them on the
#: card's torch (2.11): ``all_gather`` as DTensor issues it
#: (``_functional_collectives.all_gather_tensor``) ends each process of the
#: world with a segmentation fault, while reduce-scatter, all-to-all and
#: all-reduce run.  The launchers' worlds therefore run over the staged group
#: (:mod:`repro_torch.comm.staged`), which moves CUDA tensors through host
#: memory itself; this stays the record of plain gloo, which the probe checks
GLOO_CUDA_MISSING: Tuple[str, ...] = ("all_gather",)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """The launchers' ``("data", "model")`` mesh: ``None`` (one device, no
    mesh) for ``1x1``; otherwise a ``DeviceMesh`` of ``device_type``
    (``"cpu"`` or ``"cuda"``) over the initialised default process group,
    whose world must hold ``data * model`` processes (one rank each); its
    dimension groups take the default group's backend (the launchers'
    worlds: the staged group).

    The reference's ``make_host_mesh`` lays its mesh over forced host
    devices of one process; the port's ranks are processes, which
    :func:`repro_torch.launch.world.run_world` spawns (the train and serve
    launchers do so for ``--mesh``).
    """
    if (data, model) == (1, 1):
        return None
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"mesh {data}x{model} needs an initialised process group of {data * model} processes")
    if dist.get_world_size() != data * model:
        raise ValueError(
            f"mesh {data}x{model} needs a world of {data * model} processes; this one has {dist.get_world_size()}"
        )
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"DxM"`` -> ``(D, M)``, each at least 1."""
    data, model = (int(x) for x in text.lower().split("x"))
    if data < 1 or model < 1:
        raise ValueError(f"mesh {text!r}: both sizes must be at least 1")
    return data, model
