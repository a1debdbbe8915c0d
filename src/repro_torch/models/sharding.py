"""Parameter declaration and the logical-axis sharding rules of the model zoo.

The port of ``repro.models.sharding``.  A model declares a nested dict of
:class:`ParamSpec` with the reference's names and shapes; :func:`init_params`
turns it into tensors on one device from an explicit
:class:`torch.Generator`.

**The mesh half** (the reference's MaxText-style rules).  Every parameter and
boundary activation carries a tuple of *logical* axis names; :func:`spec_for`
resolves them to mesh axes through a rules table, with the reference's rules
and results: :class:`PartitionSpec` is a tuple with the reference's entries
(``None``, an axis name, or a tuple of names), so the two compare with
``==``.  The same model code runs on the 16x16 ``("data", "model")`` mesh,
the 2x16x16 ``("pod", "data", "model")`` mesh, or with no mesh at all.
Where the reference hands a spec to GSPMD through ``NamedSharding``, the
port hands DTensor one placement per mesh dimension (:func:`named_sharding`:
``Shard(d)`` or ``Replicate()``).  The rules read only axis names and sizes:
a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` or a plain
``{axis name: size}`` mapping.

Dtype rule: the reference keeps its parameters in float32 and casts every
weight to the activation dtype at each use.  The port stores the matrices in
the model dtype once, and keeps in float32 the leaves the reference reads in
float32 (``keep_f32``: the norm scales, ``a_log``, ``dt_bias``, ``d_skip``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

LogicalAxes = Tuple[Optional[str], ...]

#: logical axis -> mesh axes (tuple) or None (replicated)
Rules = Dict[Optional[str], Optional[Tuple[str, ...]]]

#: the reference's table (``src/repro/models/sharding.py``), entry for entry
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    # experts ride the data axis (expert parallelism inside a pod; pods
    # replicate experts, so token all-to-alls never cross pods)
    "experts": ("data",),
    "ssm_heads": ("model",),
    # decode cache: sequence dim over `model` (context parallelism)
    "cache_seq": ("model",),
    "cache_dim": ("model",),
    # sequence-parallel residual regions; replicated where the sequence does
    # not divide (decode), by spec_for's divisibility check
    "seq_sp": ("model",),
    "embed": None,
    "seq": None,
    "layers": None,
    "state": None,
    "head_dim": None,
    None: None,
}

#: a mesh as the rules see it: a DeviceMesh, or ``{axis name: size}``
MeshLike = Union[Mapping[str, int], "torch.distributed.device_mesh.DeviceMesh"]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (that dimension split over each, major to
    minor) -- the reference's ``jax.sharding.PartitionSpec`` entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh: Optional[MeshLike]) -> int:
    return 1 if mesh is None else math.prod(axis_sizes(mesh).values())


def rules_for_mesh(mesh: MeshLike, overrides: Optional[Rules] = None) -> Rules:
    """Drop mesh axes that do not exist (e.g. no ``pod`` on one pod).

    ``REPRO_EMBED_SHARD=data`` shards the activations' ``embed`` dim over
    ``data``, the reference's knob read from the same variable.
    """
    present = set(axis_sizes(mesh))
    base = dict(DEFAULT_RULES)
    if os.environ.get("REPRO_EMBED_SHARD") == "data":
        base["embed"] = ("data",)
    if overrides:
        base.update(overrides)
    out: Rules = {}
    for logical, axes in base.items():
        kept = tuple(a for a in axes if a in present) if axes is not None else ()
        out[logical] = kept or None
    return out


def spec_for(
    mesh: MeshLike,
    rules: Rules,
    logical: LogicalAxes,
    shape: Optional[Sequence[int]] = None,
) -> PartitionSpec:
    """Resolve logical axes to a :class:`PartitionSpec`, dropping non-divisible dims.

    If ``shape`` is given, a dim whose size is not divisible by the resolved
    axis product falls back to replication (e.g. 25 heads on a 16-way
    ``model`` axis).  For the ``batch`` logical axis, a *prefix* of the mesh
    axes that divides the dim is kept (batch 32 on pod x data = 2 x 16 keeps
    both; batch 1 keeps none).
    """
    sizes = axis_sizes(mesh)
    parts = []
    for d, name in enumerate(logical):
        axes = rules.get(name) if name is not None else None
        if not axes:
            parts.append(None)
            continue
        if shape is not None:
            dim = shape[d]
            if name == "batch":
                kept = []
                prod = 1
                for a in axes:
                    if dim % (prod * sizes[a]) != 0:
                        break
                    kept.append(a)
                    prod *= sizes[a]
                parts.append(tuple(kept) if kept else None)
                continue
            if dim % math.prod(sizes[a] for a in axes) != 0:
                parts.append(None)
                continue
        parts.append(axes if len(axes) > 1 else axes[0])
    return PartitionSpec(*parts)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh: MeshLike, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec``: for each mesh dimension, ``Shard(d)``
    if tensor dim ``d`` is split over it, else ``Replicate()``.  A dim split
    over several axes is ``Shard(d)`` on each, major to minor as in JAX,
    which is DTensor's order for one dim sharded on several mesh dims
    (mesh-dimension order): the spec must list them in that order."""
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {spec} lists mesh axes out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named_sharding(mesh: MeshLike, rules: Rules, logical: LogicalAxes, shape=None) -> tuple:
    """The DTensor placements of ``logical`` on ``mesh`` (the reference's
    ``NamedSharding``)."""
    return placements(mesh, spec_for(mesh, rules, logical, shape))


def local_shape(mesh: MeshLike, spec: PartitionSpec, shape: Sequence[int]) -> Tuple[int, ...]:
    """Each chip's shard of ``shape`` under ``spec``: ``shape[d] / prod(axis sizes)``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def whole_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """DTensor ``t`` gathered on tensor dim ``dim`` (replicated on every mesh
    dim that splits it)."""
    want = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)


def gather_fsdp(tree: dict, specs: dict, mesh) -> dict:
    """``tree`` (DTensors declared by ParamSpec tree ``specs``) with every
    ``fsdp`` dim gathered: one layer's weights as FSDP runs them, whole on
    their FSDP dim and still split on their tensor- and expert-parallel
    dims.  The backward of the gather is the gradients' reduce-scatter.
    ``tree`` itself with no mesh."""
    if mesh is None or mesh_size(mesh) == 1:
        return tree
    def one(t, spec):
        if not isinstance(t, DTensor):
            return t
        dims = {d for d, name in enumerate(spec.logical) if name == "fsdp"}
        want = [Replicate() if p.is_shard() and p.dim in dims else p for p in t.placements]
        return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)

    return tree_map(one, tree, specs)


def meta_dtensor(shape: Sequence[int], dtype: torch.dtype, mesh, place: tuple, make=None) -> torch.Tensor:
    """A DTensor of global ``shape`` whose local shard is a meta tensor (no
    memory): this chip's part of an argument of the dry-run.  ``make(shape,
    dtype)``, where given, makes the local shard instead (e.g. drawn from a
    seed on the card)."""
    local = list(shape)
    for i, p in enumerate(place):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    t = make(local, dtype) if make is not None else torch.empty(local, dtype=dtype, device="meta")
    return DTensor.from_local(t, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=torch.empty(shape, device="meta").stride())


def constrain(x: torch.Tensor, mesh, rules: Rules, logical: LogicalAxes) -> torch.Tensor:
    """``x`` redistributed to the placements of ``logical`` (the reference's
    ``with_sharding_constraint``); a no-op with no mesh or on one device.  A
    plain tensor under a mesh is taken as replicated."""
    if mesh is None or mesh_size(mesh) == 1:
        return x
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, named_sharding(mesh, rules, logical, x.shape))


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declared parameter: shape + logical axes + initializer family."""

    shape: Tuple[int, ...]
    logical: LogicalAxes
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0
    keep_f32: bool = False  # stored in float32 whatever the model dtype

    def std(self) -> float:
        # fan-in from the first non-stacked dim ("layers" is a batch of
        # independent layer weights, not an input dimension)
        start = 1 if (self.logical and self.logical[0] == "layers") else 0
        dims = self.shape[start:]
        fan_in = dims[0] if len(dims) > 1 else max(dims[0] if dims else 1, 1)
        return self.scale / math.sqrt(fan_in)

    def initialize(self, gen: torch.Generator, dtype: torch.dtype, device) -> torch.Tensor:
        dtype = torch.float32 if self.keep_f32 else dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        # drawn in float32 and then rounded, so one seed gives the same
        # weights in every dtype
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32, device=device)
        return x.mul_(self.std()).to(dtype)


def tree_items(tree, prefix: str = ""):
    """``(dotted key, leaf)`` pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from tree_items(v, key + ".")
        else:
            yield key, v


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of a nested dict, with the leaves at the
    same keys of the trees ``rest`` as further arguments."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def init_params(tree, gen: torch.Generator, dtype: torch.dtype, device) -> dict:
    """Initialize a (nested dict) tree of ParamSpec into tensors on ``device``.

    Leaves are drawn one after another from ``gen`` in the tree's order;
    ``gen`` must live on ``device`` (``torch.Generator(device=...)``).
    """
    return tree_map(lambda spec: spec.initialize(gen, dtype, device), tree)


def param_shardings(tree, mesh: MeshLike, rules: Rules) -> dict:
    """The placements of every leaf of a ParamSpec tree."""
    return tree_map(lambda ps: named_sharding(mesh, rules, ps.logical, ps.shape), tree)


def block_index(mesh, place: Sequence, dim: int) -> int:
    """Which block of tensor dim ``dim`` this chip holds under ``place``: its
    coordinates on the mesh dims that split ``dim``, major to minor."""
    coord, block = mesh.get_coordinate(), 0
    for i, p in enumerate(place):
        if p.is_shard(dim):
            block = block * mesh.size(i) + coord[i]
    return block


def shard_of(t: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``place``: mesh
    dimensions in order, each ``Shard(d)`` taking its coordinate's block."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if p.is_shard():
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t.contiguous()


def from_whole(t: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """The whole tensor ``t`` (the same on every rank) as a DTensor placed by
    ``place``: each rank keeps its own shard; nothing is communicated."""
    return DTensor.from_local(shard_of(t, mesh, place), mesh, place, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(params: dict, mesh, rules: Rules, specs: dict) -> dict:
    """A one-card parameter tree (the same on every rank, e.g. drawn from one
    seed) as DTensors placed by ``specs``' rules (:func:`from_whole`)."""
    return tree_map(lambda t, place: from_whole(t, mesh, place), params, param_shardings(specs, mesh, rules))


def param_count(tree) -> int:
    return sum(math.prod(spec.shape) for _, spec in tree_items(tree))
