"""Parameter declaration: :class:`ParamSpec` trees, their initialisation and size.

The port's counterpart of the declaration half of ``repro.models.sharding``.
A model declares a nested dict of :class:`ParamSpec` with the reference's
names and shapes; :func:`init_params` turns it into tensors on one device
from an explicit :class:`torch.Generator`.  The mesh rules (``DEFAULT_RULES``,
``spec_for``, ``constrain``) wait for the ``torch.distributed`` slice
(ROADMAP A.6); on one card every parameter is whole.

Dtype rule: the reference keeps its parameters in float32 and casts every
weight to the activation dtype at each use.  The port stores the matrices in
the model dtype once, and keeps in float32 the leaves the reference reads in
float32 (``keep_f32``: the norm scales, ``a_log``, ``dt_bias``, ``d_skip``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

LogicalAxes = Tuple[Optional[str], ...]


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


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def init_params(tree, gen: torch.Generator, dtype: torch.dtype, device) -> dict:
    """Initialize a (nested dict) tree of ParamSpec into tensors on ``device``.

    Leaves are drawn one after another from ``gen`` in the tree's order;
    ``gen`` must live on ``device`` (``torch.Generator(device=...)``).
    """
    return tree_map(lambda spec: spec.initialize(gen, dtype, device), tree)


def param_count(tree) -> int:
    return sum(math.prod(spec.shape) for _, spec in tree_items(tree))
