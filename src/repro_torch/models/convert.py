"""Carry the reference's weights into the port.

:func:`from_reference` takes a parameter tree made by the JAX package's
``LMModel.init`` -- handed over as nested dicts of numpy arrays, for example
``jax.tree.map(np.asarray, params)`` -- and returns the port's tree of
tensors.  Keys and stacked ``[count, ...]`` shapes map one to one; any
missing or extra key, or any shape that differs, raises.  It reads numpy
only and never JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.sharding import tree_items


def from_reference(model, tree, device: DeviceLike = None, dtype: Optional[torch.dtype] = None) -> dict:
    """The port's parameters for ``model`` from the reference tree ``tree``.

    Leaves the port keeps in float32 (norm scales, MLA's ``kv_norm`` among
    them, ``a_log``, ``dt_bias``, ``d_skip``) stay float32; every other leaf is cast to ``dtype``
    (default: the model's).  ``device`` defaults to the CUDA device.
    """
    device = resolve_device(device)
    dtype = dtype or model.dtype
    specs = dict(tree_items(model.param_specs()))
    given = dict(tree_items(tree))
    missing = sorted(set(specs) - set(given))
    extra = sorted(set(given) - set(specs))
    if missing or extra:
        raise KeyError(f"from_reference: missing keys {missing}, extra keys {extra}")
    out: dict = {}
    for key, spec in specs.items():
        arr = np.asarray(given[key])
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"from_reference: {key} has shape {arr.shape}, the port wants {spec.shape}")
        leaf_dtype = torch.float32 if spec.keep_f32 else dtype
        t = torch.as_tensor(arr.astype(np.float32)).to(device=device, dtype=leaf_dtype)
        node = out
        *path, name = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[name] = t
    return out
