"""AdamW with a warmup-cosine schedule and global-norm clipping.

The port of ``repro.optim``: plain functions over trees (nested dicts) of
tensors.  The optimizer state mirrors the parameter tree leaf for leaf; the
update is elementwise.
"""

from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    warmup_cosine,
)

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
]
