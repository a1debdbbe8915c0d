"""Checkpointing with atomic commits and an async writer.

Checkpoints store every leaf as a whole array (one npz keyed by the leaf's
tree path) plus a JSON manifest (step, extra).  The on-disk format is the
reference's (``repro.checkpoint``), key for key, so either package resumes
what the other wrote.  Commits are atomic (write to ``<dir>.tmp`` then
``os.replace``), so a crash mid-save never corrupts the latest checkpoint;
the async writer overlaps the file write with the next training steps and
is joined before the next save (bounded memory).
"""

from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    flatten_state,
    latest_step,
    load_checkpoint,
    map_state,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "flatten_state",
    "latest_step",
    "load_checkpoint",
    "map_state",
    "save_checkpoint",
]
