"""Mesh builder of the training launcher, for one card.

The reference builds a ``jax`` mesh of ``DATA x MODEL`` devices.  The port
holds the whole train state on one card, so the only mesh it takes is
``1x1``; a mesh of several cards waits for the ``torch.distributed`` slice
(ROADMAP A.6).
"""

from __future__ import annotations


def make_host_mesh(data: int = 1, model: int = 1) -> None:
    """``None`` (one card, no mesh) for ``1x1``; anything else raises."""
    if (data, model) != (1, 1):
        raise ValueError(
            f"mesh {data}x{model}: the port trains on one card (mesh 1x1); meshes of "
            "several cards wait for ROADMAP A.6"
        )
    return None
