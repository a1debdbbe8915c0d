"""``stencil3d_dof_spd``: a 27-point stencil on a ``side^3`` grid with
``dof`` unknowns per node (every unknown of a node couples to every unknown
of its 27 neighbours, itself included), with ``stencil2d_spd``'s law:
symmetric weights ``(|a| + |a^T|) / 2`` of N(0, 1) draws and a diagonal of
``shift`` plus the row's weights.  Written straight in CSR order, with no
sort through COO, so that it stays quick at 74 million nonzeros.  Sizes:
``side``, ``dof``, ``shift``."""

from __future__ import annotations

import numpy as np

from portbench.inputs import CSR, host_rng


#: the 27 node offsets ``(dz, dy, dx)`` in lexicographic order, which is
#: the order of the neighbour's node number ``x + side * (y + side * z)``
OFFSETS_3D = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def make(cfg: dict, seed: int) -> CSR:
    S, dof, shift = int(cfg["side"]), int(cfg["dof"]), float(cfg["shift"])
    nodes = S ** 3
    rng = host_rng(seed, 0)
    # a[node, o, d, e]: the draw for unknown d of node to unknown e of its
    # neighbour o; the weight is the mean of |a| and of its mirror's |a|
    a = rng.standard_normal((S, S, S, 27, dof, dof), dtype=np.float32)
    np.abs(a, out=a)
    w = np.zeros_like(a)
    valid = np.zeros((S, S, S, 27), dtype=bool)
    for o, (dz, dy, dx) in enumerate(OFFSETS_3D):
        here = tuple(slice(max(0, -d), S - max(0, d)) for d in (dz, dy, dx))
        there = tuple(slice(s.start + d, s.stop + d) for s, d in zip(here, (dz, dy, dx)))
        mirror = a[there + (26 - o,)].swapaxes(-1, -2)
        w[here + (o,)] = 0.5 * (a[here + (o,)] + mirror)
        valid[here + (o,)] = True
    del a
    centre = OFFSETS_3D.index((0, 0, 0))
    diag_idx = np.arange(dof)
    w[..., centre, diag_idx, diag_idx] = 0.0
    # [node, d, o, e]: the row-major CSR order (row (node, d), column
    # (node + offset(o), e) increasing)
    w = w.reshape(nodes, 27, dof, dof).transpose(0, 2, 1, 3)
    degree = w.sum(axis=(2, 3), dtype=np.float64)  # [nodes, dof]
    vals = np.negative(w)  # a C-ordered copy
    vals[:, diag_idx, centre, diag_idx] = (shift + degree).astype(np.float32)
    del w
    keep = np.broadcast_to(valid.reshape(nodes, 1, 27, 1), vals.shape)
    data = vals[keep]
    del vals
    step = np.array([dz * S * S + dy * S + dx for dz, dy, dx in OFFSETS_3D], dtype=np.int32)
    node = np.arange(nodes, dtype=np.int32)
    cols = ((node[:, None, None, None] + step[None, None, :, None]) * dof
            + np.arange(dof, dtype=np.int32)[None, None, None, :])
    indices = np.broadcast_to(cols, keep.shape)[keep]
    per_row = np.repeat(valid.reshape(nodes, 27).sum(axis=1) * dof, dof)
    indptr = np.zeros(nodes * dof + 1, dtype=np.int64)
    np.cumsum(per_row, out=indptr[1:])
    return CSR(n=nodes * dof, indptr=indptr, indices=indices.astype(np.int32, copy=False), data=data)


def nnz(side: int, dof: int) -> int:
    """Stored nonzeros of :func:`stencil3d_dof_spd`: ``dof^2`` per ordered
    pair of neighbouring nodes (a node is its own neighbour)."""
    return dof * dof * (3 * side - 2) ** 3
