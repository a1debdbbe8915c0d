"""Stage-program fusion: rewrite exchange programs to touch memory less.

Stage-program IR
----------------
A strategy plan (:class:`repro_torch.comm.exchange.StagePlan`) is a straight-line
program over a per-rank buffer ``buf`` (initially empty) and the immutable
per-rank ``local`` array.  Every stage reads ``ext = concat(buf, local)``
and replaces ``buf``:

=================  =========================================================
``Gather(idx)``    ``buf'[k] = ext[idx[k]]``; ``idx >= len(ext)`` delivers
                   PAD (zero).  Output width = ``idx.shape[1]``.
``A2ALocal(W,     ``all_to_all`` over the pod-local mesh axis on the
  idx=None)``      ``[ppn, W/ppn]`` view of ``buf``.  The optional ``idx``
                   is a Gather applied to ``ext`` *first* (the fused input
                   layout); output width = ``W``.
``A2APod(W,        same, over the pod axis on ``[npods, W/npods]``.
  idx=None)``
``PermuteWorld``   rounds of world-level ``ppermute``; round ``i`` sends
                   ``ext[sels[i]]`` along the partial permutation
                   ``rounds[i]``; the received blocks are concatenated.
                   Output width = ``sum(blks)``.
=================  =========================================================

Legal rewrites (applied by :func:`fuse`)
----------------------------------------
R1  **Gather composition.**  ``Gather(g); Gather(h) -> Gather(h ∘ g)``:
    ``h`` indexes ``concat(g_out, local)``, so positions ``< K`` route
    through ``g.idx``, positions in the local region re-base to the input
    ext's local region, and PADs stay PADs.  Associative; a whole chain of
    adjacent gathers collapses into one index map.  A zero-width gather
    composes away entirely (this is how zero-width stages are dropped).
R2  **Gather -> all-to-all folding.**  A (composed) Gather feeding an
    ``A2ALocal``/``A2APod`` becomes the collective's fused input layout
    ``idx``: one take + collective instead of materializing an
    intermediate buffer.  The bytes on the wire are unchanged -- the
    collective still moves exactly ``buflen`` elements per rank.
R3  **Gather -> permute folding.**  A pending Gather before a
    ``PermuteWorld`` is composed into every round's ``sels`` (same R1
    arithmetic), since the sels address ``ext`` of the gather's output.
R4  **No-op elimination.**  An identity Gather (``idx == arange(W)`` on a
    width-``W`` buffer) is dropped wherever it appears.

Every rewrite is *verified by construction*: :func:`fuse` runs the
vectorized token simulator over the original and rewritten programs and
requires identical final buffers, so an illegal rewrite cannot escape.
Values are checked separately by tests against
:func:`repro_torch.comm.exchange.execute_numpy` and
:meth:`ExchangePattern.reference`.

Wire cost is monotone: fusion never adds a collective, never widens one,
and drops only on-device gathers, so ``wire_*_bytes`` carry over verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.comm.exchange import (
    A2ALocal,
    A2APod,
    Gather,
    PermuteWorld,
    Stage,
    StagePlan,
    simulate_codes,
)


def compose_gathers(
    g1: np.ndarray, g2: np.ndarray, w_in: int, local_size: int
) -> np.ndarray:
    """Index map of ``Gather(g2) ∘ Gather(g1)`` relative to ``g1``'s input.

    ``g1`` reads ``ext0`` (width ``E0 = w_in + local_size``) producing a
    ``K1``-wide buffer; ``g2`` reads ``ext1 = concat(that, local)``.  The
    composition reads ``ext0`` directly.
    """
    g1 = np.asarray(g1)
    g2 = np.asarray(g2)
    K1 = g1.shape[1]
    E0 = w_in + local_size
    fused = np.full(g2.shape, E0, dtype=np.int32)  # default: PAD
    in_local = (g2 >= K1) & (g2 < K1 + local_size)
    np.copyto(fused, (g2 - K1 + w_in).astype(np.int32), where=in_local)
    in_buf = g2 < K1
    if K1:
        rows = np.arange(g1.shape[0])[:, None]
        routed = g1[rows, np.clip(g2, 0, K1 - 1)]
        np.copyto(fused, routed.astype(np.int32), where=in_buf)
    return fused


def _is_identity(idx: np.ndarray, w_in: int) -> bool:
    K = idx.shape[1]
    return K == w_in and bool((idx == np.arange(K, dtype=idx.dtype)).all())


def fuse_stages(
    stages: Tuple[Stage, ...], local_size: int
) -> Tuple[Stage, ...]:
    """Apply rewrites R1-R4 to a stage tuple (see module docstring)."""
    out: List[Stage] = []
    pending: Optional[np.ndarray] = None  # composed Gather index map
    pend_w = 0  # buffer width the pending map's indices are relative to
    w = 0  # current (pre-pending) buffer width

    def absorb(idx: np.ndarray) -> None:
        nonlocal pending, pend_w
        if pending is not None:
            pending = compose_gathers(pending, idx, pend_w, local_size)
        else:
            pending, pend_w = np.asarray(idx), w

    for st in stages:
        if isinstance(st, Gather):
            absorb(st.idx)
        elif isinstance(st, (A2ALocal, A2APod)):
            if st.idx is not None:  # re-fusing an already-fused program
                absorb(st.idx)
            if pending is not None and _is_identity(pending, pend_w):
                pending = None
            if pending is not None:
                assert pending.shape[1] == st.buflen
                out.append(dataclasses.replace(st, idx=pending))
                w, pending = st.buflen, None
            else:
                assert w == st.buflen
                out.append(dataclasses.replace(st, idx=None))
        elif isinstance(st, PermuteWorld):
            if pending is not None and _is_identity(pending, pend_w):
                pending = None
            if pending is not None:
                sels = tuple(
                    compose_gathers(pending, s, pend_w, local_size)
                    for s in st.sels
                )
                out.append(dataclasses.replace(st, sels=sels))
                pending = None
            else:
                out.append(st)
            w = sum(st.blks)
        else:
            raise TypeError(f"unknown stage {st!r}")
    if pending is not None and not _is_identity(pending, pend_w):
        out.append(Gather(idx=pending))
    return tuple(out)


def fuse(plan: StagePlan, verify: bool = True) -> StagePlan:
    """Return an equivalent plan with a fused stage program.

    ``verify=True`` (default) replays both programs through the vectorized
    token simulator and asserts identical final buffers -- fusion is
    correct by construction or it refuses to return.

    Planning and fusion are pure numpy, so this runs without any devices:

    >>> import numpy as np
    >>> from repro_torch.comm.exchange import plan, random_pattern
    >>> from repro_torch.comm.topology import PodTopology
    >>> pat = random_pattern(np.random.default_rng(0),
    ...                      PodTopology(npods=2, ppn=2), local_size=4)
    >>> sp = plan("two_step", pat)
    >>> fused = fuse(sp)
    >>> fused.fused and len(fused.stages) < len(sp.stages)
    True
    >>> fused.wire_inter_pod_bytes == sp.wire_inter_pod_bytes  # wire cost kept
    True
    """
    stages = fuse_stages(plan.stages, plan.pattern.local_size)
    fused = dataclasses.replace(plan, stages=stages, fused=True)
    if verify:
        want = simulate_codes(plan)
        got = simulate_codes(fused)
        if want.shape != got.shape or not np.array_equal(want, got):
            raise AssertionError(
                f"fusion changed delivery for strategy {plan.strategy!r}"
            )
    return fused
