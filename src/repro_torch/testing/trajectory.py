"""Holding one AdamW training trajectory against another.

Two correct runs of the same steps (two packages, or the CPU and the card)
agree on the loss to the rounding of their kernels, but not element for
element on the parameters: Adam divides each gradient by its own RMS, so an
element whose gradient is at the rounding noise of its sum (a sum that
nearly cancels) takes a step anywhere in ``[-lr, lr]`` in either run.

At every step, :func:`noisy_steps` marks the elements whose two runs' bias-
corrected first moments differ by more than ``NOISE_SHARE`` of a unit Adam
step (the second moment's root plus ``eps``).  :func:`compare_trajectories`
holds every element to 1e-4 of its leaf's max abs plus ``NOISE_SHARE`` of
the summed learning rate, and the marked ones to ``2 * lr_sum`` more, the
most two AdamW runs can part.  The marks excuse an element only where
noise is rare: no leaf may have more than ``MAX_MARKED_SHARE`` of its
elements marked, nor the whole tree more than 1%.  A wrong gradient (a scale, a swapped leaf) moves the
first moments of every element it reaches, so it marks the whole leaf or
layer slice, even where Adam's scale invariance hides it in the parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: the share of a unit Adam step by which the two runs' updates of an
#: element may differ before the element counts as noise-driven
NOISE_SHARE = 1e-2

#: the most of one leaf's elements that may be marked.  Sound runs mark at
#: most 0.73% of a leaf: hymba-1.5b tiny, five steps against the reference
#: (most marks come at step 5, from the steps before).  stablelm-3b marks
#: 1.2e-4 there (tiny) and 8.8e-6 on the card against the CPU (100m, three
#: steps).  A gradient scaled by 1.1 marks all of its leaf or layer slice.
MAX_MARKED_SHARE = 2e-2


def noisy_steps(acc: Optional[dict], mu_a: Dict[str, np.ndarray], mu_b: Dict[str, np.ndarray],
                nu: Dict[str, np.ndarray], step: int, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8) -> dict:
    """``acc`` (the marks of the earlier steps, or ``None``) or-ed with this
    step's: the elements whose moments ``mu_a`` and ``mu_b`` after ``step``
    steps (1-based) differ by more than ``NOISE_SHARE`` of a unit step, with
    ``nu`` either run's second moments."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    marks = {}
    for k, v in nu.items():
        diff = np.abs(np.asarray(mu_a[k], np.float64) - np.asarray(mu_b[k], np.float64)) / bc1
        marks[k] = diff > NOISE_SHARE * (np.sqrt(np.asarray(v, np.float64) / bc2) + eps)
    return marks if acc is None else {k: acc[k] | m for k, m in marks.items()}


def compare_trajectories(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                         noisy: Dict[str, np.ndarray], lr_sum: float) -> dict:
    """Parameters ``got`` after some AdamW steps against ``want``, with
    ``noisy`` the :func:`noisy_steps` marks of those steps and ``lr_sum``
    their summed learning rate.  Returns ``ok``, the leaves with elements out
    of tolerance, the leaves marked beyond ``MAX_MARKED_SHARE``, the marked
    elements in all and by leaf, the largest marked share of a leaf and its
    leaf, and the largest error over each leaf's max abs."""
    if got.keys() != want.keys():
        raise KeyError(f"leaves differ: {sorted(set(got) ^ set(want))}")
    bad, over, by_leaf, total, worst, share = {}, {}, {}, 0, 0.0, (0.0, None)
    for k, w in want.items():
        if not w.size:
            continue
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[k], np.float64) - w)
        tol = 1e-4 * np.abs(w).max() + NOISE_SHARE * lr_sum + np.where(noisy[k], 2 * lr_sum, 0.0)
        if (err > tol).any():
            bad[k] = {"elements": int((err > tol).sum()), "max_err": float(err.max())}
        n = int(noisy[k].sum())
        if n > MAX_MARKED_SHARE * w.size:
            over[k] = {"marked": n, "elements": int(w.size)}
        if n:
            by_leaf[k] = n
        total += w.size
        share = max(share, (n / w.size, k), key=lambda x: x[0])
        worst = max(worst, float(err.max() / max(np.abs(w).max(), 1e-30)))
    marked = sum(by_leaf.values())
    return {"ok": not bad and not over and marked < 0.01 * total, "out_of_tolerance": bad,
            "marked_beyond_share": over, "noise_driven": marked, "noise_driven_by_leaf": by_leaf,
            "elements": total, "max_marked_share": share[0],
            "max_marked_leaf": share[1], "max_err_over_max_abs": worst}
