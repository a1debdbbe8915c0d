"""AdamW + schedule + clipping over trees of tensors.

The port of ``repro.optim.adamw`` with the reference's arithmetic and order:
the gradients are clipped to a global norm first, then the step count
advances, the bias corrections are taken in float32, and the weight decay
sits inside ``delta``.  Every scalar that divides is a 0-d float32 tensor
on the parameters' device: CUDA divides by a Python scalar as a multiply
by its reciprocal, which would round differently from the reference.

:func:`adamw_update` writes the parameters and both moments **in place**
and returns the same trees: at stablelm-3b the float32 masters and moments
are 33.5 GB, and a functional update would hold a second copy of them.  It
runs one leaf at a time (a model has a few large stacked leaves), so the
temporaries of the update are those of one leaf; ``torch._foreach_*`` would
allocate them for every leaf at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.sharding import tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # first moments (tree like params), float32
    nu: Any  # second moments


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as a 0-d float32 tensor."""
    step = step.float()
    warm = step / _f32(max(cfg.warmup_steps, 1), step)
    t = (step - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, norm) / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(``tree`` scaled to a global norm of at most ``max_norm``, its norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), tree), norm


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = _leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (params, new state, metrics); ``params``
    (float32, as the reference's) and the moments are updated in place.

    ``grads`` may be in a narrower dtype than the parameters (a bfloat16
    working copy's): each leaf is widened to float32 before it is clipped,
    which is exact, so the arithmetic is the reference's on float32
    gradients.
    """
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - _f32(b1, stepf) ** stepf
    bc2 = 1 - _f32(b2, stepf) ** stepf
    flat_g = _leaves(grads)
    flat_m, flat_v = _leaves(state.mu), _leaves(state.nu)
    for p, g, m, v in zip(_leaves(params), flat_g, flat_m, flat_v):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        del g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat.div_(vhat.sqrt_().add_(cfg.eps))
        del vhat
        delta.add_(cfg.weight_decay * p)
        p.sub_(delta.mul_(lr))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, mu=state.mu, nu=state.nu), metrics
