"""Deterministic synthetic token pipeline (resumable).

Batches are a pure function of ``(seed, step)``, so a restart from a
checkpoint reproduces the exact batch.  Tokens follow a Zipf-like
distribution with a short learnable n-gram structure so the loss actually
decreases during training runs.
"""

from repro_torch.data.synthetic import SyntheticTokens

__all__ = ["SyntheticTokens"]
