"""The port of ``repro.data.synthetic``: the reference's numpy recipe, the
batch handed over as int64 tensors on one device.

The reference's mesh arguments are gone: the batch is made whole, and a
sharded step places it by ``repro_torch.runtime.trainer.batch_sharding``.
The values equal the reference's int32 arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass
class SyntheticTokens:
    """Deterministic ``(seed, step) -> {tokens, labels}`` batch source.

    ``device`` defaults to the CUDA device (and raises without one).
    """

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, int(step)]))
        # Zipf-ish marginal + deterministic bigram: next ~ (3*prev + noise)
        base = rng.zipf(1.3, size=(self.batch, self.seq_len + 1)) % self.vocab_size
        noise = rng.integers(0, 7, size=base.shape)
        seq = (3 * np.roll(base, 1, axis=1) + noise) % self.vocab_size
        seq[:, 0] = base[:, 0]
        seq = torch.as_tensor(seq.astype(np.int64)).to(self.device)
        return {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
