"""Pieces the traffic drivers share."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import numpy as np
import torch


def program_csr(A):
    """The benchmark's CSR as the program's own matrix type."""
    from repro_torch.sparse import CSRMatrix

    return CSRMatrix(n=A.n, indptr=A.indptr, indices=A.indices, data=A.data)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Done:
    """Marks the end of the device work queued so far: a CUDA event, or
    nothing to wait for off the card (where work ends as it is called)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def query(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn by ``rng``;
    ``make()`` builds an item only when it is kept."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List = []

    def offer(self, make: Callable[[], object]) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = make()


def worst(a: float, b: float) -> float:
    """The larger of two readings, a NaN above every number."""
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return max(a, b)


def misses(before, after) -> dict:
    """The program's cache misses between two ``cache_stats()`` snapshots."""
    a, b = dataclasses.asdict(before), dataclasses.asdict(after)
    return {k: b[k] - a[k] for k in a if k.endswith("_misses") and b[k] != a[k]}
