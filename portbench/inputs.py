"""The benchmark's sparse systems, made on the host from the seed.

Each configuration file names a ``generator``, a module of
``portbench/generators/`` whose ``make(cfg, seed)`` returns the matrix as a
:class:`CSR` in row order, with strictly increasing columns in every row.
They are the benchmark's own: the program's generators may change without
moving the yardstick.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np


class CSR(NamedTuple):
    n: int
    indptr: np.ndarray  # [n + 1] int64
    indices: np.ndarray  # [nnz] int32
    data: np.ndarray  # [nnz] float32

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of the run's ``seed``;
    any whole number, negative or wider than 64 bits, is a valid seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 128), stream]))


def device_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` for one use of ``seed``."""
    return int(np.random.SeedSequence([seed % (1 << 128), stream]).generate_state(1, np.uint64)[0] >> 1)


def make_system(cfg: dict, seed: int) -> CSR:
    """The configuration's matrix for ``seed``."""
    return importlib.import_module(f"portbench.generators.{cfg['generator']}").make(cfg, seed)
