"""Distributed Krylov solver workload over the node-aware exchange.

CG / BiCGStab re-run ONE cached exchange plan per iteration
(:mod:`repro_torch.solve.krylov`), with matvecs on
:class:`repro_torch.sparse.spmv.DistributedSpMV` and scalar reductions
through the node-aware hierarchical tree (:mod:`repro_torch.solve.reductions`).
"""

from repro_torch.solve.krylov import (
    MATVECS_PER_ITER,
    REDUCTIONS_PER_ITER,
    STALL_WINDOW,
    SolveResult,
    bicgstab,
    cg,
)
from repro_torch.solve.problems import shifted_system, spd_system
from repro_torch.solve.reductions import (
    NumpyReductions,
    TorchReductions,
    default_reductions,
    traceable_dot,
)

__all__ = [
    "MATVECS_PER_ITER",
    "REDUCTIONS_PER_ITER",
    "STALL_WINDOW",
    "SolveResult",
    "bicgstab",
    "cg",
    "shifted_system",
    "spd_system",
    "NumpyReductions",
    "TorchReductions",
    "default_reductions",
    "traceable_dot",
]
