"""Distributed Krylov solver workload over the node-aware exchange.

CG / BiCGStab re-run ONE cached exchange plan per iteration, with matvecs on
:class:`repro_torch.sparse.spmv.DistributedSpMV` (or the numpy
:class:`NumpySpMV`) and scalar reductions through the node-aware
hierarchical tree (:mod:`repro_torch.solve.reductions`): host loops in
:mod:`repro_torch.solve.krylov`, whole solves on the device as replayed CUDA
graphs in :mod:`repro_torch.solve.fused`.
"""

from repro_torch.solve.fused import FUSED_SOLVERS, fused_bicgstab, fused_cg
from repro_torch.solve.krylov import (
    MATVECS_PER_ITER,
    REDUCTIONS_PER_ITER,
    STALL_WINDOW,
    SolveResult,
    bicgstab,
    cg,
)
from repro_torch.solve.operator import (
    NumpySpMV,
    TraceableOperator,
    build_numpy,
    traceable_operator,
)
from repro_torch.solve.problems import shifted_system, spd_system
from repro_torch.solve.reductions import (
    GroupReductions,
    NumpyReductions,
    TorchReductions,
    default_reductions,
    traceable_dot,
)

__all__ = [
    "FUSED_SOLVERS",
    "fused_bicgstab",
    "fused_cg",
    "MATVECS_PER_ITER",
    "REDUCTIONS_PER_ITER",
    "STALL_WINDOW",
    "SolveResult",
    "bicgstab",
    "cg",
    "NumpySpMV",
    "TraceableOperator",
    "build_numpy",
    "traceable_operator",
    "shifted_system",
    "spd_system",
    "GroupReductions",
    "NumpyReductions",
    "TorchReductions",
    "default_reductions",
    "traceable_dot",
]
