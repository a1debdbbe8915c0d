"""Distributed Krylov solvers over the node-aware exchange (CG, BiCGStab).

The workload the paper's closing discussion argues the strategy choice must
be judged on: an iterative solver re-runs ONE irregular exchange pattern
hundreds of times, so strategy setup cost amortizes while per-iteration
exchange and reduction latency multiply.  Both solvers here:

* run their matvecs through a distributed SpMV operator
  (:class:`repro_torch.sparse.spmv.DistributedSpMV`, any strategy,
  ``overlap=True`` supported) whose ONE cached exchange plan serves every
  iteration (``repro_torch.comm.cache_stats()`` shows exactly one plan miss
  per barrier solve);
* keep ``x, r, p, ...`` as tensors on the operator's device;
* route every dot product / norm through the node-aware hierarchical
  reductions (:mod:`repro_torch.solve.reductions`: rank partials -> per-pod
  sums -> world sum, in float64), one host scalar per dot;
* record the relative-residual history so convergence trajectories can be
  compared bitwise across strategies and barrier-vs-overlap execution.

The iteration loops run on the host: host-level scalars keep the control
flow (convergence tests, breakdown guards) exact and executor-independent.
:mod:`repro_torch.solve.fused` runs the same iterations, op for op, as
replayed CUDA graphs with no host read per iteration; its residual
histories equal these loops' bitwise.  Either operator flavor works here:
:class:`~repro_torch.sparse.spmv.DistributedSpMV` or the numpy
:class:`~repro_torch.solve.operator.NumpySpMV`.
Strategy selection for a whole solve (setup amortization, reduction latency)
lives in :func:`repro_torch.core.advisor.advise_solver`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.solve.reductions import default_reductions

#: scalar all-reduces each solver issues per iteration (dot products and
#: norms, counting a norm as one dot) -- the ``reductions_per_iter`` input
#: of :func:`repro_torch.core.advisor.advise_solver`
REDUCTIONS_PER_ITER = {"cg": 2.0, "bicgstab": 6.0}

#: matvecs (= irregular exchanges) each solver issues per iteration
MATVECS_PER_ITER = {"cg": 1.0, "bicgstab": 2.0}

#: iterations without a new best residual before a solve is declared
#: stagnant (and restarted once from the best iterate)
STALL_WINDOW = 50


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Outcome of one Krylov solve.

    ``x`` is a tensor on the operator's device.  ``residuals[i]`` is the
    *relative* recursive residual norm ``||r_i|| / ||b||`` after ``i``
    iterations (``residuals[0]`` is the starting residual), computed with
    the solver's own reductions -- bitwise identical across strategies and
    barrier-vs-overlap execution.

    ``status`` names how the solve ended: ``"converged"``, ``"maxiter"``,
    a breakdown reason (``"breakdown:indefinite"``, ``"breakdown:rho"``,
    ``"breakdown:omega"``, ``"breakdown:denom"``, ``"breakdown:tt"``,
    ``"breakdown:nonfinite"``, ``"stagnation"``), with a ``"+restart"``
    suffix when the solver restarted from its best iterate and a
    ``"+exchange:<action>:<strategy>/<codec>"`` suffix when the operator's
    exchange recovered through the fault ladder
    (:func:`repro_torch.comm.faults.run_ladder`) during the solve.
    """

    x: torch.Tensor
    converged: bool
    iterations: int
    residuals: Tuple[float, ...]
    matvecs: int
    status: str = "converged"
    restarts: int = 0

    @property
    def final_residual(self) -> float:
        return self.residuals[-1]


def _recovery_baseline(op) -> int:
    health = getattr(op, "health", None)
    return health.recovery_count if health is not None else 0


def _finish_status(status: str, restarts: int, op, rc0: int) -> str:
    if restarts:
        status += "+restart"
    health = getattr(op, "health", None)
    if health is not None and health.recovery_count > rc0 and health.last_recovery:
        status += "+exchange:" + health.last_recovery
    return status


def _apply(op, v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``op(v)`` as a tensor of ``dtype`` (a
    :class:`~repro_torch.solve.operator.NumpySpMV` returns an array)."""
    return torch.as_tensor(op(v)).to(dtype)


def _prepare(op, b, x0, reductions):
    red = default_reductions(op) if reductions is None else reductions
    device = getattr(op, "device", torch.device("cpu"))
    b = torch.as_tensor(b, device=device).contiguous()
    # the ranks this process holds: every one, or one under a process group
    g, L = getattr(op, "ranks_held", op.topo.nranks), op.rows_per_rank
    if tuple(b.shape) != (g, L):
        raise ValueError(f"b must be [{g}, {L}], got {tuple(b.shape)}")
    if x0 is None:
        x = torch.zeros_like(b)
    else:
        x = torch.as_tensor(x0, dtype=b.dtype, device=device).clone()
    bnorm = red.norm(b)
    return red, b, x, bnorm


def cg(
    op,
    b,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 500,
    reductions=None,
) -> SolveResult:
    """Conjugate gradients for a symmetric positive-definite operator.

    ``op`` is a distributed SpMV (``[nranks, L] -> [nranks, L]``); one
    matvec -- one irregular exchange under the single cached plan -- and two
    hierarchical reductions per iteration.  Build an SPD system from any
    generator matrix with :func:`repro_torch.solve.problems.spd_system`.

    Non-finite residuals and stagnation (no new best residual within
    :data:`STALL_WINDOW` iterations) trigger ONE restart from the best
    iterate with a true-residual recompute ``r = b - A x``; a second
    trip ends the solve with the reason in ``SolveResult.status``.
    """
    red, b, x, bnorm = _prepare(op, b, x0, reductions)
    rc0 = _recovery_baseline(op)
    if bnorm == 0.0:
        return SolveResult(x=torch.zeros_like(b), converged=True, iterations=0,
                           residuals=(0.0,), matvecs=0,
                           status=_finish_status("converged", 0, op, rc0))
    matvecs = 0
    if x0 is None:
        r = b.clone()
    else:
        r = b - _apply(op, x, b.dtype)
        matvecs += 1
    p = r.clone()
    rs = red.dot(r, r)
    hist = [math.sqrt(max(rs, 0.0)) / bnorm]
    if hist[-1] <= tol:
        return SolveResult(x=x, converged=True, iterations=0,
                           residuals=tuple(hist), matvecs=matvecs,
                           status=_finish_status("converged", 0, op, rc0))
    it = 0
    converged = False
    restarts = 0
    status = "maxiter"
    best, best_x, best_it = hist[-1], x.clone(), 0
    while it < maxiter:
        Ap = _apply(op, p, b.dtype)
        matvecs += 1
        pAp = red.dot(p, Ap)
        if pAp <= 0.0:  # breakdown / loss of positive definiteness
            status = "breakdown:indefinite"
            break
        alpha = rs / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = red.dot(r, r)
        it += 1
        hist.append(math.sqrt(max(rs_new, 0.0)) / bnorm)
        if hist[-1] <= tol:
            converged = True
            break
        if hist[-1] < best:
            best, best_x, best_it = hist[-1], x.clone(), it
        bad = None
        if not math.isfinite(hist[-1]):
            bad = "breakdown:nonfinite"
        elif it - best_it >= STALL_WINDOW:
            bad = "stagnation"
        if bad is not None:
            if restarts:
                status = bad
                break
            # one restart from the best iterate: true-residual recompute
            restarts += 1
            x = best_x.clone()
            r = b - _apply(op, x, b.dtype)
            matvecs += 1
            p = r.clone()
            rs = red.dot(r, r)
            hist.append(math.sqrt(max(rs, 0.0)) / bnorm)
            best, best_it = hist[-1], it
            if hist[-1] <= tol:
                converged = True
                break
            if not math.isfinite(hist[-1]):
                status = bad
                break
            continue
        p = r + (rs_new / rs) * p
        rs = rs_new
    if converged:
        status = "converged"
    return SolveResult(x=x, converged=converged, iterations=it,
                       residuals=tuple(hist), matvecs=matvecs,
                       status=_finish_status(status, restarts, op, rc0),
                       restarts=restarts)


def bicgstab(
    op,
    b,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 500,
    reductions=None,
) -> SolveResult:
    """BiCGStab for a general (nonsymmetric) operator.

    Two matvecs -- two exchanges under the same single cached plan -- and
    six hierarchical reductions per iteration.  Build a well-posed
    nonsymmetric system with :func:`repro_torch.solve.problems.shifted_system`.

    Breakdown guards are tolerance-scaled (machine-eps relative to the
    quantities each ratio divides), not exact-zero tests, so near-breakdown
    no longer silently truncates the history: the first trip restarts once
    from the best iterate (true-residual recompute), the second ends the
    solve with the reason in ``SolveResult.status``.
    """
    red, b, x, bnorm = _prepare(op, b, x0, reductions)
    rc0 = _recovery_baseline(op)
    if bnorm == 0.0:
        return SolveResult(x=torch.zeros_like(b), converged=True, iterations=0,
                           residuals=(0.0,), matvecs=0,
                           status=_finish_status("converged", 0, op, rc0))
    eps = float(torch.finfo(b.dtype).eps)
    matvecs = 0
    if x0 is None:
        r = b.clone()
    else:
        r = b - _apply(op, x, b.dtype)
        matvecs += 1
    rhat = r.clone()
    rho = alpha = omega = 1.0
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    hist = [red.norm(r) / bnorm]
    if hist[-1] <= tol:
        return SolveResult(x=x, converged=True, iterations=0,
                           residuals=tuple(hist), matvecs=matvecs,
                           status=_finish_status("converged", 0, op, rc0))
    rhat_nrm = hist[0] * bnorm  # ||rhat|| is fixed at ||r_0||
    it = 0
    converged = False
    restarts = 0
    status = "maxiter"
    best, best_x, best_it = hist[-1], x.clone(), 0
    while it < maxiter:
        rho_new = red.dot(rhat, r)
        r_nrm = hist[-1] * bnorm  # recursive residual norm, no extra reduce
        bad = None
        # |<rhat, r>| can only be meaningful above eps * ||rhat|| * ||r||
        if abs(rho_new) <= eps * rhat_nrm * r_nrm:
            bad = "breakdown:rho"
        elif abs(omega) <= eps * abs(alpha):
            bad = "breakdown:omega"
        if bad is None:
            beta = (rho_new / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
            v = _apply(op, p, b.dtype)
            matvecs += 1
            denom = red.dot(rhat, v)
            # alpha = rho_new / denom would exceed 1/eps
            if abs(denom) <= eps * abs(rho_new):
                bad = "breakdown:denom"
        if bad is None:
            alpha = rho_new / denom
            s = r - alpha * v
            it += 1
            snorm = red.norm(s)
            if snorm / bnorm <= tol:  # first half-step already converged
                x = x + alpha * p
                hist.append(snorm / bnorm)
                converged = True
                break
            t = _apply(op, s, b.dtype)
            matvecs += 1
            tt = red.dot(t, t)
            # omega = <t, s> / tt would exceed ~1/eps relative to ||s||
            if tt <= (eps * snorm) ** 2:
                bad = "breakdown:tt"
        if bad is None:
            omega = red.dot(t, s) / tt
            x = x + alpha * p + omega * s
            r = s - omega * t
            hist.append(red.norm(r) / bnorm)
            if hist[-1] <= tol:
                converged = True
                break
            if hist[-1] < best:
                best, best_x, best_it = hist[-1], x.clone(), it
            if not math.isfinite(hist[-1]):
                bad = "breakdown:nonfinite"
            elif it - best_it >= STALL_WINDOW:
                bad = "stagnation"
            if bad is None:
                rho = rho_new
                continue
        if restarts:
            status = bad
            break
        # one restart from the best iterate: true-residual recompute
        restarts += 1
        x = best_x.clone()
        r = b - _apply(op, x, b.dtype)
        matvecs += 1
        rhat = r.clone()
        rho = alpha = omega = 1.0
        v = torch.zeros_like(b)
        p = torch.zeros_like(b)
        hist.append(red.norm(r) / bnorm)
        rhat_nrm = hist[-1] * bnorm
        best, best_it = hist[-1], it
        if hist[-1] <= tol:
            converged = True
            break
        if not math.isfinite(hist[-1]):
            status = bad
            break
    if converged:
        status = "converged"
    return SolveResult(x=x, converged=converged, iterations=it,
                       residuals=tuple(hist), matvecs=matvecs,
                       status=_finish_status(status, restarts, op, rc0),
                       restarts=restarts)
