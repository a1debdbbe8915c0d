"""The port's Krylov solvers against the JAX package's.

* On float32 systems the port's ``cg`` / ``bicgstab`` on
  ``DistributedSpMV(device="cpu")`` end like the reference solvers on
  ``repro.solve.NumpySpMV``: the same status, iterations within one, and
  ``x`` within 1e-4 of it (the two operators round a row's sum in different
  orders, and the reductions sum in different orders).
* Inside the port, residual histories are bitwise identical across every
  strategy and barrier-vs-overlap execution.
* A barrier solve plans exactly once.
"""

import numpy as np
import pytest
import torch

from repro.comm.topology import PodTopology as RefTopology
from repro.solve import NumpySpMV
from repro.solve import bicgstab as ref_bicgstab
from repro.solve import cg as ref_cg
from repro.solve import shifted_system as ref_shifted_system
from repro.solve import spd_system as ref_spd_system
from repro.sparse import partition_csr as ref_partition_csr
from repro.sparse.matrices import GENERATORS as REF_GENERATORS
from repro_torch.comm import STRATEGY_NAMES, PodTopology, cache_stats, clear_caches
from repro_torch.solve import (
    STALL_WINDOW,
    NumpyReductions,
    TorchReductions,
    bicgstab,
    cg,
    default_reductions,
    shifted_system,
    spd_system,
)
from repro_torch.sparse import GENERATORS, DistributedSpMV, partition_csr

TOPO = PodTopology(npods=2, ppn=4)
REF_TOPO = RefTopology(npods=2, ppn=4)
N = 144
X_TOL = 1e-4
SOLVERS = {
    "cg": (cg, ref_cg, spd_system, ref_spd_system),
    "bicgstab": (bicgstab, ref_bicgstab, shifted_system, ref_shifted_system),
}


def _system(solver, name, seed):
    _, _, make, ref_make = SOLVERS[solver]
    A = make(GENERATORS[name](N, np.random.default_rng(seed)))
    RA = ref_make(REF_GENERATORS[name](N, np.random.default_rng(seed)))
    b = np.random.default_rng(seed + 50).normal(size=(TOPO.nranks, N // TOPO.nranks))
    return A, RA, b.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_solver_matches_reference(solver, name, seed):
    port_solve, ref_solve, _, _ = SOLVERS[solver]
    A, RA, b = _system(solver, name, seed)
    op = DistributedSpMV(partition_csr(A, TOPO), strategy="two_step", device="cpu")
    ref_op = NumpySpMV(ref_partition_csr(RA, REF_TOPO), strategy="two_step")
    got = port_solve(op, b, tol=1e-5, maxiter=400)
    want = ref_solve(ref_op, b, tol=1e-5, maxiter=400)
    assert got.status == want.status
    assert abs(got.iterations - want.iterations) <= 1, (got.iterations, want.iterations)
    assert isinstance(got.x, torch.Tensor) and got.x.dtype == torch.float32
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=X_TOL, atol=X_TOL)
    if got.converged:
        # the recursive residual is honest: recompute the true one
        r = b.reshape(-1).astype(np.float64) - RA.spmv(got.x.numpy().reshape(-1)).astype(np.float64)
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_histories_bitwise_across_strategies_and_overlap(solver):
    port_solve, _, make, _ = SOLVERS[solver]
    A = make(GENERATORS["audikw_like"](N, np.random.default_rng(9)))
    part = partition_csr(A, TOPO)
    b = np.random.default_rng(10).normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    runs = {}
    for strategy in STRATEGY_NAMES:
        for overlap in (False, True):
            op = DistributedSpMV(part, strategy=strategy, overlap=overlap, device="cpu")
            runs[(strategy, overlap)] = port_solve(op, b, tol=1e-6, maxiter=300)
    first = runs[("standard", False)]
    assert first.converged
    for key, res in runs.items():
        assert res.residuals == first.residuals, key
        assert torch.equal(res.x, first.x), key
        assert (res.status, res.matvecs) == (first.status, first.matvecs), key


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_one_plan_miss_per_solve(solver):
    port_solve, _, make, _ = SOLVERS[solver]
    A = make(GENERATORS["thermal_like"](256, np.random.default_rng(11)))
    part = partition_csr(A, TOPO)
    b = np.random.default_rng(12).normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    clear_caches()
    res = port_solve(DistributedSpMV(part, strategy="split", device="cpu"), b, tol=1e-6)
    s = cache_stats()
    assert res.converged and res.matvecs > 5
    assert (s.plan_misses, s.plan_hits, s.split_misses) == (1, 0, 0), s
    port_solve(DistributedSpMV(part, strategy="split", device="cpu"), b, tol=1e-6)
    s = cache_stats()
    assert (s.plan_misses, s.plan_hits) == (1, 1), s
    clear_caches()


def test_reductions_follow_the_numpy_tree():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(TOPO.nranks, 9))
    y = rng.normal(size=(TOPO.nranks, 9))
    want = NumpyReductions(TOPO).dot(x, y)
    got = TorchReductions(TOPO).dot(torch.as_tensor(x), torch.as_tensor(y))
    assert got == pytest.approx(want, rel=1e-14)
    assert TorchReductions(TOPO).norm(torch.as_tensor(x)) == pytest.approx(
        NumpyReductions(TOPO).norm(x), rel=1e-14
    )
    A = spd_system(GENERATORS["thermal_like"](N, rng))
    op = DistributedSpMV(partition_csr(A, TOPO), strategy="standard", device="cpu")
    assert isinstance(default_reductions(op), TorchReductions)


def test_zero_rhs_and_start_guess():
    A = spd_system(GENERATORS["thermal_like"](N, np.random.default_rng(13)))
    op = DistributedSpMV(partition_csr(A, TOPO), strategy="standard", device="cpu")
    zero = cg(op, np.zeros((TOPO.nranks, N // TOPO.nranks), np.float32))
    assert zero.converged and zero.iterations == 0 and zero.residuals == (0.0,)
    b = np.ones((TOPO.nranks, N // TOPO.nranks), np.float32)
    solved = cg(op, b, tol=1e-6)
    again = cg(op, b, x0=solved.x, tol=1e-5)
    assert again.converged and again.iterations <= 1 and again.matvecs >= 1
    assert STALL_WINDOW == 50
    with pytest.raises(ValueError):
        cg(op, np.ones((TOPO.nranks, 3), np.float32))
