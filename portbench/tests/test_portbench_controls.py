"""The comparison that decides ``correct`` fails what it must: the control
(the reference in bfloat16 in the program's place) and a run whose timed
path is broken underneath.  On the CPU at small sizes; the harness's look
for a card is skipped by calling :func:`portbench.run.run_cell` directly."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import controls, run  # noqa: E402

SMALL = {
    "thermal2.cg": {"generator": "stencil2d_spd", "side": 48, "shift": 1.0, "npods": 2, "ppn": 2,
                    "offsets": [[1, 0], [-1, 0], [0, 1], [0, -1], [1, 1], [-1, -1]]},
    "audikw1.spmv_serve": {"generator": "stencil3d_dof_spd", "side": 6, "dof": 3, "shift": 1.0,
                           "npods": 2, "ppn": 2},
}


def limits(workload):
    return run.load_json(run.HERE / "limits" / f"{workload}.json")["limits"]


def fails(numbers: dict, lim: dict) -> list:
    return [k for k in lim if not numbers[k] <= lim[k]]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_program_passes_and_the_control_fails(workload):
    got = controls.readings(workload, 2**31 + 11, 0.5, True, "cpu", config=SMALL[workload])
    lim = limits(workload)
    assert fails(got["program"], lim) == []
    assert fails({**got["program"], **got["control"]}, lim) != []


def run_broken(workload):
    return run.run_cell(workload, 77, 0.4, False, "cpu", config=SMALL[workload])


def test_an_unbroken_run_is_correct():
    for workload in SMALL:
        assert run_broken(workload)["correct"]


# -- faults planted in the program's timed path ------------------------------


def halo_left_out(monkeypatch):
    """The exchange left out: every off-rank product comes out zero."""
    import repro_torch.sparse as S

    real = S.partition_csr

    def partition(A, topo):
        part = real(A, topo)
        off = dataclasses.replace(part.off, data=part.off.data * 0)
        return dataclasses.replace(part, off=off)

    monkeypatch.setattr(S, "partition_csr", partition)


def wrap_solve(monkeypatch, change):
    from repro_torch.solve import FUSED_SOLVERS

    real = FUSED_SOLVERS["cg"]

    def solve(op, b, **kw):
        res = real(op, b, **kw)
        return dataclasses.replace(res, x=change(res.x.clone(), b))

    monkeypatch.setitem(FUSED_SOLVERS, "cg", solve)


def wrap_matmat(monkeypatch, change):
    from repro_torch.sparse import DistributedSpMV

    real = DistributedSpMV.matmat
    monkeypatch.setattr(DistributedSpMV, "matmat", lambda self, V: change(real(self, V).clone(), V))


def half_zero(t):
    t[..., t.shape[-1] // 2:] = 0
    return t


def bump(t):
    t[0, 0] += 1.0
    return t


CG_FAULTS = {
    "state_unchanged": lambda mp: wrap_solve(mp, lambda x, b: torch.zeros_like(x)),
    "half_the_ranks_left_out": lambda mp: wrap_solve(mp, lambda x, b: torch.cat(
        [x[: x.shape[0] // 2], torch.zeros_like(x[x.shape[0] // 2:])])),
    "exchange_left_out": halo_left_out,
    "answer_altered": lambda mp: wrap_solve(mp, lambda x, b: bump(x)),
}

SERVE_FAULTS = {
    "state_unchanged": lambda mp: wrap_matmat(mp, lambda W, V: V.clone()),
    "half_the_batch_left_out": lambda mp: wrap_matmat(mp, lambda W, V: half_zero(W)),
    "exchange_left_out": halo_left_out,
    "answer_altered": lambda mp: wrap_matmat(mp, lambda W, V: bump(W)),
}


@pytest.mark.parametrize("fault", sorted(CG_FAULTS))
def test_a_broken_solve_is_not_correct(fault, monkeypatch):
    CG_FAULTS[fault](monkeypatch)
    assert not run_broken("thermal2.cg")["correct"]


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_a_broken_serving_path_is_not_correct(fault, monkeypatch):
    SERVE_FAULTS[fault](monkeypatch)
    assert not run_broken("audikw1.spmv_serve")["correct"]


@pytest.mark.cuda
def test_both_cells_run_small_on_the_card():
    """On a card: both drivers at small sizes through the kernels, traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload, cfg in SMALL.items():
        got = run.run_cell(workload, 5, 0.5, True, "cuda", config=cfg)
        assert got["correct"] and got["device"]["busy_s"] > 0
