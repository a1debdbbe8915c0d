"""The case study on a real process group, one process per rank.

One gloo world per topology and module (``python -m repro_torch.launch.world
--device cpu --keep-arrays``: ``PodTopology(2, 2)`` on the case study's
``thermal_like`` grid, ``PodTopology(2, 4)`` on ``random_block``, whose
all-to-all pattern gives every strategy permute rounds).  Each rank holds its
own ``[1, L]`` block, and the test holds what every rank delivered to:

* the exchange, for every strategy x {barrier, split-phase} x {none, bf16,
  int8} (halos carried as int32 bit patterns, since JSON keeps no nan's
  sign): bitwise the port's stacked ``IrregularExchange`` row; with
  ``none`` also bitwise the reference's ``execute_numpy`` of its own plan;
* ``DistributedSpMV(group=)`` and ``matmat`` (k = 3): bitwise the stacked
  ``device="cpu"`` rows, and within 1e-5 of ``repro.sparse.spmv.reference``;
* ``cg`` / ``bicgstab``: the reference solvers' status on
  ``repro.solve.NumpySpMV``, iterations within one, ``x`` within 1e-4
  (``tests/test_torch_solver.py``'s rule); histories bitwise identical
  across strategies and barrier/overlap;
* checks, faults and the recovery ladder under the group (every strategy x
  {barrier, split-phase} x {clean, retry, demote, re-advise} x codecs
  ``none`` / ``int8``): each rank's halo bitwise the stacked guarded
  exchange's row and the reference's ``execute_numpy(plan, local, wire,
  faults=, fault_call=, verify=True)`` of its own plan for the attempt that
  succeeded; recovery keys and health events equal on every rank and to
  the stacked port's; with ``fallback=False`` every rank raises the stacked
  port's and the reference's hop, with one violation;
* CG checked and CG through a retried fault: the reference's ``cg`` on
  ``repro.solve.NumpySpMV(verify=, faults=)``'s status with its
  ``+exchange:`` suffix, iterations within one, ``x`` within 1e-4, the
  clean history bitwise;
* the fused whole-solve on the group (``fused_cg`` / ``fused_bicgstab`` on
  ``DistributedSpMV(group=)``; on the host the init and block run their
  segments eagerly), every strategy x codecs ``none`` / ``int8`` barrier
  and ``none`` split-phase: bitwise the grouped host loop of the same
  operator and the port's stacked host loop in the group tree's order
  (``reductions=NumpyReductions``), and within the reference's own
  host-vs-fused tolerances (1e-5 CG, 1e-2 BiCGStab) of
  ``repro.solve.fused_cg`` / ``fused_bicgstab`` on the same seeded system;
  a checked solve, a persistent fault that every rank raises as the stacked
  fused solve does, and a transient fault that every rank resumes from the
  same checkpoint on the same rung;
* the world's own gates (rank 0's stacked checks, launch counts, the
  reductions, the fused solves, the MoE exchange dispatch on the world's
  ``("pod", "local")`` mesh, narrowed for the host) and its guards: NCCL
  raises naming ROADMAP A.6.3b item 5, and a rank planning another strategy
  or holding another fault plan makes every rank raise naming it.

In-process worlds at ``2x2`` and ``2x4`` hold the reduction tree bitwise to
``NumpyReductions`` of the stacked operands, and its int8-compressed form
equal on every rank and within one quantum of the reference's
``dot_hierarchical(..., compressor=Compressor())`` under ``shard_map``; the
tree's two levels are pinned to numpy's summation order at ``ppn`` 4, 8
and 16.  A world whose rank 1 raises before a collective ends with rank 1's
traceback within its timeout.  The world builds its systems once and hands
each rank its share, bitwise ``rank_slice(partition_csr(A, topo), r)``
with the same pattern and plans; its ranks fork from a fork server that
imported torch and the port once, and give the stacked oracles' bits.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_devices
from repro.comm import exchange as ref_exchange
from repro.comm import faults as RF
from repro.comm.fusion import fuse as ref_fuse
from repro.comm.topology import PodTopology as RefTopology
from repro.solve import NumpyReductions as RefNumpyReductions
from repro.solve import NumpySpMV
from repro.solve import bicgstab as ref_bicgstab
from repro.solve import cg as ref_cg
from repro.solve import shifted_system as ref_shifted_system
from repro.solve import spd_system as ref_spd_system
from repro.sparse import partition_csr as ref_partition_csr
from repro.sparse.matrices import GENERATORS as REF_GENERATORS
from repro.sparse.spmv import reference as ref_spmv
from repro.sparse.spmv import reference_mm as ref_spmm
from repro_torch.comm import (
    STRATEGY_NAMES,
    ExchangeIntegrityError,
    FaultPlan,
    FaultSpec,
    IrregularExchange,
    PodTopology,
    make_exchange_group,
)
from repro_torch.comm.hierarchical import ordered_sum
from repro_torch.core.device import device_for_rank
from repro_torch.launch import world
from repro_torch.solve import FUSED_SOLVERS
from repro_torch.solve import bicgstab as port_bicgstab
from repro_torch.solve import cg as port_cg
from repro_torch.solve.reductions import NumpyReductions, _tree_sum
from repro_torch.sparse import DistributedSpMV, partition_csr, rank_partition, rank_slice

REPO = Path(__file__).resolve().parents[1]
#: topology -> (matrix, rows)
WORLDS = {"2x2": ("thermal_like", 1024), "2x4": ("random_block", 512)}
MM_COLS = 3
SEED = 0
SPMV_TOL = 1e-5
X_TOL = 1e-4
SOLVERS = {"cg": (ref_cg, ref_spd_system, "b"), "bicgstab": (ref_bicgstab, ref_shifted_system, "b2")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once, each a ``python -m repro_torch.launch.world``."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "CUDA_VISIBLE_DEVICES": ""}
    runs = {}
    for topo, (matrix, rows) in WORLDS.items():
        out = tmp_path_factory.mktemp(f"world_{topo}")
        runs[topo] = out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.world", "--device", "cpu", "--topo", topo,
             "--matrix", matrix, "--rows", str(rows), "--mm-cols", str(MM_COLS), "--seed", str(SEED),
             "--timeout", "240", "--keep-arrays", "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    got = {}
    for topo, (out, proc) in runs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stdout[-3000:] + stderr[-4000:]
        ranks = json.loads((out / "world.json").read_text())["ranks"]
        assert [r["rank"] for r in ranks] == list(range(_topo(topo).nranks))
        got[topo] = ranks
    return got


def _topo(topo: str) -> PodTopology:
    return world.parse_topo(topo)


@functools.lru_cache(maxsize=None)
def _port(topo: str):
    matrix, rows = WORLDS[topo]
    A, B = world.systems(matrix, rows, SEED)
    return A, B, partition_csr(A, _topo(topo)), partition_csr(B, _topo(topo))


@functools.lru_cache(maxsize=None)
def _ref(topo: str):
    matrix, rows = WORLDS[topo]
    npods, ppn = (int(x) for x in topo.split("x"))
    gen = REF_GENERATORS[matrix]
    A = ref_spd_system(gen(rows, np.random.default_rng(SEED)))
    B = ref_shifted_system(gen(rows, np.random.default_rng(SEED + 1)))
    t = RefTopology(npods=npods, ppn=ppn)
    return A, B, ref_partition_csr(A, t), ref_partition_csr(B, t)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


@pytest.mark.parametrize("codec", world.CODECS)
@pytest.mark.parametrize("mode", world.MODES)
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_exchange_equals_stacked_rows_and_reference(worlds, topo, strategy, mode, codec):
    ranks = worlds[topo]
    t = _topo(topo)
    _, _, part, _ = _port(topo)
    _, _, ref_part, _ = _ref(topo)
    ex = IrregularExchange(part.pattern, strategy, device="cpu", wire=codec)
    for fi, feat in enumerate(world.FEATS):
        local = world.payload(t, part.rows_per_rank, feat, SEED + 3 + fi)
        stacked = ex(local).numpy()
        want = None
        if codec == "none":
            want = ref_exchange.execute_numpy(ref_fuse(ref_exchange.plan(strategy, ref_part.pattern)), local)
            np.testing.assert_array_equal(_bits(stacked), _bits(want))
        for r, rank in enumerate(ranks):
            got = np.asarray(rank["halos"][f"{strategy}|{mode}|{codec}|{feat}"], dtype=np.int32)
            assert got.shape == (1,) + stacked.shape[1:]
            np.testing.assert_array_equal(got[0], _bits(stacked[r]), err_msg=f"rank {r} {feat}")


@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_spmv_equals_stacked_rows_and_reference(worlds, topo, strategy):
    ranks = worlds[topo]
    t = _topo(topo)
    _, _, part, _ = _port(topo)
    ref_A = _ref(topo)[0]
    data = world.inputs(t, part.rows_per_rank, SEED, MM_COLS)
    op = DistributedSpMV(part, strategy=strategy, device="cpu")
    w_st, W_st = op(data["v"]).numpy(), op.matmat(data["V"]).numpy()
    w = np.concatenate([np.asarray(r["w"][strategy], np.float32) for r in ranks])
    W = np.concatenate([np.asarray(r["W"][strategy], np.float32) for r in ranks])
    np.testing.assert_array_equal(_bits(w), _bits(w_st))
    np.testing.assert_array_equal(_bits(W), _bits(W_st))
    np.testing.assert_allclose(w.reshape(-1), ref_spmv(ref_A, data["v"].reshape(-1)), rtol=SPMV_TOL, atol=SPMV_TOL)
    np.testing.assert_allclose(W.reshape(-1, MM_COLS), ref_spmm(ref_A, data["V"].reshape(-1, MM_COLS)),
                               rtol=SPMV_TOL, atol=SPMV_TOL)


@pytest.mark.parametrize("strategy", STRATEGY_NAMES + ("auto",))
@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_solve_matches_reference(worlds, topo, solver, strategy):
    ranks = worlds[topo]
    ref_solve, _, rhs = SOLVERS[solver]
    ref_A, ref_B, ref_part, ref_part_b = _ref(topo)
    t = _topo(topo)
    b = world.inputs(t, ref_part.rows_per_rank, SEED, MM_COLS)[rhs]
    ref_op = NumpySpMV(ref_part if solver == "cg" else ref_part_b, strategy="two_step")
    want = ref_solve(ref_op, b, tol=world.TOL_SOLVE, maxiter=world.MAXITER)
    first = ranks[0]["solves"][solver]["standard|False"]
    for overlap in (False, True):
        runs = [r["solves"][solver][f"{strategy}|{overlap}"] for r in ranks]
        assert {r["status"] for r in runs} == {want.status}, (runs[0]["status"], want.status)
        assert abs(runs[0]["iterations"] - want.iterations) <= 1, (runs[0]["iterations"], want.iterations)
        x = np.concatenate([np.asarray(r["x"], np.float32) for r in runs])
        np.testing.assert_allclose(x, want.x, rtol=X_TOL, atol=X_TOL)
        # every rank holds the history of every other run, bitwise
        for r in runs:
            assert r["residuals"] == first["residuals"], (strategy, overlap)


@pytest.mark.parametrize("part", ["exchange", "stacked", "spmv", "cg", "bicgstab", "launches", "faults",
                                  "reductions", "fused", "moe"])
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_world_gates(worlds, topo, part):
    gates = {f"rank {r['rank']}: {k}": ok for r in worlds[topo] for k, ok in r["gates"].items()
             if k.split(" ")[0].rstrip(":") == part}
    assert gates and all(gates.values()), [k for k, ok in gates.items() if not ok]


@pytest.mark.parametrize("guard, names", [("nccl", "A.6.3b item 5"), ("mesh_backend", "unknown backend 'fake'"),
                                          ("mismatch", "ranks [1]"), ("fault_mismatch", "ranks [1]")])
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_guards_raise_under_a_group(worlds, topo, guard, names):
    for r in worlds[topo]:
        msg = r["guards"][guard]
        assert msg != "did not raise" and names in msg, (r["rank"], msg)


def test_failing_rank_ends_the_world_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(world.WorldError) as info:
        world.run_world(world.probe, PodTopology(2, 2), device="cpu", timeout_s=60.0, args=(1,))
    assert time.monotonic() - t0 < 60.0
    assert info.value.rank == 1
    assert "rank 1 fails on purpose" in info.value.traceback and "ValueError" in info.value.traceback


def test_probe_world_gathers_every_rank():
    got = world.run_world(world.probe, PodTopology(1, 2), device="cpu", timeout_s=60.0)
    assert [g["ranks"] for g in got] == [[0, 1], [0, 1]]
    assert [g["device"] for g in got] == ["cpu", "cpu"]


def test_no_fallback_without_a_world_or_a_card():
    with pytest.raises(NotImplementedError, match="A.6.3b item 5"):
        world.run_world(world.probe, PodTopology(1, 2), device="cpu", backend="nccl")
    with pytest.raises(NotImplementedError, match="A.6.3b item 5"):
        make_exchange_group(PodTopology(1, 2), backend="nccl")
    with pytest.raises(RuntimeError, match="initialised"):
        make_exchange_group(PodTopology(1, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device_for_rank(0)


@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_rank_slice_is_the_stacked_rows(topo):
    _, _, part, _ = _port(topo)
    t, L = _topo(topo), part.rows_per_rank
    for r in range(t.nranks):
        s = rank_slice(part, r)
        for got, full in ((s.diag.data, part.diag.data), (s.diag.cols, part.diag.cols),
                          (s.off.data, part.off.data), (s.off.cols, part.off.cols)):
            np.testing.assert_array_equal(got, full.reshape(t.nranks, L, -1)[r : r + 1])
        np.testing.assert_array_equal(s.off_row_nnz, part.off_row_nnz.reshape(t.nranks, L)[r : r + 1])


def _same_array(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_handed_in_problem_is_each_ranks_slice_bitwise(tmp_path, topo):
    """The world builds its systems once (``world.build_problem``,
    ``write_problem``) and hands each rank its share: rank 0 both systems
    and partitions whole, every other rank a partition of its own rows,
    whose ``rank_slice`` is bitwise ``rank_slice(partition_csr(A, topo),
    r)`` with the whole pattern, its fingerprint and every strategy's plan
    key and plan."""
    matrix, rows = WORLDS[topo]
    t = _topo(topo)
    A, B, part, part_b = _port(topo)
    world.write_problem(str(tmp_path), *world.build_problem(t, matrix, rows, SEED))
    for r in range(t.nranks):
        sizes, got_a, got_b, got, got_b_part = world.load_problem(str(tmp_path), r)
        assert sizes == {"n": A.n, "nnz": A.nnz}
        if r == 0:
            for mine, whole in ((got_a, A), (got_b, B)):
                assert all(_same_array(getattr(mine, k), getattr(whole, k)) for k in ("indptr", "indices", "data"))
            assert got.held is None and got_b_part.held is None
        else:
            assert got_a is None and got_b is None and got.held == r and got_b_part.held == r
        for mine, whole in ((got, part), (got_b_part, part_b)):
            s, w = rank_slice(mine, r), rank_slice(whole, r)
            for a, b in ((s.diag.data, w.diag.data), (s.diag.cols, w.diag.cols), (s.off.data, w.off.data),
                         (s.off.cols, w.off.cols), (s.off_row_nnz, w.off_row_nnz)):
                assert _same_array(np.ascontiguousarray(a), np.ascontiguousarray(b)), r
            assert (mine.topo, mine.rows_per_rank, mine.halo_width) == (whole.topo, whole.rows_per_rank,
                                                                         whole.halo_width)
            assert mine.pattern == whole.pattern and mine.pattern.fingerprint() == whole.pattern.fingerprint()
            for strategy in STRATEGY_NAMES:
                assert _plan_key(mine.pattern, strategy) == _plan_key(whole.pattern, strategy)
                assert _plan_bytes(mine.pattern, strategy) == _plan_bytes(whole.pattern, strategy)


def _plan_key(pattern, strategy: str) -> tuple:
    from repro_torch.comm.strategies import _plan_key as key

    return key(pattern, strategy, 16384, 4, True)


def _plan_bytes(pattern, strategy: str) -> bytes:
    """The fused stage plan of ``strategy``, built afresh (not from the
    plan cache, which is keyed by the fingerprint), pickled."""
    import pickle

    from repro_torch.comm.exchange import plan
    from repro_torch.comm.fusion import fuse

    return pickle.dumps(fuse(plan(strategy, pattern)))


@pytest.mark.parametrize("other", [0, 2, 3])
def test_a_partition_of_one_ranks_rows_serves_that_rank_alone(other):
    _, _, part, _ = _port("2x2")
    held = rank_partition(part, 1)
    assert held.diag.data.shape == (part.rows_per_rank, part.diag.data.shape[1])
    with pytest.raises(ValueError, match="rank 1's rows alone"):
        rank_slice(held, other)
    with pytest.raises(ValueError, match="needs group="):
        DistributedSpMV(held, strategy="standard", device="cpu")


@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_ranks_fork_from_the_preloaded_server_and_match_the_stacked_oracle(topo):
    """``run_world`` forks its ranks from a fork server that has imported
    torch and the port once: two worlds in a row (the second from the warm
    server) each give every rank's tree dot bitwise ``NumpyReductions`` of
    the stacked operands, and each rank's timeline holds its four steps in
    order."""
    assert world.rank_context().get_start_method() == "forkserver"
    t = _topo(topo)
    want = [NumpyReductions(t).dot(x, y) for x, y in world.dot_operands(t, DOTS_LEN, SEED + 1)]
    for _ in range(2):
        ranks = world.run_world(world.dots, t, device="cpu", timeout_s=120.0,
                                kwargs=dict(length=DOTS_LEN, seed=SEED + 1))
        assert [r["rank"] for r in ranks] == list(range(t.nranks))
        for r in ranks:
            assert [float.fromhex(d["tree"]) for d in r["dots"]] == want, r["rank"]
            steps = r["timeline"]
            assert list(steps) == ["entered", "joined", "grouped", "device"]
            assert sorted(steps.values()) == list(steps.values())


# ---------------------------------------------------------------------------
# Checks, faults and the recovery ladder under the group
# ---------------------------------------------------------------------------

#: (case, codec) of the faults section: demote only under a lossy codec
FAULT_CASES = [(case, codec) for case, (codecs, _) in world.fault_cases("standard", SEED).items()
               if case != "detect" for codec in codecs]
#: the recovery each case must take (``None``: no recovery)
WANT_ACTION = {"clean": None, "retry": "retry", "demote": "demote", "readvise": "readvise"}


def _ref_faults(fp):
    """The port's ``FaultPlan`` as the reference's."""
    if fp is None:
        return None
    return RF.FaultPlan(seed=fp.seed, specs=tuple(RF.FaultSpec(**dataclasses.asdict(s)) for s in fp.specs),
                        active_calls=fp.active_calls)


def _ref_plan(strategy: str, pattern):
    return ref_fuse(ref_exchange.plan(strategy, pattern))


@pytest.mark.parametrize("case, codec", FAULT_CASES)
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_guarded_exchange_equals_stacked_rows_and_reference(worlds, topo, strategy, case, codec):
    ranks = worlds[topo]
    _, _, part, _ = _port(topo)
    _, _, ref_part, _ = _ref(topo)
    kw = world.fault_cases(strategy, SEED)[case][1]
    full = world.fault_payload(_topo(topo), part.rows_per_rank, SEED)
    for mode in world.MODES:
        key = f"{case}|{strategy}|{mode}|{codec}"
        st = IrregularExchange(part.pattern, strategy, device="cpu", wire=codec, **kw)
        halo, rec = world._guarded(st, torch.as_tensor(full), mode)
        assert rec["error"] is None, rec
        action = None if rec["recovery"] is None else rec["recovery"].split(":")[0]
        assert action == WANT_ACTION[case], (key, rec["recovery"])
        # the attempt that succeeded, on the reference's own plan
        succ = (strategy, codec) if rec["recovery"] is None else tuple(rec["recovery"].split(":", 1)[1].split("/"))
        if case == "readvise":
            assert succ[0] != strategy and succ[1] == "none", succ
        want = ref_exchange.execute_numpy(_ref_plan(succ[0], ref_part.pattern), full, succ[1],
                                          faults=_ref_faults(kw.get("faults")), fault_call=rec["calls"] - 1,
                                          verify=True)
        np.testing.assert_array_equal(_bits(halo.numpy()), _bits(want), err_msg=key)
        for r, rank in enumerate(ranks):
            got = rank["fault_records"][key]
            assert (got["recovery"], got["events"], got["error"]) == (rec["recovery"], rec["events"], None), (r, key)
            bits = np.asarray(rank["fault_halos"][key], dtype=np.int32)
            np.testing.assert_array_equal(bits[0], _bits(halo[r].numpy()), err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("codec", world.FAULT_CODECS)
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_persistent_fault_raises_on_every_rank_with_the_stacked_hop(worlds, topo, strategy, codec):
    ranks = worlds[topo]
    _, _, part, _ = _port(topo)
    _, _, ref_part, _ = _ref(topo)
    kw = world.fault_cases(strategy, SEED)["detect"][1]
    full = world.fault_payload(_topo(topo), part.rows_per_rank, SEED)
    fields = ("strategy", "stage_kind", "op_index", "round_index", "hop_class", "codec")
    for mode in world.MODES:
        key = f"detect|{strategy}|{mode}|{codec}"
        st = IrregularExchange(part.pattern, strategy, device="cpu", wire=codec, **kw)
        halo, rec = world._guarded(st, torch.as_tensor(full), mode)
        assert halo is None and rec["error"] is not None, key
        plan_ = _ref_plan(strategy, ref_part.pattern if mode == "barrier"
                          else ref_exchange.split_phase(ref_part.pattern).remote)
        with pytest.raises(RF.ExchangeIntegrityError) as info:
            ref_exchange.execute_numpy(plan_, full, codec, faults=_ref_faults(kw["faults"]), verify=True)
        want = {f: rec["error"][f] for f in fields}
        assert info.value.diagnostics() == want, key
        errors = [rank["fault_records"][key]["error"] for rank in ranks]
        assert all(e is not None and {f: e[f] for f in fields} == want for e in errors), (key, errors)
        # one violation on every rank: the world's maximum
        assert len({e["violation"] for e in errors}) == 1 and errors[0]["violation"] > 0, (key, errors)


@pytest.mark.parametrize("name", ["verify", "retry"])
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_guarded_solves_match_reference(worlds, topo, name):
    ranks = worlds[topo]
    _, _, ref_part, _ = _ref(topo)
    b = world.inputs(_topo(topo), ref_part.rows_per_rank, SEED, MM_COLS)["b"]
    faults = None
    if name == "retry":
        faults = RF.FaultPlan(seed=SEED + 11, specs=(RF.FaultSpec(kind="corrupt"),), active_calls=(0,))
    ref_op = NumpySpMV(ref_part, strategy=world.FAULT_SOLVE_STRATEGY, verify=True, faults=faults)
    want = ref_cg(ref_op, b, tol=world.TOL_SOLVE, maxiter=world.MAXITER)
    if name == "retry":
        assert want.status == f"converged+exchange:retry:{world.FAULT_SOLVE_STRATEGY}/none"
    runs = [r["fault_solve_runs"][name] for r in ranks]
    assert {r["status"] for r in runs} == {want.status}, (runs[0]["status"], want.status)
    assert abs(runs[0]["iterations"] - want.iterations) <= 1, (runs[0]["iterations"], want.iterations)
    x = np.concatenate([np.asarray(r["x"], np.float32) for r in runs])
    np.testing.assert_allclose(x, want.x, rtol=X_TOL, atol=X_TOL)
    clean = ranks[0]["solves"]["cg"]["standard|False"]["residuals"]
    assert all(r["residuals"] == clean for r in runs)


# ---------------------------------------------------------------------------
# The reduction tree on a group
# ---------------------------------------------------------------------------

DOTS_LEN = 64


@pytest.fixture(scope="module")
def group_dots():
    """Every rank's tree and compressed dots, an in-process world per topology."""
    return {t: world.run_world(world.dots, _topo(t), device="cpu", timeout_s=120.0,
                               kwargs=dict(length=DOTS_LEN, seed=SEED)) for t in sorted(WORLDS)}


@pytest.fixture(scope="module")
def ref_compressed_dots(tmp_path_factory):
    """The reference's ``dot_hierarchical(..., compressor=Compressor())``
    under ``shard_map`` on 8 forced host devices (the 2x2 mesh on four of
    them), and the agreed scale of each pair: ``{topo: [(value, scale)]}``."""
    d = tmp_path_factory.mktemp("dots")
    arrays = {}
    for t in sorted(WORLDS):
        for i, (x, y) in enumerate(world.dot_operands(_topo(t), DOTS_LEN, SEED)):
            arrays[f"{t}_{i}_x"], arrays[f"{t}_{i}_y"] = x, y
    np.savez(d / "in.npz", **arrays)
    run_devices(
        f"""
        import json
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import Mesh
        from repro.comm import PodTopology
        from repro.comm.compression import Compressor
        from repro.solve import DeviceReductions

        data = np.load({str(d / "in.npz")!r})
        out = {{}}
        for t in {sorted(WORLDS)!r}:
            npods, ppn = (int(v) for v in t.split("x"))
            topo = PodTopology(npods=npods, ppn=ppn)
            mesh = Mesh(np.array(jax.devices()[: topo.nranks]).reshape(npods, ppn), ("pod", "local"))
            red = DeviceReductions(topo, mesh, compressor=Compressor())
            out[t] = [red.dot(jnp.asarray(data[f"{{t}}_{{i}}_x"]), jnp.asarray(data[f"{{t}}_{{i}}_y"]))
                      for i in range({len(world.dot_operands(_topo("2x2"), 1, 0))})]
        with open({str(d / "out.json")!r}, "w") as f:
            json.dump(out, f)
        """,
        devices=8,
    )
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_group_tree_is_bitwise_numpy_reductions(group_dots, topo):
    t = _topo(topo)
    for i, (x, y) in enumerate(world.dot_operands(t, DOTS_LEN, SEED)):
        want = NumpyReductions(t).dot(x, y)
        assert want == RefNumpyReductions(RefTopology(npods=t.npods, ppn=t.ppn)).dot(x, y)
        got = {float.fromhex(r["dots"][i]["tree"]) for r in group_dots[topo]}
        assert got == {want} and float(want).hex() == group_dots[topo][0]["dots"][i]["tree"], (i, got, want)


@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_group_compressed_tree_is_one_quantum_from_the_reference(group_dots, ref_compressed_dots, topo):
    t = _topo(topo)
    for i, (x, y) in enumerate(world.dot_operands(t, DOTS_LEN, SEED)):
        got = {r["dots"][i]["compressed"] for r in group_dots[topo]}
        assert len(got) == 1, (i, got)  # every rank the same bits
        value = float.fromhex(got.pop())
        part = (x.astype(np.float64) * y).reshape(t.nranks, -1).sum(axis=1)
        pods = part.reshape(t.npods, t.ppn).sum(axis=1)
        quantum = max(np.abs(pods).max() / 127.0, np.finfo(np.float64).tiny)
        exact = NumpyReductions(t).dot(x, y)
        assert value != exact  # the inter-pod hop did quantize
        assert abs(value - ref_compressed_dots[topo][i]) <= quantum, (i, value, ref_compressed_dots[topo][i], quantum)


@pytest.mark.parametrize("rows", [1, 3, 16])
def test_ordered_sum_is_numpy_sum(rows):
    """The partials' and levels' order on the card (:func:`ordered_sum`,
    elementwise adds only) is numpy's float64 row sum, bitwise: lengths
    below 8, within a pairwise block (128), across uneven halves, and over
    several of numpy's 8192-element buffers (the case study's 65,536)."""
    rng = np.random.default_rng(rows)
    for n in (0, 1, 7, 8, 9, 63, 64, 127, 128, 129, 250, 256, 1000, 8191, 8192, 8193, 12345, 65536):
        a = rng.normal(size=(rows, n)) * 10.0 ** rng.integers(-8, 9, size=(rows, n))
        got = ordered_sum(torch.as_tensor(a)).numpy()
        np.testing.assert_array_equal(got.view(np.int64), a.sum(axis=1).view(np.int64), err_msg=f"n={n}")


@pytest.mark.parametrize("ppn", [4, 8, 16])
def test_tree_levels_sum_in_numpy_reductions_order(ppn):
    """The group tree's two levels (:func:`ordered_sum` over the pod's
    partials, then over the pod sums) are bitwise ``_tree_sum``; from ppn 8
    numpy's pairwise order differs from a left-to-right sum, so the pin
    matters there."""

    def _row_sum(values) -> float:
        return float(ordered_sum(torch.as_tensor(np.asarray(values, dtype=np.float64)).view(1, -1))[0])

    rng = np.random.default_rng(ppn)
    differs = 0
    for npods in (1, 2, 3, 4):
        t = PodTopology(npods=npods, ppn=ppn)
        for _ in range(200):
            p = rng.normal(size=t.nranks) * 10.0 ** rng.integers(-8, 9, size=t.nranks)
            pods = [_row_sum(p[q * ppn : (q + 1) * ppn]) for q in range(npods)]
            assert _row_sum(np.asarray(pods)) == _tree_sum(p, t)
            differs += functools.reduce(lambda a, b: a + b, p[:ppn].tolist()) != _row_sum(p[:ppn])
    assert (differs > 0) == (ppn >= 8), differs


# ---------------------------------------------------------------------------
# The fused whole-solve on a group
# ---------------------------------------------------------------------------

#: (solver, strategy, codec, mode) of the world's fused section on the host
FUSED_CASES = [(solver, strategy, codec, mode) for solver in sorted(SOLVERS) for strategy in STRATEGY_NAMES
               for codec in world.FUSED_CODECS for mode in ("barrier", "overlap")
               if world._fused_case(torch.device("cpu"), solver, strategy, codec, mode)]
#: the port's host loops
HOST_SOLVERS = {"cg": port_cg, "bicgstab": port_bicgstab}
#: the reference's own host-vs-fused tolerances (its tests/test_fused.py)
REF_FUSED_TOL = {"cg": 1e-5, "bicgstab": 1e-2}


def _fused_key(solver, strategy, codec, mode) -> str:
    return f"{solver}|{strategy}|{codec}|{mode}"


def _rhs(topo: str, solver: str) -> np.ndarray:
    _, _, part, _ = _port(topo)
    return world.inputs(_topo(topo), part.rows_per_rank, SEED, MM_COLS)[SOLVERS[solver][2]]


@pytest.fixture(scope="module")
def ref_fused(tmp_path_factory):
    """The reference's ``fused_cg`` / ``fused_bicgstab`` on each world's
    systems, every strategy: one child per topology on as many forced host
    devices as it has ranks, both at once."""
    from concurrent.futures import ThreadPoolExecutor

    def one(topo: str) -> dict:
        d = tmp_path_factory.mktemp(f"ref_fused_{topo}")
        np.savez(d / "rhs.npz", **{s: _rhs(topo, s) for s in SOLVERS})
        matrix, rows = WORLDS[topo]
        npods, ppn = (int(v) for v in topo.split("x"))
        run_devices(
            f"""
            import json
            import numpy as np
            from repro.comm import PodTopology
            from repro.solve import fused_bicgstab, fused_cg, shifted_system, spd_system
            from repro.sparse import build
            from repro.sparse.matrices import GENERATORS

            topo = PodTopology(npods={npods}, ppn={ppn})
            gen = GENERATORS[{matrix!r}]
            systems = {{"cg": (spd_system(gen({rows}, np.random.default_rng({SEED}))), fused_cg),
                       "bicgstab": (shifted_system(gen({rows}, np.random.default_rng({SEED + 1}))), fused_bicgstab)}}
            rhs = np.load({str(d / "rhs.npz")!r})
            out = {{}}
            for solver, (M, fn) in systems.items():
                for strategy in {list(STRATEGY_NAMES)!r}:
                    r = fn(build(M, topo, strategy=strategy), rhs[solver], tol={world.TOL_SOLVE}, maxiter={world.MAXITER})
                    out[f"{{solver}}|{{strategy}}"] = dict(status=r.status, iterations=r.iterations,
                                                          residuals=[float(v) for v in r.residuals],
                                                          x=np.asarray(r.x).ravel().tolist())
            with open({str(d / "out.json")!r}, "w") as f:
                json.dump(out, f)
            """,
            devices=npods * ppn,
        )
        return json.loads((d / "out.json").read_text())

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        return dict(zip(sorted(WORLDS), pool.map(one, sorted(WORLDS))))


def _fused_runs(worlds, topo, key) -> list:
    return [r["fused_runs"][key] for r in worlds[topo]]


@pytest.mark.parametrize("solver, strategy, codec, mode", FUSED_CASES)
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_fused_equals_grouped_host_loop(worlds, topo, solver, strategy, codec, mode):
    runs = _fused_runs(worlds, topo, _fused_key(solver, strategy, codec, mode))
    for r, run in enumerate(runs):
        assert run["status"] == "converged", (r, run["status"])
        assert run["residuals"] == run["host_residuals"], r
        np.testing.assert_array_equal(_bits(run["x"]), _bits(run["host_x"]), err_msg=f"rank {r}")
        assert run["residuals"] == runs[0]["residuals"], r
    if codec == "none":  # the host loop that the world's solve section ran
        host = worlds[topo][0]["solves"][solver][f"{strategy}|{mode == 'overlap'}"]
        assert runs[0]["host_residuals"] == host["residuals"]


@pytest.mark.parametrize("solver, strategy, codec, mode", FUSED_CASES)
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_fused_equals_stacked_host_loop_in_the_tree_order(worlds, topo, solver, strategy, codec, mode):
    runs = _fused_runs(worlds, topo, _fused_key(solver, strategy, codec, mode))
    _, _, part, part_b = _port(topo)
    op = DistributedSpMV(part if solver == "cg" else part_b, strategy=strategy, device="cpu", wire=codec,
                         overlap=mode == "overlap")
    want = HOST_SOLVERS[solver](op, _rhs(topo, solver), tol=world.TOL_SOLVE, maxiter=world.MAXITER,
                                reductions=NumpyReductions(_topo(topo)))
    assert runs[0]["residuals"] == list(want.residuals)
    x = np.concatenate([np.asarray(run["x"], np.float32) for run in runs])
    np.testing.assert_array_equal(_bits(x), _bits(want.x.numpy()))


@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_fused_matches_reference_fused(worlds, ref_fused, topo, solver, strategy):
    want = ref_fused[topo][f"{solver}|{strategy}"]
    runs = _fused_runs(worlds, topo, _fused_key(solver, strategy, "none", "barrier"))
    got = runs[0]
    assert got["status"] == want["status"], (got["status"], want["status"])
    # the two packages round a row's sum in different orders: the solves
    # may end one iteration apart, as the host loops do
    assert abs(got["iterations"] - want["iterations"]) <= 1, (got["iterations"], want["iterations"])
    common = min(len(got["residuals"]), len(want["residuals"]))
    rel = max(abs(a - c) / max(abs(c), 1e-30) for a, c in zip(got["residuals"][:common], want["residuals"][:common]))
    assert rel < REF_FUSED_TOL[solver], rel
    x = np.concatenate([np.asarray(run["x"], np.float32) for run in runs]).reshape(-1)
    np.testing.assert_allclose(x, want["x"], rtol=X_TOL, atol=X_TOL)


@pytest.mark.parametrize("topo", sorted(WORLDS))
def test_fused_checks_agree_on_every_rank(worlds, topo):
    """A checked fused CG equals the clean host loop on every rank; a
    persistent fault makes every rank raise the stacked fused raise (hop and
    violation); a transient one is resumed once on every rank, on the
    stacked solve's rung, with the clean history.  The stacked fused solve
    sums its dots in its own order, which the hop, the violation and the
    rung do not depend on."""
    ranks = worlds[topo]
    strat = world.FAULT_SOLVE_STRATEGY
    clean = ranks[0]["solves"]["cg"][f"{strat}|False"]
    checks = [r["fused_checks"] for r in ranks]
    assert all(c["verify"]["residuals"] == clean["residuals"] for c in checks)
    for c, r in zip(checks, ranks):
        np.testing.assert_array_equal(_bits(c["verify"]["x"]), _bits(r["solves"]["cg"][f"{strat}|False"]["x"]))
    _, _, part, _ = _port(topo)
    b = _rhs(topo, "cg")
    persistent = FaultPlan(seed=SEED + 15, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),))
    op = DistributedSpMV(part, strategy=strat, device="cpu", verify=True, faults=persistent)
    with pytest.raises(ExchangeIntegrityError) as info:
        FUSED_SOLVERS["cg"](op, b, tol=world.TOL_SOLVE, maxiter=world.FUSED_DETECT_MAXITER)
    want = {**info.value.diagnostics(), "violation": info.value.violation}
    assert all(c["detect"] == want for c in checks), ([c["detect"] for c in checks], want)
    transient = FaultPlan(seed=SEED + 16, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0,
                                                                       strategies=(strat,)),), active_calls=(7,))
    st = FUSED_SOLVERS["cg"](DistributedSpMV(part, strategy=strat, device="cpu", verify=True, faults=transient), b,
                             tol=world.TOL_SOLVE, maxiter=world.MAXITER, checkpoint_every=5)
    assert "+resume:1" in st.status and st.converged, st.status
    assert all(c["resume"]["status"] == st.status for c in checks), [c["resume"]["status"] for c in checks]
    assert all(c["resume"]["residuals"] == clean["residuals"] for c in checks)
