"""The benchmark's inputs, counts, reference and trace reading, on the CPU
at small sizes."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import common, inputs  # noqa: E402
from portbench.generators import stencil2d_spd, stencil3d_dof_spd  # noqa: E402
from portbench.metrics import counts  # noqa: E402
from portbench.reference import DeviceCSR, cg, csr_matmul  # noqa: E402
from portbench.trace import Profile, merged  # noqa: E402


def dense(A) -> np.ndarray:
    D = np.zeros((A.n, A.n))
    D[np.repeat(np.arange(A.n), np.diff(A.indptr)), A.indices] = A.data
    return D


CONFIGS = ROOT / "portbench" / "configs"
#: thermal2's stencil: the P1 triangle element's 7 points
P1 = tuple(tuple(o) for o in json.loads((CONFIGS / "thermal2.json").read_text())["offsets"])


def small(kind: str, side: int) -> dict:
    """``2d``: thermal2's P1 stencil; ``2d5``: the 5-point stencil."""
    if kind == "2d":
        return {"generator": "stencil2d_spd", "side": side, "shift": 1.0, "offsets": [list(o) for o in P1]}
    if kind == "2d5":
        return {"generator": "stencil2d_spd", "side": side, "shift": 1.0}
    return {"generator": "stencil3d_dof_spd", "side": side, "dof": 3, "shift": 1.0}


def test_full_size_nonzeros_by_the_formula():
    assert stencil2d_spd.nnz(1108, P1) == 8_584_786  # 100.05% of thermal2's 8,580,313
    assert stencil2d_spd.nnz(1108) == 6_133_888
    assert stencil3d_dof_spd.nnz(68, 3) == 74_181_672
    assert 1108 ** 2 == 1_227_664 and 3 * 68 ** 3 == 943_296
    for name in ("thermal2", "audikw1"):
        cfg = json.loads((CONFIGS / f"{name}.json").read_text())
        got = (stencil2d_spd.nnz(cfg["side"], P1) if name == "thermal2"
               else stencil3d_dof_spd.nnz(cfg["side"], cfg["dof"]))
        assert got == cfg["nnz"] and cfg["rows"] == cfg["rows_per_rank"] * cfg["npods"] * cfg["ppn"]


@pytest.mark.parametrize("side", [2, 5, 12])
def test_stencil2d_nonzeros_match_the_formula(side):
    assert inputs.make_system(small("2d", side), 3).nnz == stencil2d_spd.nnz(side, P1)
    assert inputs.make_system(small("2d5", side), 3).nnz == stencil2d_spd.nnz(side)
    assert stencil2d_spd.nnz(side, P1) == side * side + 4 * side * (side - 1) + 2 * (side - 1) ** 2


@pytest.mark.parametrize("side", [1, 3, 5])
def test_stencil3d_nonzeros_match_the_formula(side):
    assert inputs.make_system(small("3d", side), 3).nnz == stencil3d_dof_spd.nnz(side, 3)


@pytest.mark.parametrize("kind,side", [("2d", 9), ("3d", 4)])
def test_symmetric_strictly_dominant_and_sorted(kind, side):
    A = inputs.make_system(small(kind, side), 2**40 + 7)
    D = dense(A)
    assert np.array_equal(D, D.T)
    diag = np.diag(D)
    assert (diag - (np.abs(D).sum(axis=1) - np.abs(diag)) > 0.99).all()
    rows = np.repeat(np.arange(A.n), np.diff(A.indptr))
    d = np.diff(A.indices.astype(np.int64))
    assert (d[np.diff(rows) == 0] > 0).all()
    assert A.indptr[0] == 0 and A.indptr[-1] == A.nnz == A.indices.size == A.data.size


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_same_seed_same_system_other_seed_other_values(kind):
    a, b, c = (inputs.make_system(small(kind, 4), s) for s in (11, 11, -12))
    assert np.array_equal(a.data, b.data) and np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.indices, c.indices) and not np.array_equal(a.data, c.data)


def test_stencil2d_is_the_programs_generator_bitwise():
    from repro_torch.solve import spd_system
    from repro_torch.sparse import thermal_like

    A = inputs.make_system(small("2d5", 21), 5)
    B = spd_system(thermal_like(21 * 21, inputs.host_rng(5, 0)))
    assert np.array_equal(A.indptr, B.indptr) and np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)


def test_stencil2d_p1_couples_each_node_to_its_six_triangle_neighbours():
    side = 5
    D = dense(inputs.make_system(small("2d", side), 1))
    x, y = np.arange(side * side) % side, np.arange(side * side) // side
    dx, dy = x[None, :] - x[:, None], y[None, :] - y[:, None]
    near = (np.abs(dx) + np.abs(dy) <= 1) | ((dx == dy) & (np.abs(dx) == 1))
    assert np.array_equal(D != 0, near)
    with pytest.raises(ValueError):
        inputs.make_system({**small("2d", side), "offsets": [[1, 1]]}, 1)


def test_stencil3d_couples_every_unknown_of_neighbouring_nodes():
    A = inputs.make_system(small("3d", 3), 1)
    D = dense(A)
    node = np.arange(A.n) // 3
    z, y, x = node // 9, (node // 3) % 3, node % 3
    near = ((np.abs(z[:, None] - z) <= 1) & (np.abs(y[:, None] - y) <= 1) & (np.abs(x[:, None] - x) <= 1))
    assert np.array_equal(D != 0, near)


def test_counts_by_hand_on_a_4x4_grid_over_2_ranks():
    A = inputs.make_system(small("2d5", 4), 0)
    c = counts.problem_counts(A, 2)
    # rank 0 (rows y = 0, 1) needs row y = 2's four values, rank 1 row y = 1's
    assert c == {"n": 16, "nnz": 64, "halo": 8}
    # P1 adds 2 * 3 * 3 diagonal couplings; the diagonal neighbours of the
    # boundary rows lie in the same grid rows, so the halo stays 8
    assert counts.problem_counts(inputs.make_system(small("2d", 4), 0), 2) == {"n": 16, "nnz": 82, "halo": 8}
    assert counts.spmv_bytes(c) == 8 * 64 + 4 * (16 + 8 + 16)
    assert counts.spmv_bytes(c, 3) == 8 * 64 + 3 * 4 * (16 + 8 + 16)
    assert counts.spmv_flops(c, 3) == 2 * 64 * 3
    assert counts.cg_iteration_bytes(c) == counts.spmv_bytes(c) + 12 * 4 * 16
    assert counts.cg_iteration_flops(c) == 2 * 64 + 10 * 16


def test_counts_by_hand_on_a_3d_grid():
    A = inputs.make_system(small("3d", 2), 0)  # 8 nodes, 24 rows, every node a neighbour
    c = counts.problem_counts(A, 2)
    # each rank's 12 rows need the other rank's 12 unknowns
    assert c == {"n": 24, "nnz": 24 * 24, "halo": 24}


def test_bound_is_the_larger_of_bytes_and_operations():
    peaks = counts.peaks_of("NVIDIA H100 80GB HBM3")
    assert counts.bound_s(3.35e12, 0, peaks) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12, peaks) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 67e12, peaks) == pytest.approx(2.0)
    with pytest.raises(KeyError):
        counts.peaks_of("cpu")


@pytest.mark.parametrize("block", [7, 1 << 22])
def test_reference_product_is_the_dense_product(block):
    A = inputs.make_system(small("3d", 3), 9)
    R = DeviceCSR.of(A, "cpu")
    X = torch.randn(A.n, 3, dtype=torch.float64)
    D = torch.as_tensor(dense(A))
    assert torch.allclose(csr_matmul(R, X, block_nnz=block), D @ X, rtol=1e-12, atol=1e-12)
    assert torch.allclose(csr_matmul(R, X[:, 1], block_nnz=block), D @ X[:, 1], rtol=1e-12, atol=1e-12)
    assert torch.allclose(csr_matmul(R, X, absolute=True), D.abs() @ X.abs(), rtol=1e-12, atol=1e-12)


def test_reference_cg_agrees_with_the_programs_cpu_path():
    from repro_torch.comm import PodTopology
    from repro_torch.solve import fused_cg
    from repro_torch.sparse import DistributedSpMV, partition_csr

    A = inputs.make_system(small("2d", 32), 4)
    op = DistributedSpMV(partition_csr(common.program_csr(A), PodTopology(2, 2)), device="cpu")
    b = torch.randn(4, A.n // 4, generator=torch.Generator().manual_seed(3))
    got = fused_cg(op, b, tol=1e-6, maxiter=500)
    ref = cg(DeviceCSR.of(A, "cpu"), b.reshape(-1).double(), 1e-6, 500)
    assert got.converged and ref.converged
    assert abs(got.iterations - ref.iterations) <= 1
    assert np.allclose(got.residuals[: ref.iterations], ref.residuals[: ref.iterations], rtol=1e-3)
    x = got.x.reshape(-1).double()
    assert float((x - ref.x).norm() / ref.x.norm()) < 1e-5


def test_reference_cg_solves_on_past_tol_and_reports_the_iteration_that_met_it():
    A = inputs.make_system(small("2d", 16), 1)
    R = DeviceCSR.of(A, "cpu")
    b = torch.randn(A.n, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    short, long = cg(R, b, 1e-6, 500), cg(R, b, 1e-6, 500, run_to=1e-12)
    assert short.iterations == long.iterations and len(long.residuals) > len(short.residuals)
    assert float((b - csr_matmul(R, long.x)).norm() / b.norm()) < 1e-11


def test_profile_busy_idle_and_gaps():
    dev = [("k1", 10, 20), ("k2", 15, 30), ("k1", 50, 60)]
    host = [("portbench.wait", 30, 50), ("aten::copy_", 35, 45), ("portbench.batcher", 0, 10)]
    p = Profile(device=dev, host=host, stretch=(0, 100))
    assert merged(dev) == [(10, 30), (50, 60)]
    assert p.busy_s() == pytest.approx(30e-9) and p.window_s == pytest.approx(100e-9)
    assert p.idle_share() == pytest.approx(0.7)
    assert p.kernel("k1") == (2, pytest.approx(20e-9))
    gaps = dict(p.idle_gaps())
    assert gaps == {"outside any host event": pytest.approx(40e-9),
                    "aten::copy_": pytest.approx(20e-9), "portbench.batcher": pytest.approx(10e-9)}
    assert p.top_ops()[0] == ["k1", pytest.approx(20e-9)]
    assert Profile(device=[], host=[], stretch=(0, 1)).idle_share() is None


def test_reservoir_is_seeded_and_uniform():
    def draw(seed):
        r = common.Reservoir(4, inputs.host_rng(seed, 2))
        for i in range(1000):
            r.offer(lambda i=i: i)
        return r.items

    assert draw(1) == draw(1) and draw(1) != draw(2)
    hits = np.zeros(10)
    for s in range(400):
        r = common.Reservoir(2, inputs.host_rng(s, 2))
        for i in range(10):
            r.offer(lambda i=i: i)
        hits[r.items] += 1
    assert hits.min() > 40 and hits.max() < 120  # 80 expected for each


def test_device_seed_fits_a_torch_generator():
    for seed in (0, -1, 2**31 + 5, 2**70):
        torch.Generator().manual_seed(inputs.device_seed(seed, 1))
    assert inputs.device_seed(5, 1) != inputs.device_seed(5, 2)


def test_arrivals_offer_every_seed_the_same_gaps_in_another_order():
    from portbench import arrivals

    a, b, c = (arrivals.offsets("poisson", 1100.0, 2.0, s, 5) for s in (1, 1, 2**40 + 3))
    assert len(a) == len(c) == 2200 and np.array_equal(a, b) and not np.array_equal(a, c)
    assert a[0] == 0 and (np.diff(a) >= 0).all() and a[-1] < 2.0
    gaps = lambda t: np.sort(np.diff(np.append(t, 2.0)))  # noqa: E731
    assert np.allclose(gaps(a), gaps(c))
    with pytest.raises(ValueError):
        arrivals.offsets("closed", 10.0, 1.0, 7, 5)


def test_a_split_metric_is_read_by_its_base_reader():
    from portbench import run

    assert run.load_metric("idle_share.solve").__file__.endswith("idle_share.py")
    assert run.load_metric("b1_roofline").__file__.endswith("b1_roofline.py")


def test_kernel_share_counts_products_by_launches_or_widths():
    from types import SimpleNamespace

    peaks = counts.peaks_of("H100")
    c = {"n": 1000, "nnz": 5000, "halo": 100}
    prof = Profile(device=[("spmv_ell_kernel", 0, 1000)] * 4, host=[], stretch=(0, 10_000))
    got = counts.kernel_share(SimpleNamespace(profile=prof, counts=c, peaks=peaks), "spmv_ell_kernel", 2)
    assert got == pytest.approx(100.0 * 2 * counts.spmv_bytes(c) / 3.35e12 / 4e-6)
    prof.extra = {"batch_widths": [8, 3]}
    run = SimpleNamespace(profile=prof, counts=c, peaks=peaks)
    want = (counts.spmv_bytes(c, 8) + counts.spmv_bytes(c, 3)) / 3.35e12 / 4e-6
    assert counts.kernel_share(run, "spmv_ell_kernel", 2, widths=[8, 3]) == pytest.approx(100.0 * want)
    assert counts.kernel_share(run, "spmv_ell_kernel", 2, widths=[8]) is None
    assert counts.kernel_share(run, "spmm_ell_kernel", 2) is None


def test_device_ms_is_busy_time_per_unit_of_work():
    from types import SimpleNamespace

    from portbench import run

    reader = run.load_metric("device_ms.solve")
    prof = Profile(device=[("k", 0, 3_000_000), ("k", 2_000_000, 5_000_000)], host=[], stretch=(0, 10_000_000),
                   extra={"units": 4})
    assert reader.read(SimpleNamespace(profile=prof)) == pytest.approx(5.0 / 4)
    prof.extra = {}
    assert reader.read(SimpleNamespace(profile=prof)) is None
    assert reader.read(SimpleNamespace(profile=None)) is None
