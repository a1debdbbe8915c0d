"""The port on a CUDA GPU: the hand-written kernels against their plain
versions, and the exchange, SpMV and CG on the card against the same code on
the CPU.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  The file imports no JAX, so it runs on a GPU machine
that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.comm import STRATEGY_NAMES, IrregularExchange, PodTopology, execute_numpy, random_pattern
from repro_torch.kernels import spmv_ell as K
from repro_torch.solve import cg, spd_system
from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like

pytestmark = pytest.mark.cuda

TOPO = PodTopology(npods=2, ppn=4)
#: f32 rows of five slots, FMA on the card vs separate rounding on the CPU
SPMV_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode (run this file on the GPU)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(dev, dtype):
    """Kernel vs plain version on the card, masked and not, and the
    ``spmm(C=1) == spmv`` bitwise invariant on the card."""
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    rng = np.random.default_rng(3)
    for g, R, K_, N in [(16, 4096, 5, 4096), (3, 300, 17, 1000), (2, 513, 1, 7)]:
        data = torch.as_tensor(rng.normal(size=(g, R, K_)).astype(np.float32), device=dev).to(dtype)
        cols = torch.as_tensor(rng.integers(0, N, size=(g, R, K_)).astype(np.int32), device=dev)
        x = torch.as_tensor(rng.normal(size=(g, N)).astype(np.float32), device=dev).to(dtype)
        X = torch.as_tensor(rng.normal(size=(g, N, 8)).astype(np.float32), device=dev).to(dtype)
        mask = torch.as_tensor(
            rng.integers(0, 2, size=(g, K.num_row_tiles(R, K.TILE_R))).astype(np.int32), device=dev
        )
        mask_mm = torch.as_tensor(
            rng.integers(0, 2, size=(g, K.num_row_tiles(R, K.TILE_R_MM))).astype(np.int32), device=dev
        )
        n0 = K.spmv_ell.launches
        torch.testing.assert_close(K.spmv_ell(data, cols, x), K.spmv_ell_ref(data, cols, x), rtol=tol, atol=tol)
        assert K.spmv_ell.launches == n0 + 1
        torch.testing.assert_close(
            K.spmv_ell(data, cols, x, mask),
            K.spmv_ell_masked_ref(data, cols, x, K.rows_of_tiles(mask, K.TILE_R, R)),
            rtol=tol, atol=tol,
        )
        torch.testing.assert_close(K.spmm_ell(data, cols, X), K.spmm_ell_ref(data, cols, X), rtol=tol, atol=tol)
        torch.testing.assert_close(
            K.spmm_ell(data, cols, X, mask_mm),
            K.spmm_ell_masked_ref(data, cols, X, K.rows_of_tiles(mask_mm, K.TILE_R_MM, R)),
            rtol=tol, atol=tol,
        )
        one = X[..., :1].contiguous()
        assert torch.equal(K.spmm_ell(data, cols, one)[..., 0], K.spmv_ell(data, cols, one[..., 0].contiguous()))


@pytest.mark.parametrize("feat", [(), (3,)], ids=["vector", "batched"])
def test_exchange_on_card_equals_execute_numpy(dev, feat):
    pat = random_pattern(np.random.default_rng(1), TOPO, local_size=12)
    local = np.random.default_rng(2).normal(size=(TOPO.nranks, 12) + feat).astype(np.float32)
    for strategy in STRATEGY_NAMES:
        ex = IrregularExchange(pat, strategy, device=dev)
        want = execute_numpy(ex.plan, local)
        np.testing.assert_array_equal(ex(local).cpu().numpy(), want)
        np.testing.assert_array_equal(ex.start(local).finish().cpu().numpy(), want)


def test_spmv_and_cg_on_card(dev):
    A = spd_system(thermal_like(1024, np.random.default_rng(4)))
    part = partition_csr(A, TOPO)
    rng = np.random.default_rng(5)
    v = rng.normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    V = rng.normal(size=(TOPO.nranks, part.rows_per_rank, 4)).astype(np.float32)
    b = rng.normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    for strategy in STRATEGY_NAMES:
        bar = DistributedSpMV(part, strategy=strategy, device=dev)
        ov = DistributedSpMV(part, strategy=strategy, overlap=True, device=dev)
        w = bar(v)
        assert torch.equal(ov(v), w)
        mm = bar.matmat(V)
        assert torch.equal(mm, bar.matmat_looped(V))
        assert torch.equal(ov.matmat(V), mm)
        on_cpu = DistributedSpMV(part, strategy=strategy, device="cpu")
        torch.testing.assert_close(w.cpu(), on_cpu(v), rtol=SPMV_TOL, atol=SPMV_TOL)
    n0 = K.spmv_ell.launches
    got = cg(DistributedSpMV(part, strategy="auto", device=dev), b, tol=1e-6)
    want = cg(DistributedSpMV(part, strategy="auto", device="cpu"), b, tol=1e-6)
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 1
    assert K.spmv_ell.launches - n0 >= 2 * got.matvecs
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-4, atol=1e-4)
