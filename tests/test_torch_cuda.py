"""The port on a CUDA GPU: the hand-written kernels against their plain
versions, the exchange, SpMV and CG on the card against the same code on
the CPU, tiny serves (hymba, llama4-scout, deepseek-v2-lite's MLA,
llama-3.2-vision, whisper) through the kernels against the plain route, and
a tiny train step on the card against the same step on the CPU, rank 0 of a
sharded tiny prefill over a fake process group against its meta record, and
the staged process group's collectives on CUDA ranks.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  The file imports no JAX, so it runs on a GPU machine
that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.comm import (
    STRATEGY_NAMES,
    WIRE_CODECS,
    ExchangeIntegrityError,
    FaultPlan,
    FaultSpec,
    IrregularExchange,
    PodTopology,
    execute_numpy,
    merge_split_phase,
    random_pattern,
    split_phase,
)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import spmv_ell as K
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch.serve import build
from repro_torch.models.ssd import ssd_chunked as ssd_plain
from repro_torch.serving import measure_spmv_replay
from repro_torch.solve import NumpySpMV, bicgstab, cg, fused_cg, shifted_system, spd_system
from repro_torch.solve import fused as FUSED
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


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 8, 16, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_every_column_count(dev, dtype, C):
    """B2 at its specialised column counts (1, 2, 4, 8, 16) and at the
    generic instantiation's (3, 5, 24): against the plain version, masked
    and not; a masked launch's active tiles equal the unmasked launch; and
    column c equals B1 on column c, bitwise.  An X one element off 16-byte
    alignment takes the generic kernel and gives the same bits."""
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    rng = np.random.default_rng(C)
    for g, R, K_, N in [(3, 200, 5, 300), (2, 129, 140, 64)]:  # K 140: no staging
        data = torch.as_tensor(rng.normal(size=(g, R, K_)).astype(np.float32), device=dev).to(dtype)
        cols = torch.as_tensor(rng.integers(0, N, size=(g, R, K_)).astype(np.int32), device=dev)
        buf = torch.as_tensor(rng.normal(size=g * N * C + 1).astype(np.float32), device=dev).to(dtype)
        X = buf[: g * N * C].view(g, N, C)
        mask = torch.as_tensor(
            rng.integers(0, 2, size=(g, K.num_row_tiles(R, K.TILE_R_MM))).astype(np.int32), device=dev
        )
        got = K.spmm_ell(data, cols, X)
        torch.testing.assert_close(got, K.spmm_ell_ref(data, cols, X), rtol=tol, atol=tol)
        masked = K.spmm_ell(data, cols, X, mask)
        rows = K.rows_of_tiles(mask, K.TILE_R_MM, R)
        torch.testing.assert_close(
            masked, K.spmm_ell_masked_ref(data, cols, X, rows), rtol=tol, atol=tol
        )
        assert torch.equal(masked[rows], got[rows]) and not masked[~rows].any()
        for c in range(C):
            assert torch.equal(got[..., c], K.spmv_ell(data, cols, X[..., c].contiguous())), c
        shifted = buf[1:].view(g, N, C)
        assert torch.equal(K.spmm_ell(data, cols, shifted), K.spmm_ell(data, cols, shifted.clone()))


@pytest.mark.parametrize("wire", WIRE_CODECS)
def test_codecs_and_verify_on_card_equal_execute_numpy(dev, wire):
    """The device codecs, barrier and split-phase, bitwise the numpy oracle;
    clean verified runs see no violation (codec none included); an injected
    fault raises the oracle's diagnostics."""
    pat = random_pattern(np.random.default_rng(1), TOPO, local_size=12)
    local = np.random.default_rng(2).normal(size=(TOPO.nranks, 12, 3)).astype(np.float32) * 100
    sp = split_phase(pat)
    faults = FaultPlan(seed=7, specs=(FaultSpec(kind="perturb"),))
    for strategy in STRATEGY_NAMES:
        ex = IrregularExchange(pat, strategy, device=dev, wire=wire, verify=True)
        want = execute_numpy(ex.plan, local, wire, verify=True)
        np.testing.assert_array_equal(ex(local).cpu().numpy(), want)
        got_split = ex.start(local).finish().cpu().numpy()
        remote, local_ex, _ = ex._two_phase
        want_split = merge_split_phase(
            sp, execute_numpy(local_ex.plan, local), execute_numpy(remote.plan, local, wire)
        )
        np.testing.assert_array_equal(got_split, want_split)
        assert ex.health.failures == {}
        bad = IrregularExchange(pat, strategy, device=dev, wire=wire, verify=True, faults=faults,
                                max_retries=0, fallback=False)
        with pytest.raises(ExchangeIntegrityError) as got_err:
            bad(local)
        with pytest.raises(ExchangeIntegrityError) as want_err:
            execute_numpy(bad.plan, local, wire, faults=faults, verify=True)
        assert got_err.value.diagnostics() == want_err.value.diagnostics()


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


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_fused_graphs_equal_eager_body_and_host_loop(dev, solver):
    """The captured graphs' replay against the same program run eagerly on
    the card and against the host loop: bitwise, for every strategy,
    barrier and split phase; B1's launches come from the replays."""
    make, host = (spd_system, cg) if solver == "cg" else (shifted_system, bicgstab)
    A = make(thermal_like(1024, np.random.default_rng(6)))
    part = partition_csr(A, TOPO)
    b = np.random.default_rng(7).normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    for strategy in STRATEGY_NAMES:
        for overlap in (False, True):
            op = DistributedSpMV(part, strategy=strategy, overlap=overlap, device=dev)
            FUSED.graph_launches["spmv_ell"] = 0
            n0 = K.spmv_ell.launches
            got = FUSED._fused_solve(op, b, None, 1e-6, 300, None, solver)
            assert FUSED.graph_launches["spmv_ell"] >= 2 * got.matvecs
            # eager launches: the warm-up's init and one iteration only
            assert K.spmv_ell.launches - n0 == (4 if solver == "cg" else 6)
            eager = FUSED._fused_solve(op, b, None, 1e-6, 300, None, solver, capture=False)
            want = host(op, b, tol=1e-6, maxiter=300)
            assert got.converged
            for other in (eager, want):
                assert (got.status, got.iterations, got.matvecs) == (
                    other.status, other.iterations, other.matvecs)
                assert got.residuals == other.residuals
                assert torch.equal(got.x, other.x)


def test_fused_faults_and_resume_on_card(dev):
    A = spd_system(thermal_like(1024, np.random.default_rng(8)))
    part = partition_csr(A, TOPO)
    b = np.random.default_rng(9).normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    clean = fused_cg(DistributedSpMV(part, strategy="two_step", verify=True, device=dev), b)
    # the fault hits two_step only: the retry resumes into call 7 again, the
    # re-advised strategy resumes past it
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0, strategies=("two_step",)),),
                   active_calls=(7,))
    res = fused_cg(DistributedSpMV(part, strategy="two_step", verify=True, faults=fp, device=dev), b,
                   checkpoint_every=5)
    assert res.status.startswith("converged+resume:1"), res.status
    assert res.residuals == clean.residuals and torch.equal(res.x, clean.x)
    always = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),))
    for overlap in (False, True):
        op = DistributedSpMV(part, strategy="two_step", verify=True, faults=always, overlap=overlap,
                             device=dev)
        with pytest.raises(ExchangeIntegrityError) as e:
            fused_cg(op, b, maxiter=20)
        assert (e.value.strategy, e.value.stage_kind) == ("two_step", "a2a_pod")


def test_fused_exhausted_ladder_on_lowered_numpy_operator_stays_on_card(dev):
    """Every rung resumes into the faulted call; the host continuation of a
    ``NumpySpMV`` lowered onto the card runs on the card, as the same solve
    on a ``DistributedSpMV`` does, bitwise."""
    A = spd_system(thermal_like(1024, np.random.default_rng(8)))
    part = partition_csr(A, TOPO)
    b = np.random.default_rng(9).normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),), active_calls=(6,))
    n0 = K.spmv_ell.launches
    lowered = fused_cg(NumpySpMV(part, strategy="two_step", verify=True, faults=fp), b,
                       checkpoint_every=4, device=dev)
    assert K.spmv_ell.launches - n0 >= 2 * (lowered.iterations - 4)  # the continuation's matvecs
    own = fused_cg(DistributedSpMV(part, strategy="two_step", verify=True, faults=fp, device=dev), b,
                   checkpoint_every=4)
    assert lowered.status.startswith("converged+resume:1"), lowered.status
    assert lowered.x.device.type == "cuda"
    assert (lowered.status, lowered.iterations, lowered.matvecs) == (own.status, own.iterations, own.matvecs)
    assert lowered.residuals == own.residuals and torch.equal(lowered.x, own.x)


def test_measure_spmv_replay_parity_on_card(dev):
    A = spd_system(thermal_like(1024, np.random.default_rng(10)))
    op = DistributedSpMV(partition_csr(A, TOPO), strategy="split", device=dev)
    got = measure_spmv_replay(op, 12, 4, np.random.default_rng(0))
    assert got["parity"] == 0.0  # B2 is bitwise per column
    assert got["coalesced_s"] > 0 and got["sequential_s"] > 0


#: (B, Sq, Sk, H, KV, D, causal, window): tests/test_kernels.py's cases, hymba's
#: head ratio with a window shorter than S, and a ragged Sq < Sk; then every
#: head width the served configs resolve to (stablelm-3b's 80 over 32/32
#: heads, qwen3-32b's 128 over 64/8), S not a multiple of the 128-row query
#: tile, Sq < Sk, windows smaller than a 64-key tile and edges inside one
#: (rows that see nothing in the first key tile their CTA visits), and the
#: other multiples of 16; then the wgmma route at D 128: S ragged against
#: the 128-row and 128-key tiles, a CTA whose second warpgroup has a few rows
#: (Sq 70) or none (Sq 150), Sq < Sk causal, Sq > Sk non-causal (the vlm's
#: cross-attention, small), a window edge inside a 128-key tile, and GQA at
#: llama4-scout's 40/8 and the vlm's 64/8 heads, B 2; last the wgmma route at
#: D 80 (five 16-column sub-tiles a row) where the 128-row tile is cut: Sq 70,
#: whose CTA's second warpgroup has 6 rows, and Sq 150, whose second CTA's
#: second warpgroup has none
ATTN_CASES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 48, 48, 4, 4, 16, True, 16),
    (2, 16, 64, 4, 2, 32, True, None),
    (1, 64, 64, 2, 1, 64, False, None),
    (1, 100, 100, 2, 2, 32, True, 32),
    (2, 300, 300, 25, 5, 64, True, 128),
    (1, 70, 200, 4, 2, 128, True, 100),
    (1, 300, 300, 32, 32, 80, True, None),
    (1, 200, 200, 8, 8, 80, True, 70),
    (2, 130, 520, 4, 2, 80, True, 200),
    (1, 300, 300, 64, 8, 128, True, 100),
    (1, 300, 300, 4, 2, 64, True, 20),
    (1, 90, 400, 4, 4, 32, True, 10),
    (1, 257, 257, 4, 1, 96, False, 50),
    (1, 129, 129, 2, 2, 48, True, None),
    (1, 65, 65, 2, 1, 112, True, 33),
    (1, 70, 70, 4, 2, 128, True, None),
    (2, 150, 150, 40, 8, 128, True, None),
    (2, 100, 333, 40, 8, 128, True, None),
    (2, 260, 200, 64, 8, 128, False, None),
    (1, 300, 300, 8, 2, 128, True, 77),
    (2, 200, 200, 64, 8, 128, True, None),
    (1, 70, 70, 4, 2, 80, True, None),
    (2, 150, 150, 32, 32, 80, True, None),
]


#: B3 against ``attention_ref`` in float32 on the same inputs: f32 within the
#: reference's 2e-4 (tests/test_kernels.py); bf16 inputs leave only the
#: rounding of the output to bf16 (at most 2**-8 of it), so rtol 8e-3 and an
#: atol far under the outputs' typical size
ATTN_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (8e-3, 1e-4)}


def _route_launched(q, k, v, causal, window):
    """One wrapper call and the route it went by: launches and that route's
    count each rose by one; bf16 at ``WGMMA_PAIRS`` goes by wgmma."""
    route = FA.kernel_route(q.shape[3], v.shape[3], q.dtype)
    assert (route == "wgmma") == (q.dtype == torch.bfloat16 and (q.shape[3], v.shape[3]) in FA.WGMMA_PAIRS)
    n0, r0 = FA.flash_attention.launches, FA.flash_attention.by_route[route]
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert FA.flash_attention.launches == n0 + 1
    assert FA.flash_attention.by_route[route] == r0 + 1
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_matches_plain(dev, case, dtype):
    """B3 against ``attention_ref`` computed in float32 on the same
    (for bf16: bf16-rounded) inputs, at ``ATTN_TOL``, one launch counted on
    its route."""
    B, Sq, Sk, H, KV, D, causal, window = case
    rtol, atol = ATTN_TOL[dtype]
    rng = np.random.default_rng(7)
    q, k, v = (
        torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev).to(dtype)
        for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))
    )
    got = _route_launched(q, k, v, causal, window)
    want = FA.attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


#: (B, Sq, Sk, H, KV, Dqk, Dv, causal, window): MLA's (192, 128) and its tiny
#: preset's (48, 32), causal and not, ragged, GQA, Sq < Sk; at (192, 128)
#: also Sq 70, Sq > Sk non-causal, a window edge inside a 128-key tile and
#: GQA at 40/8
SPLIT_CASES = [
    (2, 300, 300, 16, 16, 192, 128, True, None),
    (1, 130, 130, 4, 4, 192, 128, False, None),
    (1, 70, 200, 4, 2, 192, 128, True, 100),
    (1, 70, 70, 4, 4, 192, 128, True, None),
    (2, 260, 200, 8, 2, 192, 128, False, None),
    (2, 190, 190, 16, 16, 192, 128, True, 50),
    (1, 100, 333, 40, 8, 192, 128, True, None),
    (2, 100, 100, 4, 4, 48, 32, True, None),
    (1, 65, 150, 4, 1, 48, 32, False, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_value_width_of_its_own_matches_plain(dev, case, dtype):
    """B3 with v narrower than q/k (MLA) against ``attention_ref`` in float32
    on the same inputs, at ``ATTN_TOL``, one launch counted on its route,
    output ``Dv`` wide."""
    B, Sq, Sk, H, KV, Dqk, Dv, causal, window = case
    rtol, atol = ATTN_TOL[dtype]
    rng = np.random.default_rng(11)
    q, k, v = (
        torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev).to(dtype)
        for shape in ((B, Sq, H, Dqk), (B, Sk, KV, Dqk), (B, Sk, KV, Dv))
    )
    got = _route_launched(q, k, v, causal, window)
    assert got.dtype == dtype and got.shape == (B, Sq, H, Dv)
    want = FA.attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "case",
    [(1, 300, 300, 25, 5, 64, 64, True, 128), (2, 200, 200, 40, 8, 128, 128, True, None),
     (2, 260, 200, 64, 8, 128, 128, False, None), (2, 190, 190, 16, 16, 192, 128, True, 50),
     (2, 300, 300, 32, 32, 80, 80, True, None), (1, 300, 300, 8, 2, 80, 80, True, 77),
     (2, 100, 333, 32, 32, 80, 80, True, None), (2, 260, 200, 32, 32, 80, 80, False, None),
     (2, 200, 200, 32, 8, 80, 80, True, None)],
    ids=lambda c: "x".join(map(str, c)),
)
def test_flash_attention_wgmma_and_mma_routes_agree(dev, case):
    """At each wgmma pair, the wgmma route (the wrapper) and the mma.sync
    kernel (its own uncounted entry) on the same bf16 inputs, each within
    ``ATTN_TOL`` of the float32 plain version.  At stablelm-3b's (80, 80):
    its 32/32 heads with S ragged against the 128-row tile, a window edge
    inside a 128-key tile, Sq < Sk, non-causal Sq > Sk, and GQA 32/8."""
    B, Sq, Sk, H, KV, Dqk, Dv, causal, window = case
    rtol, atol = ATTN_TOL[torch.bfloat16]
    rng = np.random.default_rng(12)
    q, k, v = (
        torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev).bfloat16()
        for shape in ((B, Sq, H, Dqk), (B, Sk, KV, Dqk), (B, Sk, KV, Dv))
    )
    n0 = FA.flash_attention.launches
    mma = FA.flash_attention_mma(q, k, v, causal=causal, window=window)
    assert FA.flash_attention.launches == n0
    wgmma = _route_launched(q, k, v, causal, window)
    want = FA.attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    torch.testing.assert_close(wgmma.float(), want, rtol=rtol, atol=atol)
    torch.testing.assert_close(mma.float(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "B,S,H,P,N,Q",
    [(2, 32, 3, 4, 8, 8), (1, 50, 2, 16, 8, 16), (2, 128, 4, 8, 16, 32), (1, 7, 1, 2, 3, 4),
     (2, 300, 5, 64, 16, 128),
     # one, two and 33 chunks; S not a multiple of Q at N = 128 (mamba2-780m's state)
     (1, 128, 3, 64, 16, 128), (2, 256, 2, 64, 16, 128), (1, 33 * 16, 2, 8, 8, 16),
     (1, 300, 2, 64, 128, 128)],
)
def test_ssd_matches_plain(dev, B, S, H, P, N, Q):
    """B4 against the plain chunked SSD (2e-4) and the sequential oracle
    (5e-4), and its output does not depend on the chunk size.  For N > 16,
    b and c are scaled so that c . b keeps the size it has at N = 16."""
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(B, S, H, P)).astype(np.float32), device=dev)
    loga = torch.as_tensor((-np.abs(rng.normal(size=(B, S, H))) * 0.2).astype(np.float32), device=dev)
    bc_scale = min(1.0, (16 / N) ** 0.5)
    b = torch.as_tensor((rng.normal(size=(B, S, N)) * bc_scale).astype(np.float32), device=dev)
    c = torch.as_tensor((rng.normal(size=(B, S, N)) * bc_scale).astype(np.float32), device=dev)
    n0 = SSD.ssd_chunked.launches
    got = SSD.ssd_chunked(x, loga, b, c, chunk=Q)
    assert SSD.ssd_chunked.launches == n0 + 1
    torch.testing.assert_close(got, ssd_plain(x, loga, b, c, chunk=Q), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, SSD.ssd_scan_ref(x, loga, b, c), rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(SSD.ssd_chunked(x, loga, b, c, chunk=max(Q // 2, 1)), got, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_chunk_fits_shared_memory(dev):
    """hymba-1.5b's and mamba2-780m's shapes (N = 128) keep their chunk of
    128; a chunk whose tiles would not fit (256) is halved; and mamba2-780m's
    state gives the plain version's output."""
    assert SSD.kernel_chunk(128, 4096, 64, 16, dev) == 128
    assert SSD.kernel_chunk(128, 50, 64, 16, dev) == 50
    assert SSD.kernel_chunk(128, 4096, 64, 128, dev) == 128
    assert SSD.kernel_chunk(256, 4096, 64, 16, dev) == 128
    rng = np.random.default_rng(10)
    B, S, H, P, N = 1, 300, 2, 64, 128
    x = torch.as_tensor(rng.normal(size=(B, S, H, P)).astype(np.float32), device=dev)
    loga = torch.as_tensor((-np.abs(rng.normal(size=(B, S, H))) * 0.2).astype(np.float32), device=dev)
    # b, c scaled so that c . b keeps the size it has at N = 16
    b = torch.as_tensor((rng.normal(size=(B, S, N)) * 0.35).astype(np.float32), device=dev)
    c = torch.as_tensor((rng.normal(size=(B, S, N)) * 0.35).astype(np.float32), device=dev)
    torch.testing.assert_close(
        SSD.ssd_chunked(x, loga, b, c, chunk=128), ssd_plain(x, loga, b, c, chunk=128), rtol=2e-4, atol=2e-4
    )


def test_ssd_rejects_head_width_above_1024(dev):
    """No fallback: a head width P > 1024 (four columns per thread of a CTA)
    raises on the card, and nothing is counted."""
    x = torch.zeros((1, 8, 1, 1028), device=dev)
    loga = torch.zeros((1, 8, 1), device=dev)
    b = torch.zeros((1, 8, 16), device=dev)
    n0 = SSD.ssd_chunked.launches
    with pytest.raises(RuntimeError, match=r"cudaError_t 1$"):
        SSD.ssd_chunked(x, loga, b, b.clone())
    assert SSD.ssd_chunked.launches == n0


@pytest.mark.parametrize("D", [8, 72, 144])
def test_flash_attention_rejects_head_dims_it_does_not_take(dev, D):
    """No fallback: a width pair outside ``HEAD_PAIRS`` raises on the card,
    equal or not."""
    q = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q[..., : D // 2].contiguous())


def test_tiny_hymba_prefill_kernel_vs_plain(dev):
    """A tiny hymba prefill through B3 and B4 against the plain route on the
    card: one launch of each per layer, logits and every cache leaf within 1e-4."""
    model, params = build("hymba-1.5b", "tiny", seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(0, 1024, (2, 80)), device=dev)
    n_fa, n_ssd = FA.flash_attention.launches, SSD.ssd_chunked.launches
    with torch.inference_mode():
        got, cache = model.prefill(params, tokens, impl="kernel")
        assert FA.flash_attention.launches - n_fa == model.cfg.n_layers
        assert SSD.ssd_chunked.launches - n_ssd == model.cfg.n_layers
        want, want_cache = model.prefill(params, tokens, impl="chunked")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for name in ("attn", "ssm"):
        for leaf in cache["seg_hyb"][name]:
            torch.testing.assert_close(
                cache["seg_hyb"][name][leaf], want_cache["seg_hyb"][name][leaf], rtol=1e-4, atol=1e-4
            )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_exchange_dispatch_is_bitwise_all_to_all_on_card(dev, dtype):
    """The MoE layer's exchange dispatch on the card: bitwise its all-to-all
    for every strategy, uniform and skewed routing; the all-to-all within
    the kernel tolerances of the same layer on the CPU."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import MoELayer

    M, cfg = 32, MoEConfig(n_experts=16, top_k=2, d_ff_expert=64)
    rng = np.random.default_rng(8)
    shapes = {"router": ((M, 16), 2.0), "w_in": ((16, M, 64), 0.1), "w_gate": ((16, M, 64), 0.1),
              "w_out": ((16, 64, M), 0.1)}
    cpu = {k: torch.as_tensor((rng.standard_normal(s) * sc).astype(np.float32)) for k, (s, sc) in shapes.items()}
    params = {k: v.to(dev, dtype) for k, v in cpu.items()}
    inputs = {"uniform": rng.standard_normal((8, 64, M)),
              "skewed": rng.standard_normal((8, 64, M)) * 0.3 + rng.standard_normal(M)}
    for name, x in inputs.items():
        xc = torch.as_tensor(x.astype(np.float32))
        xd = xc.to(dev, dtype)
        base = MoELayer(M, cfg)(params, xd, TOPO)
        assert torch.isfinite(base).all()
        for strategy in STRATEGY_NAMES + ("auto",):
            got = MoELayer(M, cfg, dispatch="exchange", strategy=strategy)(params, xd, TOPO)
            assert torch.equal(got, base), (name, strategy)
        if dtype == torch.float32:
            torch.testing.assert_close(base.cpu(), MoELayer(M, cfg)(cpu, xc, TOPO), rtol=1e-4, atol=1e-4)


def test_tiny_llama4_prefill_kernel_vs_plain(dev):
    """A tiny llama4-scout prefill through B3 against the plain route on the
    card: one launch per layer, last logits within 1e-4, greedy decode equal."""
    from repro_torch.launch.serve import generate

    model, params = build("llama4-scout-17b-a16e", "tiny", seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(0, 1024, (2, 80)), device=dev)
    n_fa = FA.flash_attention.launches
    got = generate(model, params, tokens, 4, impl="kernel")
    assert FA.flash_attention.launches - n_fa == model.cfg.n_layers
    want = generate(model, params, tokens, 4, impl="chunked")
    torch.testing.assert_close(got["logits"][0], want["logits"][0], rtol=1e-4, atol=1e-4)
    assert torch.equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "llama-3.2-vision-90b", "whisper-large-v3"])
def test_tiny_mla_vlm_enc_dec_kernel_vs_plain(dev, arch):
    """A tiny serve of each family this slice added, through B3 (MLA's pair
    (48, 32); cross-attention; the encoder) against the plain route on the
    card: B3 launched once per attention in the prefill (encoder included)
    and never in decode, first logits within 1e-4, greedy tokens equal."""
    from repro_torch.launch.serve import generate, make_context

    # the vlm at 5 layers (4 self + 1 cross): its tiny preset's 2 hold no cross layer
    model, params = build(arch, "tiny", seed=0, device=dev, layers=5 if arch == "llama-3.2-vision-90b" else None)
    tokens, ctx = make_context(1024, 2, 40, model.ctx_len(), model.cfg.d_model, seed=9)
    tokens = torch.as_tensor(tokens, device=dev)
    ctx = None if ctx is None else torch.as_tensor(ctx, device=dev)
    per_prefill = sum(s.count * (bool(s.block.self_attn) + bool(s.block.mla) + bool(s.block.cross))
                      for s in model.segments + model.enc_segments)
    n_fa = FA.flash_attention.launches
    got = generate(model, params, tokens, 4, impl="kernel", ctx=ctx)
    assert FA.flash_attention.launches - n_fa == per_prefill > 0
    want = generate(model, params, tokens, 4, impl="chunked", ctx=ctx)
    torch.testing.assert_close(got["logits"][0], want["logits"][0], rtol=1e-4, atol=1e-4)
    assert torch.equal(got["tokens"], want["tokens"])


# ---------------------------------------------------------------------------
# training (no kernel: B3/B4 have no backward)
# ---------------------------------------------------------------------------


def _tiny_train(dev, dtype="float32"):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.presets import tiny
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(tiny(get_config("stablelm-3b")), dtype=dtype)
    model = LMModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=2, seq_len=64, seed=0, device="cpu")
    return model, params, data, AdamWConfig(peak_lr=3e-3, warmup_steps=1, total_steps=4)


def test_train_step_on_card_matches_cpu(dev, monkeypatch):
    """One float32 step from the same masters and batch on the card and on
    the CPU: loss within 1e-4, masters as ``compare_trajectories`` holds
    them (1e-4 of each leaf's max abs but where gradient noise drives
    Adam's step); no kernel."""
    from repro_torch.checkpoint import flatten_state
    from repro_torch.models.sharding import tree_map
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import build_train_step
    from repro_torch.testing.trajectory import compare_trajectories, noisy_steps

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model, params, data, opt = _tiny_train(dev)
    on_card = tree_map(lambda t: t.to(dev, copy=True), params)  # the update writes in place
    batch = data.batch_at(0)
    n = (FA.flash_attention.launches, SSD.ssd_chunked.launches)
    cpu, m_cpu = build_train_step(model, opt)({"params": params, "opt": adamw_init(params)}, batch)
    card, m_card = build_train_step(model, opt)({"params": on_card, "opt": adamw_init(on_card)},
                                                {k: v.to(dev) for k, v in batch.items()})
    assert (FA.flash_attention.launches, SSD.ssd_chunked.launches) == n
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-4)
    flat = flatten_state
    noisy = noisy_steps(None, flat(card["opt"].mu), flat(cpu["opt"].mu), flat(cpu["opt"].nu), 1)
    cmp = compare_trajectories(flat(card["params"]), flat(cpu["params"]), noisy, float(m_cpu["lr"]))
    print(f"{cmp['noise_driven']} of {cmp['elements']} marked, at most "
          f"{cmp['max_marked_share']:.3e} of leaf {cmp['max_marked_leaf']}")  # shown by -rP
    assert cmp["ok"], cmp


def test_bf16_working_copy_equals_masters_on_card(dev):
    from repro_torch.models.sharding import tree_items, tree_map
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import build_train_step

    model, params, data, opt = _tiny_train(dev, "bfloat16")
    params = tree_map(lambda t: t.to(dev), params)
    state = {"params": params, "opt": adamw_init(params)}
    step = build_train_step(model, opt)
    for s in range(2):
        state, metrics = step(state, {k: v.to(dev) for k, v in data.batch_at(s).items()})
        assert torch.isfinite(metrics["loss"])
        for (k, w), (_, m) in zip(tree_items(step.work), tree_items(state["params"])):
            assert m.dtype == torch.float32 and w.dtype in (torch.bfloat16, torch.float32)
            assert torch.equal(w.detach(), m.to(w.dtype)), k


def test_trainer_refuses_the_kernel_route(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.presets import tiny
    from repro_torch.runtime import Trainer, TrainerConfig

    with pytest.raises(ValueError, match="no backward"):
        Trainer(tiny(get_config("stablelm-3b")), TrainerConfig(impl="kernel"), device=dev)


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v2-lite-16b"])
def test_op_analysis_on_card_equals_meta(dev, arch):
    """The dry-run's analyser counts a tiny prefill on the card's tensors as
    it counts the same program on meta tensors (plain route: chunked
    attention), and its peak is the card's ``max_memory_allocated`` above
    what was allocated before, within 10%."""
    import gc

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, op_analysis

    model, params = build(arch, "tiny", seed=0, device=dev)
    prompts = torch.randint(0, model.cfg.vocab_size, (2, 256), device=dev)
    meta = dryrun.analyse_cell(model.cfg, ShapeConfig("p", 256, 2, "prefill"), "chunked")
    # warm cuBLAS through another model object: the analysed one keeps its
    # MoE tallies fresh, as the meta trace's model does
    type(model)(model.cfg).prefill(params, prompts, impl="chunked")
    st = op_analysis.analyze(model.prefill, params, prompts, impl="chunked")
    assert st.flops == meta["counted_flops_per_chip"]
    assert st.mem_bytes == meta["counted_bytes_per_chip"]
    assert st.argument_bytes == meta["memory"]["argument_bytes"]
    assert (st.temp_bytes, st.output_bytes) == (meta["memory"]["temp_bytes"], meta["memory"]["output_bytes"])
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = model.prefill(params, prompts, impl="chunked")
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - before
    del out
    assert abs(st.peak_bytes - measured) <= 0.1 * measured, (st.peak_bytes, measured)


@pytest.mark.parametrize("name,args", [("quickstart", []), ("krylov_solve", ["--fused"])])
def test_examples_launch_the_spmv_kernels(dev, name, args):
    """The quickstart and the fused Krylov example, started as users start
    them on the card (each in a process of its own), pass their own checks
    and launch B1 (and the quickstart B2); their launch counts come back as
    the last line."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo / "src"), "REPRO_EXAMPLE_LAUNCHES": "1"}
    proc = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *args],
                          capture_output=True, text=True, timeout=600, cwd=repo, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    launches = json.loads(proc.stdout.strip().splitlines()[-1])["launches"]
    assert launches["spmv_ell"] > 0
    if name == "quickstart":
        assert launches["spmm_ell"] > 0 and "split" in proc.stdout
    else:
        assert launches["spmv_ell_replayed"] > 0 and "fused whole-solve" in proc.stdout


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-32b"])
def test_rank0_program_on_a_fake_group_counts_as_on_meta(dev, arch):
    """Rank 0's program of a tiny prefill on a 2 x 4 CUDA mesh over a fake
    group of 8 (``dryrun.run_on_card``, in a process of its own: a process
    group is global) has the argument bytes and counted FLOPs of the same cell
    on meta shards, and allocates at its peak the predicted temp + output
    within 10%.  Dense archs only: a fake group leaves what a collective
    receives uninitialised, and the MoE dispatch indexes with the expert ids
    it receives."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = f"""
import dataclasses, json
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world
from repro_torch.launch.presets import tiny
init_fake_world(8)
torch.cuda.set_device(0)
cfg = dataclasses.replace(tiny(get_config({arch!r})), dtype="bfloat16")
shape = ShapeConfig("p", 256, 8, "prefill")
meta = dryrun.analyse_cell(cfg, shape, "chunked", init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model")))
card = dryrun.run_on_card(cfg, shape, init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model")))
print(json.dumps({{"meta": meta, "card": card}}))
"""
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=repo,
                          env={**os.environ, "PYTHONPATH": str(repo / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    meta, card = got["meta"], got["card"]
    mem = meta["memory"]
    assert card["argument_bytes"] == mem["argument_bytes"]
    assert card["flops"] == meta["counted_flops_per_chip"]
    assert card["collective_ops"] == meta["collective_ops"] > 0
    predicted = mem["temp_bytes"] + mem["output_bytes"]
    assert abs(predicted - card["peak_beyond_arguments"]) <= 0.1 * card["peak_beyond_arguments"]


def test_staged_group_runs_every_collective_on_cuda_ranks(dev):
    """Two processes on this card over the staged group (every tensor
    staged through host memory around gloo): each collective a DTensor
    program issues, on CUDA tensors, with the right values (plain gloo
    has no CUDA path for DTensor's all-gather, ``GLOO_CUDA_MISSING``)."""
    from repro_torch.comm import staged
    from repro_torch.launch import world

    ranks = world.run_world(world.collectives, 2, backend=staged.BACKEND, timeout_s=120.0)
    for r in ranks:
        for name in world.PROBES:
            assert r[name]["ok"] and r[name]["backend"] == staged.BACKEND, (name, r[name])
