"""The port's blocked-ELL kernels B1/B2 against the JAX reference kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held to
``repro.kernels.spmv_ell`` in Pallas interpret mode at the shapes of
``tests/test_kernels.py``, with the reference's own tolerances (2e-5 for
float32, 5e-2 for bfloat16).  The CUDA kernels themselves are checked
against the plain versions on a GPU by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmv_ell import TILE_R as REF_TILE_R
from repro.kernels.spmv_ell import TILE_R_MM as REF_TILE_R_MM
from repro.kernels.spmv_ell import spmm_ell as ref_spmm_ell
from repro.kernels.spmv_ell import spmv_ell as ref_spmv_ell
from repro_torch.kernels import spmv_ell as K

SHAPES = [(8, 3, 32), (300, 17, 1000), (256, 128, 128), (513, 1, 7)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
C = 3


def _inputs(R, K_, N, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(R, K_)).astype(np.float32)
    cols = rng.integers(0, N, size=(R, K_)).astype(np.int32)
    x = rng.normal(size=(N,)).astype(np.float32)
    X = rng.normal(size=(N, C)).astype(np.float32)
    return rng, data, cols, x, X


def _t(a, dtype=None):
    return torch.as_tensor(a)[None].to(dtype) if dtype is not None else torch.as_tensor(a)[None]


def test_tile_sizes_match_reference():
    # the port keeps the reference's mask granularity, so one tile mask
    # means the same rows in both
    assert (K.TILE_R, K.TILE_R_MM) == (REF_TILE_R, REF_TILE_R_MM)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R,K_,N", SHAPES)
def test_spmv_plain_matches_pallas(R, K_, N, dtype, masked):
    jdt, tdt, tol = DTYPES[dtype]
    rng, data, cols, x, _ = _inputs(R, K_, N)
    mask = None
    if masked:
        mask = rng.integers(0, 2, size=(K.num_row_tiles(R, K.TILE_R),)).astype(np.int32)
    want = ref_spmv_ell(
        jnp.asarray(data, jdt), jnp.asarray(cols), jnp.asarray(x, jdt), interpret=True,
        tile_mask=None if mask is None else jnp.asarray(mask),
    )
    got = K.spmv_ell(
        _t(data, tdt), _t(cols), _t(x, tdt), tile_mask=None if mask is None else _t(mask)
    )[0]
    assert got.dtype == tdt and tuple(got.shape) == (R,)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R,K_,N", SHAPES)
def test_spmm_plain_matches_pallas(R, K_, N, dtype, masked):
    jdt, tdt, tol = DTYPES[dtype]
    rng, data, cols, _, X = _inputs(R, K_, N)
    mask = None
    if masked:
        mask = rng.integers(0, 2, size=(K.num_row_tiles(R, K.TILE_R_MM),)).astype(np.int32)
    want = ref_spmm_ell(
        jnp.asarray(data, jdt), jnp.asarray(cols), jnp.asarray(X, jdt), interpret=True,
        tile_mask=None if mask is None else jnp.asarray(mask),
    )
    got = K.spmm_ell(
        _t(data, tdt), _t(cols), _t(X, tdt), tile_mask=None if mask is None else _t(mask)
    )[0]
    assert got.dtype == tdt and tuple(got.shape) == (R, C)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K_,N", SHAPES)
def test_spmm_one_column_equals_spmv_bitwise(R, K_, N, dtype):
    rng = np.random.default_rng(1)
    g = 3
    data = torch.as_tensor(rng.normal(size=(g, R, K_)).astype(np.float32)).to(dtype)
    cols = torch.as_tensor(rng.integers(0, N, size=(g, R, K_)).astype(np.int32))
    x = torch.as_tensor(rng.normal(size=(g, N)).astype(np.float32)).to(dtype)
    mask = torch.as_tensor(
        rng.integers(0, 2, size=(g, K.num_row_tiles(R, K.TILE_R))).astype(np.int32)
    )
    one = K.spmm_ell(data, cols, x[..., None].contiguous())[..., 0]
    assert torch.equal(one, K.spmv_ell(data, cols, x))
    # the masked form is the unmasked one with skipped rows zeroed
    masked = K.spmv_ell(data, cols, x, tile_mask=mask)
    rows = K.rows_of_tiles(mask, K.TILE_R, R)
    assert torch.equal(masked, torch.where(rows, K.spmv_ell(data, cols, x), 0))


def test_batched_ranks_are_independent():
    """One call over g stacked ranks equals g calls on single ranks."""
    rng = np.random.default_rng(2)
    g, R, K_, N = 4, 37, 5, 50
    data = torch.as_tensor(rng.normal(size=(g, R, K_)).astype(np.float32))
    cols = torch.as_tensor(rng.integers(0, N, size=(g, R, K_)).astype(np.int32))
    X = torch.as_tensor(rng.normal(size=(g, N, 2)).astype(np.float32))
    batched = K.spmm_ell(data, cols, X)
    for r in range(g):
        assert torch.equal(batched[r], K.spmm_ell(data[r : r + 1], cols[r : r + 1], X[r : r + 1])[0])


def test_cpu_calls_do_not_count_launches():
    before = (K.spmv_ell.launches, K.spmm_ell.launches)
    data = torch.ones((1, 4, 2))
    cols = torch.zeros((1, 4, 2), dtype=torch.int32)
    K.spmv_ell(data, cols, torch.ones((1, 3)))
    K.spmm_ell(data, cols, torch.ones((1, 3, 2)))
    assert (K.spmv_ell.launches, K.spmm_ell.launches) == before


@pytest.mark.parametrize(
    "case",
    ["float64", "int64_cols", "mixed_dtype", "bad_shape", "bad_mask", "noncontiguous"],
)
def test_wrapper_rejects_bad_inputs(case):
    data = torch.ones((2, 8, 3))
    cols = torch.zeros((2, 8, 3), dtype=torch.int32)
    x = torch.ones((2, 5))
    mask = None
    if case == "float64":
        data, x = data.double(), x.double()
    elif case == "int64_cols":
        cols = cols.long()
    elif case == "mixed_dtype":
        x = x.bfloat16()
    elif case == "bad_shape":
        x = torch.ones((3, 5))
    elif case == "bad_mask":
        mask = torch.ones((2, 2), dtype=torch.int32)
    elif case == "noncontiguous":
        data = torch.ones((2, 3, 8)).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        K.spmv_ell(data, cols, x, tile_mask=mask)
