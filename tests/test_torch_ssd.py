"""The port's SSD kernel B4 and Mamba-2 mixer against the JAX reference.

On the CPU the wrapper :func:`repro_torch.kernels.ssd_scan.ssd_chunked` runs
its plain version, the port's ``models/ssd.py::ssd_chunked``.  Both are held
to the Pallas kernel ``ssd_scan_kernel`` (interpret mode) and to
``repro.models.ssd.ssd_chunked`` within 2e-4, and to the sequential oracle
``ref.ssd_scan`` within 5e-4 (the tolerances of ``tests/test_kernels.py``);
so is :func:`_chunk_parallel`, the CUDA kernels' decomposition in plain
PyTorch.
The port's ``Mamba2Mixer(impl="kernel")`` is held to the reference's
``Mamba2Mixer(impl="pallas")`` on the same carried-over parameters.  The CUDA
kernel itself is held to the plain version on a GPU by
``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as RefSSMConfig
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan_kernel
from repro.models.mamba2 import Mamba2Mixer as RefMixer
from repro.models.sharding import init_params
from repro.models.ssd import ssd_chunked as ref_chunked
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import ssd as port_ssd
from repro_torch.models.mamba2 import Mamba2Mixer
from repro_torch.models.sharding import tree_map

SHAPES = [(2, 32, 3, 4, 8, 8), (1, 50, 2, 16, 8, 16), (2, 128, 4, 8, 16, 32), (1, 7, 1, 2, 3, 4)]


def _inputs(B, S, H, P, N, seed=0, decay=0.2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            (-np.abs(rng.normal(size=(B, S, H))) * decay).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES)
def test_ssd_matches_pallas_chunked_and_oracle(B, S, H, P, N, Q):
    x, loga, b, c = _inputs(B, S, H, P, N)
    j = [jnp.asarray(a) for a in (x, loga, b, c)]
    t = [torch.as_tensor(a) for a in (x, loga, b, c)]
    pallas = np.asarray(ssd_scan_kernel(*j, chunk=Q, interpret=True))
    chunked = np.asarray(ref_chunked(*j, chunk=Q))
    n0 = SSD.ssd_chunked.launches
    got = SSD.ssd_chunked(*t, chunk=Q).numpy()
    assert SSD.ssd_chunked.launches == n0  # the CPU route launches nothing
    plain = port_ssd.ssd_chunked(*t, chunk=Q).numpy()
    oracle = SSD.ssd_scan_ref(*t).numpy()
    for y in (got, plain):
        np.testing.assert_allclose(y, pallas, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(y, chunked, rtol=2e-4, atol=2e-4)
    for bi in range(B):
        seq = np.asarray(ref.ssd_scan(j[0][bi], jnp.exp(j[1][bi]), j[2][bi], j[3][bi]))
        np.testing.assert_allclose(got[bi], seq, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(oracle[bi], seq, rtol=5e-4, atol=5e-4)


def _chunk_parallel(
    xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int = 128
) -> torch.Tensor:
    """The CUDA kernels' decomposition in plain PyTorch, every chunk at once
    but the state passing: scores ``G = c b^T`` per chunk, each chunk's own
    end state, ``h_c = h_{c-1} exp(la_end_c) + S_c`` over chunks, then
    ``y = (G o decay) x + exp(la) (c . h_{c-1})``.  float32, ``la`` summed
    in float64 inside a chunk, the exponent masked and never the product."""
    B, S, H, P = xdt.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    x = torch.nn.functional.pad(xdt.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, Q, H, P)
    la = torch.nn.functional.pad(loga.double(), (0, 0, 0, pad)).reshape(B, nc, Q, H).cumsum(2)
    bq = torch.nn.functional.pad(b.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    cq = torch.nn.functional.pad(c.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    scores = torch.einsum("bcin,bcjn->bcij", cq, bq)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = (la[:, :, :, None] - la[:, :, None, :]).float()  # [B, nc, Q, Q, H]
    decay = torch.exp(diff.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    la_end = la[:, :, -1]  # [B, nc, H]
    w = torch.exp((la_end[:, :, None] - la).float())  # [B, nc, Q, H]
    own = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bq, w, x)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(h)
        h = h * torch.exp(la_end[:, i].float())[:, :, None, None] + own[:, i]
    hin = torch.stack(entering, dim=1)  # [B, nc, H, N, P]
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, decay, x)
    y = y + torch.einsum("bcin,bchnp->bcihp", cq, hin) * torch.exp(la.float())[..., None]
    return y.reshape(B, nc * Q, H, P)[:, :S]


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES + [(1, 70, 2, 6, 5, 16)])
def test_ssd_chunk_parallel_matches_reference(B, S, H, P, N, Q):
    """The CUDA kernels' decomposition in plain PyTorch against the
    reference's chunked SSD (2e-4) and sequential oracle (5e-4)."""
    x, loga, b, c = _inputs(B, S, H, P, N, seed=1)
    j = [jnp.asarray(a) for a in (x, loga, b, c)]
    got = _chunk_parallel(*(torch.as_tensor(a) for a in (x, loga, b, c)), chunk=Q).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_chunked(*j, chunk=Q)), rtol=2e-4, atol=2e-4)
    for bi in range(B):
        seq = np.asarray(ref.ssd_scan(j[0][bi], jnp.exp(j[1][bi]), j[2][bi], j[3][bi]))
        np.testing.assert_allclose(got[bi], seq, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("seed,q", [(0, 4), (1, 8), (2, 16)])
def test_ssd_chunk_invariance(seed, q):
    """The output does not depend on the chunk size (as in tests/test_kernels.py)."""
    t = [torch.as_tensor(a) for a in _inputs(1, 24, 2, 4, 6, seed=seed, decay=0.3)]
    np.testing.assert_allclose(
        SSD.ssd_chunked(*t, chunk=q).numpy(), SSD.ssd_chunked(*t, chunk=24).numpy(), rtol=2e-4, atol=2e-4
    )


@pytest.mark.parametrize(
    "make,err",
    [
        (lambda: (torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 3), torch.zeros(1, 8, 5), torch.zeros(1, 8, 5)),
         ValueError),
        (lambda: (torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2), torch.zeros(1, 8, 5), torch.zeros(1, 8, 6)),
         ValueError),
        (lambda: (torch.zeros(1, 8, 2, 4, dtype=torch.bfloat16), torch.zeros(1, 8, 2), torch.zeros(1, 8, 5),
                  torch.zeros(1, 8, 5)), TypeError),
        (lambda: (torch.zeros(1, 2, 8, 4).transpose(1, 2), torch.zeros(1, 8, 2), torch.zeros(1, 8, 5),
                  torch.zeros(1, 8, 5)), ValueError),
    ],
    ids=["loga-heads-differ", "b-c-differ", "bfloat16", "not-contiguous"],
)
def test_ssd_chunked_rejects_bad_inputs(make, err):
    with pytest.raises(err):
        SSD.ssd_chunked(*make())


def test_mamba2_mixer_kernel_matches_reference_pallas():
    rcfg = RefSSMConfig(state_dim=8, head_dim=8, expand=2, chunk=8)
    ref_mixer = RefMixer(32, rcfg)
    port_mixer = Mamba2Mixer(32, SSMConfig(**dataclasses.asdict(rcfg)))
    # one compile, not one per leaf
    params = jax.jit(lambda key: init_params(ref_mixer.params(), key, jnp.float32))(jax.random.PRNGKey(3))
    tparams = tree_map(lambda a: torch.tensor(np.asarray(a)), params)
    x = np.random.default_rng(4).normal(size=(2, 20, 32)).astype(np.float32)
    want = np.asarray(ref_mixer(params, jnp.asarray(x), impl="pallas"))
    got = port_mixer(tparams, torch.as_tensor(x), impl="kernel").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
