"""The port's attention kernel B3 against the JAX reference.

On the CPU the wrapper :func:`repro_torch.kernels.flash_attention.flash_attention`
runs its plain version; it and :func:`attention_ref` are held to the Pallas
kernel ``flash_attention_kernel`` (interpret mode) and to ``ref.attention``
at the shapes of ``tests/test_kernels.py`` plus one at hymba-1.5b's head
ratio (25 query heads over 5 KV heads, head_dim 64, a window shorter than
the sequence) and at the head widths of stablelm-3b (80) and qwen3-32b
(128), with the reference's tolerances: 2e-4 in float32, 3e-2 in bfloat16.
Every head width a served config resolves to is one the kernel takes.  The
CUDA kernel itself is held to the plain version on a GPU by
``tests/test_torch_cuda.py``.
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_kernel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.presets import PRESETS
from repro_torch.launch.serve import check_kernel_heads
from repro_torch.models.lm import FAMILIES, LMModel

CASES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 48, 48, 4, 4, 16, True, 16),
    (2, 16, 64, 4, 2, 32, True, None),  # cached decode-style Sq < Sk
    (1, 64, 64, 2, 1, 64, False, None),  # bidirectional (encoder)
    (1, 100, 100, 2, 2, 32, True, 32),  # non-multiple of block
    (1, 80, 80, 25, 5, 64, True, 24),  # hymba's head ratio, window < S
    (1, 40, 40, 4, 4, 80, True, 12),  # stablelm-3b's head width
    (1, 33, 33, 8, 2, 128, True, None),  # qwen3-32b's head width and ratio
]
#: one compiled program per case instead of one per eager op
ref_attention = jax.jit(ref.attention, static_argnames=("causal", "window"))
DTYPES = {"float32": (np.float32, torch.float32, 2e-4), "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, Sq, Sk, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_matches_pallas_and_ref(case, dtype):
    B, Sq, Sk, H, KV, D, causal, win = case
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(B, Sq, Sk, H, KV, D)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    pallas = np.asarray(
        flash_attention_kernel(jq, jk, jv, causal=causal, window=win, block_q=32, block_k=32, interpret=True),
        np.float32,
    )
    oracle = np.stack(
        [np.asarray(ref_attention(jq[b], jk[b], jv[b], causal=causal, window=win), np.float32) for b in range(B)]
    )
    n0 = FA.flash_attention.launches
    got = FA.flash_attention(tq, tk, tv, causal=causal, window=win)
    assert FA.flash_attention.launches == n0  # the CPU route launches nothing
    assert got.dtype == tdt and got.shape == (B, Sq, H, D)
    plain = FA.attention_ref(tq, tk, tv, causal=causal, window=win)
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(plain.float().numpy(), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "make,err",
    [
        (lambda: (torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16)), ValueError),
        (lambda: (torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8)), ValueError),
        (lambda: (torch.zeros(1, 4, 2, 16, dtype=torch.float16),) * 3, TypeError),
        (lambda: (torch.zeros(1, 2, 4, 16).transpose(1, 2),) + (torch.zeros(1, 4, 2, 16),) * 2, ValueError),
    ],
    ids=["heads-do-not-group", "head-dim-differs", "float16", "not-contiguous"],
)
def test_flash_attention_rejects_bad_inputs(make, err):
    with pytest.raises(err):
        FA.flash_attention(*make())


#: the configs LMModel builds: a ported family and no MLA (ROADMAP A.4b)
SERVED = [a for a in ARCH_IDS if get_config(a).family in FAMILIES and get_config(a).mla is None]


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("arch", SERVED)
def test_every_served_head_width_is_taken(arch, preset):
    """The head width of every served config, at every preset, is one the
    CUDA kernel takes (the predicate its wrapper checks on a CUDA tensor)."""
    model = LMModel(PRESETS[preset](get_config(arch)))
    D = model.attention_head_dim
    assert D is None or FA.head_dim_supported(D), (arch, preset, D)
    check_kernel_heads(model)


def test_check_kernel_heads_names_the_config():
    cfg = dataclasses.replace(get_config("stablelm-3b"), head_dim=72)
    with pytest.raises(ValueError, match="stablelm-3b: head_dim 72"):
        check_kernel_heads(LMModel(cfg))
    assert not FA.head_dim_supported(72) and FA.head_dim_supported(80)
