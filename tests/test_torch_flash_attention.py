"""The port's attention kernel B3 against the JAX reference.

On the CPU the wrapper :func:`repro_torch.kernels.flash_attention.flash_attention`
runs its plain version; it and :func:`attention_ref` are held to the Pallas
kernel ``flash_attention_kernel`` (interpret mode) and to ``ref.attention``
at the shapes of ``tests/test_kernels.py`` plus one at hymba-1.5b's head
ratio (25 query heads over 5 KV heads, head_dim 64, a window shorter than
the sequence) and at the head widths of stablelm-3b (80) and qwen3-32b
(128), with the reference's tolerances: 2e-4 in float32, 3e-2 in bfloat16.
At a value width other than the query/key width (MLA's), where the Pallas
kernel has no route, the wrapper and its plain version are held to the
reference's ``attend_chunked``.  Every (q/k, v) width pair that a config
sends to B3, at every preset, is one the kernel is compiled for, the
pairs of :data:`HEAD_PAIRS` are the CUDA source's, and so is the route
table :func:`kernel_route` (which kernel serves each pair and dtype).  The
CUDA kernels themselves are held to the plain version on a GPU by
``tests/test_torch_cuda.py``.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_kernel
from repro.models.layers import attend_chunked as ref_attend_chunked
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.presets import PRESETS
from repro_torch.launch.serve import check_kernel_heads
from repro_torch.models.lm import LMModel

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
    n0, routes = FA.flash_attention.launches, dict(FA.flash_attention.by_route)
    got = FA.flash_attention(tq, tk, tv, causal=causal, window=win)
    # the CPU route launches nothing and counts no kernel route
    assert FA.flash_attention.launches == n0 and dict(FA.flash_attention.by_route) == routes
    assert got.dtype == tdt and got.shape == (B, Sq, H, D)
    plain = FA.attention_ref(tq, tk, tv, causal=causal, window=win)
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(plain.float().numpy(), oracle, rtol=tol, atol=tol)


#: (B, Sq, Sk, H, KV, Dqk, Dv, causal): MLA's pair (192, 128) and its tiny
#: preset's (48, 32), GQA, a cached Sq < Sk, non-causal
SPLIT_CASES = [
    (2, 24, 24, 4, 4, 48, 32, True),
    (1, 40, 40, 4, 4, 192, 128, True),
    (2, 16, 48, 4, 2, 32, 16, True),
    (1, 30, 50, 4, 1, 64, 32, False),
]
ref_chunked = jax.jit(ref_attend_chunked, static_argnames=("causal", "window", "scale", "block"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_value_width_of_its_own_matches_reference_chunked(case, dtype):
    """q/k ``Dqk`` wide, v ``Dv`` wide: the wrapper (its plain version on the
    CPU) and ``attention_ref`` against the reference's ``attend_chunked``
    (small key blocks, so the online softmax is exercised), with MLA's
    scale ``1/sqrt(Dqk)``, at the reference's tolerances."""
    B, Sq, Sk, H, KV, Dqk, Dv, causal = case
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((B, Sq, H, Dqk), (B, Sk, KV, Dqk), (B, Sk, KV, Dv)))
    scale = 1.0 / np.sqrt(Dqk)
    want = np.asarray(ref_chunked(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal, scale=scale, block=16),
                      np.float32)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    got = FA.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    assert got.dtype == tdt and got.shape == (B, Sq, H, Dv)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(FA.attention_ref(tq, tk, tv, causal=causal).float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "make,err",
    [
        (lambda: (torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16)), ValueError),
        (lambda: (torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8)), ValueError),
        (lambda: (torch.zeros(1, 4, 2, 16, dtype=torch.float16),) * 3, TypeError),
        (lambda: (torch.zeros(1, 2, 4, 16).transpose(1, 2),) + (torch.zeros(1, 4, 2, 16),) * 2, ValueError),
        (lambda: (torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32), torch.zeros(2, 4, 2, 16)), ValueError),
        (lambda: (torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32), torch.zeros(1, 5, 2, 16)), ValueError),
        (lambda: (torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 16)), ValueError),
        (lambda: (torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32), torch.zeros(4, 2, 16)), ValueError),
    ],
    ids=["heads-do-not-group", "head-dim-differs", "float16", "not-contiguous", "v-batch-differs",
         "v-keys-differ", "v-kv-heads-differ", "v-not-4d"],
)
def test_flash_attention_rejects_bad_inputs(make, err):
    with pytest.raises(err):
        FA.flash_attention(*make())


def test_check_accepts_a_value_width_of_its_own():
    """v may be as wide as it likes; its batch, keys and KV heads are k's."""
    q, k, v = torch.zeros(1, 4, 2, 32), torch.zeros(1, 6, 1, 32), torch.zeros(1, 6, 1, 16)
    FA._check(q, k, v, None)
    assert FA.flash_attention(q, k, v).shape == (1, 4, 2, 16)


#: every config LMModel builds: all of the repo's
SERVED = list(ARCH_IDS)


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("arch", SERVED)
def test_every_served_head_width_is_taken(arch, preset):
    """Every (q/k, v) width pair that a config sends to B3, at every preset,
    is one the CUDA kernel takes (the predicate its wrapper checks on a CUDA
    tensor)."""
    model = LMModel(PRESETS[preset](get_config(arch)))
    for qk, v in model.attention_head_pairs:
        assert FA.head_dims_supported(qk, v), (arch, preset, qk, v)
    assert bool(model.attention_head_pairs) == (model.cfg.family != "ssm")
    check_kernel_heads(model)


def test_check_kernel_heads_names_the_config():
    cfg = dataclasses.replace(get_config("stablelm-3b"), head_dim=72)
    with pytest.raises(ValueError, match="stablelm-3b: head_dim 72"):
        check_kernel_heads(LMModel(cfg))
    assert not FA.head_dims_supported(72, 72) and FA.head_dims_supported(80, 80)
    mla = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(mla, mla=dataclasses.replace(mla.mla, v_head_dim=96))
    with pytest.raises(ValueError, match="deepseek-v2-lite-16b: head_dim 192 .q/k. / 96 .v."):
        check_kernel_heads(LMModel(cfg))


def test_head_pair_predicate():
    """Equal widths: the multiples of 16 up to 128; unequal: MLA's pairs
    only, in that order (q/k, v)."""
    for d in range(1, 200):
        assert FA.head_dims_supported(d, d) == (d % 16 == 0 and d <= 128), d
    assert FA.head_dims_supported(192, 128) and FA.head_dims_supported(48, 32)
    for qk, v in [(128, 192), (32, 48), (192, 192), (192, 64), (64, 32), (48, 16)]:
        assert not FA.head_dims_supported(qk, v), (qk, v)


def test_head_pairs_are_the_cuda_sources():
    """The pure-Python list of compiled pairs is the one the CUDA source
    dispatches on (``REPRO_HEAD_DIMS`` and ``REPRO_HEAD_PAIRS``)."""
    src = (Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu").read_text()
    equal = re.search(r"#define REPRO_HEAD_DIMS\(X\) (.*)", src).group(1)
    pairs = re.search(r"#define REPRO_HEAD_PAIRS\(X\) (.*)", src).group(1)
    compiled = [(int(d), int(d)) for d in re.findall(r"X\((\d+)\)", equal)]
    compiled += [(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", pairs)]
    assert tuple(compiled) == FA.HEAD_PAIRS


def test_kernel_route_is_the_cuda_sources():
    """:func:`kernel_route` names the kernel that ``launch<>`` in the CUDA
    source runs: bfloat16 goes to ``flash_fwd_bf16_wgmma`` at the pairs of
    ``REPRO_WGMMA_PAIRS`` (which ``launch<>`` tests through
    ``wgmma_pair<DQK, DV>()``) and to ``flash_fwd_bf16`` at every other
    compiled pair; float32 goes to ``flash_fwd_f32``."""
    src = (Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu").read_text()
    macro = re.search(r"#define REPRO_WGMMA_PAIRS\(X\) (.*)", src).group(1)
    wgmma = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    body = re.search(r"int launch\(int dtype,.*?\n}\n", src, re.S).group(0)
    assert re.search(r"dtype == 0\) return launch_f32<DQK, DV>", body)
    assert re.search(r"if constexpr \(wgmma_pair<DQK, DV>\(\)\) \{\s*return launch_bf16_wgmma<DQK, DV>", body)
    assert re.search(r"\} else \{\s*return launch_bf16<DQK, DV>", body)
    assert "REPRO_WGMMA_PAIRS(REPRO_IS)" in re.search(r"constexpr bool wgmma_pair\(\) \{.*?\n}\n", src, re.S).group(0)
    assert wgmma == set(FA.WGMMA_PAIRS) and wgmma <= set(FA.HEAD_PAIRS)
    for qk, v in FA.HEAD_PAIRS:
        assert FA.kernel_route(qk, v, torch.float32) == "f32"
        assert FA.kernel_route(qk, v, torch.bfloat16) == ("wgmma" if (qk, v) in wgmma else "mma"), (qk, v)
    with pytest.raises(ValueError):
        FA.kernel_route(72, 72, torch.bfloat16)
    with pytest.raises(TypeError):
        FA.kernel_route(64, 64, torch.float16)


def test_served_wide_heads_take_the_wgmma_route():
    """Every served family runs the wgmma kernel in bfloat16: llama4-scout's
    and the vlm's heads of 128, deepseek-v2-lite's MLA pair (192, 128),
    hymba's and whisper's 64, and stablelm-3b's 80 (in 32-byte swizzle
    rows); only the tiny presets' widths keep ``mma.sync``."""
    for arch, route in [("llama4-scout-17b-a16e", "wgmma"), ("llama-3.2-vision-90b", "wgmma"),
                        ("deepseek-v2-lite-16b", "wgmma"), ("hymba-1.5b", "wgmma"),
                        ("whisper-large-v3", "wgmma"), ("stablelm-3b", "wgmma")]:
        model = LMModel(PRESETS["full"](get_config(arch)))
        assert {FA.kernel_route(qk, v, torch.bfloat16) for qk, v in model.attention_head_pairs} == {route}, arch
