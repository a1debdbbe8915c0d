"""The port's LMModel against the JAX reference, for all six families.

``hymba-1.5b`` (hybrid: sliding-window GQA + Mamba-2 heads), ``stablelm-3b``
(dense), ``mamba2-780m`` (ssm), ``llama4-scout-17b-a16e`` (moe: 4 experts,
top-2, one shared expert, at the reference tests' capacity factor 8, so
that no assignment is dropped and decode equals the full forward),
``deepseek-v2-lite-16b`` (moe with MLA: latent rank 32, rope 16, nope 16,
v 16, so q/k heads 32 wide and v heads 16; one dense layer, one MoE layer),
``whisper-large-v3`` (enc_dec: 2 encoder layers over 8 context frames, 2
decoder layers) and ``llama-3.2-vision-90b`` (vlm: one self and one cross
layer over 8 image tokens), each shrunk as in ``tests/test_models.py``, in
float32.  The vlm and enc_dec models get the same stub context embeddings
``[B, 8, d_model]`` from a numpy seed.  The reference's parameters
(``LMModel.init``) are carried over with ``from_reference``; the port runs
with ``impl="kernel"`` on the CPU (the plain versions of B3 and B4), the
reference with ``impl="pallas"`` (Pallas in interpret mode), except for
deepseek, where the reference runs ``impl="chunked"``: its Pallas kernel
sizes v by q's width and so has no route for MLA's unequal widths.  The
hymba prompt (12) is longer than its window (8), so the prefill writes the
window ring.  Tolerances: 1e-4 between the two packages; 5e-2 for the
port's decode against its own full forward, as ``tests/test_models.py``
allows the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import tree_flatten_with_path
from repro.configs import get_config as ref_config
from repro.models import LMModel as RefModel
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import serve
from repro_torch.launch.serve import rehome_cache
from repro_torch.models.convert import from_reference
from repro_torch.models.lm import LMModel
from repro_torch.models.sharding import tree_items

ARCHS = ["hymba-1.5b", "stablelm-3b", "mamba2-780m", "llama4-scout-17b-a16e",
         "deepseek-v2-lite-16b", "whisper-large-v3", "llama-3.2-vision-90b"]
NEW_ARCHS = ["deepseek-v2-lite-16b", "llama-3.2-vision-90b", "whisper-large-v3"]
B, S, EXTRA = 2, 12, 3
CTX = 8  # context frames / image tokens of the shrunk enc_dec and vlm
TOL = 1e-4


def shrink(cfg, dtype="float32"):
    kw = dict(
        n_layers=2, d_model=64, d_ff=128 if cfg.d_ff else 0, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16, vocab_size=256, dtype=dtype,
        cross_context=CTX if cfg.cross_context else 0,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla:
        kw["mla"] = dataclasses.replace(cfg.mla, kv_lora_rank=32, rope_head_dim=16, nope_head_dim=16,
                                        v_head_dim=16)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8, head_dim=8, chunk=8)
    if cfg.encoder:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2, context=CTX)
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = 2  # one self and one cross layer
    if cfg.window:
        kw["window"] = 8
    return dataclasses.replace(cfg, **kw)


def _blend(dst, src):
    if dst.shape != src.shape:
        return dst.at[tuple(slice(0, s) for s in src.shape)].set(src.astype(dst.dtype))
    return src.astype(dst.dtype)


def _flat(tree) -> dict:
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The reference's outputs for one arch, and the port's model and weights."""
    arch = request.param
    ref = RefModel(shrink(ref_config(arch)))
    model = LMModel(shrink(get_config(arch)))
    params = jax.jit(ref.init)(jax.random.PRNGKey(1))  # one compile, not one per leaf
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S + EXTRA))
    ctx = rng.normal(size=(B, CTX, 64)).astype(np.float32) if model.ctx_len() else None
    jctx = None if ctx is None else jnp.asarray(ctx)
    impl = "chunked" if ref.cfg.mla else "pallas"  # the reference's Pallas has no MLA route
    last, cache = ref.prefill(params, jnp.asarray(toks[:, :S], jnp.int32), jctx, impl=impl)
    out = {"arch": arch, "toks": toks, "ctx": None if ctx is None else torch.as_tensor(ctx),
           "prefill": np.asarray(last), "cache": _flat(cache)}
    cache = jax.tree.map(_blend, ref.init_cache(B, S + EXTRA, jnp.float32), cache)
    out["decode"] = []
    decode = jax.jit(ref.decode_step)  # one compile for the three steps
    for t in range(EXTRA):
        logits, cache = decode(params, jnp.asarray(toks[:, S + t : S + t + 1], jnp.int32), cache,
                                        jnp.int32(S + t))
        out["decode"].append(np.asarray(logits[:, 0]))
    out["apply"] = np.asarray(ref.apply(params, jnp.asarray(toks, jnp.int32), jctx))
    out["model"] = model
    out["ref_params"] = jax.tree.map(np.asarray, params)
    out["params"] = from_reference(model, out["ref_params"], device="cpu")
    return out


def test_prefill_logits_and_cache_match_reference(pair):
    model, params = pair["model"], pair["params"]
    tokens = torch.as_tensor(pair["toks"][:, :S])
    n_fa, n_ssd = FA.flash_attention.launches, SSD.ssd_chunked.launches
    last, cache = model.prefill(params, tokens, pair["ctx"], impl="kernel")
    assert (FA.flash_attention.launches, SSD.ssd_chunked.launches) == (n_fa, n_ssd)
    np.testing.assert_allclose(last.numpy(), pair["prefill"], rtol=TOL, atol=TOL)
    got = {k: v.numpy() for k, v in tree_items(cache)}
    assert sorted(got) == sorted(pair["cache"])
    for key, want in pair["cache"].items():
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key], want, rtol=TOL, atol=TOL, err_msg=key)


def test_decode_after_rehome_matches_reference(pair):
    model, params, toks = pair["model"], pair["params"], pair["toks"]
    _, cache = model.prefill(params, torch.as_tensor(toks[:, :S]), pair["ctx"], impl="kernel")
    cache = rehome_cache(model, cache, B, S + EXTRA)
    for t in range(EXTRA):
        logits, cache = model.decode_step(params, torch.as_tensor(toks[:, S + t : S + t + 1]), cache, S + t)
        np.testing.assert_allclose(logits[:, 0].numpy(), pair["decode"][t], rtol=TOL, atol=TOL)


def test_apply_matches_reference(pair):
    got = pair["model"].apply(pair["params"], torch.as_tensor(pair["toks"]), pair["ctx"], impl="dot")
    np.testing.assert_allclose(got.numpy(), pair["apply"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_decode_matches_own_full_forward(pair, impl):
    model, params, toks = pair["model"], pair["params"], pair["toks"]
    full = model.apply(params, torch.as_tensor(toks), pair["ctx"], impl=impl)
    last, cache = model.prefill(params, torch.as_tensor(toks[:, :S]), pair["ctx"], impl=impl)
    torch.testing.assert_close(last[:, 0], full[:, S - 1], rtol=5e-3, atol=5e-3)
    cache = rehome_cache(model, cache, B, S + EXTRA)
    for t in range(EXTRA):
        logits, cache = model.decode_step(params, torch.as_tensor(toks[:, S + t : S + t + 1]), cache, S + t)
        torch.testing.assert_close(logits[:, 0], full[:, S + t], rtol=5e-2, atol=5e-2)


def test_from_reference_rejects_missing_extra_and_misshapen(pair):
    model, tree = pair["model"], pair["ref_params"]
    seg = next(k for k in tree if k.startswith("seg_"))
    with pytest.raises(KeyError, match="missing"):
        from_reference(model, {k: v for k, v in tree.items() if k != "embed"}, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        from_reference(model, {**tree, "not_a_leaf": np.zeros((64, 64), np.float32)}, device="cpu")
    bad = {**tree, "embed": tree["embed"][:-1]}
    with pytest.raises(ValueError, match="embed"):
        from_reference(model, bad, device="cpu")
    # leaves the reference reads in float32 stay float32 in a bfloat16 model
    half = from_reference(model, tree, device="cpu", dtype=torch.bfloat16)
    assert half["embed"].dtype == torch.bfloat16
    assert half["final_norm"]["scale"].dtype == torch.float32
    if "ssm" in half[seg]:
        assert {half[seg]["ssm"][k].dtype for k in ("a_log", "dt_bias", "d_skip")} == {torch.float32}
    if "w_uk" in half[seg].get("attn", {}):
        assert half[seg]["attn"]["kv_norm"]["scale"].dtype == torch.float32
        assert half[seg]["attn"]["w_uv"].dtype == torch.bfloat16


def _edit(tree, key, value=None):
    """A copy of the nested ``tree`` with the dotted ``key`` dropped (``value``
    None) or replaced."""
    head, _, rest = key.partition(".")
    out = dict(tree)
    if rest:
        out[head] = _edit(tree[head], rest, value)
    elif value is None:
        del out[head]
    else:
        out[head] = value
    return out


#: leaves of MLA, cross-attention, the encoder and the adapter (those
#: reached in each shrunk config)
NEW_LEAVES = {
    "deepseek-v2-lite-16b": ["seg_dense0.attn.wq", "seg_moe.attn.w_kv_a", "seg_moe.attn.kv_norm.scale",
                             "seg_moe.attn.w_uk", "seg_moe.attn.w_uv", "seg_moe.attn.wo"],
    "whisper-large-v3": ["seg_dec.cross.wq", "seg_dec.cross.wk", "seg_dec.cross_norm.scale",
                         "enc_enc.attn.wv", "enc_enc.mlp.w_in", "adapter"],
    "llama-3.2-vision-90b": ["seg_cross.cross.wv", "seg_cross.cross.wo", "seg_cross.cross_norm.scale",
                             "adapter"],
}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_from_reference_rejects_missing_and_misshapen_new_leaves(arch):
    """MLA's, cross-attention's, the encoder's and the adapter's leaves carry
    over one to one, and each raises where it is missing or misshapen."""
    ref = RefModel(shrink(ref_config(arch)))
    model = LMModel(shrink(get_config(arch)))
    tree = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.PRNGKey(2)))
    got = dict(tree_items(from_reference(model, tree, device="cpu")))
    for key in NEW_LEAVES[arch]:
        assert key in got, key
        with pytest.raises(KeyError, match="missing"):
            from_reference(model, _edit(tree, key), device="cpu")
        leaf = dict(tree_items(tree))[key]
        with pytest.raises(ValueError, match=key.split(".")[-1]):
            from_reference(model, _edit(tree, key, np.zeros((*leaf.shape, 2), np.float32)), device="cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_mla_vlm_enc_dec_build_and_serve_tiny(arch):
    """The configs whose families or attention the port once refused (MLA,
    vlm, enc_dec) build and serve at the tiny preset on the CPU, with the
    reference's segments and context length and the stub context drawn
    after the prompts; the same seed gives the same tokens."""
    argv = ["--arch", arch, "--preset", "tiny", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
            "--gen", "4", "--seed", "3"]
    out = serve.main(argv)
    assert out["tokens"].shape == (2, 4)
    assert torch.equal(serve.main(argv)["tokens"], out["tokens"])
    model, _ = serve.build(arch, "tiny", device="cpu")
    ref = RefModel(serve.PRESETS["tiny"](ref_config(arch)))
    assert [(s.name, s.count) for s in model.segments] == [(s.name, s.count) for s in ref.segments]
    assert [(s.name, s.count) for s in model.enc_segments] == [(s.name, s.count) for s in ref.enc_segments]
    assert model.ctx_len() == ref.ctx_len()
    prompts, ctx = serve.make_context(model.cfg.vocab_size, 2, 20, model.ctx_len(), model.cfg.d_model, seed=3)
    np.testing.assert_array_equal(prompts, serve.make_prompts(model.cfg.vocab_size, 2, 20, seed=3))
    rng = np.random.default_rng(3)
    rng.integers(0, model.cfg.vocab_size, (2, 20))
    if model.ctx_len():
        np.testing.assert_array_equal(ctx, rng.normal(size=(2, model.ctx_len(), model.cfg.d_model)).astype(np.float32))
    else:
        assert ctx is None


def test_full_hymba_matches_the_reference_parameter_count():
    cfg = get_config("hymba-1.5b")
    model = LMModel(cfg)
    assert model.param_count() == RefModel(ref_config("hymba-1.5b")).param_count() == 1_640_812_800
    assert model.vocab == 32016 and [s.name for s in model.segments] == ["hyb"]


@pytest.mark.parametrize("arch,count", [("deepseek-v2-lite-16b", 15_647_895_040),
                                        ("whisper-large-v3", 1_602_643_200),
                                        ("llama-3.2-vision-90b", 87_733_903_360)])
def test_full_new_configs_match_the_reference_parameter_count(arch, count):
    model = LMModel(get_config(arch))
    assert model.param_count() == RefModel(ref_config(arch)).param_count() == count
