"""The port's MoE layer against the JAX reference's, on the CPU.

* ``_fill_capacity`` gives the reference's positions bitwise.
* The single-device path (``topo=None``) against the reference's local path
  in float32 (atol = rtol = 1e-5), with the router's top-k experts equal
  first: routing is discrete, so a flipped expert is reported as such and
  not absorbed by the tolerance.
* The all-to-all path on ``PodTopology(2, 4)`` against the reference's
  ``shard_map`` all-to-all on 8 forced host devices (the reference's own
  8-device case: M 16, 16 experts, top-2, F 32; uniform and skewed inputs),
  within 1e-5.  The reference's own exchange dispatch is not the yardstick
  (ROADMAP §C caveat 2).
* ``dispatch="exchange"`` is bitwise the port's all-to-all for every
  strategy and ``auto`` on both inputs; with the int8 wire, the dispatch
  hop stays within the codec's per-element envelope and the layer close to
  full precision; the reference's divisibility errors.
* llama4-scout at the tiny preset, at its own capacity factor (1.25): the
  prefill and the capacity-limited decode against the reference's on the
  same weights, and the full config's parameter count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_devices
from repro.configs import get_config as ref_config
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.launch.train import PRESETS as REF_PRESETS
from repro.models import LMModel as RefModel
from repro.models.moe import MoELayer as RefMoELayer
from repro_torch.comm import STRATEGY_NAMES, IrregularExchange, PodTopology, block_pattern, exchange_for
from repro_torch.comm import wire as W
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.launch.presets import PRESETS
from repro_torch.launch.serve import rehome_cache
from repro_torch.models.convert import from_reference
from repro_torch.models.lm import LMModel
from repro_torch.models.moe import MoELayer

TOL = 1e-5
M, B, S = 16, 8, 16
TOPO = PodTopology(npods=2, ppn=4)
#: the reference's 8-device case (tests/test_moe_dispatch.py)
SHARD_CFG = dict(n_experts=16, top_k=2, d_ff_expert=32)


def _params(rng, cfg, scale=2.0, shared=False):
    E, F = cfg["n_experts"], cfg["d_ff_expert"]
    p = {
        "router": rng.standard_normal((M, E)) * scale,
        "w_in": rng.standard_normal((E, M, F)) * 0.1,
        "w_gate": rng.standard_normal((E, M, F)) * 0.1,
        "w_out": rng.standard_normal((E, F, M)) * 0.1,
    }
    if shared:
        Fs = F * cfg.get("n_shared", 1)
        p["shared"] = {"w_in": rng.standard_normal((M, Fs)) * 0.1, "w_gate": rng.standard_normal((M, Fs)) * 0.1,
                       "w_out": rng.standard_normal((Fs, M)) * 0.1}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _inputs(rng):
    """The reference's uniform and skewed inputs: a constant bias skews the
    router's top-k towards a few experts."""
    return {
        "uniform": rng.standard_normal((B, S, M)).astype(np.float32),
        "skewed": (rng.standard_normal((B, S, M)) * 0.3 + rng.standard_normal(M)).astype(np.float32),
    }


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _ref_route(params, x, k):
    logits = jnp.einsum("bsm,me->bse", jnp.asarray(x), jnp.asarray(params["router"]))
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), k)
    return np.asarray(top_e)


def _shard_case():
    rng = np.random.default_rng(0)
    return _params(rng, SHARD_CFG), _inputs(rng)


# ---------------------------------------------------------------------------
# capacity fill and the single-device path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bins,cap", [(4, 3), (16, 1), (8, 100)])
def test_fill_capacity_matches_reference(bins, cap):
    eid = np.random.default_rng(bins).integers(0, bins, size=257).astype(np.int32)
    pos, keep = MoELayer._fill_capacity(torch.as_tensor(eid), cap)
    rpos, rkeep = RefMoELayer._fill_capacity(jnp.asarray(eid), bins, cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    # batched over a leading rank axis: each row is filled on its own
    two = np.stack([eid, eid[::-1]])
    bpos, _ = MoELayer._fill_capacity(torch.as_tensor(two), cap)
    np.testing.assert_array_equal(bpos[1].numpy(), np.asarray(RefMoELayer._fill_capacity(jnp.asarray(eid[::-1]), bins, cap)[0]))


@pytest.mark.parametrize(
    "case",
    [
        dict(n_experts=4, top_k=2, d_ff_expert=32),
        dict(n_experts=16, top_k=1, d_ff_expert=32, n_shared=1),
        dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=0.5),  # drops
    ],
    ids=["top2", "top1-shared", "top2-drops"],
)
@pytest.mark.parametrize("inp", ["uniform", "skewed"])
def test_local_path_matches_reference(case, inp):
    rng = np.random.default_rng(3)
    params = _params(rng, case, shared=bool(case.get("n_shared")))
    x = _inputs(rng)[inp]
    ref = RefMoELayer(M, RefMoEConfig(**case))
    layer = MoELayer(M, MoEConfig(**case))
    _, top_e = layer.route(_t(params), torch.as_tensor(x))
    np.testing.assert_array_equal(top_e.numpy(), _ref_route(params, x, case["top_k"]))
    want = np.asarray(ref(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = layer(_t(params), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the tally's drops are the assignments past each expert's capacity
    T, cfg = B * S * case["top_k"], MoEConfig(**case)
    cap = max(int(T / cfg.n_experts * cfg.capacity_factor), 1)
    over = np.maximum(np.bincount(top_e.numpy().ravel(), minlength=cfg.n_experts) - cap, 0).sum()
    assert layer.tally.read() == {"calls": 1, "routed": T, "dropped": over, "shipped": 0}


# ---------------------------------------------------------------------------
# the sharded paths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_map_outputs(tmp_path_factory):
    """The reference's shard_map all-to-all on 8 forced host devices."""
    params, inputs = _shard_case()
    d = tmp_path_factory.mktemp("moe")
    np.savez(d / "in.npz", **{f"p_{k}": v for k, v in params.items()}, **inputs)
    run_devices(
        f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.comm import PodTopology, execute_numpy, make_exchange_mesh
        from repro.configs.base import MoEConfig
        from repro.models.moe import MoELayer

        mesh = make_exchange_mesh(PodTopology(npods=2, ppn=4))
        data = np.load({str(d / "in.npz")!r})
        params = {{k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("p_")}}
        layer = MoELayer({M}, MoEConfig(**{SHARD_CFG!r}), ep_axis=("pod", "local"))
        out = {{name: np.asarray(layer(params, jnp.asarray(data[name]), mesh))
               for name in ("uniform", "skewed")}}

        # ROADMAP §C caveat 2: the reference's own exchange dispatch on the
        # uniform input, and its dispatch hop (send buffer in, halo out) as
        # the layer's stages run it
        x = jnp.asarray(data["uniform"])
        ex_layer = MoELayer({M}, MoEConfig(**{SHARD_CFG!r}), dispatch="exchange", strategy="standard")
        out["exchange_uniform"] = np.asarray(ex_layer(params, x, mesh))
        top_p, top_e = jax.lax.top_k(jax.nn.softmax(jnp.einsum("bsm,me->bse", x, params["router"]), -1), 2)
        top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
        n, b, S = 8, x.shape[0] // 8, x.shape[1]
        cap = max(int(b * S * 2 / n * 1.25), 8)
        stage_send = ex_layer._exchange_stages(mesh, b, S, {M}, jnp.dtype(jnp.float32))[0]
        send, send_e, _, _, counts = stage_send(x, top_p, top_e)
        step = ex_layer.dispatcher.step(np.asarray(counts, dtype=np.int64), cap, payload_width={M})
        out["hop_send"] = np.asarray(send)
        out["hop_widths"] = step.bundle.widths
        out["hop_device"] = np.asarray(step.exchange_dispatch(send))
        out["hop_numpy"] = execute_numpy(step.exchange_dispatch.plan, out["hop_send"])
        np.savez({str(d / "out.npz")!r}, **out)
        """,
        devices=8,
    )
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("inp", ["uniform", "skewed"])
def test_all_to_all_matches_reference_shard_map(shard_map_outputs, inp):
    params, inputs = _shard_case()
    x = inputs[inp]
    layer = MoELayer(M, MoEConfig(**SHARD_CFG))
    _, top_e = layer.route(_t(params), torch.as_tensor(x))
    np.testing.assert_array_equal(top_e.numpy(), _ref_route(params, x, SHARD_CFG["top_k"]))
    got = layer(_t(params), torch.as_tensor(x), TOPO)
    assert got.shape == (B, S, M) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), shard_map_outputs[inp], rtol=TOL, atol=TOL)


def test_reference_exchange_dispatch_moves_data_exactly(shard_map_outputs):
    """ROADMAP §C caveat 2: the reference's exchange dispatch misses its
    all-to-all bitwise, but its dispatch hop is exact -- the device output
    equals ``execute_numpy`` and the port's exchange on the same send buffer
    and routing widths -- so the last-bit difference comes from its compiled
    stages, and the layer stays within tolerance of the all-to-all."""
    out = shard_map_outputs
    np.testing.assert_array_equal(out["hop_device"], out["hop_numpy"])
    cap = out["hop_send"].shape[1] // TOPO.nranks
    pattern = block_pattern(TOPO, cap, out["hop_widths"])
    got = IrregularExchange(pattern, "standard", device="cpu")(torch.as_tensor(out["hop_send"]))
    np.testing.assert_array_equal(got.numpy(), out["hop_device"])
    np.testing.assert_allclose(out["exchange_uniform"], out["uniform"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("strategy", STRATEGY_NAMES + ("auto",))
@pytest.mark.parametrize("inp", ["uniform", "skewed"])
def test_exchange_is_bitwise_all_to_all(inp, strategy):
    params, inputs = _shard_case()
    x = torch.as_tensor(inputs[inp])
    base = MoELayer(M, MoEConfig(**SHARD_CFG))(_t(params), x, TOPO)
    layer = MoELayer(M, MoEConfig(**SHARD_CFG), dispatch="exchange", strategy=strategy)
    got = layer(_t(params), x, TOPO)
    assert torch.equal(got, base)
    # the dispatcher measured real traffic and the hops shipped only the
    # occupied prefixes
    disp = layer.dispatcher
    assert disp.histogram.updates == 1 and disp.device.type == "cpu"
    tally = layer.tally.read()
    widths = disp.bucketer(next(iter(disp._bucketers))).bundle.widths
    assert tally["shipped"] == 2 * int(widths.sum()) > 0
    if strategy != "auto":
        assert disp._strategies[next(iter(disp._strategies))] == strategy


@pytest.mark.parametrize("inp", ["uniform", "skewed"])
def test_exchange_int8_wire_stays_within_its_envelope(inp):
    params, inputs = _shard_case()
    x = torch.as_tensor(inputs[inp])
    cfg = MoEConfig(**SHARD_CFG)
    base = MoELayer(M, cfg)(_t(params), x, TOPO)
    lossy = MoELayer(M, cfg, dispatch="exchange", strategy="two_step", wire="int8")
    got = lossy(_t(params), x, TOPO)
    assert torch.isfinite(got).all() and not torch.equal(got, base)
    # the dispatch hop itself: each element within half an int8 step of its
    # wire block's largest magnitude (bounded here by the whole buffer's),
    # with the reference wire tests' slack for float32 rounding
    layer = MoELayer(M, cfg)
    top_p, top_e = layer.route(_t(params), x)
    n, e_local, t, cap = layer._shard_shapes(B, S, TOPO)
    send = layer._stage_send(x, top_p, top_e, n, e_local, t, cap)[0]
    bundle = lossy.dispatcher.bucketer(cap).bundle
    exact = exchange_for(bundle.pattern_dispatch, "two_step", device="cpu")(send)
    wired = exchange_for(bundle.pattern_dispatch, "two_step", device="cpu", wire="int8")(send)
    assert (wired - exact).abs().max() <= W.REL_ERROR_BOUND["int8"] * send.abs().max() * (1 + 1e-6)
    # and the layer, as the reference holds its lossy-wire exchange
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0.05, atol=0.05)


def test_sharded_paths_raise_the_reference_errors():
    params, inputs = _shard_case()
    x = torch.as_tensor(inputs["uniform"])
    bad = MoEConfig(n_experts=12, top_k=2, d_ff_expert=32)
    zeros = {"router": torch.zeros(M, 12), "w_in": torch.zeros(12, M, 32),
             "w_gate": torch.zeros(12, M, 32), "w_out": torch.zeros(12, 32, M)}
    for dispatch in ("all_to_all", "exchange"):
        with pytest.raises(ValueError, match="divisible.*12|12.*divisible"):
            MoELayer(M, bad, dispatch=dispatch)(zeros, x, TOPO)
        with pytest.raises(ValueError, match="batch"):
            MoELayer(M, MoEConfig(**SHARD_CFG), dispatch=dispatch)(_t(params), x[:4], TOPO)
    with pytest.raises(ValueError, match="dispatch must be"):
        MoELayer(M, bad, dispatch="ring")
    # one rank is the single-device path, whatever the dispatch
    one = MoELayer(M, MoEConfig(**SHARD_CFG), dispatch="exchange")(_t(params), x, PodTopology(1, 1))
    torch.testing.assert_close(one, MoELayer(M, MoEConfig(**SHARD_CFG))(_t(params), x), rtol=0, atol=0)


class _Mesh:
    """The axis names and sizes of a mesh, as the port's and the reference's
    ``_ep_size`` read them (a ``DeviceMesh`` / a ``jax.sharding.Mesh``)."""

    def __init__(self, **sizes):
        self.mesh_dim_names = self.axis_names = tuple(sizes)
        self.shape = sizes

    def size(self, dim: int) -> int:
        return self.shape[self.mesh_dim_names[dim]]


@pytest.mark.parametrize("ep_axis", ["data", "local", ("pod", "local"), ("pod", "local", "model"), ("data", "local")])
@pytest.mark.parametrize("dispatch", ["all_to_all", "exchange"])
def test_expert_parallel_axes_are_the_reference_ones(ep_axis, dispatch):
    """``ep_axis`` is a mesh axis or a tuple of them, and the degree their
    product (1 when one is absent); the exchange dispatch's default is the
    ``("pod", "local")`` world, as in the reference."""
    cfg = dict(n_experts=16, top_k=2, d_ff_expert=32)
    mesh = _Mesh(pod=2, local=4, model=2)
    for kw in ({}, {"ep_axis": ep_axis}):
        port = MoELayer(M, MoEConfig(**cfg), dispatch=dispatch, **kw)
        ref = RefMoELayer(M, RefMoEConfig(**cfg), dispatch=dispatch, **kw)
        assert port.ep_axis == ref.ep_axis and port._ep_axes() == ref._ep_axes()
        assert port._ep_size(mesh) == ref._ep_size(mesh)


# ---------------------------------------------------------------------------
# llama4-scout at the tiny preset, at its own capacity
# ---------------------------------------------------------------------------

ARCH, BATCH, PROMPT, EXTRA = "llama4-scout-17b-a16e", 2, 24, 3


@pytest.fixture(scope="module")
def llama4_tiny():
    ref = RefModel(REF_PRESETS["tiny"](ref_config(ARCH)))
    params = jax.jit(ref.init)(jax.random.PRNGKey(2))
    toks = np.random.default_rng(5).integers(0, ref.cfg.vocab_size, (BATCH, PROMPT + EXTRA))
    last, cache = ref.prefill(params, jnp.asarray(toks[:, :PROMPT], jnp.int32))
    full = ref.init_cache(BATCH, PROMPT + EXTRA, jnp.float32)
    cache = jax.tree.map(lambda d, s: d.at[tuple(slice(0, n) for n in s.shape)].set(s), full, cache)
    decode = jax.jit(ref.decode_step)
    steps = []
    for t in range(EXTRA):
        logits, cache = decode(params, jnp.asarray(toks[:, PROMPT + t : PROMPT + t + 1], jnp.int32), cache,
                               jnp.int32(PROMPT + t))
        steps.append(np.asarray(logits[:, 0]))
    model = LMModel(PRESETS["tiny"](get_config(ARCH)))
    return model, from_reference(model, jax.tree.map(np.asarray, params), device="cpu"), toks, np.asarray(last), steps


def test_tiny_llama4_prefill_and_capacity_limited_decode_match_reference(llama4_tiny):
    model, params, toks, want_last, want_steps = llama4_tiny
    cfg = model.cfg.moe
    assert (cfg.top_k, cfg.capacity_factor, cfg.n_shared) == (2, 1.25, 1)
    moe = model.segments[0].block.moe
    moe.tally.reset()
    last, cache = model.prefill(params, torch.as_tensor(toks[:, :PROMPT]), impl="kernel")
    np.testing.assert_allclose(last.numpy(), want_last, rtol=1e-4, atol=1e-4)
    prefill = moe.tally.read()
    cache = rehome_cache(model, cache, BATCH, PROMPT + EXTRA)
    moe.tally.reset()
    for t in range(EXTRA):
        logits, cache = model.decode_step(params, torch.as_tensor(toks[:, PROMPT + t : PROMPT + t + 1]), cache,
                                          PROMPT + t)
        np.testing.assert_allclose(logits[:, 0].numpy(), want_steps[t], rtol=1e-4, atol=1e-4)
    decode = moe.tally.read()
    # two layers share the block: one call per layer per step
    assert prefill["calls"] == model.cfg.n_layers and decode["calls"] == EXTRA * model.cfg.n_layers
    assert prefill["routed"] == model.cfg.n_layers * BATCH * PROMPT * cfg.top_k
    # decode routes B * k = 4 assignments into 4 experts of capacity 1
    assert decode["routed"] == EXTRA * model.cfg.n_layers * BATCH * cfg.top_k


def test_full_llama4_matches_the_reference_parameter_count():
    model = LMModel(get_config(ARCH))
    assert model.param_count() == RefModel(ref_config(ARCH)).param_count() == 107_769_861_120
    assert [s.name for s in model.segments] == ["moe"] and model.attention_head_pairs == {(128, 128)}
    cut = LMModel(dataclasses.replace(get_config(ARCH), n_layers=8))
    assert cut.param_count() == 19_685_790_720


def test_leading_dense_layers_make_a_dense0_segment():
    """``first_dense_layers`` (deepseek-v2's layout) puts a ``dense0``
    segment before the MoE segment, as in the reference; its full-sequence
    logits match the reference's on carried weights."""
    def with_dense0(cfg):
        return dataclasses.replace(cfg, n_layers=3, moe=dataclasses.replace(cfg.moe, first_dense_layers=1,
                                                                             capacity_factor=8.0))

    ref = RefModel(with_dense0(REF_PRESETS["tiny"](ref_config(ARCH))))
    model = LMModel(with_dense0(PRESETS["tiny"](get_config(ARCH))))
    assert [(s.name, s.count) for s in model.segments] == [("dense0", 1), ("moe", 2)]
    assert model.param_count() == ref.param_count()
    params = jax.jit(ref.init)(jax.random.PRNGKey(4))
    toks = np.random.default_rng(6).integers(0, ref.cfg.vocab_size, (2, 16))
    want = np.asarray(ref.apply(params, jnp.asarray(toks, jnp.int32)))
    got = model.apply(from_reference(model, jax.tree.map(np.asarray, params), device="cpu"), torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
