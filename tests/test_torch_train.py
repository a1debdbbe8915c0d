"""The port's training path against the JAX reference, on the CPU.

Per module: AdamW (``repro_torch.optim``), the synthetic data
(``repro_torch.data``) and checkpoints (``repro_torch.checkpoint``), each
with the counterparts of ``tests/test_substrates.py`` and against the
reference's own functions; ``LMModel.loss`` and its gradients for the seven
families' ``tiny`` presets against ``jax.value_and_grad`` of the
reference's ``LMModel.loss``; and the trainer (``repro_torch.runtime``)
against the reference composed without a mesh (``value_and_grad`` +
``adamw_update``).  The reference's own ``Trainer`` is not the oracle: under
a mesh its embedding gather raises (ROADMAP caveat C.3).

Inputs are made from seeds with numpy (the reference's weights from its
``LMModel.init``, carried over with ``from_reference`` in float32).
Tolerances: AdamW 1e-6 relative; loss 1e-5 relative and each gradient leaf
within 1e-4 of that leaf's max abs (every family, MoE included: at the
tiny presets no routing decision is near a tie); five float32 steps: losses
1e-4 relative, parameters by
:func:`repro_torch.testing.trajectory.compare_trajectories` (1e-4 of each
leaf's max abs, plus Adam's amplified gradient noise on at most 2% of each
leaf; planted gradient faults must fail it); a
bfloat16 step's loss 2e-2 and masters 2·lr + 1e-6 (a step of Adam moves an
element by about ±lr, so a sign flip of a tiny gradient costs 2·lr).
"""

import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import optim as ref_optim
from repro.compat import tree_flatten_with_path
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_config
from repro.data import SyntheticTokens as RefTokens
from repro.launch.train import tiny as ref_tiny
from repro.models import LMModel as RefModel
from repro_torch.checkpoint import CheckpointManager, flatten_state, latest_step, load_checkpoint, save_checkpoint
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as train_launcher
from repro_torch.launch.presets import tiny
from repro_torch.models.convert import from_reference
from repro_torch.models.lm import LMModel
from repro_torch.models.sharding import tree_items
from repro_torch.optim import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    warmup_cosine,
)
from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig, build_train_step
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.testing.trajectory import compare_trajectories, noisy_steps

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = ["stablelm-3b", "hymba-1.5b", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
         "whisper-large-v3", "llama-3.2-vision-90b", "mamba2-780m"]
B, S = 2, 64  # S is twice hymba's tiny window (32): the window masks


def _flat_ref(tree) -> dict:
    """The reference tree's leaves by the port's dotted key."""
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in tree_flatten_with_path(tree)[0]}


def _flat(tree) -> dict:
    return {k: v.detach().numpy() for k, v in tree_items(tree)}


def _assert_leaves_close(got: dict, want: dict, rel: float, atol: float = 0.0):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.size:
            err = np.abs(got[k].astype(np.float64) - w).max()
            assert err <= rel * np.abs(w).max() + atol, (k, err, np.abs(w).max())


# ---------------------------------------------------------------------------
# AdamW (counterparts of tests/test_substrates.py, then the reference)
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(state.step) == 200 and state.step.dtype == torch.int32


def test_clip_by_global_norm():
    tree = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 2500, 5000, 9999, 10_000, 20_000])
def test_schedule_bounds(step):
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=100, total_steps=10_000)
    lr = float(warmup_cosine(cfg, torch.tensor(step)))
    assert 0.0 <= lr <= cfg.peak_lr * (1 + 1e-6)
    want = float(ref_optim.warmup_cosine(ref_optim.AdamWConfig(peak_lr=1e-3, warmup_steps=100,
                                                                 total_steps=10_000), jnp.asarray(step)))
    assert lr == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_weight_decay_pulls_to_zero():
    cfg = AdamWConfig(peak_lr=0.05, warmup_steps=1, total_steps=100, weight_decay=1.0)
    params = {"w": torch.tensor([5.0])}
    state = adamw_init(params)
    for _ in range(100):
        params, state, _ = adamw_update(cfg, params, {"w": torch.zeros(1)}, state)
    assert float(params["w"].abs().max()) < 1.0


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_matches_reference(grad_scale):
    """Three steps from the same params, grads and state: params, moments
    and lr within 1e-6 relative, grad_norm within 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 5), "nested": {"b": (7,), "s": (3, 2, 4)}}

    def draw(scale=1.0):
        def one(shape):
            return (rng.normal(size=shape) * scale).astype(np.float32)
        return {"w": one(shapes["w"]), "nested": {"b": one(shapes["nested"]["b"]),
                                                   "s": one(shapes["nested"]["s"])}}

    p0 = draw()
    grads = [draw(grad_scale) for _ in range(3)]
    kw = dict(peak_lr=0.02, warmup_steps=2, total_steps=10)
    rp, rs = jax.tree.map(jnp.asarray, p0), ref_optim.adamw_init(jax.tree.map(jnp.asarray, p0))
    tp = jax.tree.map(torch.tensor, p0)
    ts = adamw_init(tp)
    for g in grads:
        rp, rs, rm = ref_optim.adamw_update(ref_optim.AdamWConfig(**kw), rp, jax.tree.map(jnp.asarray, g), rs)
        tp, ts, tm = adamw_update(AdamWConfig(**kw), tp, jax.tree.map(torch.tensor, g), ts)
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert int(ts.step) == int(rs.step)
        for got, want in ((tp, rp), (ts.mu, rs.mu), (ts.nu, rs.nu)):
            _assert_leaves_close(_flat(got), _flat_ref(want), 1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_data_deterministic_and_step_addressable():
    d1 = SyntheticTokens(vocab_size=1000, batch=4, seq_len=32, seed=3, device="cpu")
    d2 = SyntheticTokens(vocab_size=1000, batch=4, seq_len=32, seed=3, device="cpu")
    b1, b2 = d1.batch_at(17), d2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(d1.batch_at(18)["tokens"], b1["tokens"])
    assert b1["tokens"].shape == (4, 32) and b1["tokens"].dtype == torch.int64
    assert (b1["tokens"] >= 0).all() and (b1["tokens"] < 1000).all()
    # labels are next-token shifted from the same stream
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert torch.equal(next(iter(d1))["tokens"], d1.batch_at(0)["tokens"])


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (3, 17), (11, 1234), (2024, 99_999)])
def test_synthetic_tokens_equal_reference(seed, step):
    mine = SyntheticTokens(vocab_size=50304, batch=3, seq_len=40, seed=seed, device="cpu").batch_at(step)
    ref = RefTokens(vocab_size=50304, batch=3, seq_len=40, seed=seed).batch_at(step)
    for k in ("tokens", "labels"):
        assert ref[k].dtype == np.int32
        np.testing.assert_array_equal(mine[k].numpy(), ref[k].astype(np.int64))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 3), generator=g), "b": torch.zeros((3,))},
        "nested": {"deep": {"x": torch.arange(5, dtype=torch.int32)}},
    }


def test_checkpoint_roundtrip_bitwise(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 7, state, extra={"note": "hi"})
    template = {"params": {"w": torch.empty(4, 3, device="meta"), "b": torch.empty(3, device="meta")},
                "nested": {"deep": {"x": torch.empty(5, dtype=torch.int32, device="meta")}}}
    restored, manifest = load_checkpoint(str(tmp_path), template, device="cpu")
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "hi"
    for (ka, a), (kb, b) in zip(tree_items(state), tree_items(restored)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomic_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _state(s))
    mgr.wait()
    steps = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert not any(x.endswith(".tmp") for x in os.listdir(tmp_path))
    assert latest_step(str(tmp_path)) == 4


def test_save_async_snapshots_on_the_callers_thread(tmp_path, monkeypatch):
    """An update in place while the writer is held does not reach the
    saved arrays: they are the state as it was when the save was asked."""
    release, write = threading.Event(), ckpt.save_checkpoint

    def held_write(*args, **kwargs):
        release.wait(60)
        return write(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", held_write)
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=10)
    params = {"w": torch.linspace(-1.0, 1.0, 12).reshape(3, 4), "b": torch.ones(4)}
    grads = {"w": torch.full((3, 4), 0.5), "b": torch.full((4,), -0.25)}
    params, opt, _ = adamw_update(cfg, params, grads, adamw_init(params))
    state = {"params": params, "opt": opt}
    at_save = flatten_state(state, copy=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, state)
    adamw_update(cfg, params, grads, opt)  # params, mu and nu change in place
    release.set()
    mgr.wait()
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    assert saved.keys() == at_save.keys()
    for k, v in at_save.items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)
    now = flatten_state(state)
    assert not np.array_equal(now["params/w"], at_save["params/w"])
    assert not np.array_equal(now["opt/.mu/w"], at_save["opt/.mu/w"])


def test_failed_save_async_leaves_no_reference_to_the_snapshot(tmp_path, monkeypatch):
    """A write that fails keeps its error for the next ``wait()`` but not the
    host snapshot: once the writer thread has ended, the snapshot is freed
    (with the collector off), and ``wait()`` raises the error's type and
    message, its traceback's text kept as a note."""
    import gc
    import weakref

    refs = []

    def failing_write(directory, step, state, extra=None):
        refs.append(weakref.ref(state["w"]))
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_checkpoint", failing_write)
    mgr = CheckpointManager(str(tmp_path))
    gc.collect()
    gc.disable()
    try:
        mgr.save_async(1, {"w": torch.ones(1024)})
        thread = mgr._thread
        thread.join(60)
        alive = thread.is_alive(), refs[0]() is not None
    finally:
        gc.enable()
    assert alive == (False, False)
    with pytest.raises(OSError, match="disk full") as info:
        mgr.wait()
    assert "failing_write" in "".join(info.value.__notes__)


def test_checkpoint_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match=r"leaf w: shape \(2, 2\) != expected \(3, 3\)"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros((3, 3))}, device="cpu")
    with pytest.raises(KeyError, match="checkpoint missing leaf 'v'"):
        load_checkpoint(str(tmp_path), {"v": torch.zeros((2, 2))}, device="cpu")


def _ref_train_state(arch="stablelm-3b"):
    """A reference train state with non-zero moments: init + one update."""
    ref = RefModel(ref_tiny(ref_config(arch)))
    p = jax.jit(ref.init)(jax.random.PRNGKey(2))
    opt = ref_optim.adamw_init(p)
    g = jax.tree.map(lambda x: 0.01 * jnp.ones_like(x), p)
    p, opt, _ = ref_optim.adamw_update(ref_optim.AdamWConfig(), p, g, opt)
    return {"params": p, "opt": opt}


def _npz_keys(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as z:
        return set(z.files)


def test_checkpoints_interchangeable_both_ways(tmp_path):
    state = _ref_train_state()
    model = LMModel(tiny(get_config("stablelm-3b")))
    template = {"params": from_reference(model, jax.tree.map(np.asarray, state["params"]), device="cpu",
                                         dtype=torch.float32)}
    template["opt"] = adamw_init(template["params"])
    # the reference writes, the port reads
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, state, extra={"seed": 0})
    mine, manifest = load_checkpoint(str(tmp_path / "ref"), template, device="cpu")
    assert manifest == {"step": 3, "extra": {"seed": 0}, "n_leaves": len(_npz_keys(tmp_path / "ref", 3))}
    assert isinstance(mine["opt"], OptState) and mine["opt"].step.dtype == torch.int32
    assert int(mine["opt"].step) == 1
    for name, got, want in (("params", mine["params"], state["params"]), ("mu", mine["opt"].mu, state["opt"].mu),
                            ("nu", mine["opt"].nu, state["opt"].nu)):
        want = _flat_ref(want)
        for k, v in _flat(got).items():
            np.testing.assert_array_equal(v, want[k], err_msg=f"{name}.{k}")
    # the port writes, the reference reads
    save_checkpoint(str(tmp_path / "port"), 3, mine, extra={"seed": 0})
    assert _npz_keys(tmp_path / "port", 3) == _npz_keys(tmp_path / "ref", 3)
    assert {"params/embed", "opt/.step", "opt/.mu/embed", "opt/.nu/seg_dec/attn/wq"} <= _npz_keys(tmp_path / "port", 3)
    back, manifest2 = ref_ckpt.load_checkpoint(str(tmp_path / "port"), jax.tree.map(jnp.zeros_like, state))
    assert manifest2 == manifest
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# loss and gradients for every family
# ---------------------------------------------------------------------------


def _tokens(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module", params=ARCHS)
def grads_case(request):
    """The reference's loss and gradients (remat on) for one arch's tiny
    preset, and the port's model with the same float32 weights."""
    arch = request.param
    ref = RefModel(ref_tiny(ref_config(arch)))
    model = LMModel(tiny(get_config(arch)))
    params = jax.jit(ref.init)(jax.random.PRNGKey(1))
    toks, labels = _tokens(model.cfg.vocab_size)
    rb = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    if model.ctx_len():
        ctx = np.random.default_rng(1).normal(size=(B, model.ctx_len(), model.cfg.d_model)).astype(np.float32)
        rb["ctx"], tb["ctx"] = jnp.asarray(ctx), torch.as_tensor(ctx)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b, impl="dot", mesh=None, remat=True)))(params, rb)
    return {"model": model, "batch": tb, "loss": float(loss), "grads": _flat_ref(grads),
            "params": from_reference(model, jax.tree.map(np.asarray, params), device="cpu", dtype=torch.float32)}


def _port_loss_and_grads(model, params, batch, **kw):
    leaves = [v.detach().clone().requires_grad_() for _, v in tree_items(params)]
    keys = [k for k, _ in tree_items(params)]
    tree = {}
    for k, v in zip(keys, leaves):
        node = tree
        *path, name = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[name] = v
    loss = model.loss(tree, batch, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), {k: g.numpy() for k, g in zip(keys, grads)}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_loss_and_grads_match_reference(grads_case, remat):
    loss, grads = _port_loss_and_grads(grads_case["model"], grads_case["params"], grads_case["batch"],
                                       impl="dot", remat=remat)
    assert np.isfinite(loss)
    assert loss == pytest.approx(grads_case["loss"], rel=1e-5)
    _assert_leaves_close(grads, grads_case["grads"], 1e-4)


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_remat_policies_give_equal_loss_and_grads(monkeypatch, policy):
    model = LMModel(tiny(get_config("hymba-1.5b")))
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device=CPU)
    toks, labels = _tokens(model.cfg.vocab_size, seed=4)
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    base_loss, base = _port_loss_and_grads(model, params, batch, remat=False)
    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    loss, grads = _port_loss_and_grads(model, params, batch, remat=True)
    assert loss == pytest.approx(base_loss, rel=1e-6)
    _assert_leaves_close(grads, base, 1e-6)


def test_serving_apply_unchanged_by_remat():
    """Without autograd ``remat`` changes nothing: the serve path's logits."""
    model = LMModel(tiny(get_config("stablelm-3b")))
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    toks = torch.as_tensor(_tokens(model.cfg.vocab_size)[0])
    with torch.inference_mode():
        a = model.apply(params, toks, remat=True)
        b = model.apply(params, toks, remat=False)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trainer against the reference composed without a mesh
# ---------------------------------------------------------------------------


def _ref_run(arch, steps, opt_kw, batch=B, seq=S, seed=0, dtype=None):
    """The reference's training composition on one device: its initial
    params, the losses, and the params and moments after each step."""
    cfg = ref_tiny(ref_config(arch))
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    ref = RefModel(cfg)
    ocfg = ref_optim.AdamWConfig(**opt_kw)

    @jax.jit
    def step(p, opt, b):
        loss, g = jax.value_and_grad(lambda p: ref.loss(p, b, impl="dot", mesh=None, remat=True))(p)
        p, opt, _ = ref_optim.adamw_update(ocfg, p, g, opt)
        return p, opt, loss

    p0 = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    p, opt = p0, ref_optim.adamw_init(p0)
    data = RefTokens(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq, seed=seed)
    losses, after, moments = [], [], []
    for s in range(steps):
        p, opt, loss = step(p, opt, data.batch_at(s))
        losses.append(float(loss))
        after.append(_flat_ref(p))
        moments.append((_flat_ref(opt.mu), _flat_ref(opt.nu)))
    return p0, losses, after, moments


def _ref_init_dir(tmp_path, arch, p0) -> str:
    """The reference's initial state as a step-0 checkpoint the port's
    trainer resumes from (written by the reference's own ``save_checkpoint``)."""
    d = str(tmp_path / "run")
    ref_ckpt.save_checkpoint(d, 0, {"params": p0, "opt": ref_optim.adamw_init(p0)})
    return d


_REF_FIVE_STEPS = {}
FIVE_STEP_OPT = dict(peak_lr=3e-3, warmup_steps=1, total_steps=5)


def _five_steps(tmp_path, arch, fault=None):
    """Five port steps from the reference's initial state, with ``fault``
    (if given) applied to each step's gradient tree before the update; the
    reference's run (made once per arch), the port's output and the
    comparison of the final parameters."""
    if arch not in _REF_FIVE_STEPS:
        _REF_FIVE_STEPS[arch] = _ref_run(arch, 5, FIVE_STEP_OPT)
    p0, want_losses, want_after, moments = _REF_FIVE_STEPS[arch]
    trainer = Trainer(tiny(get_config(arch)),
                      TrainerConfig(steps=5, batch=B, seq_len=S, log_every=1, checkpoint_every=100,
                                    checkpoint_dir=_ref_init_dir(tmp_path, arch, p0)),
                      AdamWConfig(**FIVE_STEP_OPT), device="cpu")
    inner, noisy = trainer.step_fn, None

    def step_and_mark(state, batch):  # the elements each step's gradient noise drives
        nonlocal noisy
        state, metrics = inner(state, batch)
        mu_ref, nu_ref = moments[int(state["opt"].step) - 1]
        noisy = noisy_steps(noisy, _flat(state["opt"].mu), mu_ref, nu_ref, int(state["opt"].step))
        return state, metrics

    trainer.step_fn = step_and_mark
    update = trainer_mod.adamw_update

    def faulty_update(cfg, params, grads, opt):
        fault(grads)
        return update(cfg, params, grads, opt)

    if fault is not None:
        trainer_mod.adamw_update = faulty_update
    try:
        out = trainer.run()
    finally:
        trainer_mod.adamw_update = update
    lr_sum = sum(float(warmup_cosine(AdamWConfig(**FIVE_STEP_OPT), torch.tensor(s))) for s in range(1, 6))
    cmp = compare_trajectories(_flat(out["state"]["params"]), want_after[-1], noisy, lr_sum)
    return want_losses, out, cmp


@pytest.mark.parametrize("arch", ["stablelm-3b", "hymba-1.5b"])
def test_five_steps_match_reference(tmp_path, arch):
    want_losses, out, cmp = _five_steps(tmp_path, arch)
    print(f"{arch}: {cmp['noise_driven']} of {cmp['elements']} marked, at most "
          f"{cmp['max_marked_share']:.3e} of leaf {cmp['max_marked_leaf']}")  # shown by -rP
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in out["history"]], want_losses, rtol=1e-4)
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert cmp["ok"], cmp
    assert int(out["state"]["opt"].step) == 5


def _scale_grad(path, factor, layer=None):
    def fault(grads):
        *nodes, name = path.split(".")
        for n in nodes:
            grads = grads[n]
        g = grads[name].clone()
        g[slice(None) if layer is None else layer] *= factor
        grads[name] = g
    return fault


def _swap_grads(a, b):
    def fault(grads):
        ga, gb = grads["seg_dec"][a], grads["seg_dec"][b]
        grads["seg_dec"][a], grads["seg_dec"][b] = gb, ga
    return fault


@pytest.mark.parametrize("fault", [
    _scale_grad("final_norm.scale", 1.1),
    _scale_grad("seg_dec.attn_norm.scale", 1.1, layer=1),
    _scale_grad("seg_dec.mlp.w_in", 1.1, layer=0),
    _swap_grads("attn_norm", "mlp_norm"),
], ids=["final_norm_x1.1", "attn_norm_layer1_x1.1", "w_in_layer0_x1.1", "swapped_norms"])
def test_five_step_comparison_catches_planted_faults(tmp_path, fault):
    """A wrong gradient in a small leaf or one layer's slice fails the
    parameter comparison: a scale is invisible in Adam's parameters (the
    update divides it out) but marks every element it reaches."""
    _, _, cmp = _five_steps(tmp_path, "stablelm-3b", fault)
    assert not cmp["ok"], cmp


def test_bf16_master_weights(tmp_path):
    """A bfloat16 model trains on float32 masters: the working copy equals
    ``master.to(bf16)`` bitwise after every step, the keep-f32 leaves stay
    float32, and one step matches the reference run at the same dtype."""
    arch = "stablelm-3b"
    opt_kw = dict(peak_lr=3e-3, warmup_steps=1, total_steps=3)
    p0, want_losses, want_after, _ = _ref_run(arch, 1, opt_kw, dtype="bfloat16")
    cfg = dataclasses.replace(tiny(get_config(arch)), dtype="bfloat16")
    model = LMModel(cfg)
    params = from_reference(model, jax.tree.map(np.asarray, p0), device="cpu", dtype=torch.float32)
    state = {"params": params, "opt": adamw_init(params)}
    step = build_train_step(model, AdamWConfig(**opt_kw))
    data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=B, seq_len=S, seed=0, device="cpu")
    specs = dict(tree_items(model.param_specs()))
    for s in range(3):
        state, metrics = step(state, data.batch_at(s))
        for (k, w), (_, m) in zip(tree_items(step.work), tree_items(state["params"])):
            assert m.dtype == torch.float32
            assert w.dtype == (torch.float32 if specs[k].keep_f32 else torch.bfloat16), k
            assert torch.equal(w.detach(), m.to(w.dtype)), k
        if s == 0:
            assert float(metrics["loss"]) == pytest.approx(want_losses[0], rel=2e-2)
            lr = float(metrics["lr"])
            _assert_leaves_close(_flat(state["params"]), want_after[0], 0.0, atol=2 * lr + 1e-6)


def _trainer(tmp_path, **kw):
    cfg = TrainerConfig(steps=6, batch=2, seq_len=32, log_every=1, checkpoint_every=2,
                        checkpoint_dir=str(tmp_path), **kw)
    return Trainer(tiny(get_config("stablelm-3b")), cfg,
                   AdamWConfig(peak_lr=3e-3, warmup_steps=1, total_steps=6), device="cpu")


def test_failure_injection_and_lossless_resume(tmp_path):
    """``fail_at_step`` raises; a fresh trainer resumes from the last
    checkpoint and ends where an uninterrupted run ends, bitwise."""
    full = _trainer(tmp_path / "full").run()
    failing = _trainer(tmp_path / "cut", fail_at_step=3)
    with pytest.raises(SimulatedFailure, match="step 3"):
        failing.run()
    failing.ckpt.wait()  # the save submitted before the failure commits
    assert latest_step(str(tmp_path / "cut")) == 2
    resumed = _trainer(tmp_path / "cut").run()
    assert resumed["history"][0]["step"] == 3
    assert resumed["history"] == full["history"][2:]
    for (k, a), (_, b) in zip(tree_items(full["state"]["params"]), tree_items(resumed["state"]["params"])):
        assert torch.equal(a, b), k
    assert int(resumed["state"]["opt"].step) == 6
    assert latest_step(str(tmp_path / "cut")) == 6


def test_trainer_runs_only_impls_with_a_backward():
    with pytest.raises(ValueError, match="kernel"):
        Trainer(tiny(get_config("stablelm-3b")), TrainerConfig(impl="kernel"), device="cpu")


# ---------------------------------------------------------------------------
# the launcher, and approx_params
# ---------------------------------------------------------------------------


def _launch(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)


def test_launcher_trains_tiny_on_cpu():
    proc = _launch("--arch", "stablelm-3b", "--preset", "tiny", "--device", "cpu", "--steps", "20")
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    first, final = (float(x) for x in last.removeprefix("first loss ").split(" -> last loss "))
    assert last.startswith("first loss ") and final < first


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launcher_mesh_without_a_card_raises_before_spawning(launcher, monkeypatch):
    """A ``--mesh`` world runs its ranks on the CUDA device unless
    ``--device cpu`` asks for the host: on a box with no card the launcher
    raises before it spawns any rank, and carries nothing to the host."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import world

    if torch.cuda.is_available():
        pytest.skip("this box has a card: the mesh would run on it")
    spawned = []
    monkeypatch.setattr(world, "run_world", lambda *a, **k: spawned.append(a))
    main = {"train": train_launcher.main, "serve": serve_launcher.main}[launcher]
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        main(["--preset", "tiny", "--mesh", "2x2"])
    assert not spawned


def test_launcher_mesh_other_than_the_world_raises(tmp_path):
    """In a process group that is already initialised, the launcher runs as
    one of its ranks, and a ``--mesh`` of another size raises."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="world of 4 processes; this one has 1"):
            train_launcher.main(["--preset", "tiny", "--device", "cpu", "--steps", "1", "--mesh", "2x2"])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_approx_params_equal_reference(arch):
    assert arch in REF_ARCH_IDS
    n = get_config(arch).approx_params()
    assert isinstance(n, int) and n == ref_config(arch).approx_params()
    known = {"stablelm-3b": 2_795_276_800, "hymba-1.5b": 1_640_812_800}
    if arch in known:
        assert n == known[arch]
