"""The port's examples (``repro_torch.examples``) against the reference's, on the CPU.

Each example runs here with ``--device cpu`` (the kernels' plain versions)
and is held to the reference by the reference's own library calls, not by
rerunning its 8-device example children:

* every example, started as users start it (``python -m
  repro_torch.examples.<name>``) with the reference's smoke arguments, exits
  0 and prints the reference's expected line;
* strategy_advisor: stdout byte-identical to the reference script's;
* quickstart: the matrix line, the advisor tables and each strategy's
  ``wire_bytes`` equal to the reference's; the products within the
  reference's 1e-4; overlap bitwise equal to barrier (asserted in the
  example);
* krylov_solve: the advisor tables, the numpy executor's residual
  histories (bitwise) and cache counts equal to ``repro.solve.NumpySpMV`` +
  ``cg``; the fused solve's history bitwise the host loop's;
* chaos_serving: stdout identical to the reference script's, the full
  trace hashes and counts equal to ``repro.serving.simulate``, the healed
  halos bitwise ``repro.comm.execute_numpy``;
* serve_lm: on the reference's ``LMModel.init`` weights (carried over with
  ``from_reference``), greedy tokens equal to the reference example's loop
  and every step's logits within 1e-4, for qwen3-32b, deepseek-v2-lite-16b
  (with the dispatch counts and advice table) and mamba2-780m;
* train_lm: from the reference's initial state, the first loss within 1e-4
  relative of the reference composed without a mesh, the parameters after
  two steps by ``compare_trajectories``; a ``--resume`` run continues from
  the checkpoint.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import optim as ref_optim
from repro.compat import tree_flatten_with_path
from repro.configs import get_config as ref_config
from repro.data import SyntheticTokens as RefTokens
from repro.launch import serve as ref_serve
from repro.launch.train import small_100m as ref_small_100m
from repro.launch.train import tiny as ref_tiny
from repro.models import LMModel as RefModel
from repro_torch.configs import get_config
from repro_torch.examples import chaos_serving, krylov_solve, quickstart, serve_lm, strategy_advisor, train_lm
from repro_torch.launch.presets import tiny
from repro_torch.models.convert import from_reference
from repro_torch.models.sharding import tree_items
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.testing.trajectory import compare_trajectories, noisy_steps

REPO = Path(__file__).resolve().parents[1]
STRATEGIES = ("standard", "two_step", "three_step", "split")

#: the reference's smoke arguments and expected lines (tests/test_examples_smoke.py)
SMOKE = {
    "chaos_serving": ([], "chaos serving"),
    "krylov_solve": (["--fused"], "fused whole-solve"),
    "quickstart": ([], "split"),
    "strategy_advisor": (["--messages", "32", "--nodes", "4", "--payload-width", "8"], "best strategy"),
    "serve_lm": (["--arch", "deepseek-v2-lite-16b", "--batch", "1", "--prompt-len", "8", "--gen", "3",
                  "--advise-dispatch"], "dispatch advice"),
    "train_lm": (["--steps", "2"], "loss:"),
}


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.pop("XLA_FLAGS", None)
    return env


def _printed(fn, *args):
    """``fn(*args)`` and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _reference_script(name: str, *args: str) -> str:
    proc = subprocess.run([sys.executable, str(REPO / "examples" / f"{name}.py"), *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_example_runs_as_a_module_with_the_smoke_args(name, tmp_path):
    args, expect = SMOKE[name]
    if name == "train_lm":
        args = args + ["--ckpt", str(tmp_path / "ckpt")]
    proc = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *args, "--device", "cpu"],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert expect in proc.stdout, proc.stdout[-2000:]


# ---------------------------------------------------------------------------
# strategy_advisor
# ---------------------------------------------------------------------------

ADVISOR_INVOCATIONS = {
    "smoke": SMOKE["strategy_advisor"][0],
    "messages-256-nodes-16": ["--messages", "256", "--nodes", "16"],
    "payload-width-64": ["--payload-width", "64"],
    "overlap": ["--compute-us", "50", "--interior-frac", "0.9"],
    "wire-auto": ["--wire", "auto"],
}


@pytest.mark.parametrize("machine", ["lassen", "tpu_v5e_pod"])
@pytest.mark.parametrize("invocation", sorted(ADVISOR_INVOCATIONS))
def test_strategy_advisor_prints_the_reference_bytes(invocation, machine):
    argv = ADVISOR_INVOCATIONS[invocation] + ["--machine", machine]
    out, printed = _printed(strategy_advisor.main, argv + ["--device", "cpu"])
    assert printed == _reference_script("strategy_advisor", *argv)
    assert len(out["rows"]) == 17 and not any(out["launches"].values())


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart_run():
    return _printed(quickstart.main, ["--device", "cpu"])


def test_quickstart_tables_and_wire_bytes_equal_reference(quickstart_run):
    from repro.comm.strategies import planned
    from repro.comm.topology import PodTopology
    from repro.comm.wire import scaled_wire_bytes
    from repro.core import advise
    from repro.sparse import audikw_like, partition_csr

    out, printed = quickstart_run
    topo = PodTopology(npods=2, ppn=4)
    A = audikw_like(128, np.random.default_rng(0))
    part = partition_csr(A, topo)
    pattern = part.pattern.to_comm_pattern()
    assert printed.splitlines()[0] == (f"matrix n={A.n} nnz={A.nnz}; irregular pattern: "
                                       f"{len(pattern.messages)} messages, stats={pattern.stats()}")
    for k in (1, quickstart.K):
        want = advise(pattern, machine="tpu_v5e_pod", payload_width=k)
        assert out["tables"][k] == want.table()
        assert f"-> best at k={k}: {want.best.key}\n" in printed
    for strat in STRATEGIES:
        want = scaled_wire_bytes(planned(part.pattern, strat), "none", 4)
        assert out["wire_bytes"][strat] == tuple(want)
        assert f"intra-pod {want[0]:6d} B   inter-pod {want[1]:6d} B" in printed


def test_quickstart_products_meet_the_reference_tolerance(quickstart_run):
    out, printed = quickstart_run
    assert set(out["max_abs_err"]) == set(STRATEGIES)
    for spmv_err, mm_err in out["max_abs_err"].values():
        assert spmv_err <= 1e-4 and mm_err <= 1e-4
    assert printed.count("OK (spmv + matmat k=8 + overlap)") == 4


# ---------------------------------------------------------------------------
# krylov_solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def krylov_run():
    return _printed(krylov_solve.main, ["--fused", "--device", "cpu"])


def test_krylov_histories_and_cache_counts_equal_reference(krylov_run):
    from repro.comm import cache_stats, clear_caches
    from repro.comm.topology import PodTopology
    from repro.core import advise_solver, figure43_pattern
    from repro.solve import REDUCTIONS_PER_ITER, NumpySpMV, cg, spd_system
    from repro.sparse import partition_csr, thermal_like

    out, printed = krylov_run
    rng = np.random.default_rng(0)
    topo = PodTopology(npods=2, ppn=4)
    part = partition_csr(spd_system(thermal_like(1024, rng)), topo)
    b = rng.normal(size=(topo.nranks, part.rows_per_rank))
    flagship = figure43_pattern(2048, 256, 16)
    for iters in (1, 200):
        want = advise_solver(flagship, iters, machine="lassen", reductions_per_iter=REDUCTIONS_PER_ITER["cg"])
        assert out["advice"][iters] == want.table()
    for iters in (50, 400):
        want = advise_solver(flagship, iters, machine="lassen", fused="auto",
                             reductions_per_iter=REDUCTIONS_PER_ITER["cg"])
        assert out["advice"][f"fused@{iters}"] == want.best.key
    want = advise_solver(part.pattern.to_comm_pattern(), 200, machine="tpu_v5e_pod",
                         reductions_per_iter=REDUCTIONS_PER_ITER["cg"])
    assert out["own_pattern_best"] == want.best.key
    clear_caches()
    for strategy in STRATEGIES:
        for overlap in (False, True):
            res = cg(NumpySpMV(part, strategy=strategy, overlap=overlap), b, tol=1e-6)
            assert out["histories"][(strategy, overlap)] == tuple(res.residuals), (strategy, overlap)
    s = cache_stats()
    assert out["cache"] == {k: getattr(s, k) for k in ("plan_misses", "plan_hits", "split_misses", "split_hits")}
    assert "bitwise-identical residual histories" in printed


def test_krylov_device_and_fused_histories(krylov_run):
    out, printed = krylov_run
    dev = out["device"]
    assert dev["barrier"] == dev["overlap"] and dev["barrier"][-1] <= 1e-6
    assert dev["int8"][-1] <= 1e-4
    fused = out["fused"]
    assert fused["fused"] == fused["host"]  # bitwise: float64 scalars on both paths
    assert (fused["misses"], fused["hits"]) == (1, 0)
    assert "history drift 0.0e+00" in printed and "fused whole-solve" in printed


# ---------------------------------------------------------------------------
# chaos_serving
# ---------------------------------------------------------------------------


def test_chaos_serving_equals_reference():
    from repro.comm.exchange import execute_numpy, plan, random_pattern
    from repro.comm.faults import FaultPlan, FaultSpec
    from repro.comm.topology import PodTopology
    from repro.serving import SimConfig, WorkloadClass, simulate
    from repro.testing import make_trace

    out, printed = _printed(chaos_serving.main, ["--device", "cpu"])
    assert printed == _reference_script("chaos_serving")
    topo = PodTopology(npods=2, ppn=4)
    patterns = {f"s{i}": random_pattern(np.random.default_rng(300 + i), topo, local_size=32, max_elems=4)
                for i in range(3)}
    classes = {k: WorkloadClass.from_pattern(p, fp=k) for k, p in patterns.items()}
    trace = make_trace(11, 96, sorted(classes), pattern="burst", rate=4000.0)
    storm_plan = FaultPlan(seed=11, specs=(
        FaultSpec(kind="perturb", prob=0.35, frac=0.1, strategies=("two_step",)),
        FaultSpec(kind="slow", prob=0.1, delay_s=1e-3),
    ))
    clean = simulate(classes, trace, SimConfig(max_width=8, strategy="two_step"))
    storm = simulate(classes, trace, SimConfig(max_width=8, strategy="two_step", chaos=storm_plan,
                                               deadline_s=0.25))
    fields = ("trace_hash", "completed", "shed", "probes", "fault_events", "recoveries")
    for got, want in ((out["clean"], clean), (out["storm"], storm)):
        assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    local = np.random.default_rng(0).normal(size=(topo.nranks, 32)).astype(np.float32)
    for name, pat in patterns.items():
        np.testing.assert_array_equal(out["healed"][name], execute_numpy(plan("standard", pat), local))
    assert out["recoveries"] == ["readvise:three_step/none"] * 3


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------

SERVE_CASES = {
    "qwen3-32b": ["--batch", "2", "--prompt-len", "40", "--gen", "8"],
    "deepseek-v2-lite-16b": SMOKE["serve_lm"][0][2:],
    "mamba2-780m": ["--batch", "2", "--prompt-len", "40", "--gen", "8"],
}


def _reference_example_loop(model, params, prompts, ctx, gen):
    """``examples/serve_lm.py``'s loop: prefill, grow the cache, jitted greedy
    decode; its tokens and each generated token's logits."""
    logits, cache = model.prefill(params, prompts, ctx)
    grown = model.init_cache(prompts.shape[0], prompts.shape[1] + gen, model.dtype)
    cache = jax.tree.map(
        lambda dst, src: dst.at[tuple(slice(0, s) for s in src.shape)].set(src.astype(dst.dtype))
        if dst.shape != src.shape else src.astype(dst.dtype),
        grown, cache,
    )
    decode = jax.jit(model.decode_step)
    step_logits = [np.asarray(logits[:, -1])]
    token = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    toks = [token]
    for t in range(gen - 1):
        logits, cache = decode(params, token, cache, jnp.int32(prompts.shape[1] + t))
        step_logits.append(np.asarray(logits[:, 0]))
        token = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
        toks.append(token)
    return np.asarray(jnp.concatenate(toks, axis=1)), step_logits


@pytest.mark.parametrize("arch", sorted(SERVE_CASES))
def test_serve_lm_greedy_tokens_equal_reference(arch):
    argv = SERVE_CASES[arch]
    opts = dict(zip(argv[::2], argv[1::2]))
    batch, prompt_len, gen = int(opts["--batch"]), int(opts["--prompt-len"]), int(opts["--gen"])
    advise = "--advise-dispatch" in argv
    ref = RefModel(ref_tiny(ref_config(arch)))
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    prompts, ctx = serve_lm.make_context(ref.cfg.vocab_size, batch, prompt_len, ref.ctx_len(), ref.cfg.d_model,
                                         seed=0)
    want, want_logits = _reference_example_loop(ref, params, jnp.asarray(prompts, jnp.int32),
                                                 None if ctx is None else jnp.asarray(ctx), gen)
    cfg = tiny(get_config(arch))
    tparams = from_reference(serve_lm.LMModel(cfg), jax.tree.map(np.asarray, params), device="cpu")
    out, printed = _printed(serve_lm.serve, cfg, tparams, torch.as_tensor(prompts),
                            None if ctx is None else torch.as_tensor(ctx), gen, advise)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    for got, w in zip(out["logits"], want_logits, strict=True):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-4)
    assert f"sample: {want[0][:16]}" in printed
    if advise:
        served = np.concatenate([prompts, want], axis=1)
        counts, advice = ref_serve.dispatch_advice(params, ref.cfg, served, 2, 4)
        np.testing.assert_array_equal(out["dispatch"]["counts"], counts)
        assert out["dispatch"]["advice"].table() == advice.table()
        assert advice.table() in printed


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

TRAIN_STEPS = 2


def _flat_ref(tree) -> dict:
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in tree_flatten_with_path(tree)[0]}


def _flat(tree) -> dict:
    return {k: v.detach().numpy() for k, v in tree_items(tree)}


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """The reference composed without a mesh at the example's settings
    (``small_100m``, batch 8 x 256, ``chunked``, the example's AdamW) for
    two steps, and the example's trainer resumed from the reference's
    initial state, each step's first moments marked against the reference's."""
    cfg = ref_small_100m(ref_config("stablelm-3b"))
    ref = RefModel(cfg)
    opt_kw = dict(peak_lr=1e-3, warmup_steps=30, total_steps=TRAIN_STEPS)
    ocfg = ref_optim.AdamWConfig(**opt_kw)

    @jax.jit
    def step(p, opt, b):
        loss, g = jax.value_and_grad(lambda p: ref.loss(p, b, impl="chunked", mesh=None, remat=True))(p)
        p, opt, _ = ref_optim.adamw_update(ocfg, p, g, opt)
        return p, opt, loss

    p0 = jax.jit(ref.init)(jax.random.PRNGKey(0))
    ckpt = str(tmp_path_factory.mktemp("train_lm") / "ckpt")
    ref_ckpt.save_checkpoint(ckpt, 0, {"params": p0, "opt": ref_optim.adamw_init(p0)})
    p, opt = p0, ref_optim.adamw_init(p0)
    data = RefTokens(vocab_size=cfg.vocab_size, batch=8, seq_len=256, seed=0)
    losses, moments = [], []
    for s in range(TRAIN_STEPS):
        p, opt, loss = step(p, opt, data.batch_at(s))
        losses.append(float(loss))
        moments.append((_flat_ref(opt.mu), _flat_ref(opt.nu)))
    want_after = _flat_ref(p)
    del p0, p, opt

    args = train_lm.parse_args(["--steps", str(TRAIN_STEPS), "--ckpt", ckpt, "--resume", "--device", "cpu"])
    trainer = train_lm.make_trainer(args)
    inner, noisy = trainer.step_fn, None

    def step_and_mark(state, batch):
        nonlocal noisy
        state, metrics = inner(state, batch)
        k = int(state["opt"].step)
        noisy = noisy_steps(noisy, _flat(state["opt"].mu), *moments[k - 1], k)
        return state, metrics

    trainer.step_fn = step_and_mark
    out, printed = _printed(train_lm.train, trainer, args)
    lr_sum = sum(float(warmup_cosine(AdamWConfig(**opt_kw), torch.tensor(s)))
                 for s in range(1, TRAIN_STEPS + 1))
    cmp = compare_trajectories(_flat(out["state"]["params"]), want_after, noisy, lr_sum)
    return ckpt, losses, out, printed, cmp


def test_train_lm_first_steps_match_reference(train_run):
    _, losses, out, printed, cmp = train_run
    assert [h["step"] for h in out["history"]] == [1]  # a log line every 20 steps, and the first
    np.testing.assert_allclose(out["history"][0]["loss"], losses[0], rtol=1e-4)
    assert cmp["ok"], cmp
    assert int(out["state"]["opt"].step) == TRAIN_STEPS
    assert "model: stablelm-3b ~59M params" in printed and "loss:" in printed


def test_train_lm_resume_continues_from_the_checkpoint(train_run):
    ckpt = train_run[0]
    out, printed = _printed(train_lm.main, ["--steps", str(TRAIN_STEPS + 1), "--ckpt", ckpt, "--resume",
                                            "--device", "cpu"])
    assert [h["step"] for h in out["history"]] == [TRAIN_STEPS + 1]
    assert int(out["state"]["opt"].step) == TRAIN_STEPS + 1 and np.isfinite(out["history"][0]["loss"])
    assert f"over {TRAIN_STEPS + 1} steps" in printed
    assert not any(out["launches"].values())
    # resumed again at its last step: nothing is left to train
    again, printed = _printed(train_lm.main, ["--steps", str(TRAIN_STEPS + 1), "--ckpt", ckpt, "--resume",
                                              "--device", "cpu"])
    assert again["history"] == [] and f"already at step {TRAIN_STEPS + 1}" in printed
