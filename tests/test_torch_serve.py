"""The port's serving entry point ``repro_torch.launch.serve`` on the CPU.

At the ``tiny`` preset its greedy tokens equal those of the reference
launcher's prefill + decode loop (``src/repro/launch/serve.py``) on the same
weights, carried over with ``from_reference``; the prompt (40) is longer than
the tiny window (32).  For llama4-scout (MoE) the same holds, and the
measured routing counts, the dispatch advice, the serving simulation's
report and the chaos storm's trace hash equal the reference launcher's.
For deepseek-v2-lite (MLA + MoE), llama-3.2-vision (vlm) and whisper-large-v3
(enc_dec) at the tiny preset, with the stub context embeddings drawn after
the prompts as the reference launcher draws them, the greedy tokens equal
the reference's too.  Without ``--device`` the entry point needs a CUDA
device.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch.train import PRESETS as REF_PRESETS
from repro.models import LMModel as RefModel
from repro_torch.launch import serve
from repro_torch.launch.presets import PRESETS
from repro_torch.models.convert import from_reference

REPO = Path(__file__).resolve().parents[1]
BATCH, PROMPT, GEN = 2, 40, 6


def _reference_greedy(model, params, prompts, gen, ctx=None):
    """The loop of ``repro.launch.serve.main``: prefill, re-home, greedy decode."""
    logits, cache = model.prefill(params, prompts, ctx)
    full = model.init_cache(prompts.shape[0], prompts.shape[1] + gen, model.dtype)

    def blend(dst, src):
        if dst.shape != src.shape:
            return dst.at[tuple(slice(0, s) for s in src.shape)].set(src.astype(dst.dtype))
        return src.astype(dst.dtype)

    cache = jax.tree.map(blend, full, cache)
    decode = jax.jit(model.decode_step)
    token = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    outs = [token]
    for t in range(gen - 1):
        logits, cache = decode(params, token, cache, jnp.int32(prompts.shape[1] + t))
        token = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
        outs.append(token)
    return np.asarray(jnp.concatenate(outs, axis=1))


def test_presets_match_the_reference():
    for name in ("tiny", "100m", "full"):
        for arch in ("hymba-1.5b", "stablelm-3b", "mamba2-780m"):
            got = dataclasses.asdict(PRESETS[name](serve.get_config(arch)))
            assert got == dataclasses.asdict(REF_PRESETS[name](ref_config(arch)))


@pytest.fixture(scope="module")
def reference():
    """The reference launcher's greedy tokens at the tiny preset, and its weights."""
    ref = RefModel(REF_PRESETS["tiny"](ref_config("hymba-1.5b")))
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))  # one compile, not one per leaf
    prompts = serve.make_prompts(ref.cfg.vocab_size, BATCH, PROMPT, seed=0)
    tokens = _reference_greedy(ref, params, jnp.asarray(prompts, jnp.int32), GEN)
    return jax.tree.map(np.asarray, params), prompts, tokens


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_tiny_hymba_greedy_tokens_match_reference(reference, impl):
    params, prompts, want = reference
    model = serve.LMModel(PRESETS["tiny"](serve.get_config("hymba-1.5b")))
    tparams = from_reference(model, params, device="cpu")
    out = serve.generate(model, tparams, torch.as_tensor(prompts), GEN, impl=impl)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert len(out["logits"]) == GEN and out["prefill_s"] > 0 and out["decode_s"] > 0


def test_main_runs_on_the_cpu_when_asked(capsys):
    out = serve.main(["--arch", "mamba2-780m", "--preset", "tiny", "--batch", "2", "--prompt-len", "20",
                      "--gen", "4", "--device", "cpu", "--seed", "3"])
    assert out["tokens"].shape == (2, 4) and out["tokens"].device.type == "cpu"
    assert "mamba2-780m (tiny" in capsys.readouterr().out
    # the same seed draws the same weights and prompts
    again = serve.main(["--arch", "mamba2-780m", "--preset", "tiny", "--batch", "2", "--prompt-len", "20",
                        "--gen", "4", "--device", "cpu", "--seed", "3"])
    assert torch.equal(out["tokens"], again["tokens"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "llama-3.2-vision-90b", "whisper-large-v3"],
                         ids=["mla-moe", "vlm", "enc-dec"])
def test_mla_vlm_enc_dec_greedy_tokens_match_reference(arch):
    """The reference launcher's loop at the tiny preset (its default
    ``chunked`` prefill) and the port's kernel route on the same weights,
    prompts and stub context (drawn after the prompts from one seed) give
    the same greedy tokens; so does the port's ``main`` on its own seed's
    weights, twice."""
    ref = RefModel(REF_PRESETS["tiny"](ref_config(arch)))
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    prompts, ctx = serve.make_context(ref.cfg.vocab_size, BATCH, PROMPT, ref.ctx_len(), ref.cfg.d_model, seed=0)
    assert (ctx is None) == (arch == "deepseek-v2-lite-16b")
    want = _reference_greedy(ref, params, jnp.asarray(prompts, jnp.int32), GEN,
                             None if ctx is None else jnp.asarray(ctx))
    model = serve.LMModel(PRESETS["tiny"](serve.get_config(arch)))
    tparams = from_reference(model, jax.tree.map(np.asarray, params), device="cpu")
    out = serve.generate(model, tparams, torch.as_tensor(prompts), GEN, impl="kernel",
                         ctx=None if ctx is None else torch.as_tensor(ctx))
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    argv = ["--arch", arch, "--preset", "tiny", "--device", "cpu", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--seed", "4"]
    assert torch.equal(serve.main(argv)["tokens"], serve.main(argv)["tokens"])


def test_vlm_layers_must_keep_whole_cross_groups():
    with pytest.raises(ValueError, match="not a multiple of cross_attn_every 5"):
        serve.build("llama-3.2-vision-90b", "tiny", device="cpu", layers=7)
    model, params = serve.build("llama-3.2-vision-90b", "tiny", device="cpu", layers=10)
    assert [(s.name, s.count) for s in model.segments] == [("self", 8), ("cross", 2)]
    assert params["seg_cross"]["cross"]["wq"].shape[0] == 2


# ---------------------------------------------------------------------------
# llama4-scout (MoE): serving, routing counts, advice, simulation, chaos
# ---------------------------------------------------------------------------

MOE_ARCH = "llama4-scout-17b-a16e"


@pytest.fixture(scope="module")
def moe_reference():
    """The reference launcher's tiny llama4-scout serve and its dispatch
    reports, on weights that the port then carries over."""
    ref = RefModel(REF_PRESETS["tiny"](ref_config(MOE_ARCH)))
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    prompts = serve.make_prompts(ref.cfg.vocab_size, BATCH, PROMPT, seed=0)
    tokens = _reference_greedy(ref, params, jnp.asarray(prompts, jnp.int32), GEN)
    served = np.concatenate([prompts, tokens], axis=1)
    reports = {}
    for npods, ppn in ((2, 4), (1, 3)):  # 3 ranks: batch rows not divisible
        counts, advice = ref_serve.dispatch_advice(params, ref.cfg, served, npods, ppn)
        reports[npods, ppn] = (counts, advice)
    return jax.tree.map(np.asarray, params), prompts, tokens, ref.cfg, reports


def _moe_port(moe_reference):
    params, *_ = moe_reference
    model = serve.LMModel(PRESETS["tiny"](serve.get_config(MOE_ARCH)))
    return model, from_reference(model, params, device="cpu")


def test_tiny_llama4_greedy_tokens_match_reference(moe_reference):
    _, prompts, want, *_ = moe_reference
    model, tparams = _moe_port(moe_reference)
    out = serve.generate(model, tparams, torch.as_tensor(prompts), GEN, impl="kernel")
    np.testing.assert_array_equal(out["tokens"].numpy(), want)


@pytest.mark.parametrize("ranks", [(2, 4), (1, 3)], ids=["2x4", "1x3"])
def test_routing_counts_and_advice_match_reference(moe_reference, ranks):
    _, prompts, tokens, ref_cfg, reports = moe_reference
    model, tparams = _moe_port(moe_reference)
    served = np.concatenate([prompts, tokens], axis=1)
    want_counts, want_advice = reports[ranks]
    counts = serve.routing_counts(tparams, model.cfg, torch.as_tensor(served), ranks[0] * ranks[1])
    assert counts.dtype == want_counts.dtype
    np.testing.assert_array_equal(counts, want_counts)
    counts, advice = serve.dispatch_advice(tparams, model.cfg, served, *ranks)
    assert [(r.key, r.predicted_time) for r in advice.ranked] == [
        (r.key, r.predicted_time) for r in want_advice.ranked]
    assert advice.table() == want_advice.table()
    with pytest.raises(ValueError, match="MoE arch"):
        serve.routing_counts(tparams, PRESETS["tiny"](serve.get_config("stablelm-3b")), served, 8)


def test_simulate_serving_and_chaos_match_reference(moe_reference, capsys):
    from repro.comm.faults import FaultPlan as RefFaultPlan
    from repro.comm.faults import FaultSpec as RefFaultSpec
    from repro.serving import SimConfig as RefSimConfig
    from repro.serving import WorkloadClass as RefWorkloadClass
    from repro.serving import serving_report as ref_serving_report
    from repro.serving import simulate as ref_simulate
    from repro.testing import make_trace as ref_make_trace

    ref_cfg = moe_reference[3]
    out = serve.main(["--arch", MOE_ARCH, "--preset", "tiny", "--device", "cpu", "--batch", str(BATCH),
                      "--prompt-len", str(PROMPT), "--gen", str(GEN), "--advise-dispatch",
                      "--simulate-serving", "8", "--chaos", "1"])
    printed = capsys.readouterr().out
    assert "dispatch advice (2 pods x 4" in printed and "chaos storm (seed 1)" in printed
    got = out["dispatch"]
    # the reference launcher's reports on the same weights and served tokens
    _, params = serve.build(MOE_ARCH, "tiny", seed=0, device="cpu")
    numpy_params = {"embed": params["embed"].numpy(),
                    "seg_moe": {"moe": {"router": params["seg_moe"]["moe"]["router"].numpy()}}}
    served = np.concatenate([serve.make_prompts(ref_cfg.vocab_size, BATCH, PROMPT, 0), out["tokens"].numpy()], 1)
    counts, advice = ref_serve.dispatch_advice(numpy_params, ref_cfg, served, 2, 4)
    np.testing.assert_array_equal(got["counts"], counts)
    assert got["advice"].table() == advice.table()
    cls = RefWorkloadClass.from_routing(counts, ppn=4, d_model=ref_cfg.d_model, fp="moe")
    trace = ref_make_trace(0, 8, ["moe"], pattern="burst", rate=400, kinds={"moe": "moe"})
    assert got["report"] == ref_serving_report({"moe": cls}, trace, RefSimConfig(max_width=8))
    plan = RefFaultPlan(seed=1, specs=(RefFaultSpec(kind="perturb", prob=0.25, frac=0.1),
                                       RefFaultSpec(kind="slow", prob=0.1, delay_s=2e-3)))
    storm = ref_simulate({"moe": cls}, trace, RefSimConfig(max_width=8, chaos=plan, deadline_s=0.05))
    assert got["storm"].trace_hash == storm.trace_hash
    assert (got["storm"].completed, got["storm"].fault_events, got["storm"].recoveries) == (
        storm.completed, storm.fault_events, storm.recoveries)


def test_advise_dispatch_needs_a_moe_arch_and_layers_cut_depth():
    with pytest.raises(ValueError, match="MoE arch"):
        serve.main(["--arch", "stablelm-3b", "--preset", "tiny", "--device", "cpu", "--gen", "2",
                    "--advise-dispatch"])
    model, params = serve.build(MOE_ARCH, "tiny", device="cpu", layers=1)
    assert model.cfg.n_layers == 1 and params["seg_moe"]["moe"]["w_in"].shape[0] == 1


def test_entry_point_needs_a_card_without_device():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--preset", "tiny"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert "generated" not in proc.stdout
