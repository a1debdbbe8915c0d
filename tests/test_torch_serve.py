"""The port's serving entry point ``repro_torch.launch.serve`` on the CPU.

At the ``tiny`` preset its greedy tokens equal those of the reference
launcher's prefill + decode loop (``src/repro/launch/serve.py``) on the same
weights, carried over with ``from_reference``; the prompt (40) is longer than
the tiny window (32).  The families and flags the port does not run yet
raise ``NotImplementedError``, and without ``--device`` the entry point needs
a CUDA device.
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
from repro.launch.train import PRESETS as REF_PRESETS
from repro.models import LMModel as RefModel
from repro_torch.launch import serve
from repro_torch.launch.presets import PRESETS
from repro_torch.models.convert import from_reference

REPO = Path(__file__).resolve().parents[1]
BATCH, PROMPT, GEN = 2, 40, 6


def _reference_greedy(model, params, prompts, gen):
    """The loop of ``repro.launch.serve.main``: prefill, re-home, greedy decode."""
    logits, cache = model.prefill(params, prompts)
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


@pytest.mark.parametrize(
    "argv",
    [
        ["--arch", "deepseek-v2-lite-16b"],
        ["--arch", "llama4-scout-17b-a16e"],
        ["--arch", "llama-3.2-vision-90b"],
        ["--arch", "whisper-large-v3"],
        ["--advise-dispatch"],
        ["--simulate-serving", "8"],
        ["--chaos", "1"],
    ],
    ids=["mla-moe", "moe", "vlm", "enc-dec", "advise-dispatch", "simulate-serving", "chaos"],
)
def test_unported_families_and_flags_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        serve.main(argv + ["--preset", "tiny", "--device", "cpu"])


def test_entry_point_needs_a_card_without_device():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--preset", "tiny"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert "generated" not in proc.stdout
