"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own.

Each check runs in a fresh interpreter, so what this test process already
imported (JAX, ``repro``) cannot hide an import the port makes.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _run(code: str, cwd=None, **env_extra) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=300, env=env, cwd=cwd or REPO,
    )


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for name in ("repro_torch.comm.strategies", "repro_torch.kernels.spmv_ell",
                 "repro_torch.models.lm", "repro_torch.kernels.flash_attention",
                 "repro_torch.comm.faults", "repro_torch.comm.compression",
                 "repro_torch.comm.hierarchical", "repro_torch.comm._legacy_planner",
                 "repro_torch.solve.operator", "repro_torch.solve.fused",
                 "repro_torch.serving.request", "repro_torch.serving.queue",
                 "repro_torch.serving.batcher", "repro_torch.serving.sim",
                 "repro_torch.serving.executor", "repro_torch.runtime.watchdog",
                 "repro_torch.testing.traces", "repro_torch.optim.adamw",
                 "repro_torch.data.synthetic", "repro_torch.checkpoint.ckpt",
                 "repro_torch.runtime.trainer", "repro_torch.launch.train",
                 "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                 "repro_torch.launch.op_analysis", "repro_torch.core.errors"):
        assert name in mods, name
    proc = _run(
        f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("OK", len({mods!r}))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "chip_b3_layouts.py"])
def test_no_jax_or_repro_import_lines(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)")
    bad = [
        line for line in (REPO / path).read_text().splitlines() if pattern.match(line)
    ]
    assert not bad, bad


def test_entry_points_without_device_raise_when_no_cuda():
    proc = _run(
        """
        import numpy as np, torch
        assert not torch.cuda.is_available()
        from repro_torch.comm import IrregularExchange, PodTopology, random_pattern
        from repro_torch.sparse import build, thermal_like
        topo = PodTopology(npods=2, ppn=2)
        pat = random_pattern(np.random.default_rng(0), topo, local_size=4)
        A = thermal_like(64, np.random.default_rng(0))
        for make in (lambda: IrregularExchange(pat, "two_step"),
                     lambda: IrregularExchange(pat, "two_step", wire="int8", verify=True),
                     lambda: build(A, topo, strategy="two_step"),
                     lambda: build(A, topo, strategy="auto", wire="auto", verify=True)):
            try:
                make()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError("ran on the CPU without being asked to")
        # the fused solvers: a numpy operator is lowered onto the CUDA device
        # unless told otherwise; a CPU operator is solved where it lives
        from repro_torch.solve import build_numpy, fused_cg, spd_system, traceable_operator
        S = spd_system(A)
        op = build_numpy(S, topo)
        b = np.ones((topo.nranks, op.rows_per_rank), np.float32)
        for make in (lambda: fused_cg(op, b), lambda: traceable_operator(op)):
            try:
                make()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError("ran on the CPU without being asked to")
        assert fused_cg(op, b, device="cpu").converged
        assert fused_cg(build(S, topo, strategy="two_step", device="cpu"), b).converged
        # the examples, each started without --device
        import contextlib, io
        from repro_torch.examples import (chaos_serving, krylov_solve, quickstart, serve_lm,
                                          strategy_advisor, train_lm)
        for main, argv in ((strategy_advisor.main, ["--messages", "32"]), (quickstart.main, []),
                           (krylov_solve.main, ["--fused"]), (chaos_serving.main, []),
                           (serve_lm.main, ["--arch", "deepseek-v2-lite-16b", "--advise-dispatch"]),
                           (train_lm.main, ["--steps", "1"])):
            printed = io.StringIO()
            try:
                with contextlib.redirect_stdout(printed):
                    main(argv)
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
                assert not printed.getvalue(), printed.getvalue()
            else:
                raise AssertionError(f"{main.__module__} ran on the CPU without being asked to")
        # asking for the CPU works
        IrregularExchange(pat, "two_step", device="cpu")(np.ones((4, 4), np.float32))
        IrregularExchange(pat, "two_step", device="cpu", wire="int8", verify=True)(np.ones((4, 4), np.float32))
        print("OK")
        """,
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_train_entry_points_without_device_raise_when_no_cuda(tmp_path):
    proc = _run(
        f"""
        import torch
        assert not torch.cuda.is_available()
        from repro_torch.checkpoint import load_checkpoint, save_checkpoint
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticTokens
        from repro_torch.launch.presets import tiny
        from repro_torch.launch.train import main
        from repro_torch.runtime import Trainer, TrainerConfig
        save_checkpoint({str(tmp_path)!r}, 1, {{"w": torch.zeros(2)}})
        for make in (lambda: SyntheticTokens(vocab_size=16, batch=1, seq_len=4),
                     lambda: Trainer(tiny(get_config("stablelm-3b")), TrainerConfig(steps=1)),
                     lambda: load_checkpoint({str(tmp_path)!r}, {{"w": torch.zeros(2)}}),
                     lambda: main(["--steps", "1"])):
            try:
                make()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError("ran on the CPU without being asked to")
        print("OK")
        """,
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"


def _last_line(text: str) -> str:
    lines = text.strip().splitlines()
    return lines[-1] if lines else ""


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(alone)], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
