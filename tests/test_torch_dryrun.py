"""The port's dry-run (``repro_torch.launch.dryrun``) and its op analyser
(``repro_torch.launch.op_analysis``) against the reference's
``repro.launch.dryrun``.

The reference's dry-run runs in a child interpreter: importing it prepends
``--xla_force_host_platform_device_count=512`` to ``XLA_FLAGS``, which must
not reach this process (``tests/conftest.py``).  Its ``model_flops``,
``attention_kernel_terms`` and ``shape_applicable`` are arithmetic on the
config and the parameter tree, so they are held equal for every one of the
10 archs x 4 shapes at full size, with the reference's model at ``tp=1``.
The port's traced cells run at the ``tiny`` preset in bfloat16, 2 x 64
tokens; the dense ones are held to a closed form.  The fused stub is held
to the reference's within 1e-6 on seeded inputs.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attend_fused_stub as ref_stub
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.presets import tiny
from repro_torch.models.layers import attend_fused_stub
from repro_torch.models.lm import LMModel
from repro_torch.models.sharding import tree_items

REPO = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
B, S = 2, 64


def _child(code: str, **env_extra) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), **env_extra}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)


@pytest.fixture(scope="module")
def reference():
    """``"arch|shape" -> {ok, why, model_flops, terms}`` from the reference's dry-run."""
    proc = _child(
        """
        import json
        from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
        from repro.launch.dryrun import attention_kernel_terms, model_flops
        from repro.models import LMModel
        out = {}
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            model = LMModel(cfg, tp=1)
            for name, shape in SHAPES.items():
                ok, why = shape_applicable(cfg, shape)
                out[f"{arch}|{name}"] = {"ok": ok, "why": why, "model_flops": list(model_flops(cfg, model, shape)),
                                         "terms": attention_kernel_terms(cfg, model, shape)}
        print(json.dumps(out))
        """,
        JAX_PLATFORMS="cpu",
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the reference's arithmetic, every cell at full size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_kernel_terms_equal_the_reference(reference, arch):
    cfg = get_config(arch)
    model = LMModel(cfg)
    for name, shape in SHAPES.items():
        want = reference[f"{arch}|{name}"]
        assert list(dryrun.model_flops(cfg, model, shape)) == want["model_flops"], name
        assert dryrun.attention_kernel_terms(cfg, model, shape) == want["terms"], name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skipped_cells_match_the_reference(reference, arch, tmp_path):
    for name, shape in SHAPES.items():
        want = reference[f"{arch}|{name}"]
        assert list(shape_applicable(get_config(arch), shape)) == [want["ok"], want["why"]], name
        if not want["ok"]:
            rec = dryrun.run_cell(arch, name, "one_card", str(tmp_path))
            assert rec == {"arch": arch, "shape": name, "mesh": "one_card", "skipped": want["why"]}
    assert set(reference) == {f"{a}|{n}" for a in ARCH_IDS for n in SHAPES}


def test_shared_experts_count_top_k_over_n_experts_as_in_the_reference():
    """The reference's MoE rule scales every ``w_in``/``w_gate``/``w_out``
    under a ``moe`` key, the shared expert's too (ROADMAP caveat 9)."""
    cfg = get_config("llama4-scout-17b-a16e")
    model = LMModel(cfg)
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    moe = [(key, math.prod(ps.shape)) for key, ps in tree_items(model.param_specs())
           if ".moe." in key and key.rsplit(".", 1)[-1] in ("w_in", "w_gate", "w_out")]
    shared = [(key, n) for key, n in moe if ".shared." in key]
    assert shared and all(key.startswith("seg_moe.moe.shared.") for key, _ in shared)
    _, total, active = dryrun.model_flops(cfg, model, SHAPES["prefill_32k"])
    routed_only = total - sum(n - int(n * k / E) for key, n in moe if ".shared." not in key)
    assert routed_only - active == sum(n - int(n * k / E) for _, n in shared) > 0


# ---------------------------------------------------------------------------
# the fused stub
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["gqa", "mla"])
def test_fused_stub_matches_the_reference(case):
    rng = np.random.default_rng(7)
    H, KV, Dqk, Dv = (8, 2, 32, 32) if case == "gqa" else (4, 4, 48, 32)
    q = rng.normal(size=(2, 12, H, Dqk)).astype(np.float32)
    k = rng.normal(size=(2, 12, KV, Dqk)).astype(np.float32)
    v = rng.normal(size=(2, 12, KV, Dv)).astype(np.float32)
    got = attend_fused_stub(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v))
    want = np.asarray(ref_stub(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert got.shape == want.shape == (2, 12, H, Dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the op analyser on known programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_analyser_counts_a_known_program(device):
    D, L = 64, 5
    x = torch.randn(D, D, device=device)
    ws = [torch.randn(D, D, device=device) for _ in range(L)]

    def program(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    st = op_analysis.analyze(program, x, ws)
    assert st.flops == 2 * D**3 * L
    assert st.mem_bytes >= L * D * D * 4
    assert st.mem_bytes == 2 * 2 * L * D * D * 4  # mm and tanh each write a D x D result
    assert (st.collective_by_kind, st.collective_ops, st.collective_bytes) == ({}, 0, 0)
    assert st.argument_bytes == (L + 1) * D * D * 4
    assert st.output_bytes == D * D * 4
    assert st.peak_bytes == 3 * D * D * 4  # the previous x, x @ w and its tanh
    assert st.temp_bytes == 2 * D * D * 4
    top = op_analysis.top_contributors(st, k=2)
    assert sorted(op for _, _, op, _ in top) == ["aten.mm", "aten.tanh"]
    assert all(b == 2 * L * D * D * 4 and n == L for b, n, _, _ in top)
    coll = op_analysis.analyze_collectives(program, x, ws)
    assert (coll.by_kind, coll.op_count, coll.total_bytes) == ({}, 0, 0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_analyser_counts_nothing_for_views_and_no_op_casts(device):
    x = torch.zeros(8, 16, device=device)
    empty = op_analysis.analyze(lambda: None)
    assert (empty.flops, empty.mem_bytes, empty.peak_bytes, empty.output_bytes, empty.argument_bytes) == (0, 0, 0, 0, 0)
    views = op_analysis.analyze(
        lambda a: (a.view(-1), a.to(torch.float32), a.detach(), a[1:], a.T, a.contiguous(), a.reshape(16, 8)), x)
    assert (views.flops, views.mem_bytes, views.peak_bytes, views.output_bytes) == (0, 0, 0, 0)
    assert views.argument_bytes == x.nbytes


def test_analyser_sees_the_backward():
    D = 32
    x = torch.randn(D, D, device="meta")
    w = torch.randn(D, D, device="meta", requires_grad=True)
    st = op_analysis.analyze(lambda: torch.autograd.grad((x @ w).sum(), w))
    assert st.flops == 2 * 2 * D**3  # forward x @ w, backward x.T @ grad


# ---------------------------------------------------------------------------
# the traced cells at the tiny preset
# ---------------------------------------------------------------------------


def _tiny(arch):
    return dataclasses.replace(tiny(get_config(arch)), dtype="bfloat16")


def _param_bytes(model, dtype=None):
    return sum(math.prod(ps.shape) * (4 if ps.keep_f32 or dtype == torch.float32 else 2)
               for _, ps in tree_items(model.param_specs()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_argument_bytes_and_record(arch, kind):
    cfg = _tiny(arch)
    model = LMModel(cfg)
    shape = ShapeConfig(f"tiny_{kind}", S, B, kind)
    rec = dryrun.analyse_cell(cfg, shape, impl="chunked")
    tokens = B * (1 if kind == "decode" else S) * 8
    ctx = B * model.ctx_len() * cfg.d_model * 2
    if kind == "train":
        want = 3 * _param_bytes(model, torch.float32) + 4 + 2 * tokens + ctx  # masters, mu, nu, step; tokens, labels
        cache = 0
    elif kind == "prefill":
        want, cache = _param_bytes(model) + tokens + ctx, 0
    else:
        cache = sum(t.nbytes for _, t in tree_items(model.init_cache(B, S, device="meta")))
        want = _param_bytes(model) + tokens + cache
    mem = rec["memory"]
    assert mem["argument_bytes"] == want
    assert mem["alias_bytes"] == cache
    assert mem["temp_bytes"] >= 0 and mem["output_bytes"] > 0
    assert (rec["mesh"], rec["chips"], rec["collective_ops"], rec["collective_by_kind"]) == ("one_card", 1, 0, {})
    assert rec["params_total"] == model.param_count()
    assert rec["counted_flops_per_chip"] > 0 and rec["counted_bytes_per_chip"] > 0
    assert rec["analytic_kernel_flops_per_chip"] == rec["analytic_kernel_bytes_per_chip"] == 0
    assert rec["knobs"] == {"attn_impl": "chunked", "remat": os.environ.get("REPRO_REMAT_POLICY", "full")}


DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense" and get_config(a).mla is None]


def _dense_prefill_flops(cfg, attention: bool) -> float:
    """Matrix-product FLOPs of a dense prefill: per layer the q/k/v/o
    projections, the MLP and, under ``chunked``, both products over the full
    key block (one block of 1024 covers S; masked scores are computed too);
    the head at the last position only."""
    M, H, KV, D, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    T = B * S
    layer = 2 * T * M * D * (2 * H + 2 * KV) + (3 if cfg.act == "silu" else 2) * 2 * T * M * F
    if attention:
        layer += 2 * 2 * B * H * S * S * D
    return cfg.n_layers * layer + 2 * B * M * cfg.padded_vocab(16)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_flops_equal_a_closed_form_and_fused_adds_the_kernel_terms(arch, monkeypatch):
    cfg = _tiny(arch)
    shape = ShapeConfig("tiny_prefill", S, B, "prefill")
    chunked = dryrun.analyse_cell(cfg, shape)
    assert chunked["counted_flops_per_chip"] == _dense_prefill_flops(cfg, attention=True)
    monkeypatch.setenv("REPRO_ATTN_IMPL", "fused")
    fused = dryrun.analyse_cell(cfg, shape)
    terms = dryrun.attention_kernel_terms(cfg, LMModel(cfg), shape)
    assert terms["flops"] == cfg.n_layers * 4.0 * B * cfg.n_heads * S * S * cfg.resolved_head_dim * 0.5
    assert fused["knobs"]["attn_impl"] == "fused"
    assert (fused["analytic_kernel_flops_per_chip"], fused["analytic_kernel_bytes_per_chip"]) == (
        terms["flops"], terms["bytes"])
    assert fused["counted_flops_per_chip"] == _dense_prefill_flops(cfg, attention=False) + terms["flops"]
    fn, args, _ = dryrun.cell_program(LMModel(cfg), shape, "fused")
    assert fused["counted_bytes_per_chip"] == op_analysis.analyze(fn, *args).mem_bytes + terms["bytes"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-large-v3", "hymba-1.5b"])
def test_fused_cells_add_exactly_the_kernel_terms(arch, kind):
    """Under ``fused`` every cell traces (train too: the stub has a
    backward) and adds exactly ``attention_kernel_terms``; decode adds 0."""
    cfg = _tiny(arch)
    shape = ShapeConfig(f"tiny_{kind}", S, B, kind)
    rec = dryrun.analyse_cell(cfg, shape, impl="fused")
    fn, args, _ = dryrun.cell_program(LMModel(cfg), shape, "fused")
    stats = op_analysis.analyze(fn, *args)
    terms = dryrun.attention_kernel_terms(cfg, LMModel(cfg), shape)
    assert (kind == "decode") == (terms["flops"] == 0)
    assert rec["counted_flops_per_chip"] == stats.flops + terms["flops"]
    assert rec["counted_bytes_per_chip"] == stats.mem_bytes + terms["bytes"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_writes_records_without_initialising_cuda(tmp_path):
    proc = _child(
        f"""
        import json, os, torch
        from repro_torch.launch.dryrun import main
        main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--out", {str(tmp_path)!r}])
        main(["--arch", "stablelm-3b", "--shape", "long_500k", "--mesh", "one_card", "--out", {str(tmp_path)!r}])
        assert not torch.cuda.is_initialized()
        print("OK", sorted(os.listdir({str(tmp_path)!r})))
        """,
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[ OK ] stablelm-3b x decode_32k x one_card" in proc.stdout
    assert "[SKIP] stablelm-3b x long_500k x one_card: full-attention arch" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "OK ['stablelm-3b__decode_32k__one_card.json']"
    rec = json.loads((tmp_path / "stablelm-3b__decode_32k__one_card.json").read_text())
    for key in ("arch", "shape", "mesh", "chips", "lower_s", "analytic_kernel_flops_per_chip",
                "analytic_kernel_bytes_per_chip", "knobs", "collective_bytes_per_chip", "collective_by_kind",
                "collective_ops", "model_flops", "params_total", "params_active", "counted_flops_per_chip",
                "counted_bytes_per_chip"):
        assert key in rec, key
    assert not {"compile_s", "xla_cost_flops_raw", "xla_cost_bytes_raw", "hlo_flops_per_chip"} & set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    cfg = get_config("stablelm-3b")
    # the cache: 32 layers of k and v, 128 x 32768 x 32 heads x 80, bf16
    assert rec["memory"]["alias_bytes"] == cfg.n_layers * 2 * 128 * 32768 * cfg.n_kv_heads * 80 * 2
    assert rec["model_flops"] == 2.0 * cfg.approx_params() * 128


@pytest.mark.parametrize("mesh", ["multi", "both"])
def test_cli_mesh_of_several_cards_raises(mesh, tmp_path):
    """Kept in name, rewritten: ``--mesh multi`` and ``both`` no longer raise;
    they write per-chip records of the reference's meshes (here mamba2-780m's
    500k-token decode, the cheapest cell to trace), each in a fake world of
    its size, never touching CUDA."""
    proc = _child(
        f"""
        import torch
        from repro_torch.launch.dryrun import main
        main(["--arch", "mamba2-780m", "--shape", "long_500k", "--mesh", {mesh!r}, "--out", {str(tmp_path)!r}])
        assert not torch.cuda.is_initialized()
        """,
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    kinds = ["single", "multi"] if mesh == "both" else [mesh]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"mamba2-780m__long_500k__{k}.json" for k in kinds)
    sizes = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
    model, shape = LMModel(get_config("mamba2-780m"), tp=16), SHAPES["long_500k"]
    for kind in kinds:
        assert f"[ OK ] mamba2-780m x long_500k x {kind}" in proc.stdout
        rec = json.loads((tmp_path / f"mamba2-780m__long_500k__{kind}.json").read_text())
        assert (rec["mesh"], rec["chips"]) == (kind, math.prod(sizes[kind].values()))
        assert rec["memory"]["argument_bytes"] == dryrun.spec_argument_bytes(model, shape, sizes[kind])
        assert [rec["model_flops"], rec["params_total"], rec["params_active"]] == \
            list(dryrun.model_flops(model.cfg, model, shape))


# ---------------------------------------------------------------------------
# per-chip records on a mesh: a fake world of 8 (2 x 4), the tiny presets
# ---------------------------------------------------------------------------

MESH_SHAPES = {"prefill": ShapeConfig("prefill", 64, 8, "prefill"),
               "decode": ShapeConfig("decode", 64, 8, "decode"),
               "train": ShapeConfig("train", 64, 8, "train")}


@pytest.fixture(scope="module")
def mesh_cells():
    """``"arch|kind"`` -> the port's per-chip record on a 2x4 mesh, its one-card
    record and ``spec_argument_bytes``, and the reference's compiled
    ``argument_size_in_bytes`` of the same cell on a 2x4 mesh of 8 host
    devices: its ``lower_cell`` with ``get_config`` and ``SHAPES`` patched in
    the child to these tiny cells, the mesh's axes ``Auto`` (this jax's
    ``jax.make_mesh`` makes ``Explicit`` axes, which the reference's
    ``with_sharding_constraint`` anchors reject).  The two children run at once."""
    shapes = {k: (v.seq_len, v.global_batch, v.kind) for k, v in MESH_SHAPES.items()}
    port = f"""
        import dataclasses, json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import ARCH_IDS, get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import init_fake_world
        from repro_torch.launch.presets import tiny
        from repro_torch.models.lm import LMModel
        init_fake_world(8)
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        out = {{}}
        for arch in ARCH_IDS:
            cfg = dataclasses.replace(tiny(get_config(arch)), dtype="bfloat16")
            for kind, (seq, batch, k) in {shapes!r}.items():
                shape = ShapeConfig(kind, seq, batch, k)
                out[arch + "|" + kind] = {{
                    "mesh": dryrun.analyse_cell(cfg, shape, "chunked", mesh=mesh, mesh_kind="host"),
                    "one_card": dryrun.analyse_cell(cfg, shape, "chunked"),
                    "spec_bytes": dryrun.spec_argument_bytes(LMModel(cfg, tp=4), shape, {{"data": 2, "model": 4}}),
                }}
        print(json.dumps(out))
        """
    ref = f"""
        import json
        import jax
        from jax.sharding import AxisType
        import repro.launch.dryrun as rd
        from repro.configs import ARCH_IDS
        from repro.configs.base import ShapeConfig
        from repro.launch.train import tiny
        full = rd.get_config
        rd.get_config = lambda arch: tiny(full(arch))
        rd.SHAPES = {{kind: ShapeConfig(kind, *v) for kind, v in {shapes!r}.items()}}
        mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8], axis_types=(AxisType.Auto,) * 2)
        out = {{}}
        for arch in ARCH_IDS:
            for kind in rd.SHAPES:
                lowered, _ = rd.lower_cell(arch, kind, mesh)
                out[arch + "|" + kind] = lowered.compile().memory_analysis().argument_size_in_bytes
        print(json.dumps(out))
        """
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env={**env, **extra}, cwd=REPO)
             for code, extra in ((port, {"CUDA_VISIBLE_DEVICES": ""}), (ref, {"JAX_PLATFORMS": "cpu"}))]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got, want = (json.loads(out.strip().splitlines()[-1]) for out, _ in outs)
    for key, cell in got.items():
        cell["reference_argument_bytes"] = want[key]
    return got


def _dtype_terms(arch: str, kind: str) -> int:
    """The bytes by which the port's per-chip arguments exceed the reference
    dry-run's, each from its local shard on the 2x4 mesh: the ``keep_f32``
    leaves in float32 where the reference declares every parameter bf16
    (prefill, decode; the train state is float32 in both), and the token ids
    in int64 where the reference's are int32; less the reference's int32
    ``pos`` of decode, an argument that the port's ``decode_step`` takes as
    a Python int.  Beside the dtypes, ``jax.jit`` drops the arguments a
    program never reads: decode's encoder and adapter weights (whisper, the
    vlm), its cross-attention key and value projections (the cross K/V come
    from the cache), and ``pos`` where no cache reads it (mamba2); the port
    passes them all."""
    from repro_torch.models import sharding as sh

    sizes = {"data": 2, "model": 4}
    rules = sh.rules_for_mesh(sizes)
    model = LMModel(_tiny(arch), tp=4)
    shape = MESH_SHAPES[kind]
    local = lambda ps: math.prod(sh.local_shape(sizes, sh.spec_for(sizes, rules, ps.logical, ps.shape), ps.shape))
    unread = lambda key: kind == "decode" and (key.startswith(("enc_", "adapter")) or ".cross.w" in key
                                               and key.endswith((".wk", ".wv")))
    params = dict(tree_items(model.param_specs()))
    f32 = 0 if kind == "train" else sum(2 * local(ps) for key, ps in params.items() if ps.keep_f32 and not unread(key))
    f32 += sum(local(ps) * (4 if ps.keep_f32 else 2) for key, ps in params.items() if unread(key))
    ids = {"train": 2 * shape.seq_len, "prefill": shape.seq_len, "decode": 1}[kind] * shape.global_batch // 2
    cache = model.init_cache(1, 1, device="meta")
    reads_pos = any(k.rsplit(".", 1)[-1] in ("k", "c_kv") for k, _ in tree_items(cache))
    return f32 + 4 * ids - (4 if kind == "decode" and reads_pos else 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_argument_bytes_are_the_local_shards(mesh_cells, arch, kind):
    cell = mesh_cells[f"{arch}|{kind}"]
    rec = cell["mesh"]
    assert (rec["mesh"], rec["chips"]) == ("host", 8)
    assert rec["memory"]["argument_bytes"] == cell["spec_bytes"]
    assert rec["memory"]["argument_bytes"] - _dtype_terms(arch, kind) == cell["reference_argument_bytes"]
    assert rec["collective_ops"] > 0 and rec["collective_bytes_per_chip"] > 0
    assert set(rec["collective_by_kind"]) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_flops_per_chip_cover_the_one_card_count(mesh_cells, arch, kind):
    cell = mesh_cells[f"{arch}|{kind}"]
    rec, one = cell["mesh"], cell["one_card"]
    assert rec["counted_flops_per_chip"] * rec["chips"] >= one["counted_flops_per_chip"]
    assert rec["counted_flops_per_chip"] < one["counted_flops_per_chip"]


def test_one_device_mesh_gives_the_one_card_record():
    proc = _child(
        """
        import dataclasses, json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import init_fake_world
        from repro_torch.launch.presets import tiny
        init_fake_world(1)
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(tiny(get_config("hymba-1.5b")), dtype="bfloat16")
        out = []
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig(kind, 64, 2, kind)
            out.append([dryrun.analyse_cell(cfg, shape, "chunked", mesh=mesh),
                        dryrun.analyse_cell(cfg, shape, "chunked")])
        print(json.dumps(out))
        """,
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for on_mesh, one in json.loads(proc.stdout.strip().splitlines()[-1]):
        del on_mesh["lower_s"], one["lower_s"]
        assert on_mesh == one


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-large-v3", "hymba-1.5b"])
def test_fused_prefill_matches_the_reference(arch):
    """The stub through the whole model (MLA's unequal widths; the encoder,
    self- and cross-attention; the hybrid's SSM on its chunked path), the
    reference's weights carried over, float32: last logits and cache within 1e-4."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import LMModel as RefModel
    from repro_torch.models.convert import from_reference
    from test_torch_lm import CTX, _flat, shrink

    ref = RefModel(shrink(ref_config(arch)))
    model = LMModel(shrink(get_config(arch)))
    params = jax.jit(ref.init)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 12))
    ctx = rng.normal(size=(2, CTX, 64)).astype(np.float32) if model.ctx_len() else None
    last, cache = ref.prefill(params, jnp.asarray(toks, jnp.int32), None if ctx is None else jnp.asarray(ctx),
                              impl="fused")
    got_last, got_cache = model.prefill(from_reference(model, jax.tree.map(np.asarray, params), device="cpu"),
                                        torch.as_tensor(toks), None if ctx is None else torch.as_tensor(ctx),
                                        impl="fused")
    np.testing.assert_allclose(got_last.numpy(), np.asarray(last), rtol=1e-4, atol=1e-4)
    want = _flat(cache)
    got = {k: v.numpy() for k, v in tree_items(got_cache)}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
