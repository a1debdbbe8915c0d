"""Dry-run: every (arch x shape x mesh) cell traced at full size on meta tensors.

The port's counterpart of ``repro.launch.dryrun``, which proves without
hardware that the distribution of every cell is coherent: it lowers and
compiles each cell's ``train_step`` / ``prefill`` / ``serve_step`` for its
production meshes with ``ShapeDtypeStruct`` inputs.  The port runs eagerly:
it builds each cell's parameters, optimizer state, batch and cache as
**meta tensors** at full size (shapes and dtypes, no memory) and runs the
cell's real entry point once under
:func:`repro_torch.launch.op_analysis.analyze`:

* ``train``   -- one :class:`~repro_torch.runtime.trainer.TrainStep` (remat,
  the bf16 working copy, AdamW), on float32 masters and AdamW state as
  :func:`~repro_torch.runtime.trainer.state_template` builds them;
* ``prefill`` -- ``LMModel.prefill`` on parameters in the model dtype (the
  ``keep_f32`` leaves in float32), with ``ctx_emb`` where the model has a
  context;
* ``decode``  -- one ``decode_step`` against an ``init_cache(B, S)`` cache at
  ``pos = S - 1``.

``--mesh`` picks where a cell runs:

* ``one_card`` (the default) -- one H100 holds the cell; every tensor is whole.
* ``single`` / ``multi`` -- the reference's meshes: the 16x16 ``("data",
  "model")`` pod (256 chips) and 2x16x16 ``("pod", "data", "model")`` (512
  chips); ``both`` runs the two.  The dry-run makes the default process group
  a fake group of the mesh's size in its own process, standing at rank 0
  (:func:`repro_torch.launch.mesh.init_fake_world`), and builds the mesh over
  it.  Every argument is a DTensor placed by the reference's rules
  (:mod:`repro_torch.models.sharding`: parameters and optimizer state by
  ``param_shardings``, token ids by ``batch`` on their first dim, the decode
  cache by :func:`cache_shardings`), its local shard a meta tensor, and the
  model is ``LMModel(cfg, tp=16)`` with the reference's head padding.  The
  counts are rank 0's, per chip (see :mod:`~repro_torch.launch.op_analysis`).

It allocates on no device and never initialises CUDA, so the rule that the
port's entry points run on the card does not apply to it.

The record, one JSON per cell under ``artifacts/dryrun_torch/`` named
``{arch}__{shape}__{mesh}.json``, keeps the reference's key names where the
quantity is the same (``arch``, ``shape``, ``mesh``, ``chips``, ``lower_s``
-- the trace seconds --, ``analytic_kernel_*_per_chip``, ``knobs``,
``collective_*``, ``model_flops``, ``params_total``, ``params_active``,
``memory``).  The counted quantities are ``counted_flops_per_chip`` and
``counted_bytes_per_chip`` (the reference's ``hlo_*``: the port counts ops,
not HLO), the analytic kernel terms included as the reference includes
them, divided by the chip count as it divides them.  ``memory`` is one
chip's: ``argument_bytes`` -- every argument's storage (parameters,
optimizer state or cache, and the token ids); ``output_bytes`` -- what the
call returns that it allocated; ``temp_bytes`` -- the rest of the call's
peak, so the cell needs ``argument + temp + output`` bytes at once;
``alias_bytes`` -- the decode cache, which ``decode_step`` updates in place
(ROADMAP caveat 8; an SSM state is replaced, and the new one counts as
output), as the reference donates it.

Left out, with no counterpart: ``compile_s`` (nothing is compiled);
``xla_cost_flops_raw`` / ``xla_cost_bytes_raw`` (XLA's ``cost_analysis``,
which counts each loop body once: an eager trace has no folded loops);
``memory.code_bytes`` (no generated code: the trace runs no kernel).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import init_fake_world, make_production_mesh, production_shape
from repro_torch.models.lm import LMModel
from repro_torch.models.sharding import (
    constrain,
    local_shape,
    meta_dtensor,
    mesh_size,
    named_sharding,
    param_shardings,
    rules_for_mesh,
    spec_for,
    tree_items,
    tree_map,
)
from repro_torch.models.transformer import pad_heads
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import TrainStep, state_template

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")
#: where a cell runs: one card, or the reference's two production meshes
MESHES = ("one_card", "single", "multi")
#: one H100's memory (80 GB, the data sheet's): a cell fits if its
#: arguments, temporaries and outputs do
CARD_BYTES = 80e9


# ---------------------------------------------------------------------------
# knobs and analytic terms (the reference's)
# ---------------------------------------------------------------------------


def attn_impl() -> str:
    """REPRO_ATTN_IMPL knob: "chunked" (online softmax in plain ops, default)
    or "fused" (the kernel's stand-in + analytic kernel terms)."""
    return os.environ.get("REPRO_ATTN_IMPL", "chunked")


def attention_kernel_terms(cfg: ModelConfig, model: LMModel, shape: ShapeConfig) -> Dict[str, float]:
    """Analytic per-chip FLOPs/HBM-bytes of the flash kernel calls that the
    fused-attention dry-run variant replaces with a stub.

    fwd FLOPs = 4*B*H*S*Sk*D (QK^T + PV), x2.5 more for the flash backward;
    HBM bytes = Q+K+V+O traffic (x3 for fwd+bwd).  Causality halves the
    effective Sk; sliding windows clamp it.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}  # decode path uses the dot impl
    hp, kvp = pad_heads(cfg.n_heads, cfg.n_kv_heads, model.tp)
    D = cfg.resolved_head_dim
    flops = 0.0
    byts = 0.0

    def add(layers, H, KV, sq, sk, causal=True, window=None):
        nonlocal flops, byts
        eff = min(window, sk) if window else sk
        factor = 0.5 if (causal and not window) else 1.0
        flops_l = 4.0 * B * H * sq * eff * D * factor
        bytes_l = 2.0 * B * D * (sq * H + 2 * sk * KV + sq * H)  # q,k,v,o bf16
        mult_f = 3.5 if shape.kind == "train" else 1.0
        mult_b = 3.0 if shape.kind == "train" else 1.0
        flops += layers * flops_l * mult_f
        byts += layers * bytes_l * mult_b

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        if cfg.mla is None:
            n_self = cfg.n_layers if fam != "vlm" else cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
            add(n_self, hp, kvp, S, S, causal=True, window=cfg.window)
        else:
            add(cfg.n_layers, hp, hp, S, S, causal=True)  # MLA expands per-head K
        if fam == "vlm":
            add(cfg.n_layers // cfg.cross_attn_every, hp, kvp, S, cfg.cross_context, causal=False)
    elif fam == "hybrid":
        add(cfg.n_layers, hp, kvp, S, S, causal=True, window=cfg.window)
    elif fam == "enc_dec":
        add(cfg.n_layers, hp, kvp, S, S, causal=True)
        add(cfg.n_layers, hp, kvp, S, cfg.encoder.context, causal=False)  # cross
        add(cfg.encoder.n_layers, hp, kvp, cfg.encoder.context, cfg.encoder.context, causal=False)
    # ssm family: no attention
    return {"flops": flops, "bytes": byts}


def model_flops(cfg: ModelConfig, model: LMModel, shape: ShapeConfig) -> Tuple[float, int, int]:
    """6*N*D (train) / 2*N*D (inference) with N = active params (MoE-aware):
    ``(flops, total params, active params)``.  Every leaf under a ``moe`` key
    named ``w_in``, ``w_gate`` or ``w_out`` counts ``top_k / n_experts`` of
    itself, the shared expert's too, as in the reference (ROADMAP caveat 9)."""
    total = active = 0
    for key, ps in tree_items(model.param_specs()):
        n = math.prod(ps.shape)
        total += n
        keys = key.split(".")
        if "moe" in keys and any(k in ("w_in", "w_gate", "w_out") for k in keys):
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        active += n
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens, total, active


# ---------------------------------------------------------------------------
# meta-tensor cells
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _nbytes(tree) -> int:
    return sum(t.to_local().nbytes if hasattr(t, "to_local") else t.nbytes for _, t in tree_items(tree))


def _dtype(model: LMModel, spec) -> torch.dtype:
    return torch.float32 if spec.keep_f32 else model.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig, model: LMModel) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell, at full
    (global) size: the token ids (int64, where the reference's are int32),
    the context embeddings, and for decode the cache of ``init_cache(B, S)``."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    ctx = _meta((B, model.ctx_len(), cfg.d_model), model.dtype) if model.ctx_len() else None
    if shape.kind == "train":
        out["batch"] = {"tokens": _meta((B, S), torch.int64), "labels": _meta((B, S), torch.int64)}
        if ctx is not None:
            out["batch"]["ctx"] = ctx
    elif shape.kind == "prefill":
        out["tokens"] = _meta((B, S), torch.int64)
        out["ctx"] = ctx
    else:  # decode: one new token against a seq_len-deep cache
        out["token"] = _meta((B, 1), torch.int64)
        out["cache"] = model.init_cache(B, S, device="meta")
    return out


def cache_logical(key: str, ndim: int) -> tuple:
    """The logical axes of a cache leaf, by its key name (the reference's heuristic)."""
    if key in ("k", "v", "cross_k", "cross_v"):
        logical = ("layers", "batch", "cache_seq", None, None)
    elif key in ("c_kv", "k_rope"):
        logical = ("layers", "batch", "cache_seq", None)
    elif key == "ssm":
        logical = ("layers", "batch", "ssm_heads", None, None)
    elif key == "conv":
        logical = ("layers", "batch", None, "ssm_heads", None)
    else:
        logical = (None,) * ndim
    return logical[:ndim] + (None,) * (ndim - len(logical))


def cache_shardings(cache_tree, mesh, rules) -> dict:
    """The placements of every cache leaf (logical axes by its key name)."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else named_sharding(mesh, rules, cache_logical(k, v.ndim), v.shape) for k, v in tree.items()}

    return walk(cache_tree)


def _constrain_cache(tree, mesh, rules):
    """Every cache leaf redistributed to its :func:`cache_shardings` placement."""
    return {k: _constrain_cache(v, mesh, rules) if isinstance(v, dict)
            else constrain(v, mesh, rules, cache_logical(k, v.ndim)) for k, v in tree.items()}


def _on_mesh(tree, mesh, place, make=None):
    """Each meta leaf of ``tree`` as a DTensor on ``mesh`` placed by ``place``."""
    return tree_map(lambda t, p: meta_dtensor(t.shape, t.dtype, mesh, p, make), tree, place)


def _batch(t: torch.Tensor, mesh, rules, make=None) -> torch.Tensor:
    """A batch input split by ``batch`` on its first dim (the reference's ``bspec``)."""
    logical = ("batch",) + (None,) * (t.ndim - 1)
    return meta_dtensor(t.shape, t.dtype, mesh, named_sharding(mesh, rules, logical, t.shape), make)


def seeded(device, seed: int, vocab: int) -> Callable:
    """``make(shape, dtype)``: tensors on ``device`` drawn from one seeded
    generator -- floats normal with std 0.02, integers (token ids) below ``vocab``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(shape, dtype):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=device).mul_(0.02).to(dtype)
        return torch.randint(0, vocab, shape, generator=gen, device=device, dtype=dtype)

    return make


def cell_program(model: LMModel, shape: ShapeConfig, impl: str, mesh=None,
                 make: Optional[Callable] = None) -> Tuple[Callable, tuple, int]:
    """``(fn, args, alias_bytes)`` of one cell, every tensor a meta tensor at
    full size; on ``mesh``, each a DTensor of meta shards, or of shards made
    by ``make`` (:func:`seeded`) where given: rank 0's real program."""
    if make is not None and (mesh is None or shape.kind == "train"):
        raise ValueError("real local shards are made for a prefill or decode cell on a mesh")
    ins = input_specs(model.cfg, shape, model)
    rules = rules_for_mesh(mesh) if mesh is not None else None
    bat = (lambda t: t) if mesh is None else (lambda t: None if t is None else _batch(t, mesh, rules, make))
    if shape.kind == "train":
        step = TrainStep(model, AdamWConfig(), impl=impl, remat=True, mesh=mesh)
        return step, (state_template(model, mesh), tree_map(bat, ins["batch"])), 0
    specs = model.param_specs()
    params = tree_map(lambda spec: _meta(spec.shape, _dtype(model, spec)), specs)
    if mesh is not None:
        params = _on_mesh(params, mesh, param_shardings(specs, mesh, rules), make)
    if shape.kind == "prefill":
        def prefill(p, tokens, c):
            logits, cache = model.prefill(p, tokens, c, impl=impl, mesh=mesh)
            if mesh is not None:  # the reference's out_shardings
                cache = _constrain_cache(cache, mesh, rules)
            return logits, cache

        return prefill, (params, bat(ins["tokens"]), bat(ins["ctx"])), 0
    cache = ins["cache"]
    if mesh is not None:
        cache = _on_mesh(cache, mesh, cache_shardings(cache, mesh, rules), make)
    S = shape.seq_len
    return (lambda p, token, c: model.decode_step(p, token, c, S - 1, mesh=mesh)), \
        (params, bat(ins["token"]), cache), _nbytes(cache)


def spec_argument_bytes(model: LMModel, shape: ShapeConfig, sizes: Dict[str, int]) -> int:
    """One chip's argument bytes of a cell, from ``spec_for`` alone: each
    argument's local shard (``local_shape``) times its itemsize, on a mesh
    of axis ``sizes`` (what the DTensor trace's argument bytes must equal)."""
    rules = rules_for_mesh(sizes)
    ins = input_specs(model.cfg, shape, model)

    def shard(t, logical) -> int:
        return math.prod(local_shape(sizes, spec_for(sizes, rules, logical, t.shape), t.shape)) * t.element_size()

    def batch(t) -> int:
        return 0 if t is None else shard(t, ("batch",) + (None,) * (t.ndim - 1))

    specs = [ps for _, ps in tree_items(model.param_specs())]
    if shape.kind == "train":
        # float32 masters and two float32 moments, AdamW's int32 step
        masters = sum(shard(_meta(ps.shape, torch.float32), ps.logical) for ps in specs)
        return 3 * masters + 4 + sum(batch(t) for _, t in tree_items(ins["batch"]))
    total = sum(shard(_meta(ps.shape, _dtype(model, ps)), ps.logical) for ps in specs)
    if shape.kind == "prefill":
        return total + batch(ins["tokens"]) + batch(ins["ctx"])
    cache = sum(shard(t, cache_logical(k.rsplit(".", 1)[-1], t.ndim)) for k, t in tree_items(ins["cache"]))
    return total + batch(ins["token"]) + cache


def _on_devices(mesh):
    """``mesh``, or ``None`` (one card) for a mesh of one device, where the
    reference's constraints are no-ops."""
    return None if mesh is not None and mesh_size(mesh) == 1 else mesh


def _model(cfg: ModelConfig, mesh) -> LMModel:
    """The cell's model, heads padded for the mesh's ``model`` axis as in the reference."""
    return LMModel(cfg, tp=1 if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1))


def lower_cell(arch: str, shape_name: str, mesh=None) -> Tuple[Callable, tuple, int, LMModel]:
    """``(fn, args, alias_bytes, model)`` of one (arch, shape) cell on
    ``mesh`` (``None``: one card)."""
    mesh = _on_devices(mesh)
    model = _model(get_config(arch), mesh)
    fn, args, alias = cell_program(model, SHAPES[shape_name], attn_impl(), mesh)
    return fn, args, alias, model


def analyse_cell(cfg: ModelConfig, shape: ShapeConfig, impl: Optional[str] = None, mesh=None,
                 mesh_kind: str = "one_card") -> Dict[str, Any]:
    """The record of one applicable cell (without its names), traced with
    attention ``impl`` (default: :func:`attn_impl`) on ``mesh`` (``None``:
    one card)."""
    impl = impl or attn_impl()
    mesh = _on_devices(mesh)
    model = _model(cfg, mesh)
    chips = mesh_size(mesh)
    t0 = time.perf_counter()
    fn, args, alias = cell_program(model, shape, impl, mesh)
    stats = op_analysis.analyze(fn, *args)
    lower_s = time.perf_counter() - t0
    mf, n_total, n_active = model_flops(cfg, model, shape)
    kern = attention_kernel_terms(cfg, model, shape) if impl == "fused" else {"flops": 0.0, "bytes": 0.0}
    kern = {k: v / chips for k, v in kern.items()}
    return {
        "mesh": mesh_kind,
        "chips": chips,
        "lower_s": lower_s,
        "counted_flops_per_chip": stats.flops + kern["flops"],
        "counted_bytes_per_chip": stats.mem_bytes + kern["bytes"],
        "analytic_kernel_flops_per_chip": kern["flops"],
        "analytic_kernel_bytes_per_chip": kern["bytes"],
        "knobs": {"attn_impl": impl, "remat": os.environ.get("REPRO_REMAT_POLICY", "full")},
        "collective_bytes_per_chip": stats.collective_bytes,
        "collective_by_kind": stats.collective_by_kind,
        "collective_ops": stats.collective_ops,
        "model_flops": mf,
        "params_total": n_total,
        "params_active": n_active,
        "memory": {
            "argument_bytes": stats.argument_bytes,
            "output_bytes": stats.output_bytes,
            "temp_bytes": stats.temp_bytes,
            "alias_bytes": alias,
        },
    }


def run_on_card(cfg: ModelConfig, shape: ShapeConfig, mesh, impl: str = "chunked", seed: int = 0,
                reps: int = 3) -> Dict[str, Any]:
    """Rank 0's program of a prefill or decode cell on ``mesh`` (a CUDA mesh
    over a fake process group standing at rank 0), run on the card.

    Its local shards are drawn from ``seed`` on the card (:func:`seeded`).  A
    fake group moves no data, so the gathered buffers hold whatever memory
    they were given: the run is measured, not checked for values.  Returns
    the analyser's argument bytes and counted FLOPs on the card, the bytes the
    call allocated at its peak beyond what was allocated before it (one run
    outside the analyser), and its CUDA-event milliseconds (median of ``reps``).
    """
    model = _model(cfg, mesh)
    make = seeded(torch.device("cuda", torch.cuda.current_device()), seed, cfg.vocab_size)
    fn, args, _ = cell_program(model, shape, impl, mesh, make)
    with torch.no_grad():
        stats = op_analysis.analyze(fn, *args)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        del out
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            del out
    times.sort()
    return {"argument_bytes": stats.argument_bytes, "flops": stats.flops, "collective_ops": stats.collective_ops,
            "collective_by_kind": stats.collective_by_kind, "peak_beyond_arguments": peak,
            "ms": times[len(times) // 2]}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _write(rec: Dict[str, Any], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def production_mesh(mesh_kind: str):
    """The mesh of ``mesh_kind`` (``None`` for one card) over a fake default
    process group of its size, made anew (a process group is global)."""
    import torch.distributed as dist

    if mesh_kind == "one_card":
        return None
    multi = mesh_kind == "multi"
    if dist.is_initialized():
        dist.destroy_process_group()
    init_fake_world(math.prod(production_shape(multi)[0]))
    return make_production_mesh(multi_pod=multi, device_type="cpu")


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, mesh=None) -> Dict[str, Any]:
    """Analyse and write one cell; ``mesh`` is ``mesh_kind``'s (made here when not given)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": why}
    if mesh is None:
        mesh = production_mesh(mesh_kind)
    rec = {"arch": arch, "shape": shape_name, **analyse_cell(cfg, shape, mesh=mesh, mesh_kind=mesh_kind)}
    _write(rec, out_dir)
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=MESHES + ("both",), default="one_card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACTS))
    args = ap.parse_args(argv)

    cells = []
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh_kind in meshes:
        mesh = production_mesh(mesh_kind)
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch} x {shape_name} x {mesh_kind}"
                try:
                    rec = run_cell(arch, shape_name, mesh_kind, args.out, mesh)
                except Exception as e:  # noqa: BLE001 - report and continue
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                           "error": f"{type(e).__name__}: {e}"}
                    _write(rec, args.out)
                if "error" in rec:
                    print(f"[FAIL] {key}: {rec['error'][:300]}")
                elif "skipped" in rec:
                    print(f"[SKIP] {key}: {rec['skipped']}")
                else:
                    mem = rec["memory"]
                    need = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
                    print(
                        f"[ OK ] {key}: trace={rec['lower_s']:.1f}s "
                        f"flops/chip={rec['counted_flops_per_chip']:.4e} "
                        f"(x{rec['counted_flops_per_chip'] * rec['chips'] / rec['model_flops']:.3f} model_flops) "
                        f"args={mem['argument_bytes'] / 1e9:.2f}GB temp={mem['temp_bytes'] / 1e9:.2f}GB "
                        f"out={mem['output_bytes'] / 1e9:.2f}GB alias={mem['alias_bytes'] / 1e9:.2f}GB "
                        f"coll={rec['collective_bytes_per_chip'] / 1e9:.3f}GB/{rec['collective_ops']} ops "
                        f"fits_80GB={'yes' if need <= CARD_BYTES else 'no'}",
                        flush=True,
                    )
                cells.append(rec)
    n_ok = sum(1 for c in cells if "error" not in c and "skipped" not in c)
    n_skip = sum(1 for c in cells if "skipped" in c)
    n_fail = sum(1 for c in cells if "error" in c)
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped (documented), {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
