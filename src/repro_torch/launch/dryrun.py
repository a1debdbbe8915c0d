"""One-card dry-run: every (arch x shape) cell traced at full size on meta tensors.

The port's counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's ``train_step`` / ``prefill`` / ``serve_step`` for its
production meshes with ``ShapeDtypeStruct`` inputs.  The port runs eagerly
on one card: it builds each cell's parameters, optimizer state, batch and
cache as **meta tensors** at full size (shapes and dtypes, no memory) and
runs the cell's real entry point once under
:func:`repro_torch.launch.op_analysis.analyze`:

* ``train``   -- one :class:`~repro_torch.runtime.trainer.TrainStep` (remat,
  the bf16 working copy, AdamW), on float32 masters and AdamW state as
  :func:`~repro_torch.runtime.trainer.state_template` builds them;
* ``prefill`` -- ``LMModel.prefill`` on parameters in the model dtype (the
  ``keep_f32`` leaves in float32), with ``ctx_emb`` where the model has a
  context;
* ``decode``  -- one ``decode_step`` against an ``init_cache(B, S)`` cache at
  ``pos = S - 1``.

It allocates on no device and never initialises CUDA, so the rule that the
port's entry points run on the card does not apply to it.

The record, one JSON per cell under ``artifacts/dryrun_torch/``, keeps the
reference's key names where the quantity is the same (``arch``, ``shape``,
``mesh`` -- ``"one_card"`` --, ``chips``, ``lower_s`` -- the trace seconds --,
``analytic_kernel_*_per_chip``, ``knobs``, ``collective_*``,
``model_flops``, ``params_total``, ``params_active``, ``memory``).  The
counted quantities are ``counted_flops_per_chip`` and
``counted_bytes_per_chip`` (the reference's ``hlo_*``: the port counts ops,
not HLO), the analytic kernel terms included as the reference includes
them.  ``memory``: ``argument_bytes`` -- every argument's storage
(parameters, optimizer state or cache, and the token ids); ``output_bytes``
-- what the call returns that it allocated; ``temp_bytes`` -- the rest of
the call's peak, so the cell needs ``argument + temp + output`` bytes at
once; ``alias_bytes`` -- the decode cache, which ``decode_step`` updates in
place (ROADMAP caveat 8; an SSM state is replaced, and the new one counts
as output), as the reference donates it.

Left out, with no counterpart: ``compile_s`` (nothing is compiled);
``xla_cost_flops_raw`` / ``xla_cost_bytes_raw`` (XLA's ``cost_analysis``,
which counts each loop body once: an eager trace has no folded loops);
``memory.code_bytes`` (no generated code: the trace runs no kernel).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
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
from repro_torch.models.lm import LMModel
from repro_torch.models.sharding import tree_items, tree_map
from repro_torch.models.transformer import pad_heads
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import TrainStep, state_template

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")
MESH = "one_card"
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
    return sum(t.nbytes for _, t in tree_items(tree))


def cell_program(model: LMModel, shape: ShapeConfig, impl: str) -> Tuple[Callable, tuple, int]:
    """``(fn, args, alias_bytes)`` of one cell, every tensor a meta tensor at full size."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    ctx = _meta((B, model.ctx_len(), cfg.d_model), model.dtype) if model.ctx_len() else None
    if shape.kind == "train":
        batch = {"tokens": _meta((B, S), torch.int64), "labels": _meta((B, S), torch.int64)}
        if ctx is not None:
            batch["ctx"] = ctx
        step = TrainStep(model, AdamWConfig(), impl=impl, remat=True)
        return step, (state_template(model), batch), 0
    dtype_of = lambda spec: torch.float32 if spec.keep_f32 else model.dtype
    params = tree_map(lambda spec: _meta(spec.shape, dtype_of(spec)), model.param_specs())
    if shape.kind == "prefill":
        return (lambda p, tokens, c: model.prefill(p, tokens, c, impl=impl)), \
            (params, _meta((B, S), torch.int64), ctx), 0
    cache = model.init_cache(B, S, device="meta")
    return (lambda p, token, c: model.decode_step(p, token, c, S - 1)), \
        (params, _meta((B, 1), torch.int64), cache), _nbytes(cache)


def analyse_cell(cfg: ModelConfig, shape: ShapeConfig, impl: Optional[str] = None) -> Dict[str, Any]:
    """The record of one applicable cell (without its names), traced with
    attention ``impl`` (default: :func:`attn_impl`)."""
    impl = impl or attn_impl()
    model = LMModel(cfg)
    t0 = time.perf_counter()
    fn, args, alias = cell_program(model, shape, impl)
    stats = op_analysis.analyze(fn, *args)
    lower_s = time.perf_counter() - t0
    mf, n_total, n_active = model_flops(cfg, model, shape)
    kern = attention_kernel_terms(cfg, model, shape) if impl == "fused" else {"flops": 0.0, "bytes": 0.0}
    return {
        "mesh": MESH,
        "chips": 1,
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


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _write(rec: Dict[str, Any], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{MESH}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def one_card(mesh_kind: str) -> None:
    """Raise unless ``mesh_kind`` is ``"single"``: one card."""
    if mesh_kind != "single":
        raise ValueError(
            f"--mesh {mesh_kind}: the port's dry-run analyses one card (--mesh single); meshes of "
            "several cards wait for ROADMAP A.6"
        )


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str) -> Dict[str, Any]:
    one_card(mesh_kind)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": MESH, "skipped": why}
    rec = {"arch": arch, "shape": shape_name, **analyse_cell(cfg, shape)}
    _write(rec, out_dir)
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACTS))
    args = ap.parse_args(argv)
    one_card(args.mesh)

    cells = []
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    for arch in archs:
        for shape_name in shapes:
            key = f"{arch} x {shape_name} x {MESH}"
            try:
                rec = run_cell(arch, shape_name, args.mesh, args.out)
            except Exception as e:  # noqa: BLE001 - report and continue
                rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "error": f"{type(e).__name__}: {e}"}
                _write(rec, args.out)
            if "error" in rec:
                print(f"[FAIL] {key}: {rec['error'][:300]}")
            elif "skipped" in rec:
                print(f"[SKIP] {key}: {rec['skipped']}")
            else:
                mem = rec["memory"]
                need = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
                print(
                    f"[ OK ] {key}: trace={rec['lower_s']:.1f}s flops={rec['counted_flops_per_chip']:.4e} "
                    f"(x{rec['counted_flops_per_chip'] / rec['model_flops']:.3f} model_flops) "
                    f"args={mem['argument_bytes'] / 1e9:.2f}GB temp={mem['temp_bytes'] / 1e9:.2f}GB "
                    f"out={mem['output_bytes'] / 1e9:.2f}GB alias={mem['alias_bytes'] / 1e9:.2f}GB "
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
