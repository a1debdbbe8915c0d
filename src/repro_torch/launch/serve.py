"""Batched serving: prefill a prompt batch, then decode greedily.

The port's counterpart of ``python -m repro.launch.serve``, with the kernels
switched on:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --preset full \\
        --batch 4 --prompt-len 4096 --gen 32            # one CUDA GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --preset tiny \\
        --device cpu                                    # the plain versions, on the host
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \\
        --preset full --layers 8 --batch 4 --prompt-len 4096 --gen 32 \\
        --advise-dispatch --simulate-serving 64 --chaos 1   # MoE, 8 of 48 layers
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --preset full --batch 4 --prompt-len 4096 --gen 32  # MLA + MoE, whole
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \\
        --preset full --batch 16 --prompt-len 192 --gen 32  # encoder-decoder
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-90b \\
        --preset full --layers 20 --batch 4 --prompt-len 2048 --gen 16  # 20 of 100 layers

1. build ``LMModel`` for the architecture at the preset's size;
2. draw the parameters on the device from a ``torch.Generator`` seeded by
   ``--seed``, in the config's dtype;
3. for ``vlm`` and ``enc_dec``, draw the frontend's stub embeddings
   ``[batch, ctx_len, d_model]`` after the prompts, as the reference's
   launcher does;
4. prefill the prompts (``--impl kernel``: the CUDA kernels B3 and B4 in every
   layer, the encoder's too; ``chunked`` / ``dot``: plain torch ops);
5. re-home the prefill cache into buffers ``prompt_len + gen`` deep;
6. decode ``--gen`` tokens greedily with plain torch ops.

Without ``--device`` it runs on the CUDA device and raises where there is
none.  ``--layers`` cuts the depth (a model too large for one card; for a
``vlm`` a multiple of its ``cross_attn_every``).  For a
MoE model, ``--advise-dispatch`` then ranks the exchange strategies for the
routing histogram of the served tokens over ``--npods`` x ``--ppn`` ranks;
``--simulate-serving N`` replays N dispatch requests of that pattern through
the serving simulator (``repro_torch.serving``), coalesced against
sequential, and ``--chaos SEED`` re-runs the simulation under a seeded fault
storm -- as the reference's launcher does.

``--mesh DxM`` other than ``1x1`` serves on a ``("data", "model")`` mesh of
``D * M`` processes, one rank each, joined by the process group that
stages every collective through host memory around gloo
(:mod:`repro_torch.comm.staged`; spawned by
:func:`repro_torch.launch.world.run_launcher`, or this process's rank of a
process group already initialised), as the reference's launcher passes its
mesh: the model built with ``tp=M``, its weights drawn whole from the seed
and sharded by the reference's rules, the prompts sharded over ``data``,
``prefill`` / ``decode_step`` given the mesh; with ``--impl kernel`` each
rank runs B3 and B4 on its own batch rows and heads.  Rank 0 prints.  The
ranks run on the CUDA device (every rank on ``cuda:(rank % device_count)``,
so one card holds them all) or, with ``--device cpu``, on the host:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b --preset full \\
        --batch 4 --prompt-len 2048 --gen 16 --mesh 2x2  # 4 CUDA ranks

``--dtype float32`` draws the weights and runs the activations in float32
(default: the config's dtype).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import HEAD_PAIRS, head_dims_supported
from repro_torch.launch.presets import PRESETS
from repro_torch.models.lm import LMModel, on_mesh
from repro_torch.models.moe_dispatch import ExpertLoadHistogram
from repro_torch.models.sharding import distribute_params, from_whole, named_sharding, rules_for_mesh


def build(arch: str, preset: str = "tiny", seed: int = 0, device: DeviceLike = None,
          dtype: Optional[torch.dtype] = None, layers: Optional[int] = None, tp: int = 1):
    """``(model, params)``: the model at ``preset`` with parameters drawn on
    ``device`` from a generator seeded by ``seed``.

    ``dtype`` (default: the config's) sets the model's activation dtype and
    its weights' together; one seed draws the same weights in every dtype.
    ``layers`` (default: the preset's) cuts the depth and nothing else; for
    a ``vlm`` it must be a multiple of ``cross_attn_every``, so that the cut
    keeps the published share of cross-attention layers.  ``tp`` is the
    ``"model"`` axis of the mesh the model will run on (``LMModel(tp=)``).
    """
    device = resolve_device(device)
    cfg = PRESETS[preset](get_config(arch))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=str(dtype).removeprefix("torch."))
    if layers is not None:
        if cfg.family == "vlm" and layers % cfg.cross_attn_every:
            raise ValueError(
                f"{cfg.name}: --layers {layers} is not a multiple of cross_attn_every {cfg.cross_attn_every}"
            )
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = LMModel(cfg, tp=tp)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, model.init(gen, device=device)


def make_prompts(vocab_size: int, batch: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """``[batch, prompt_len]`` token ids from ``np.random.default_rng(seed)``,
    as the reference's launcher draws them."""
    return make_context(vocab_size, batch, prompt_len, 0, 0, seed)[0]


def make_context(vocab_size: int, batch: int, prompt_len: int, ctx_len: int, d_model: int,
                 seed: int = 0) -> tuple:
    """``(prompts, ctx)``: the prompts of :func:`make_prompts` and, from the
    same ``np.random.default_rng(seed)`` right after them, the frontend's
    ``[batch, ctx_len, d_model]`` float32 stub embeddings (audio frames,
    image patches), or ``None`` where ``ctx_len`` is 0 -- the reference
    launcher's draw."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab_size, (batch, prompt_len))
    if not ctx_len:
        return prompts, None
    return prompts, rng.normal(size=(batch, ctx_len, d_model)).astype(np.float32)


def rehome_cache(model: LMModel, cache: dict, batch: int, max_len: int, mesh=None) -> dict:
    """The prefill cache padded with zeros to ``max_len`` deep (window
    rings, SSM states and cross-attention K/V over the ``ctx_len`` context
    keep their shape); on a ``mesh`` the cache's leaves are DTensors."""
    full = model.init_cache(batch, max_len, model.dtype, "meta")

    def grow(dst, src):
        src = src.to(dst.dtype)
        for dim, (want, have) in enumerate(zip(dst.shape, src.shape)):
            if want != have:
                pad = torch.zeros((*src.shape[:dim], want - have, *src.shape[dim + 1:]), dtype=src.dtype,
                                  device=src.device)
                src = torch.cat([src, pad], dim=dim)
        return src

    with on_mesh(mesh):
        return _zip_map(grow, full, cache)


def _zip_map(fn, a, b):
    return {k: _zip_map(fn, a[k], b[k]) if isinstance(a[k], dict) else fn(a[k], b[k]) for k in a}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_kernel_heads(model: LMModel) -> None:
    """Raise, naming the config, where the attention kernel B3 cannot take
    one of the model's (q/k, v) head widths on a CUDA device."""
    for qk, v in sorted(model.attention_head_pairs):
        if not head_dims_supported(qk, v):
            raise ValueError(
                f"{model.cfg.name}: head_dim {qk} (q/k) / {v} (v) is not a pair the flash_attention "
                f"kernel takes {HEAD_PAIRS}"
            )


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def generate(model: LMModel, params: dict, prompts: torch.Tensor, gen: int, impl: str = "kernel",
             ctx: Optional[torch.Tensor] = None, mesh=None) -> dict:
    """Prefill ``prompts [B, S]`` (with the stub context embeddings ``ctx``
    of a ``vlm`` / ``enc_dec`` model) with ``impl``, then ``gen`` greedy tokens.

    Returns ``tokens [B, gen]``, ``logits`` (one float32 ``[B, vocab]`` per
    generated token: the prefill's last position, then each decode step's),
    and the host-clock seconds of the prefill (cache re-homing included) and
    of the decode loop.  On a ``mesh``, ``params`` are its DTensors and
    ``prompts`` / ``ctx`` whole tensors (the same on every rank), sharded
    here by the reference's rules; every rank gathers each step's logits
    and picks the same token (under ``no_grad``: DTensor parameters made
    outside inference mode cannot be sliced inside it).
    """
    with torch.inference_mode() if mesh is None else torch.no_grad():
        return _generate(model, params, prompts, gen, impl, ctx, mesh)


def _generate(model: LMModel, params: dict, prompts: torch.Tensor, gen: int, impl: str, ctx, mesh) -> dict:
    device = prompts.device
    if impl == "kernel" and device.type == "cuda":
        check_kernel_heads(model)
    B, S = prompts.shape
    place = lambda t, logical: t
    if mesh is not None:
        rules = rules_for_mesh(mesh)
        place = lambda t, logical: from_whole(t, mesh, named_sharding(mesh, rules, logical, t.shape))
        prompts = place(prompts, ("batch", "seq"))
        ctx = None if ctx is None else place(ctx, ("batch", None, None))
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, ctx, impl=impl, mesh=mesh)
    cache = rehome_cache(model, cache, B, S + gen, mesh)
    _sync(device)
    t1 = time.perf_counter()
    step_logits = [_whole(logits[:, -1:])[:, 0].float()]
    token = step_logits[0].argmax(dim=-1)[:, None]
    outs = [token]
    for t in range(gen - 1):
        logits, cache = model.decode_step(params, place(token, ("batch", "seq")), cache, S + t, mesh=mesh)
        step_logits.append(_whole(logits)[:, 0].float())
        token = step_logits[-1].argmax(dim=-1)[:, None]
        outs.append(token)
    tokens = torch.cat(outs, dim=1)
    _sync(device)
    t2 = time.perf_counter()
    return {"tokens": tokens, "logits": step_logits, "prefill_s": t1 - t0, "decode_s": t2 - t1, "cache": cache}


def routing_counts(params, cfg, tokens, nranks: int) -> np.ndarray:
    """Measured (src rank -> dst rank) routed-token counts for served tokens.

    The reference's function, over the port's tensors: it replays the first
    MoE layer's router over the embedded token ids (the layer-0
    approximation: later layers see residual-mixed activations, but the
    first routing decision is exact) and bins the top-k assignments by
    source shard (batch rows block-sharded over ranks, the
    ``np.array_split`` convention: the first ``B % nranks`` ranks carry one
    extra row) and destination shard (experts block-sharded over ranks).
    This is the traffic matrix the dispatch hop would carry -- the advisor's
    measured histogram.  Computed in numpy in float32.
    """
    if cfg.family != "moe":
        raise ValueError(f"--advise-dispatch needs a MoE arch, got {cfg.family!r}")
    router = params["seg_moe"]["moe"]["router"][0].detach().float().cpu().numpy()  # [M, E]
    toks2 = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor) else tokens)
    toks = toks2.reshape(-1)
    embed = params["embed"]
    rows = embed[torch.as_tensor(toks, device=embed.device)]  # the served rows only
    logits = rows.detach().float().cpu().numpy() @ router
    k = cfg.moe.top_k
    top = np.argsort(-logits, axis=-1)[:, :k]  # [N, k]
    e_per = max(cfg.moe.n_experts // nranks, 1)
    rows = toks2.shape[0] if toks2.ndim > 1 else toks.size
    sizes = np.full(nranks, rows // nranks, dtype=np.int64)
    sizes[: rows % nranks] += 1
    owner = np.repeat(np.arange(nranks), sizes)  # [rows]
    src = np.repeat(np.repeat(owner, toks.size // rows), k)
    dst = np.minimum(top.reshape(-1) // e_per, nranks - 1)
    counts = np.zeros((nranks, nranks), dtype=np.int64)
    np.add.at(counts, (src, dst), 1)
    return counts


def dispatch_advice(params, cfg, tokens, npods: int, ppn: int, machine: str = "tpu_v5e_pod"):
    """Rank exchange strategies for the traffic this serving run produced.

    Returns ``(counts, advice)``: the measured ``[nranks, nranks]`` routing
    histogram and the :class:`repro_torch.core.Advice` ranking for it, with
    byte terms scaled by ``d_model`` (each routed token ships a d_model-wide
    activation row).  ``machine`` defaults to the reference's, so the
    rankings are its own (the port has no H100 constants, ROADMAP A.6.1).
    """
    nranks = npods * ppn
    counts = routing_counts(params, cfg, tokens, nranks)
    hist = ExpertLoadHistogram(nranks)
    hist.update(counts)
    return counts, hist.advise(ppn=ppn, payload_width=cfg.d_model, machine=machine)


def simulate_dispatch(counts: np.ndarray, d_model: int, ppn: int, n_requests: int,
                      chaos: Optional[int] = None) -> dict:
    """The reference launcher's serving simulation of measured routing:
    ``n_requests`` dispatch requests of the ``counts`` pattern, coalesced
    against sequential (``"report"``), and with ``chaos`` the same trace under
    a seeded fault storm (``"storm"``, a :class:`repro_torch.serving.SimResult`)."""
    from repro_torch.comm.faults import FaultPlan, FaultSpec
    from repro_torch.serving import SimConfig, WorkloadClass, serving_report, simulate
    from repro_torch.testing import make_trace

    cls = WorkloadClass.from_routing(counts, ppn=ppn, d_model=d_model, fp="moe")
    trace = make_trace(0, n_requests, ["moe"], pattern="burst", rate=50 * n_requests, kinds={"moe": "moe"})
    out = {"report": serving_report({"moe": cls}, trace, SimConfig(max_width=8))}
    if chaos is not None:
        plan = FaultPlan(seed=chaos, specs=(
            FaultSpec(kind="perturb", prob=0.25, frac=0.1),
            FaultSpec(kind="slow", prob=0.1, delay_s=2e-3),
        ))
        out["storm"] = simulate({"moe": cls}, trace, SimConfig(max_width=8, chaos=plan, deadline_s=0.05))
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b", choices=ARCH_IDS)
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", choices=("kernel", "chunked", "dot"), default="kernel")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="weights and activations (default: the config's)")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x2: that many processes")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the preset's)")
    ap.add_argument("--advise-dispatch", action="store_true",
                    help="after serving, rank exchange strategies for the "
                         "measured MoE routing histogram (MoE archs only)")
    ap.add_argument("--npods", type=int, default=2, help="pods assumed for --advise-dispatch")
    ap.add_argument("--ppn", type=int, default=4, help="ranks per pod assumed for --advise-dispatch")
    ap.add_argument("--simulate-serving", type=int, default=0, metavar="N",
                    help="with --advise-dispatch: replay N concurrent dispatch "
                         "requests of the measured routing pattern through the "
                         "continuous-batching simulator and report coalesced vs "
                         "sequential p50/p99/throughput")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="with --simulate-serving: re-run the simulation under "
                         "a seeded fault storm (FaultPlan(SEED)) and report the "
                         "recovery-ladder outcome")
    return ap.parse_args(argv)


def report_dispatch(params, cfg, served, npods: int, ppn: int, simulate_n: int = 0,
                    chaos: Optional[int] = None) -> dict:
    """``--advise-dispatch`` (and ``--simulate-serving``, ``--chaos``) on the
    served tokens ``[B, S]``: prints the reports and returns ``counts``,
    ``advice`` and, where asked, the simulation's ``report`` and ``storm``."""
    counts, advice = dispatch_advice(params, cfg, served, npods, ppn)
    print(f"dispatch advice ({npods} pods x {ppn}, {int(counts.sum())} routed tokens):")
    print(advice.table())
    out = {"counts": counts, "advice": advice}
    if not simulate_n:
        return out
    out.update(simulate_dispatch(counts, cfg.d_model, ppn, simulate_n, chaos))
    co, sq = out["report"]["coalesced"], out["report"]["sequential"]
    print(f"serving sim ({simulate_n} requests, k<=8): "
          f"coalesced p50={co['p50_s']*1e3:.2f}ms p99={co['p99_s']*1e3:.2f}ms "
          f"{co['throughput_rps']:.0f} rps | sequential "
          f"{sq['throughput_rps']:.0f} rps | speedup {out['report']['speedup']:.2f}x")
    if chaos is not None:
        storm = out["storm"]
        total = storm.completed + storm.shed
        rate = storm.completed / total if total else 1.0
        print(f"chaos storm (seed {chaos}): {storm.fault_events} faults, "
              f"{storm.recoveries} ladder recoveries, {storm.shed} shed, {storm.probes} probes "
              f"({storm.probe_recoveries} closed breakers), {storm.deadline_misses} deadline misses | "
              f"completion {rate:.1%} | trace {storm.trace_hash[:12]}")
    return out


def run(args: argparse.Namespace, device: DeviceLike = None, mesh=None) -> dict:
    """This rank's serve: the launcher's build, prompts and ``generate``;
    rank 0 (or the only process) prints and runs ``--advise-dispatch``."""
    tp = mesh.size(mesh.mesh_dim_names.index("model")) if mesh is not None else 1
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    model, params = build(args.arch, args.preset, args.seed, device, dtype=dtype, layers=args.layers, tp=tp)
    device = params["embed"].device
    cfg = model.cfg
    prompts, ctx = make_context(cfg.vocab_size, args.batch, args.prompt_len, model.ctx_len(), cfg.d_model,
                                args.seed)
    weights = params if mesh is None else distribute_params(params, mesh, rules_for_mesh(mesh),
                                                            model.param_specs())
    out = generate(model, weights, torch.as_tensor(prompts, device=device), args.gen, impl=args.impl,
                   ctx=None if ctx is None else torch.as_tensor(ctx, device=device), mesh=mesh)
    if mesh is not None and mesh.get_rank() != 0:
        return out
    where = device if mesh is None else f"{device} (mesh {args.mesh}, {mesh.size()} ranks)"
    print(f"{model.cfg.name} ({args.preset}, {model.param_count():,} parameters) on {where}: "
          f"prefill {args.batch}x{args.prompt_len} in {out['prefill_s']:.3f}s; "
          f"decoded {args.gen} tokens/seq in {out['decode_s']:.3f}s")
    print("generated:", out["tokens"].cpu().numpy()[:, :10], flush=True)
    if args.advise_dispatch:
        served = np.concatenate([prompts, out["tokens"].cpu().numpy()], axis=1)
        out["dispatch"] = report_dispatch(params, model.cfg, served, args.npods, args.ppn,
                                          args.simulate_serving, args.chaos)
    return out


def summary(out: dict) -> dict:
    """What a rank of a ``--mesh`` world returns: its tokens, the prefill's
    gathered last-position logits ``[B, vocab]`` (float32) and its times."""
    return {"tokens": out["tokens"].cpu().tolist(), "prefill_logits": out["logits"][0].cpu().tolist(),
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve (:func:`repro_torch.launch.world.run_launcher`): one rank's
    ``generate`` output, or rank 0's ``tokens``, times and ``launches`` with
    every rank's under ``"ranks"`` where ``--mesh`` spawned them."""
    from repro_torch.launch.world import run_launcher

    return run_launcher("repro_torch.launch.serve", argv)


if __name__ == "__main__":
    main()
