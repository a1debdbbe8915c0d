"""A gloo world of CPU processes that holds the sharded programs to one-card runs.

A fake process group moves no data, so only a real group can show that the
sharded programs' collectives are right.  ``python -m
repro_torch.testing.mesh_world --out results.json`` spawns ``--world`` (4)
CPU processes joined by gloo through a ``file://`` store, each on one rank of
a ``2 x (world / 2)`` ``("data", "model")`` mesh.  Every rank runs, for each
architecture at its tiny preset (``LMModel(cfg, tp=model)``; the MoE's
``capacity_factor`` 8, the reference tests' loose capacity, so that the
sharded and the one-card dispatch drop nothing):

* ``prefill`` -- the sharded ``LMModel.prefill(impl="chunked", mesh=...)``
  on parameters from :func:`~repro_torch.models.sharding.distribute_params`
  and batch-sharded token ids, and one ``decode_step`` on its cache, each
  against the one-card call on the same weights;
* ``serve_wide`` -- the same for qwen3-32b on a ``(1, world)`` mesh, whose
  2 key/value heads are fewer than the chips on ``model``;
* ``moe`` -- the reference test's MoE layer, ``_dispatch_shard_map`` on a
  ``(world,)`` ``("data",)`` mesh against ``_dispatch_local``;
* ``train`` -- one sharded :class:`~repro_torch.runtime.trainer.TrainStep`
  of a dense config against the one-card step: the losses, and the updated
  masters by :func:`~repro_torch.testing.trajectory.compare_trajectories`.

Each rank writes its maximum absolute errors; the JSON at ``--out`` holds the
list of every rank's results.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

#: every architecture of the zoo, one per family and then some
ARCHS = ("stablelm-3b", "qwen3-32b", "chatglm3-6b", "deepseek-coder-33b", "deepseek-v2-lite-16b",
         "mamba2-780m", "hymba-1.5b", "llama-3.2-vision-90b", "whisper-large-v3", "llama4-scout-17b-a16e")
B, S = 4, 32


def _shard(t: torch.Tensor, mesh, rules, logical):
    from torch.distributed.tensor import DTensor

    from repro_torch.models import sharding as sh

    place = sh.named_sharding(mesh, rules, logical, t.shape)
    return DTensor.from_local(sh.shard_of(t, mesh, place), mesh, place, run_check=False)


def _err(got, want) -> float:
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    return float((got - want).abs().max())


def _model(arch: str, tp: int):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.presets import tiny
    from repro_torch.models.lm import LMModel

    cfg = tiny(get_config(arch))
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return LMModel(cfg, tp=tp)


def _serve(arch: str, mesh, rules, tp: int) -> dict:
    from repro_torch.models import sharding as sh
    from repro_torch.models.lm import on_mesh

    m = _model(arch, tp)
    cfg = m.cfg
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    ctx = (torch.from_numpy(rng.normal(size=(B, m.ctx_len(), cfg.d_model)).astype(np.float32))
           if m.ctx_len() else None)
    with torch.no_grad():
        want, cache = m.prefill(params, tok, ctx, impl="chunked")
        want_d, _ = m.decode_step(params, nxt, _grown(m, cache, S), S)
        dp = sh.distribute_params(params, mesh, rules, m.param_specs())
        ctx_d = None if ctx is None else _shard(ctx, mesh, rules, ("batch", None, None))
        got, cache_d = m.prefill(dp, _shard(tok, mesh, rules, ("batch", "seq")), ctx_d, impl="chunked", mesh=mesh)
        with on_mesh(mesh):
            cache_d = _grown(m, cache_d, S)
        got_d, _ = m.decode_step(dp, _shard(nxt, mesh, rules, ("batch", "seq")), cache_d, S, mesh=mesh)
    return {"prefill": _err(got, want), "decode": _err(got_d, want_d)}


def _grown(model, cache: dict, S: int) -> dict:
    """The prefill's cache with its full-attention and latent leaves one slot
    longer (the decode step's write slot ``S``), zero-filled; a sliding
    window's ring keeps its length."""
    def grow(key, t):
        if key in ("k", "v", "c_kv", "k_rope") and model.cfg.window is None:
            pad = torch.zeros((*t.shape[:2], 1, *t.shape[3:]), dtype=t.dtype, device=t.device)
            return torch.cat([t, pad], dim=2)
        return t

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else grow(k, v) for k, v in tree.items()}

    return walk(cache)


def _moe(world: int) -> float:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import sharding as sh
    from repro_torch.models.moe import MoELayer

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    moe = MoELayer(32, MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=8.0))
    p = sh.init_params(moe.params(), torch.Generator().manual_seed(0), torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 4, 32)).astype(np.float32))
    with torch.no_grad():
        want = moe(p, x)
        rules = sh.rules_for_mesh(mesh)
        got = moe(sh.distribute_params(p, mesh, rules, moe.params()), _shard(x, mesh, rules, ("batch", None, None)),
                  mesh=mesh)
    return _err(got, want)


def _train(mesh, rules, tp: int) -> dict:
    from repro_torch.models import sharding as sh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.trainer import TrainStep
    from repro_torch.testing.trajectory import compare_trajectories, noisy_steps

    m = _model("stablelm-3b", tp)
    opt = AdamWConfig(total_steps=10, warmup_steps=2)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, m.cfg.vocab_size, (B, S))) for k in ("tokens", "labels")}

    def fresh():
        p = m.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
        return {"params": p, "opt": adamw_init(p)}

    one, one_m = TrainStep(m, opt)(fresh(), batch)
    state = fresh()
    dp = sh.distribute_params(state["params"], mesh, rules, m.param_specs())
    two, two_m = TrainStep(m, opt, mesh=mesh)(
        {"params": dp, "opt": adamw_init(dp)}, {k: _shard(v, mesh, rules, ("batch", "seq")) for k, v in batch.items()}
    )
    flat = lambda tree: {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).numpy()
                         for k, v in sh.tree_items(tree)}
    noisy = noisy_steps(None, flat(two["opt"].mu), flat(one["opt"].mu), flat(one["opt"].nu), 1)
    cmp = compare_trajectories(flat(two["params"]), flat(one["params"]), noisy, float(one_m["lr"]))
    loss = two_m["loss"]
    loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
    return {"loss": float(one_m["loss"]), "loss_err": abs(float(loss) - float(one_m["loss"])),
            "masters_ok": bool(cmp["ok"]), "masters_worst": cmp["max_err_over_max_abs"],
            "out_of_tolerance": sorted(cmp["out_of_tolerance"]), "marked_beyond_share": cmp["marked_beyond_share"],
            "noise_driven": cmp["noise_driven"], "elements": cmp["elements"]}


def _rank(rank: int, world: int, init: str, out_dir: str, archs: List[str]) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import sharding as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        tp = world // 2
        mesh = init_device_mesh("cpu", (2, tp), mesh_dim_names=("data", "model"))
        rules = sh.rules_for_mesh(mesh)
        # a (1, world) mesh: the tiny presets' 2 key/value heads fewer than
        # the world's chips on "model", so each chip picks its own
        wide = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
        res = {"rank": rank, "serve": {a: _serve(a, mesh, rules, tp) for a in archs},
               "serve_wide": _serve("qwen3-32b", wide, sh.rules_for_mesh(wide), world),
               "moe": _moe(world), "train": _train(mesh, rules, tp)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def run(world: int = 4, archs=ARCHS) -> list:
    """Spawn the world; every rank's results, in rank order."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(world, f"file://{d}/store", d, list(archs)), nprocs=world)
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--arch", action="append", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run(args.world, args.arch or ARCHS)
    with open(args.out, "w") as f:
        json.dump({"wall_s": time.perf_counter() - t0, "ranks": res}, f, indent=1)


if __name__ == "__main__":
    main()
