"""A world of CPU processes that holds the sharded programs to one-card runs.

A fake process group moves no data, so only a real group can show that the
sharded programs' collectives are right.  ``python -m
repro_torch.testing.mesh_world --out results.json`` spawns ``--world`` (4)
CPU processes joined through a ``file://`` store by the launchers' process
group, which stages every collective through host memory around gloo
(:func:`repro_torch.launch.world.run_world` with ``backend="staged"``, the
launchers' spawner and backend), each on
one rank of a ``2 x (world / 2)`` ``("data", "model")`` mesh.  Every rank runs, for each
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
  masters by :func:`~repro_torch.testing.trajectory.compare_trajectories`;
* ``moe_exchange`` -- on a ``(2, world / 2)`` ``("pod", "local")`` mesh, the
  MoE case of :func:`moe_case` (uniform and skewed inputs): the all-to-all
  with ``ep_axis=("pod", "local")`` and ``dispatch="exchange"`` for every
  strategy and ``auto``, each rank's shard bitwise across them, the whole
  outputs (rank 0) and each layer's tally; the reference's three errors;
  five calls of one exchange layer (planning on the first only); the bf16
  wire beside full precision;
* ``launchers`` -- the train and serve launchers' programs with ``--mesh
  2x(world / 2) --device cpu`` in this world: stablelm-3b tiny trained
  ``TRAIN_STEPS`` steps as a spawned launcher rank runs it (rank 0's printed
  closing line kept), and on rank 0 alone (``1x1``, checkpointed); that
  checkpoint resumed on the mesh to ``2 * TRAIN_STEPS`` with rank 1's
  straggler watchdog forced to escalate at step ``STRAGGLER_STEP``, and on
  rank 0 alone under the same escalation (the ``1x1`` continuation), rank 0
  comparing the two runs' straggler and final checkpoints; hymba-1.5b tiny
  served with ``--impl chunked``;
* ``collectives`` -- each collective a DTensor program issues
  (:func:`repro_torch.launch.world.collectives`) on this world's CPU
  tensors, over its staged group.

Each rank writes its maximum absolute errors (and the sections' values); the
JSON at ``--out`` holds the list of every rank's results.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

#: every architecture of the zoo, one per family and then some
ARCHS = ("stablelm-3b", "qwen3-32b", "chatglm3-6b", "deepseek-coder-33b", "deepseek-v2-lite-16b",
         "mamba2-780m", "hymba-1.5b", "llama-3.2-vision-90b", "whisper-large-v3", "llama4-scout-17b-a16e")
B, S = 4, 32
#: the ("pod", "local") MoE case: the reference tests' widths and inputs
#: (tests/test_moe_dispatch.py) with 8 experts, two on each of 4 ranks
MOE_M, MOE_B, MOE_S = 16, 8, 16
MOE_CFG = dict(n_experts=8, top_k=2, d_ff_expert=32)
EXCHANGE_STRATEGIES = ("standard", "two_step", "three_step", "split", "auto")
#: steps of the launchers' training runs (the resumed runs go on to twice it)
TRAIN_STEPS = 10
#: the 0-based step of the resumed runs at which a watchdog escalates: the
#: runs checkpoint step ``STRAGGLER_STEP + 1`` as a straggler's
STRAGGLER_STEP = TRAIN_STEPS + 1
#: the launchers' options common to every run in the world
LAUNCH_ARGS = ("--preset", "tiny", "--device", "cpu")


def _shard(t: torch.Tensor, mesh, rules, logical):
    from repro_torch.models import sharding as sh

    return sh.from_whole(t, mesh, sh.named_sharding(mesh, rules, logical, t.shape))


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


def moe_case(seed: int = 0) -> tuple:
    """``(params, inputs)`` of the ``("pod", "local")`` MoE sections as
    float32 numpy arrays, drawn as the reference's tests draw theirs: the
    router scaled by 2, the experts by 0.1, then uniform inputs and skewed
    ones (a constant bias pulls the router's top-k towards a few experts)."""
    rng = np.random.default_rng(seed)
    E, F, M = MOE_CFG["n_experts"], MOE_CFG["d_ff_expert"], MOE_M
    params = {"router": rng.standard_normal((M, E)) * 2.0, "w_in": rng.standard_normal((E, M, F)) * 0.1,
              "w_gate": rng.standard_normal((E, M, F)) * 0.1, "w_out": rng.standard_normal((E, F, M)) * 0.1}
    inputs = {"uniform": rng.standard_normal((MOE_B, MOE_S, M)),
              "skewed": rng.standard_normal((MOE_B, MOE_S, M)) * 0.3 + rng.standard_normal(M)}
    return ({k: v.astype(np.float32) for k, v in params.items()},
            {k: v.astype(np.float32) for k, v in inputs.items()})


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "did not raise"


def _moe_exchange(world: int, rank: int, dm_mesh) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.comm import WORLD_AXES, cache_stats, clear_caches
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import MoELayer
    from repro_torch.models.sharding import from_whole

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=WORLD_AXES)
    cfg = MoEConfig(**MOE_CFG)
    params, inputs = moe_case()
    shard, whole = (Shard(0), Shard(0)), (Replicate(), Replicate())
    dp = {k: from_whole(torch.from_numpy(v), mesh, whole if k == "router" else shard) for k, v in params.items()}
    xs = {k: from_whole(torch.from_numpy(v), mesh, shard) for k, v in inputs.items()}
    res = {"bitwise": {}, "tally": {}, "outputs": {}}
    with torch.no_grad():
        for name, x in xs.items():
            base = MoELayer(MOE_M, cfg, ep_axis=WORLD_AXES)
            outs = {"all_to_all": base(dp, x, mesh=mesh)}
            res["tally"][f"{name}|all_to_all"] = base.tally.read()
            for strategy in EXCHANGE_STRATEGIES:
                layer = MoELayer(MOE_M, cfg, dispatch="exchange", strategy=strategy)
                outs[strategy] = layer(dp, x, mesh=mesh)
                res["tally"][f"{name}|{strategy}"] = layer.tally.read()
                res["bitwise"][f"{name}|{strategy}"] = torch.equal(outs[strategy].to_local(),
                                                                   outs["all_to_all"].to_local())
            for key, y in outs.items():
                y = y.full_tensor()
                if rank == 0:
                    res["outputs"][f"{name}|{key}"] = y.tolist()

        # the reference's errors: a mesh other than ("pod", "local"), experts
        # not divisible by the ranks, a batch not divisible by them
        E6 = dict(MOE_CFG, n_experts=6)
        bad = {"router": torch.zeros(MOE_M, 6), "w_in": torch.zeros(6, MOE_M, 32),
               "w_gate": torch.zeros(6, MOE_M, 32), "w_out": torch.zeros(6, 32, MOE_M)}
        bad = {k: from_whole(v, mesh, whole if k == "router" else shard) for k, v in bad.items()}
        x_dm = from_whole(torch.from_numpy(inputs["uniform"]), dm_mesh, (Shard(0), Replicate()))
        router_dm = {"router": from_whole(torch.from_numpy(params["router"]), dm_mesh, whole)}
        x6 = from_whole(torch.from_numpy(inputs["uniform"][:6]), mesh, shard)
        res["errors"] = {
            "mesh": _raises(lambda: MoELayer(MOE_M, cfg, dispatch="exchange", ep_axis=("data", "model"))(
                router_dm, x_dm, mesh=dm_mesh)),
            "experts_exchange": _raises(lambda: MoELayer(MOE_M, MoEConfig(**E6), dispatch="exchange")(
                bad, xs["uniform"], mesh=mesh)),
            "experts_all_to_all": _raises(lambda: MoELayer(MOE_M, MoEConfig(**E6), ep_axis=WORLD_AXES)(
                bad, xs["uniform"], mesh=mesh)),
            "batch": _raises(lambda: MoELayer(MOE_M, cfg, dispatch="exchange")(dp, x6, mesh=mesh)),
        }

        # five batches of one routing distribution pay planning once
        clear_caches()
        layer = MoELayer(MOE_M, cfg, dispatch="exchange", strategy="three_step")
        for i in range(5):
            layer(dp, xs["uniform"], mesh=mesh)
            if i == 0:
                first = cache_stats()
        last = cache_stats()
        res["cache"] = {k: [getattr(first, k), getattr(last, k)]
                        for k in ("plan_misses", "exchange_misses", "exchange_hits")}
        wired = MoELayer(MOE_M, cfg, dispatch="exchange", strategy="two_step", wire="bf16")(dp, xs["uniform"],
                                                                                             mesh=mesh)
        full = MoELayer(MOE_M, cfg, ep_axis=WORLD_AXES)(dp, xs["uniform"], mesh=mesh)
        res["bf16_max_abs_err"] = float((wired.to_local() - full.to_local()).abs().max())
    return res


@contextlib.contextmanager
def _escalates_at(step: int):
    """This process's straggler watchdogs report their budget spent at
    ``step`` (as a rank that fell behind three steps running would)."""
    from repro_torch.runtime.watchdog import StragglerWatchdog

    end = StragglerWatchdog.end_step
    StragglerWatchdog.end_step = lambda self, s: end(self, s) or s == step
    try:
        yield
    finally:
        StragglerWatchdog.end_step = end


def _checkpoints_agree(got_dir: str, want_dir: str, step: int, start: int, lr: float) -> dict:
    """The checkpoints of ``step`` in two directories: their manifests'
    extras and, by :func:`compare_trajectories` (marks from the moments at
    ``step``, ``lr`` an upper bound of each step's rate since ``start``), the
    parameters."""
    from repro_torch.testing.trajectory import compare_trajectories, noisy_steps

    def load(d):
        path = os.path.join(d, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f, np.load(os.path.join(path, "arrays.npz")) as z:
            return json.load(f)["extra"], {k: z[k] for k in z.files}

    (got_extra, got), (want_extra, want) = load(got_dir), load(want_dir)
    part = lambda a, pre: {k[len(pre):]: v for k, v in a.items() if k.startswith(pre)}
    noisy = noisy_steps(None, part(got, "opt/.mu/"), part(want, "opt/.mu/"), part(want, "opt/.nu/"), step)
    cmp = compare_trajectories(part(got, "params/"), part(want, "params/"), noisy, lr * (step - start))
    return {"extra": [got_extra, want_extra], "ok": bool(cmp["ok"]),
            "out_of_tolerance": sorted(cmp["out_of_tolerance"]), "worst": cmp["max_err_over_max_abs"]}


def _launchers(rank: int, world: int, out_dir: str) -> dict:
    import torch.distributed as dist

    from repro_torch.launch import serve, train
    from repro_torch.launch.world import _launcher_rank

    mesh = ["--mesh", f"2x{world // 2}"]
    lm = ["--arch", "stablelm-3b", *LAUNCH_ARGS]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ran = _launcher_rank(rank, torch.device("cpu"), "repro_torch.launch.train",
                             [*lm, "--steps", str(TRAIN_STEPS), *mesh])
    res = {"train": ran["history"], "printed": printed.getvalue()}
    one, two = os.path.join(out_dir, "ckpt_1x1"), os.path.join(out_dir, "ckpt_mesh")
    if rank == 0:  # TRAIN_STEPS on one rank alone, checkpointed
        res["train_1x1"] = train.main([*lm, "--steps", str(TRAIN_STEPS), "--ckpt", one])["history"]
        shutil.copytree(one, two)
    dist.barrier()
    more = ["--steps", str(2 * TRAIN_STEPS), "--resume"]
    with _escalates_at(STRAGGLER_STEP) if rank == 1 else contextlib.nullcontext():
        res["resumed"] = train.main([*lm, *more, "--ckpt", two, *mesh])["history"]
    if rank == 0:
        with _escalates_at(STRAGGLER_STEP):
            res["resumed_1x1"] = train.main([*lm, *more, "--ckpt", one])["history"]
        peak_lr = train.parse_args([]).lr
        res["checkpoints"] = {step: _checkpoints_agree(two, one, step, TRAIN_STEPS, peak_lr)
                              for step in (STRAGGLER_STEP + 1, 2 * TRAIN_STEPS)}
    dist.barrier()
    out = serve.main(["--arch", "hymba-1.5b", *LAUNCH_ARGS, "--impl", "chunked", *mesh])
    res["serve_tokens"] = out["tokens"].tolist()
    return res


def _collectives(rank: int) -> dict:
    import torch.distributed as dist

    from repro_torch.launch.world import collectives

    got = collectives(rank, torch.device("cpu"))
    return {"backend": dist.get_backend(), **{name: r["ok"] for name, r in got.items()}}


def _rank(rank: int, device: torch.device, out_dir: str, archs: List[str]) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import sharding as sh

    world = dist.get_world_size()
    tp = world // 2
    mesh = init_device_mesh("cpu", (2, tp), mesh_dim_names=("data", "model"))
    rules = sh.rules_for_mesh(mesh)
    # a (1, world) mesh: the tiny presets' 2 key/value heads fewer than
    # the world's chips on "model", so each chip picks its own
    wide = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
    return {"rank": rank, "serve": {a: _serve(a, mesh, rules, tp) for a in archs},
            "serve_wide": _serve("qwen3-32b", wide, sh.rules_for_mesh(wide), world),
            "moe": _moe(world), "train": _train(mesh, rules, tp),
            "moe_exchange": _moe_exchange(world, rank, mesh), "launchers": _launchers(rank, world, out_dir),
            "collectives": _collectives(rank)}


def run(world: int = 4, archs=ARCHS) -> list:
    """Spawn the world; every rank's results, in rank order."""
    from repro_torch.comm.staged import BACKEND as STAGED
    from repro_torch.launch.world import run_world

    with tempfile.TemporaryDirectory() as d:
        return run_world(_rank, world, device="cpu", backend=STAGED, timeout_s=280.0, args=(d, list(archs)))


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
