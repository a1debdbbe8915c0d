"""Trainer: an eager train step and a fault-tolerant step loop on one device.

The port of ``repro.runtime.trainer``:

* :func:`build_train_step` -- forward, ``backward``, AdamW, in the
  reference's order;
* checkpoint/restart via :mod:`repro_torch.checkpoint`, in the reference's
  on-disk format (either package resumes the other's checkpoints);
* the straggler watchdog, which escalates to a checkpoint;
* simulated failure injection (``fail_at_step``): the run raises mid-way,
  and a fresh :class:`Trainer` resumes losslessly from the last checkpoint.

**Precision, the reference's.**  The reference keeps its parameters in
float32 and casts each weight to ``cfg.dtype`` where it uses it; the
gradient comes back through that cast and AdamW runs in float32.  The
port's model reads its matrices in the model dtype as stored
(:mod:`repro_torch.models.sharding`), so the train state holds **float32
master parameters** -- the tree the reference has and the checkpoint saves
-- and each step runs the model on a working copy in the model dtype, made
by one cast per leaf (the ``keep_f32`` leaves stay float32).  The gradients
with respect to the working copy are widened to float32 inside
:func:`~repro_torch.optim.adamw_update`, which updates the masters; then
the working copy is cast again.  After every step the working copy equals
``master.to(dtype)`` bitwise.

Attention runs ``impl="dot"`` (the reference trainer's) or ``"chunked"``:
the kernels B3 and B4 have no backward, nor have the reference's Pallas
kernels, so the trainer never launches a hand-written kernel.  ``"fused"``
is the dry-run's stand-in for the flash kernel
(:func:`repro_torch.models.layers.attend_fused_stub`, plain ops with a
backward), which :mod:`repro_torch.launch.dryrun` traces a step with, as
the reference's ``build_train_step`` takes any impl.

**On a mesh** (``mesh=`` a ``DeviceMesh``; the reference's
``build_train_step`` shardings): the masters, both moments (which follow
the parameters, as the reference's ``OptState`` shardings do), the working
copy and its gradients are DTensors placed by
:func:`~repro_torch.models.sharding.param_shardings`, and the batch by
:func:`batch_sharding`.  The loss, clip's global norm and AdamW run on the
DTensors.  :class:`Trainer` takes the mesh too (``mesh=``, the reference's
``Trainer(cfg, mesh, ...)``): every rank draws the whole state from the seed
and keeps its shards, and checkpoints hold whole arrays (gathered from every
rank, written by rank 0), so a checkpoint written on one mesh restores on
another, or on none.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.data import SyntheticTokens
from repro_torch.models.lm import LMModel, on_mesh
from repro_torch.models.sharding import (
    distribute_params,
    from_whole,
    meta_dtensor,
    named_sharding,
    param_shardings,
    rules_for_mesh,
    tree_items,
    tree_map,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.watchdog import StragglerWatchdog

log = logging.getLogger(__name__)

#: attention implementations the trainer runs: those with a backward
TRAIN_IMPLS = ("dot", "chunked", "fused")


def _check_impl(impl: str) -> None:
    if impl not in TRAIN_IMPLS:
        raise ValueError(
            f"training runs attention impl {TRAIN_IMPLS}, got {impl!r}: the kernels have no backward"
        )


def _refill(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    return {k: _refill(v, leaves) if isinstance(v, dict) else next(leaves) for k, v in tree.items()}


class TrainStep:
    """``(state, batch) -> (state, metrics)``: one eager step.

    ``state`` is ``{"params": float32 masters, "opt": OptState}``; it is
    updated in place and returned.  ``work`` is the working copy the model
    runs on (see the module docstring): it is made from the masters the
    first time a state is seen, and cast again after every update.
    """

    def __init__(self, model: LMModel, opt_cfg: AdamWConfig, impl: str = "dot", remat: bool = True, mesh=None):
        _check_impl(impl)
        self.model, self.opt_cfg, self.impl, self.remat, self.mesh = model, opt_cfg, impl, remat, mesh
        self.dtypes = {
            key: torch.float32 if spec.keep_f32 else model.dtype
            for key, spec in tree_items(model.param_specs())
        }
        self.work: Optional[dict] = None
        self._masters = None

    def cast(self, masters) -> None:
        """The working copy := ``masters`` cast to the model dtype, leaf by leaf."""
        if self.work is None or self._masters is not masters:
            self.work = _refill(masters, iter(
                torch.empty_like(m, dtype=self.dtypes[key]).requires_grad_()
                for key, m in tree_items(masters)
            ))
            self._masters = masters
        with torch.no_grad():
            for (_, w), (_, m) in zip(tree_items(self.work), tree_items(masters)):
                w.copy_(m)

    def __call__(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        if self._masters is not state["params"]:
            self.cast(state["params"])
        leaves = [w for _, w in tree_items(self.work)]
        loss = self.model.loss(self.work, batch, impl=self.impl, remat=self.remat, mesh=self.mesh)
        with on_mesh(self.mesh):
            if isinstance(loss, DTensor):  # the whole sum, before autograd seeds it with ones
                loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            params, opt, metrics = adamw_update(
                self.opt_cfg, state["params"], _refill(self.work, iter(grads)), state["opt"]
            )
        del grads
        self.cast(params)
        metrics["loss"] = loss.detach()
        return {"params": params, "opt": opt}, metrics


def build_train_step(model: LMModel, opt_cfg: AdamWConfig, impl: str = "dot", remat: bool = True,
                     mesh=None) -> Callable:
    """An eager ``(state, batch) -> (state, metrics)`` (:class:`TrainStep`)."""
    return TrainStep(model, opt_cfg, impl=impl, remat=remat, mesh=mesh)


def batch_sharding(mesh, rules, batch: int, seq: int) -> tuple:
    """The placements of the ``[batch, seq]`` token ids (the reference's)."""
    return named_sharding(mesh, rules, ("batch", "seq"), (batch, seq))


def state_template(model: LMModel, mesh=None) -> Dict[str, Any]:
    """The train state's shapes and dtypes as meta tensors: float32 masters
    and AdamW's state; on ``mesh``, each a DTensor placed by the parameter
    rules (the moments follow the parameters)."""
    specs = model.param_specs()
    if mesh is None:
        params = tree_map(lambda spec: torch.empty(spec.shape, dtype=torch.float32, device="meta"), specs)
    else:
        params = tree_map(lambda spec, place: meta_dtensor(spec.shape, torch.float32, mesh, place),
                          specs, param_shardings(specs, mesh, rules_for_mesh(mesh)))
    return {"params": params, "opt": adamw_init(params)}


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    impl: str = "dot"
    remat: bool = True
    fail_at_step: Optional[int] = None  # fault-injection for tests


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    """The step loop over :class:`SyntheticTokens` on ``device`` (default:
    the CUDA device; raises without one).

    ``mesh`` (a ``("data", "model")`` ``DeviceMesh`` over the process group
    this rank belongs to, e.g. from
    :func:`repro_torch.launch.mesh.make_host_mesh`) shards the model
    (``LMModel(tp=model)``), the state and each batch as the reference's
    ``Trainer(cfg, mesh, ...)`` does; every rank of the mesh runs the loop.
    """

    def __init__(self, model_cfg: ModelConfig, cfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None, device: DeviceLike = None, mesh=None):
        import torch.distributed as dist

        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        names = mesh.mesh_dim_names if mesh is not None else ()
        self.model = LMModel(model_cfg, tp=mesh.size(names.index("model")) if "model" in names else 1)
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=cfg.steps)
        self.step_fn = build_train_step(self.model, self.opt_cfg, impl=cfg.impl, remat=cfg.remat, mesh=mesh)
        self.data = SyntheticTokens(
            vocab_size=model_cfg.vocab_size, batch=cfg.batch, seq_len=cfg.seq_len,
            seed=cfg.seed, device=self.device,
        )
        if mesh is not None:
            self._rules = rules_for_mesh(mesh)
            self._batch_place = batch_sharding(mesh, self._rules, cfg.batch, cfg.seq_len)
        # on a mesh every rank gathers the whole state for a checkpoint, and
        # rank 0 writes it
        writer = mesh is None or dist.get_rank() == 0
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, writer=writer) if cfg.checkpoint_dir else None
        self.watchdog = StragglerWatchdog()
        self.history: list = []

    # ------------------------------------------------------------------
    def init_state(self, rng_seed: int = 0) -> Dict[str, Any]:
        """Float32 parameters drawn from a generator on the device, and
        zero moments."""
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        params = self.model.init(gen, dtype=torch.float32, device=self.device)
        if self.mesh is not None:
            params = distribute_params(params, self.mesh, self._rules, self.model.param_specs())
        return {"params": params, "opt": adamw_init(params)}

    def state_template(self) -> Dict[str, Any]:
        return state_template(self.model, self.mesh)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's batch, on a mesh each rank's shard of it as DTensors."""
        batch = self.data.batch_at(step)
        if self.mesh is None:
            return batch
        place = self._batch_place
        return {k: from_whole(v, self.mesh, place) for k, v in batch.items()}

    def _agree(self, escalate: bool) -> bool:
        """On a mesh, whether any rank's watchdog escalated (an all-reduce
        MAX over each of the mesh's dims): a straggler checkpoint gathers
        the state, a collective every rank must enter together."""
        if self.mesh is None:
            return escalate
        import torch.distributed as dist

        flag = torch.tensor([int(escalate)])
        for dim in range(self.mesh.ndim):
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.mesh.get_group(dim))
        return bool(flag.item())

    # ------------------------------------------------------------------
    def run(self, resume: bool = True) -> Dict[str, Any]:
        start = 0
        state = None
        if resume and self.ckpt and latest_step(self.ckpt.directory) is not None:
            state, manifest = self.ckpt.restore(self.state_template(), device=self.device)
            start = manifest["step"]
            log.info("resumed from step %d", start)
        if state is None:
            state = self.init_state()

        for step in range(start, self.cfg.steps):
            if self.cfg.fail_at_step is not None and step == self.cfg.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            self.watchdog.start_step()
            batch = self.batch_at(step)
            state, metrics = self.step_fn(state, batch)
            escalate = self._agree(self.watchdog.end_step(step))
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                loss = metrics["loss"]
                loss = float(loss.full_tensor() if isinstance(loss, DTensor) else loss)
                self.history.append({"step": step + 1, "loss": loss})
                log.info("step %d loss %.4f", step + 1, loss)
            if self.ckpt and (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save_async(step + 1, state, extra={"seed": self.cfg.seed})
            if escalate:
                log.warning("straggler budget exhausted at step %d: checkpoint + restart", step)
                if self.ckpt:
                    self.ckpt.save_async(step + 1, state, extra={"straggler": True})
                self.watchdog.consecutive = 0
        if self.ckpt:
            self.ckpt.save_async(self.cfg.steps, state)
            self.ckpt.wait()
        return {"state": state, "history": self.history, "straggler_events": self.watchdog.events}
