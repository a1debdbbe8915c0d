"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

Full stack: synthetic data pipeline -> transformer -> AdamW -> async
checkpointing -> straggler watchdog, with checkpoint/restart.

The port's counterpart of ``examples/train_lm.py``: the same options, trainer
settings (the ``100m`` preset, batch 8 x 256, attention ``chunked``, a log
line every 20 steps, a checkpoint every 100) and lines, plus ``--device``.
The reference's ``make_host_mesh(1, 1)`` is the port's one-card mesh.  The
default ``--ckpt`` lies under the temporary directory (``TMPDIR``).  The
train path launches none of the kernels B1-B4: they have no backward.
``--resume`` continues from the newest checkpoint in ``--ckpt``; where that
one is already at ``--steps``, nothing is left to train and the loss line
says so.  The reference's check that the loss falls holds for a run that
trains at least 100 steps; a resumed run counts the steps it trains, not
``--steps``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.examples import add_device_option, counts_launches, run
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import small_100m
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    add_device_option(ap)
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace) -> Trainer:
    """The example's trainer for the parsed options."""
    cfg = small_100m(get_config(args.arch))
    make_host_mesh(1, 1)
    return Trainer(
        cfg,
        TrainerConfig(
            steps=args.steps,
            batch=8,
            seq_len=256,
            log_every=20,
            checkpoint_every=100,
            checkpoint_dir=args.ckpt,
            impl="chunked",
        ),
        AdamWConfig(peak_lr=1e-3, warmup_steps=30, total_steps=args.steps),
        device=args.device,
    )


def train(trainer: Trainer, args: argparse.Namespace) -> dict:
    """Run ``trainer`` and print the example's lines."""
    print(f"model: {trainer.model.cfg.name} ~{trainer.model.param_count()/1e6:.0f}M params")
    out = trainer.run(resume=args.resume)
    h = out["history"]
    if not h:
        print(f"loss: none: the checkpoint in {args.ckpt} is already at step {args.steps}")
        return out
    print(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} over {args.steps} steps")
    # short runs are too noisy to assert on; a resumed run counts the steps
    # it trained, from the first logged (its first step) to the last
    if h[-1]["step"] - h[0]["step"] + 1 >= 100:
        assert h[-1]["loss"] < h[0]["loss"], "training must reduce loss"
    return out


@counts_launches
def main(argv: Optional[Sequence[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    return train(make_trainer(args), args)


if __name__ == "__main__":
    run(main)
