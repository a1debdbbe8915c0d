"""Training launcher.

The port of ``repro.launch.train``: the same options, presets (``tiny``
reduced width, ``100m``, ``full``) and closing line, plus ``--device``
(the CUDA device by default; ``cpu`` when asked).  Supports
checkpoint/restart (``--resume``), fault injection (``--fail-at``) and, as
the reference, elastic resharding: checkpoints hold whole arrays, so a run
resumes on another ``--mesh``.

``--mesh DxM`` other than ``1x1`` trains on a ``("data", "model")`` mesh of
``D * M`` processes, one rank each, joined by the process group that
stages every collective through host memory around gloo
(:mod:`repro_torch.comm.staged`; spawned by
:func:`repro_torch.launch.world.run_launcher`; in a process group that is
already initialised, this process is one rank of it and the world must
hold ``D * M``), as the reference's ``Trainer(cfg, mesh, ...)``.  Rank 0
prints the closing line.  The ranks run on the CUDA device (every rank on
``cuda:(rank % device_count)``, so one card holds them all) or, with
``--device cpu``, on the host.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --preset tiny \\
        --device cpu --steps 50 --ckpt /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --preset tiny \\
        --device cpu --steps 50 --mesh 2x2 --ckpt /tmp/run1 --resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --preset full \\
        --batch 2 --seq 4096 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --preset 100m \\
        --steps 10 --batch 8 --seq 512 --mesh 2x2 --ckpt /tmp/run2   # 4 CUDA ranks
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.launch.presets import PRESETS
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x2: that many processes")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, device=None, mesh=None) -> dict:
    """This rank's run: ``Trainer.run`` with the launcher's settings; rank
    0 (or the only process) prints the closing line."""
    cfg = PRESETS[args.preset](get_config(args.arch))
    trainer = Trainer(
        cfg,
        TrainerConfig(
            steps=args.steps, batch=args.batch, seq_len=args.seq,
            checkpoint_dir=args.ckpt, fail_at_step=args.fail_at,
            log_every=max(args.steps // 10, 1),
            checkpoint_every=max(args.steps // 4, 1),
        ),
        AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps),
        device=device,
        mesh=mesh,
    )
    out = trainer.run(resume=args.resume)
    losses = out["history"]
    if mesh is None or mesh.get_rank() == 0:
        print(f"first loss {losses[0]['loss']:.4f} -> last loss {losses[-1]['loss']:.4f}", flush=True)
    return out


def summary(out: dict) -> dict:
    """What a rank of a ``--mesh`` world returns: its loss history."""
    return {"history": out["history"]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train (:func:`repro_torch.launch.world.run_launcher`): one rank's
    ``Trainer.run`` output, or rank 0's ``history`` and ``launches`` with
    every rank's under ``"ranks"`` where ``--mesh`` spawned them."""
    from repro_torch.launch.world import run_launcher

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return run_launcher("repro_torch.launch.train", argv)


if __name__ == "__main__":
    main()
