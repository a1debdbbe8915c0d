"""Training launcher.

The port of ``repro.launch.train``: the same options, presets (``tiny``
reduced width, ``100m``, ``full``) and closing line, plus ``--device``
(the CUDA device by default; ``cpu`` when asked).  Supports
checkpoint/restart (``--resume``) and fault injection (``--fail-at``);
``--mesh`` takes ``1x1`` only (a several-card group: ROADMAP A.6.3).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --preset tiny \\
        --device cpu --steps 50 --ckpt /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --preset full \\
        --batch 2 --seq 4096 --steps 10
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import PRESETS
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; one card: 1x1")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    d, m = (int(x) for x in args.mesh.split("x"))
    make_host_mesh(d, m)
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
        device=args.device,
    )
    out = trainer.run(resume=args.resume)
    losses = out["history"]
    print(f"first loss {losses[0]['loss']:.4f} -> last loss {losses[-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
