"""Reproduce the paper's Figure 4.3 analysis as a planning tool.

Given a scenario (message count, destination nodes, message sizes), print the
per-size strategy ranking on both machine registries -- the exact exercise of
paper §4.6, usable for planning a real deployment's exchange strategy.

``--payload-width k`` widens the byte terms for batched ``k``-column payloads
(the multi-vector SpMM / batched-serving lever: message counts stay fixed, so
big ``k`` pushes every model toward the bandwidth-bound regime and can flip
the winner -- compare ``--payload-width 1`` with ``--payload-width 64``).

``--compute-us t --interior-frac f`` adds overlap-aware ranking: a per-step
local compute of ``t`` microseconds, ``f`` of it halo-independent, lets the
split-phase pipeline hide the inter-node phase and ``+overlap`` variants
enter the ranking.

``--wire auto`` (or a codec name / comma list, e.g. ``none,bf16``) adds
inter-pod wire-format variants: ``+wire:<codec>`` entries scale the
inter-node byte terms by the codec's compression ratio and pay its
encode+decode term, so bandwidth-bound sizes flip to a compressed wire.

The port's counterpart of ``examples/strategy_advisor.py``: the same
options and output, plus ``--device``.  The advisor is host code and
launches no kernel; the device is resolved all the same, so that without
``--device`` a machine with no CUDA device raises, as every entry point of
the port does.

    PYTHONPATH=src python -m repro_torch.examples.strategy_advisor --messages 256 --nodes 16
    PYTHONPATH=src python -m repro_torch.examples.strategy_advisor --payload-width 64
    PYTHONPATH=src python -m repro_torch.examples.strategy_advisor --compute-us 50 --interior-frac 0.9
    PYTHONPATH=src python -m repro_torch.examples.strategy_advisor --wire auto --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import ComputeProfile, advise, figure43_pattern
from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device_option, counts_launches, run


@counts_launches
def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--messages", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--machine", default="lassen", choices=("lassen", "tpu_v5e_pod"))
    ap.add_argument("--duplicate", type=float, default=0.0,
                    help="fraction of duplicate data removable by node-aware schemes")
    ap.add_argument("--payload-width", type=int, default=1,
                    help="batched payload columns k (PatternStats.widened)")
    ap.add_argument("--compute-us", type=float, default=0.0,
                    help="per-step local compute in us; enables overlap ranking")
    ap.add_argument("--interior-frac", type=float, default=0.0,
                    help="fraction of compute that is halo-independent")
    ap.add_argument("--wire", default=None,
                    help="wire codec candidates: 'auto', a codec name, or a "
                         "comma list like 'none,bf16'")
    add_device_option(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    wire = args.wire
    if wire and "," in wire:
        wire = tuple(wire.split(","))

    compute = None
    if args.compute_us > 0.0:
        compute = ComputeProfile.from_fraction(
            args.compute_us * 1e-6, args.interior_frac
        )

    print(f"machine={args.machine}  inter-node messages={args.messages}  "
          f"destination nodes={args.nodes}  duplicates={args.duplicate:.0%}  "
          f"payload_width={args.payload_width}"
          + (f"  compute={args.compute_us}us"
             f" interior={args.interior_frac:.0%}" if compute else "")
          + (f"  wire={args.wire}" if wire else "") + "\n")
    print(f"{'msg size':>10} | best strategy                     | predicted | runner-up")
    print("-" * 90)
    rows = []
    for logs in range(4, 21):
        size = 2 ** logs
        pat = figure43_pattern(size, args.messages, args.nodes)
        adv = advise(pat, machine=args.machine,
                     duplicate_fraction=args.duplicate,
                     payload_width=args.payload_width,
                     compute=compute,
                     wire=wire)
        b, r = adv.ranked[0], adv.ranked[1]
        print(f"{size:>10} | {b.key:<33} | {b.predicted_time:.3e}s | "
              f"{r.key} ({r.predicted_time:.2e}s)")
        rows.append((size, b.key, b.predicted_time, r.key, r.predicted_time))
    return {"rows": rows}


if __name__ == "__main__":
    run(main)
