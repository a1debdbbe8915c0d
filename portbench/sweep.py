"""The load a serving cell's system sustains, found once by a sweep on the
card, from which the cell's fixed ``rate_per_s`` is set (a run never
searches for its rate).

    python3 -m portbench.sweep --workload <name> --seed <n> --seconds 5 \
        --rates 400 800 1200 1600 --out sweep.json

One process sets the cell up once, then serves a window of the cell's
arrivals at each rate in turn and records the offered and answered rates,
the latency quantiles, the batch widths, the deepest queue and how long
the last answers came after the window closed.  A rate is sustained while
nothing is shed and the queue drains within a batch's time of the close.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def sweep(workload: str, seed: int, seconds: float, rates, device, config: dict = None) -> list:
    import torch

    from portbench import run
    from portbench.inputs import make_system

    spec = run.cell(workload)
    cfg = config if config is not None else run.load_json(run.HERE / "configs" / f"{spec['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{spec['traffic']}.json")
    driver = run.load_driver(traffic["kind"])(make_system(cfg, seed), cfg, traffic, seed, torch.device(device))
    rows = []
    for rate in rates:
        driver.rate = float(rate)
        t = time.perf_counter()
        w = driver.window(seconds)
        lat = w["latencies_ms"]
        widths = w["batch_widths"]
        rows.append({"rate_per_s": float(rate), "offered": w["attempted"], "shed": w["failed"],
                     "answered_per_s": int(np.sum(np.isfinite(lat))) / seconds,
                     "latency_ms_p50_p95_p99_max": [float(np.percentile(lat, q)) for q in (50, 95, 99, 100)],
                     "mean_width": w["dispatched"] / max(1, w["batches"]),
                     "widths": {str(k): v for k, v in sorted(widths.items())},
                     "queue_max": driver.notes["queue_max"], "drain_ms": driver.notes["drain_ms"],
                     "seconds": time.perf_counter() - t})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    rows = sweep(args.workload, args.seed, args.seconds, args.rates, "cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                                          "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
