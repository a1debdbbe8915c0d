"""Readings that the limits of ``portbench/limits/<workload>.json`` are set
from: the program's compared numbers over many seeds, and the control's.

    python3 -m portbench.controls --workload <name> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 --seconds 3 --out readings.json

For each seed, one process does what a run does (inputs, set-up, a short
window at the cell's own load, the judgement) and records every compared
number.  On the control seeds it then judges the control by the same
comparison: the reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place on the same inputs.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, seconds: float, control: bool, device, config: dict = None) -> dict:
    import torch

    from portbench import run
    from portbench.inputs import make_system

    spec = run.cell(workload)
    cfg = config if config is not None else run.load_json(run.HERE / "configs" / f"{spec['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{spec['traffic']}.json")
    keys = run.load_json(run.HERE / "limits" / f"{workload}.json")["limits"]
    device = torch.device(device)
    A = make_system(cfg, seed)
    driver = run.load_driver(traffic["kind"])(A, cfg, traffic, seed, device)
    window = driver.window(seconds)
    items = driver.release()
    gc.collect()
    program = {k: v for k, (v, _) in driver.check(items, keys).items()}
    out = {"seed": seed, "attempted": window["attempted"], "program": program, "notes": driver.notes}
    if control:
        out["control"] = driver.control_numbers(items, torch.bfloat16)
    return out


def _rank(v: float) -> float:
    """Order readings with a NaN above every number."""
    return math.inf if math.isnan(v) else v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        rows.append(readings(args.workload, seed, args.seconds, seed in args.control_seeds, "cuda"))
        rows[-1]["seconds"] = time.perf_counter() - t
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "rows": rows}
    for side in ("program", "control"):
        got = [r[side] for r in rows if side in r]
        if got:
            summary[f"{side}_max"] = {k: max((g[k] for g in got), key=_rank) for k in got[0]}
            summary[f"{side}_min"] = {k: min((g[k] for g in got), key=_rank) for k in got[0]}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
