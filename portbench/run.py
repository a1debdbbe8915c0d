"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
mix are found by name: ``BENCHMARK.json``'s ``workloads`` entry names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` names the driver in
``portbench/drivers/``); each metric, end-to-end or per-layer, is read by
``portbench/metrics/<name>.py``; the limits of the compared numbers are ``portbench/limits/
<workload>.json``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``, each compared number
beside its limit.  A run without a CUDA card, or with fewer cards than the
cell asks for, exits 2 and prints no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
#: top-level modules no run may hold: JAX and the JAX package the program
#: was ported from (``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str) -> dict:
    """The workload's ``BENCHMARK.json`` entry, with the metrics it reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {**entry, "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def load_metric(name: str):
    """The reader module of an end-to-end or per-layer metric:
    ``portbench/metrics/<name>.py``, or for a name ``<base>.<suffix>``
    without a file of its own (one quantity split by the end-to-end
    metric it moves), ``<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics._{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}").Driver


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What the metric readers read: the set-up seconds, the window's
    record, the profiled stretch and the problem's counts (both ``None``
    untraced), and the card's peaks (``None`` off a card)."""

    def __init__(self, setup_s: float, window: dict, profile, counts: dict, peaks: dict):
        self.setup_s, self.window, self.profile = setup_s, window, profile
        self.counts, self.peaks = counts, peaks


def clean(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, config: dict = None) -> dict:
    """Set up, measure and judge one run of ``workload``; returns the result
    object.  ``config`` replaces the cell's configuration file (the tests
    run small sizes on the CPU, where no time is a device number)."""
    import torch

    from portbench.inputs import make_system
    from portbench.metrics import counts as C
    from portbench.trace import STRETCH, read_profile

    spec = cell(workload)
    cfg = config if config is not None else load_json(HERE / "configs" / f"{spec['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{spec['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")["limits"]
    device = torch.device(device)

    t = time.perf_counter()
    A = make_system(cfg, seed)
    log(f"{spec['config']}: n={A.n} nnz={A.nnz} made in {time.perf_counter() - t:.2f} s")
    driver = load_driver(traffic["kind"])(A, cfg, traffic, seed, device)
    setup_s = time.perf_counter() - START
    log(f"set-up {setup_s:.2f} s: " + json.dumps(driver.notes))

    window = driver.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the traced stretch follows the window, so that the profiler's
    # callbacks cannot slow the window that the per-layer metrics read
    profile = None
    if trace:
        from torch.profiler import ProfilerActivity, profile as profiler

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profiler(activities=acts) as prof:
            with torch.profiler.record_function(STRETCH):
                extra = driver.profiled_stretch()
        t = time.perf_counter()
        profile = read_profile(prof, extra)
        log(f"profiled stretch {profile.window_s * 1e3:.3f} ms, {len(profile.device)} device events, "
            f"read in {time.perf_counter() - t:.2f} s")
        del prof

    log("window: " + json.dumps({k: v for k, v in window.items() if isinstance(v, (int, float))})
        + " " + json.dumps(driver.notes))
    items = driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = driver.check(items, limits)
    correct = all(isinstance(v, (int, float)) and v <= lim for v, lim in checks.values())
    log(f"judged {len(items)} answers against the reference in {time.perf_counter() - t:.2f} s; "
        f"not compared: {json.dumps(driver.notes.get('not_compared', {}))}")

    peaks = C.peaks_of(torch.cuda.get_device_name(device)) if device.type == "cuda" else None
    nranks = int(cfg["npods"]) * int(cfg["ppn"])
    run = Run(setup_s, window, profile, C.problem_counts(A, nranks) if trace else None, peaks)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct) and window["failed"] == 0, "attempted": int(window["attempted"]),
              "failed": int(window["failed"]), "metrics": metrics, "device": dev}
    if profile is not None:
        dev.update(busy_s=profile.busy_s(), window_s=profile.window_s)
        result["breakdown"] = {"device_ops": profile.top_ops(), "idle_gaps": profile.idle_gaps()}
    result["checks"] = {k: {"value": clean(v), "limit": lim} for k, (v, lim) in checks.items()}
    return result


def card_line() -> str:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return got.stdout.strip() or got.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    need = cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"the cell needs {need} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from repro_torch.kernels import build as kbuild

    t = time.perf_counter()
    built = kbuild.build(["spmv_ell"])
    log(f"card: {card_line()}; torch {torch.__version__}; spmv_ell "
        f"{'built' if built else 'loaded from ' + str(kbuild.BUILD_DIR)} ({time.perf_counter() - t:.2f} s)")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    for k, c in result["checks"].items():
        ok = isinstance(c["value"], (int, float)) and c["value"] <= c["limit"]
        log(f"check {k}: {c['value']} (limit {c['limit']}) {'ok' if ok else 'FAILED'}")
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
