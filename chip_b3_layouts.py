"""B3's bfloat16 wgmma kernel at stablelm-3b's (80, 80): the layout the
source keeps beside the candidates it was chosen over, built side by side
from the checkout's ``src/repro_torch/csrc/flash_attention.cu`` and timed in
turns on one card.

    python3 chip_b3_layouts.py [--against OTHER_CHECKOUT]

Candidates, each a text edit of the source (an edit that no longer matches
the source fails the run):

* ``kept``: the source as it is -- q/k/v as two 64-column boxes of the
  128-byte swizzle, the columns past 80 zero-filled by TMA, Q K^T in five
  k-steps, P V one m64n80k16 over a sub-tile and a part of the next;
* ``pv_n128``: the same with P V as m64n128k16 over both sub-tiles (48
  columns of zeros multiplied);
* ``swizzle_32b``: 16-column boxes in the 32-byte swizzle, five 4 KB
  sub-tiles a row, every product exact, 100 KB of shared memory;
* ``tiles_reversed``: ``kept`` with the query tiles launched last to first
  (the longest causal CTAs first).

Each candidate runs in a process of its own under a time limit and is held
to ``attention_ref`` in float32 at ``TOL_ATTN_BF16`` on the D 80 cases of
``CASES`` (its ``mma.sync`` kernel too); the ones that pass are timed at
stablelm-3b's prefill shape ``[2, 2048, 32, 80]``, causal, in turns, beside
the ``mma.sync`` kernel and SDPA on cuDNN (``chip_smoke.Timer``: L2 flushed,
mean of 20).  With ``--against``, another checkout's source (an earlier
commit's ``git archive``) is built too: the SASS of every kernel both
compile is compared instruction by instruction, every row of
``chip_smoke.py``'s kernels line at the D 64, D 128 and (192, 128) pairs is
timed for the two in turns (other, kept, kept, other), and ``chip_smoke.phase_serve_stablelm`` runs on each
checkout's package in turns, a process each, for the stablelm-3b prefill's
ms and device split (its gates hold only on this checkout).  Needs one
CUDA card and ``nvcc``; writes ``chiprun_out/b3_layouts.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))
SOURCE = HERE / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
BUILD = HERE / "build" / "b3_layouts"
OUT = HERE / "chiprun_out" / "b3_layouts.json"

#: the 32-byte swizzle at (80, 80): the sub-tile width, its bytes and the
#: descriptor's swizzle follow the pair; every other pair keeps 64 columns
SWIZZLE_32B = [
    ("""  static constexpr int kCQK = (DQK + kSw - 1) / kSw;  // sub-tiles of a q / k row
  static constexpr int kCV = (DV + kSw - 1) / kSw;    // and of a v row
  static constexpr uint32_t kQBytes = kCQK * kSub;
  static constexpr uint32_t kKBytes = kCQK * kSub;
  static constexpr uint32_t kVBytes = kCV * kSub;""",
     """  static constexpr int kW = DQK % 64 == 0 && DV % 64 == 0 ? 64 : 16;
  static constexpr uint32_t kSubW = kBN * kW * 2;
  static constexpr int kCQK = DQK / kW;
  static constexpr int kCV = DV / kW;
  static constexpr uint32_t kQBytes = kCQK * kSubW;
  static constexpr uint32_t kKBytes = kCQK * kSubW;
  static constexpr uint32_t kVBytes = kCV * kSubW;"""),
    ("""__device__ __forceinline__ void wgmma_fence() {""",
     """template <int SW>
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t lbo = 1) {
  return ((uint64_t)(smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)SW << 32) |
         ((SW == 64 ? 1ull : 3ull) << 62);
}
__device__ __forceinline__ void wgmma_fence() {"""),
    ("""  using L = Layout<DQK, DV>;
  extern __shared__""",
     """  using L = Layout<DQK, DV>;
  constexpr int kSw = L::kW;
  constexpr uint32_t kSub = L::kSubW;
  constexpr uint32_t kSubDesc = kSub >> 4;
  extern __shared__"""),
    ("const uint64_t dq = desc_sw128(", "const uint64_t dq = desc_sw<kSw>("),
    ("const uint64_t dk = desc_sw128(", "const uint64_t dk = desc_sw<kSw>("),
    ("const uint64_t dv = desc_sw128(base + L::kOffV + s * L::kVBytes, L::kCV == 2 ? kSubDesc : 1);",
     "const uint64_t dv = desc_sw<kSw>(base + L::kOffV + s * L::kVBytes, L::kCV > 1 ? kSubDesc : 1);"),
    ("wgmma_pv(o, phi[kk], dv + 128 * kk);", "wgmma_pv(o, phi[kk], dv + 2 * kSw * kk);"),
    ("wgmma_pv(o, plo[kk], dv + 128 * kk);", "wgmma_pv(o, plo[kk], dv + 2 * kSw * kk);"),
    ("bool head_rows_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int width) {",
     "bool head_rows_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int width, int sw) {"),
    ("const cuuint32_t box[4] = {(cuuint32_t)wg::kSw, 1, (cuuint32_t)wg::kBN, 1};",
     "const cuuint32_t box[4] = {(cuuint32_t)sw, 1, (cuuint32_t)wg::kBN, 1};"),
    ("CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,",
     "CU_TENSOR_MAP_INTERLEAVE_NONE, sw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,"),
    ("""  if (!head_rows_map(&tq, q, B, Sq, H, DQK) || !head_rows_map(&tk, k, B, Sk, KV, DQK) ||
      !head_rows_map(&tv, v, B, Sk, KV, DV)) {""",
     """  constexpr int sw = wg::Layout<DQK, DV>::kW;
  if (!head_rows_map(&tq, q, B, Sq, H, DQK, sw) || !head_rows_map(&tk, k, B, Sk, KV, DQK, sw) ||
      !head_rows_map(&tv, v, B, Sk, KV, DV, sw)) {"""),
]
#: P V as m64n128k16 at DV 80: a 64-float accumulator picks the n128 product
PV_N128 = [
    ("""    float o[DV / 2];  // the m64n64 (m64n80, m64n128) accumulator of P V
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;""",
     """    float o[DV == 80 ? 64 : DV / 2];
#pragma unroll
    for (int e = 0; e < (DV == 80 ? 64 : DV / 2); ++e) o[e] = 0.f;"""),
]
TILES_REVERSED = [("  const int q0 = blockIdx.x * kBM;", "  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;")]

#: (B, Sq, Sk, H, KV, Dqk, Dv, causal, window): stablelm-3b's prefill; S
#: ragged with a window edge inside a tile; Sq < Sk; non-causal; GQA 32/8;
#: a CTA whose second warpgroup has 6 rows (Sq 70) or none (Sq 150); a
#: window shorter than a tile; Sq > Sk non-causal; then one case at each
#: other wgmma pair
CASES = [
    (2, 2048, 2048, 32, 32, 80, 80, True, None),
    (2, 1000, 1000, 32, 32, 80, 80, True, 300),
    (2, 100, 1000, 32, 32, 80, 80, True, 256),
    (2, 600, 600, 32, 32, 80, 80, False, None),
    (2, 1000, 1000, 32, 8, 80, 80, True, None),
    (1, 70, 70, 4, 2, 80, 80, True, None),
    (2, 150, 150, 8, 8, 80, 80, True, None),
    (1, 300, 300, 8, 2, 80, 80, True, 77),
    (2, 260, 200, 8, 2, 80, 80, False, None),
    (1, 300, 300, 25, 5, 64, 64, True, 128),
    (2, 200, 200, 40, 8, 128, 128, True, None),
    (2, 190, 190, 16, 16, 192, 128, True, 50),
]
SLM_ROW = ((2, 2048, 32, 80), (2, 2048, 32, 80), (2, 2048, 32, 80), True, None)


def other_rows() -> dict:
    """tag -> (q, k, v shapes, causal, window): every row of ``chip_smoke.py``'s
    kernels line at the other wgmma pairs (hymba's and whisper's D 64,
    llama4-scout's and the vlm's D 128, MLA's (192, 128))."""
    import chip_smoke as cs
    from repro_torch.configs import get_config

    def row(arch, b, s):
        c = get_config(arch)
        h, kv, d = c.n_heads, c.n_kv_heads, c.resolved_head_dim
        return (b, s, h, d), (b, s, kv, d), (b, s, kv, d), True, c.window

    rows = {"hymba": row(cs.LM_ARCH, cs.LM_BATCH, cs.LM_PROMPT),
            "llama4-scout": row(cs.MOE_ARCH, cs.MOE_BATCH, cs.MOE_PROMPT)}
    rows.update({line.removeprefix("flash_attention_"): tuple(case)
                 for line, (_, *case) in cs.serve_b3_shapes().items()})
    return rows


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"chip_b3_layouts: an edit no longer matches the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def sources(against) -> dict:
    kept = SOURCE.read_text()
    out = {"kept": kept, "pv_n128": edited(kept, PV_N128), "swizzle_32b": edited(kept, SWIZZLE_32B),
           "tiles_reversed": edited(kept, TILES_REVERSED)}
    if against:
        out["against"] = (Path(against) / SOURCE.relative_to(HERE)).read_text()
    return out


def build_all(srcs: dict) -> dict:
    """One nvcc per candidate, all at once; the wgmma kernels' ptxas lines."""
    from repro_torch.kernels import build as kbuild

    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = BUILD / f"{name}.cu"
        cu.write_text(text)
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(BUILD / f"lib{name}.so"), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       time.perf_counter())
    res = {}
    for name, (proc, t0) in procs.items():
        log, _ = proc.communicate()
        lines, keep = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                keep = "flash_fwd_bf16_wgmma" in line
            if keep and ("registers" in line or "spill" in line or "entry" in line):
                lines.append(re.sub(r"_ZN\w+?flash_fwd", "flash_fwd", line.strip()))
        res[name] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0, "wgmma_ptxas": lines}
        if proc.returncode:
            res[name]["log"] = log[-4000:]
    return res


def sass(path: Path) -> dict:
    """kernel name (the file's own anonymous namespace dropped) -> its SASS
    instructions, addresses and encodings stripped."""
    from repro_torch.kernels import build as kbuild

    tool = os.path.join(os.path.dirname(kbuild._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", m.group(1))
            funcs[cur] = []
        elif cur is not None:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            if ins:
                funcs[cur].append(ins)
    return funcs


def sass_compare() -> dict:
    a, k = sass(BUILD / "libagainst.so"), sass(BUILD / "libkept.so")
    out = {}
    for name in sorted(set(a) | set(k)):
        if name not in a or name not in k:
            out[name] = "only in " + ("kept" if name in k else "against")
        else:
            out[name] = "identical" if a[name] == k[name] else \
                f"differs ({len(a[name])} vs {len(k[name])} instructions)"
    return out


def library(name: str):
    lib = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_attention.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
    lib.repro_flash_attention.restype = i
    lib.repro_flash_attention_bf16_mma.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
    lib.repro_flash_attention_bf16_mma.restype = i
    return lib


def runner(lib, mma: bool = False):
    """``fn(q, k, v, causal, window)``: bf16 attention by the library's
    routed entry, or by its ``mma.sync`` entry."""
    import torch

    def fn(q, k, v, causal, window):
        B, Sq, H, D = q.shape
        Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
        out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KV, D, Dv,
                int(causal), int(window or 0), float(D ** -0.5), torch.cuda.current_stream().cuda_stream)
        err = lib.repro_flash_attention_bf16_mma(*args) if mma else lib.repro_flash_attention(1, *args)
        if err:
            raise RuntimeError(f"launch failed with cudaError_t {err}")
        return out
    return fn


def check(name: str) -> list:
    import torch

    from chip_smoke import TOL_ATTN_BF16
    from repro_torch.kernels import flash_attention as FA

    rtol, atol = TOL_ATTN_BF16
    gen = torch.Generator(device="cuda").manual_seed(5)
    lib = library(name)
    rows = []
    for case in CASES:
        B, Sq, Sk, H, KV, Dqk, Dv, causal, window = case
        q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                   for s in ((B, Sq, H, Dqk), (B, Sk, KV, Dqk), (B, Sk, KV, Dv)))
        want = FA.attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
        row = {"case": case}
        for route, fn in (("kernel", runner(lib)), ("mma.sync", runner(lib, mma=True))):
            got = fn(q, k, v, causal, window).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            row[route] = {"max_abs_err": diff.max().item(),
                          "allowance_used": (diff / (atol + rtol * want.abs())).max().item(),
                          "finite": bool(torch.isfinite(got).all())}
        row["ok"] = all(row[r]["allowance_used"] <= 1 and row[r]["finite"] for r in ("kernel", "mma.sync"))
        rows.append(row)
        print(f"[check {name}] {json.dumps(row)}", flush=True)
    return rows


def timing(names: list) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from chip_smoke import Timer

    timer = Timer(torch)
    libs = {n: library(n) for n in names}
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}

    def inputs(qs, ks, vs):
        return (torch.randn(s, generator=gen, device="cuda").bfloat16() for s in (qs, ks, vs))

    qs, ks, vs, causal, win = SLM_ROW
    q, k, v = inputs(qs, ks, vs)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa(*_):
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    fns = {n: runner(libs[n]) for n in names if n != "against"}
    fns["mma.sync"] = runner(libs["kept"], mma=True)
    fns["sdpa (cudnn)"] = sdpa
    order = list(fns) + list(fns)[::-1]
    t = {}
    for n in order:
        t.setdefault(n, []).append(timer(lambda: fns[n](q, k, v, causal, win)))
    out["stablelm-3b [2, 2048, 32, 80] causal"] = t
    print(f"[time] stablelm-3b: {json.dumps(t)}", flush=True)
    del q, k, v, qt, kt, vt
    if "against" in libs:
        for tag, (qs, ks, vs, causal, win) in other_rows().items():
            q, k, v = inputs(qs, ks, vs)
            fns = {n: runner(libs[n]) for n in ("against", "kept")}
            t = {}
            for n in ("against", "kept", "kept", "against"):
                t.setdefault(n, []).append(timer(lambda: fns[n](q, k, v, causal, win)))
            out[tag] = t
            print(f"[time] {tag}: {json.dumps(t)}", flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    return out


def serve(tree: str) -> dict:
    """``chip_smoke.phase_serve_stablelm`` on the package of checkout
    ``tree``: its summary, and the gate failure if one failed."""
    import chip_smoke

    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    ctx = {"details": {}}
    chip_smoke.phase_build(ctx)
    try:
        chip_smoke.phase_serve_stablelm(ctx)
        failed = None
    except AssertionError as e:
        failed = str(e)
    return {"tree": tree, "serve_stablelm": ctx["details"].get("serve_stablelm"), "gates_failed": failed}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_b3_layouts: no CUDA device is available; this script runs only on a GPU")
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--check":
        rows = check(sys.argv[2])
        return 0 if all(r["ok"] for r in rows) else 1
    if len(sys.argv) >= 2 and sys.argv[1] == "--time":
        print("TIMING " + json.dumps(timing(sys.argv[2:])), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--serve":
        print("SERVE " + json.dumps(serve(sys.argv[2])), flush=True)
        return 0
    against = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--against" else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "build": build_all(sources(against))}
    print(json.dumps(result["build"], indent=1), flush=True)
    if against:
        result["sass"] = sass_compare()
        print(json.dumps(result["sass"], indent=1), flush=True)
    passed, result["checks"] = [], {}
    for name, b in result["build"].items():
        if b["rc"]:
            continue
        proc = subprocess.run(["timeout", "-k", "5", "180", sys.executable, __file__, "--check", name])
        result["checks"][name] = proc.returncode
        if proc.returncode == 0:
            passed.append(name)
    print(f"checks (0: every case within TOL_ATTN_BF16): {result['checks']}", flush=True)
    ok = "kept" in passed
    if ok:
        proc = subprocess.run(["timeout", "-k", "5", "600", sys.executable, __file__, "--time", *passed],
                              capture_output=True, text=True)
        print(proc.stdout[-6000:], proc.stderr[-3000:], flush=True)
        found = [line for line in proc.stdout.splitlines() if line.startswith("TIMING ")]
        result["times_ms"] = json.loads(found[-1][len("TIMING "):]) if found else None
        ok = proc.returncode == 0 and bool(found)
    if ok and against:
        result["serve_stablelm"] = []
        for tree in (against, str(HERE), str(HERE), against):
            proc = subprocess.run(["timeout", "-k", "5", "400", sys.executable, __file__, "--serve", tree],
                                  capture_output=True, text=True)
            found = [line for line in proc.stdout.splitlines() if line.startswith("SERVE ")]
            run = json.loads(found[-1][len("SERVE "):]) if found else {"tree": tree, "error": proc.stderr[-3000:]}
            print(json.dumps({k: v for k, v in run.items() if k != "serve_stablelm"}), flush=True)
            summary = run.get("serve_stablelm") or {}
            print(json.dumps({k: summary.get(k) for k in ("prefill_ms", "flash_attention_launches_by_route",
                                                          "prefill_split")}), flush=True)
            result["serve_stablelm"].append(run)
        ok = all(run.get("serve_stablelm") for run in result["serve_stablelm"])
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1))
    print(f"wrote {OUT.relative_to(HERE)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
