#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check every result.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA GPU

These paths, each driven with the kernels' launch counts set to 0 just
before it and read just after:

* the paper's case study at a real size: the 5-point stencil
  ``spd_system(thermal_like(1 << 20))`` (1,048,576 rows, about 5.2M
  nonzeros, the size class of thermal2) row-partitioned over
  ``PodTopology(npods=4, ppn=4)`` -- 16 ranks of 65,536 rows, four per node
  as on Lassen -- all held on one card; kernels B1/B2;
* the same case study on a real process group (``repro_torch.launch.world``):
  16 processes of one rank each, all on this card, joined by gloo and
  staged through host memory; kernels B1/B2 at ``g = 1`` in every rank,
  counted per rank in the child processes against a predicted count, and
  B1 replayed in the fused CG / BiCGStab's CUDA graphs (one graph per
  stretch between two staged hops), counted per rank; in
  the same world one llama4-scout MoE layer at full width (d_model 5120, 16
  experts of 8192, top-1, one expert per process, bf16) dispatched by the
  exchange over the world's ``("pod", "local")`` ``DeviceMesh``; no kernel
  (the experts are GEMMs, as in the reference); and the train and serve
  launchers' ``--mesh 2x2`` on 4 CUDA ranks of this card, joined by the
  group that stages every collective through host memory around gloo
  (plain gloo has no CUDA path for DTensor's all-gather, probed here):
  stablelm-3b and hymba-1.5b served at full width in bf16 with B3 and B4
  per rank on head and batch shards, checked in float32 against one
  process, and stablelm-3b's 100m preset trained against ``1x1``;
* the same case study solved whole on the device: CG and BiCGStab as
  replayed CUDA graphs (``repro_torch.solve.fused``); kernel B1;
* the serving executor draining coalesced batches of the case study's
  operators through ``DistributedSpMV.matmat``; kernel B2;
* LLM serving: hymba-1.5b at full width and depth (32 hybrid layers,
  d_model 1600, 1,640,812,800 parameters, random weights from a seed),
  batch 4, prompts of 4096 tokens (longer than its 2048-token window), 32
  greedy tokens, through ``repro_torch.launch.serve``; kernels B3/B4; and
  a short serve of stablelm-3b (B3 at head width 80);
* MoE serving: llama4-scout-17b-a16e at full width (d_model 5120, 40/8
  heads of 128, 16 experts top-1 of d_ff 8192 and a shared expert), 8 of
  its 48 layers (19,685,790,720 parameters, bf16), batch 4 x 4096, 32
  greedy tokens; kernel B3 at head width 128 (the MoE layers are GEMMs and
  index moves, as in the reference);
* MLA serving: deepseek-v2-lite-16b whole (27 layers, MLA with q/k heads
  192 wide and v heads 128 over 16 heads, 64 experts top-6 and 2 shared,
  15,647,895,040 parameters, bf16), batch 4 x 4096, 32 greedy tokens;
  kernel B3 at the pair (192, 128);
* encoder-decoder serving: whisper-large-v3 whole (32 encoder + 32 decoder
  layers, d_model 1280, 20 heads of 64), batch 16, 1500 stub frames,
  prompts of 192 tokens, 32 greedy tokens; kernel B3 in the encoder
  (non-causal), the decoder's self- and cross-attention;
* VLM serving: llama-3.2-vision-90b at full width (d_model 8192, 64/8 heads
  of 128, d_ff 28672, 1600 stub image tokens), 20 of its 100 layers (16
  self + 4 cross, 19,281,551,360 parameters), batch 4 x 2048, 16 greedy
  tokens; kernel B3 in self- and cross-attention;
* the dry-run's op analyser (``repro_torch.launch.dryrun``): stablelm-3b's
  prefill at 2 x 2048 and its train step at 2 x 4096 analysed on meta
  tensors and held to the card (the prefill also analysed on the card's
  tensors, B3 32 times by wgmma);
* training: stablelm-3b at full width and depth (2,795,276,800 parameters,
  bf16 compute on float32 masters), batch 2 x 4096, 10 AdamW steps through
  ``repro_torch.runtime.Trainer``; no kernel (B3 and B4 have no backward,
  and the trainer runs the plain attention and SSD under autograd, as the
  reference trains with ``impl="dot"``): B3/B4 launch 0 times;
* the mesh (``repro_torch.launch.dryrun --mesh single|multi``): stablelm-3b's
  train_4k, prefill_32k and decode_32k analysed per chip on the reference's
  16x16 and 2x16x16 meshes (DTensor on meta shards, a fake process group
  of 256 / 512 in a child process each), and rank 0's program of the
  16x16 prefill_32k run on the card at full width over a fake group of 256;
  no kernel (the dry-run runs ``chunked``), so no count is read;
* the six examples of ``repro_torch.examples`` as users start them, each
  in a process of its own with the reference's smoke arguments (and
  krylov_solve without ``--fused``, serve_lm at its defaults and on
  mamba2-780m, train_lm at its 300 steps and resumed); the counts each
  reports cover its own process: B1/B2 in quickstart, B1 in krylov_solve,
  B3 in serve_lm, B4 on mamba2-780m, none in train_lm.

Phases, each of which fails the run on any error:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together; seconds, registers and spills printed);
1b. the fused CG's profiled solve (``fused_profile``) in a child process
   of its own, before any other process has used the card: B1's kernels in
   its trace equal to the launches counted from the graph replays;
2. the examples (``examples``): each of the ten runs above in a child
   process on the card, its exit code, the reference's expected line and
   its launch gate checked, its wall seconds recorded; then B1-B4 at the
   shapes the examples give them against their plain versions; right
   after the build (placed just before ``fused``, it left that phase's
   profiler two B1 kernels short of the launches counted, in both full
   runs);
2b. the mesh (``mesh``): the dry-run CLI on the two production meshes and
   rank 0's prefill on the card (see ``phase_mesh``), each in a child
   process because a process group is global;
3. B1 (``spmv_ell``) and B2 (``spmm_ell``) at the solve path's shapes,
   masked and unmasked, f32 and bf16, against their plain PyTorch versions;
   kernel, plain and ``torch.sparse`` CSR times and the bound;
4. the exchange of all four strategies, barrier and split-phase, on the card
   against the host ``execute_numpy``, bitwise;
5. the distributed SpMV of every strategy: overlap == barrier and
   ``matmat == matmat_looped`` bitwise, and agreement with a float64 host
   CSR product; then a small system solved on the card and on the CPU;
6. the solve path: CG (strategy "auto", the advisor on ``lassen``), BiCGStab
   on ``shifted_system`` of the same grid, and one ``matmat`` of 8 columns;
7. a CG iteration's host wall time and its device time by kernel under
   ``torch.profiler``;
8. the exchange's wire codecs, checks, injected faults and recovery ladder
   at the case study's size against ``execute_numpy``, and CG through them;
9. the serving executor: ``measure_spmv_replay`` (64 requests, width 8,
   parity 0), a simulated schedule drained through ``matmat`` (B2) under
   seeded faults, each completed batch held to a float64 CSR product, and
   ``simulate()``'s trace hash against the reference's;
10. B3 (``flash_attention``, f32 and bf16) and B4 (``ssd_chunked``, f32) at the
   serving path's shapes and at ragged / ``Sq < Sk`` / non-causal / no-window
   / other-chunk cases, and B3 at stablelm-3b's and qwen3-32b's head widths
   (80, 128), stablelm-3b's and llama4-scout's at their serve phases'
   shapes too, against their plain versions (B3 against the plain version
   in float32 on the same inputs); kernel, plain and library (``scaled_dot_product_attention``;
   none for the SSD) times and the bound, B3's at every shape a serve
   phase gives it (hymba's, stablelm-3b's, llama4-scout's; MLA's q/k 192 /
   v 128; whisper's encoder, decoder self- and cross-attention; the vlm's
   self- and cross-attention), beside SDPA on its fastest backend that
   takes the shapes; B3 beside SDPA at D = 128, S = 4096, causal; at every
   row the wgmma route serves (hymba's D 64, llama4-scout's and the vlm's
   D 128, MLA's (192, 128)) the wgmma kernel beside the mma.sync kernel of
   the other widths, both checked against the plain version;
11. the serving path: in float32, the kernel route against the plain route
   (prefill logits, greedy tokens) and decode against the full forward;
   then the bfloat16 run, its prefill and decode times, peak memory, and the
   device's busy share over ten decode steps;
12. a short bfloat16 serve of stablelm-3b at full width and depth (batch 2,
   prompts of 2048, 8 tokens; counts reset just before, read just after):
   B3 at head width 80, 32 launches, finite logits;
13. one llama4-scout MoE layer at full width on 16 stacked ranks (one
   expert each; batch 16 x 1024, uniform and skewed routing): the exchange
   dispatch bitwise the all-to-all for every strategy and ``auto``, the
   int8 wire's dispatch hop within its envelope, the exchange cache under a
   jittered skewed count stream of 50 batches (hit rate >= 0.9), a
   simulated MoE schedule drained through ``BatchExecutor.register_moe``
   bitwise the all-to-all; ms per layer call, slots routed / dropped /
   shipped, and one call's device time by class;
14. llama4-scout serving: in float32 at 2 layers (2 x 1024, 8 tokens) the
   kernel route against the plain route; then the bfloat16 main path at 8
   layers, B3 launched once per layer in the prefill (every launch by the
   wgmma route) and never in decode, its times, memory, capacity drops, decode busy share and prefill device
   time by class, and the dispatch advice, serving simulation and chaos
   storm on the served tokens;
15.-17. this slice's serving paths (``serve_mla``, ``serve_whisper``,
   ``serve_vlm``): in float32 at a small depth (deepseek 2 layers at 2 x
   1024 with a capacity factor at which nothing drops, whisper 4 + 4 layers
   at 4 x 192, the vlm 4 + 1 layers at 2 x 512) the kernel route against the
   plain route and decode against the full forward; then the bfloat16 main
   path, B3 launched once per attention in the prefill (27, 96, 20), each
   launch at a shape phase 10 checked and timed and by the wgmma route, and
   never in decode, finite
   logits, times, peak memory, capacity drops
   (deepseek), the decode busy share and the prefill's device time by class;
18. the training path (``train``): stablelm-3b at full width and depth,
   10 steps at 2 x 4096 (finite, falling losses; the working copy equal to
   the masters cast to bf16; no B3/B4 launch), ms per step, tokens/s, MFU,
   peak memory, and 2 profiled steps' busy share and device time by class;
   then the 100m preset in float32, 3 steps on the card against the CPU,
   and a failure at step 3 resumed from a checkpoint bitwise an
   uninterrupted run; before ``fused``, whose graph replays would leave the
   profiler blind;
19. the dry-run's op analyser (``dryrun``, no profiler): stablelm-3b's
   prefill at 2 x 2048 analysed on meta tensors and on the card's tensors
   (argument bytes, counted FLOPs chunked and kernel-vs-fused, B3 32 times by
   wgmma, the predicted temp + output bytes within 10% of the card's peak),
   and the train step at 2 x 4096 (the predicted peak within 10% of phase
   ``train``'s); the roofline shares of both on 989 TFLOP/s;
20. the whole solve as replayed CUDA graphs (``fused_cg``/``fused_bicgstab``
   on the case study): against the host loops (iterations, status, matvecs,
   histories within 1e-10, true residual), one fused-cache miss then a hit,
   graph replay bitwise the eager body, histories bitwise across strategies
   x barrier/overlap, the host path's integrity-error fields, a resume after
   a transient fault, host reads per solve; then ms/iteration of fused and
   host loop over 200 iterations (wire none / int8 / checked), a block-size
   sweep on the converging solves and the 200-iteration horizon, and the
   busy share of phase 1b's profiled solve; the last phase in this process,
   because after its graph replays ``torch.profiler`` records no device
   activity here;
21. the world (``world``): the case study on 16 processes over gloo in one
    child process (see ``phase_world``): every rank's halos, SpMV and solves
    bitwise the stacked run's rows; the fused CG / BiCGStab on the group,
    bitwise the grouped host loop and the stacked host loop in the tree's
    order, B1 by replays only, one host read per block (ms per iteration
    against the host loop, capture seconds); checks, faults and the recovery
    ladder agreed by every rank and bitwise the stacked guarded exchange; the
    on-pod-then-inter-pod reduction tree, plain and int8-compressed; its
    launches as predicted, the guards; the MoE exchange dispatch at full
    width on the world's mesh (bitwise across strategies and the mesh
    all-to-all, bitwise the stacked exchange, the stacked run's slot
    counts, the int8 wire bitwise the stacked int8 run, planning once; ms
    per call);
    then the collective probe over plain gloo and the staged group, and
    the launchers' ``--mesh 2x2`` on CUDA ranks (serve at full width, bf16
    and a float32 check, train 100m); last, so no other process shares the
    card with a profiled phase;
22. one JSON line of the kernels (B3 eight times: at hymba's shapes, at
    llama4-scout's, at MLA's prefill, at whisper's encoder, decoder self-
    and cross-attention, and at the vlm's self- and cross-attention; each
    B3 entry's launches are its main path's launches at that shape), the
    card's name and power limit, and the device line last.

Without a CUDA device, or without the rest of the checkout beside it, it
exits non-zero and prints no result.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SEED = 0
SIDE = 1024  # grid side: SIDE * SIDE = 1 << 20 rows
NPODS, PPN = 4, 4
STRATEGIES = ("standard", "two_step", "three_step", "split")
MM_COLS = 8
#: B2's column counts held against its plain version: every specialisation
#: (1, 2, 4, 8, 16: the serving drain's batches take 1 to 8 columns) and the
#: generic kernel (3)
MM_CHECK_COLS = (1, 2, 3, 4, MM_COLS, 16)

#: the LLM serving path: hymba-1.5b at full width and depth, a batch of
#: prompts longer than its 2048-token window, greedy decode
LM_ARCH = "hymba-1.5b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 4096, 32
#: a dense config whose head width (80) B3 takes since it took every
#: multiple of 16: stablelm-3b at full width and depth, a short serve
SLM_ARCH = "stablelm-3b"
SLM_BATCH, SLM_PROMPT, SLM_GEN = 2, 2048, 8
#: the MoE serving path: llama4-scout-17b-a16e at full width (d_model 5120,
#: 40/8 heads of 128, 16 experts top-1 of d_ff 8192, one shared expert),
#: 8 of its 48 layers (107.8B parameters do not fit the card; 8 layers are
#: 19.7B, 39.4 GB in bf16); a 2-layer float32 check first
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 8
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 4096, 32
MOE_CHECK_LAYERS, MOE_CHECK_BATCH, MOE_CHECK_PROMPT, MOE_CHECK_GEN = 2, 2, 1024, 8
#: the MoE dispatch phase: one llama4-scout MoE layer on 16 stacked ranks
#: (one expert each), a batch of 16 x 1024 tokens; a count stream of 50
#: batches through MoEDispatcher; a simulated schedule of 24 requests of
#: 16 x 64 tokens drained through BatchExecutor.register_moe
MOE_NPODS, MOE_PPN = 4, 4
MOE_DISPATCH_BATCH, MOE_DISPATCH_SEQ = 16, 1024
MOE_STREAM_BATCHES = 50
MOE_SIM_REQUESTS, MOE_SIM_SEQ = 24, 64
#: the reference's acceptance number for the exchange cache under a
#: jittered skewed stream (tests/test_moe_dispatch.py)
MOE_HIT_RATE = 0.9

#: this slice's serving paths, at full width: deepseek-v2-lite-16b whole (MLA
#: q/k 192 / v 128 over 16 heads + 64 experts top-6 and 2 shared, 27 layers,
#: 31.3 GB in bf16); whisper-large-v3 whole (32 encoder + 32 decoder layers,
#: 1500 frames, 192-token prompts + 32 tokens within its 448 text positions);
#: llama-3.2-vision-90b at 20 of its 100 layers (16 self + 4 cross over 1600
#: image tokens, 38.6 GB in bf16; all 100 are 175.5 GB).  Each has a float32
#: check at a small depth first: deepseek's at a capacity factor of 11 (at
#: least experts / top_k, so no expert can overflow and decode must equal
#: the full forward)
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_BATCH, MLA_PROMPT, MLA_GEN = 4, 4096, 32
MLA_CHECK = {"layers": 2, "batch": 2, "prompt": 1024, "gen": 8, "capacity_factor": 11.0}
WH_ARCH = "whisper-large-v3"
WH_BATCH, WH_PROMPT, WH_GEN = 16, 192, 32
WH_CHECK = {"layers": 4, "encoder_layers": 4, "batch": 4, "prompt": 192, "gen": 8}
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 20
VLM_BATCH, VLM_PROMPT, VLM_GEN = 4, 2048, 16
VLM_CHECK = {"layers": 5, "batch": 2, "prompt": 512, "gen": 8}

#: the training path: stablelm-3b at full width and depth (32 layers,
#: d_model 2560, 32 heads of 80, d_ff 6912, vocab 50304) with bf16 compute
#: on float32 masters, the reference's train_4k sequence of 4096 tokens and
#: its global batch of 256 cut to 2 for one card; remat "full", the
#: launcher's AdamW (lr 3e-3, warmup steps // 10); 10 steps, of which the
#: median of 3-10 is reported, then 2 more under the profiler
TRAIN_ARCH = "stablelm-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4096, 10, 3e-3
#: the float32 check: the 100m preset, 3 steps on the card against the same
#: steps on the CPU, then checkpoints every 2 steps, a failure injected at
#: step 3 and a resume to step 6 against an uninterrupted run
TRAIN_CHECK = {"preset": "100m", "batch": 2, "seq": 128, "steps": 3, "resume_steps": 6, "fail_at": 3,
               "every": 2}
#: the card's losses against the CPU's (relative)
TOL_TRAIN_LOSS = 1e-4

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) FLOP/s
#: and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12

#: tolerances: f32 kernel vs plain version (the reference's own kernel
#: tolerance), bf16 (one bf16 rounding of an fp32 sum), and the f32 SpMV vs a
#: float64 host product, relative to (|A| |v|) per row
TOL_F32 = 2e-5
TOL_BF16 = 5e-2
TOL_SPMV = 1e-5
TOL_SOLVE = 1e-6
#: CG's true residual with the int8 wire.  The int8 codec rounds each
#: inter-pod halo value by up to 0.5/127 of its block's largest magnitude,
#: so the solve converges on an operator some 1e-4 away from A: 1e-5
#: cannot be reached, and the gate is a quarter of the per-element bound
TOL_TRUE_INT8 = 1e-3
#: B3 / B4 against their plain versions: f32 at the reference's own kernel
#: tolerances (tests/test_kernels.py); B3 on bf16 inputs against the plain
#: version in float32 on the same (bf16-rounded) inputs, where only the
#: kernel's rounding of its output to bf16 (at most 2**-8 of it) is left:
#: rtol twice that, atol far under the outputs' typical size (about 0.03 at
#: the path's shapes); the SDPA yardstick in bf16 (which rounds its own
#: probabilities to bf16) at the reference's bf16 3e-2; the model's prefill
#: logits, kernel route against plain route in float32, relative to the
#: largest |logit|; decode against the full forward (tests/test_models.py)
TOL_ATTN_F32 = 2e-4
TOL_ATTN_BF16 = (8e-3, 1e-4)
TOL_SDPA_BF16 = 3e-2
TOL_SSD = 2e-4
TOL_SSD_SEQ = 5e-4
TOL_LOGITS = 1e-3
TOL_DECODE = 5e-2
#: the dry-run's predicted bytes (meta tensors) against the card's
#: max_memory_allocated (relative)
TOL_DRYRUN_MEM = 0.10


def log(*args) -> None:
    print(*args, flush=True)


class Timer:
    """CUDA-event timing of one callable, with the L2 flushed before each run.

    Before each timed run the device also spins for about a millisecond
    (``torch.cuda._sleep``), so the start event and the run are both queued
    before the start event executes: a short kernel is timed by what the
    device spends on it, not by how long the host takes to launch it.
    """

    #: ~1 ms at the H100's 1.98 GHz boost clock
    SETTLE_CYCLES = 2_000_000

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        # 256 MB, five times the H100's 50 MB L2
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(self.reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SETTLE_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / self.reps

    def per_call(self, fn) -> float:
        """ms per call of ``reps`` calls back to back between two CUDA events,
        L2 warm: the stream's span, host-bound gaps included (for paths of
        many small launches, where the host sets the pace)."""
        torch = self.torch
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(self.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / self.reps


def bound(nbytes: int, flops: int, peak_flops: float = FP32_FLOPS) -> tuple:
    """The least ms the card could take: the larger of bytes over the HBM
    rate and operations over ``peak_flops``, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """Visible (query, key) pairs of one head: query i sits at key i + Sk - Sq."""
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def ssd_flops(S: int, Q: int, H: int, P: int, N: int) -> int:
    """fp32 operations of the chunked SSD for one batch row of H heads: per
    chunk of q steps, the causal c.b scores (shared by the heads), and per
    head their product with x, the incoming state's term and the state
    update."""
    total = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        tri = q * (q + 1) // 2
        total += tri * 2 * N + H * (tri * 2 * P + 2 * (q * 2 * N * P) + N * P)
    return total


def csr_product64(A, V: np.ndarray, absolute: bool = False) -> np.ndarray:
    """``A @ V`` (or ``|A| @ |V|``) in float64 on the host; ``V: [n]`` or ``[n, k]``."""
    rows = np.repeat(np.arange(A.n), np.diff(A.indptr))
    data = A.data.astype(np.float64)
    vals = V.astype(np.float64)[A.indices]
    if absolute:
        data, vals = np.abs(data), np.abs(vals)
    if vals.ndim == 1:
        return np.bincount(rows, weights=data * vals, minlength=A.n)
    return np.stack(
        [np.bincount(rows, weights=data * vals[:, c], minlength=A.n) for c in range(vals.shape[1])],
        axis=1,
    )


def ell_as_csr(torch, data, cols, N: int):
    """The stacked ELL block as one block-diagonal CSR matrix (padding slots
    kept as stored zeros), for the library yardstick."""
    g, R, K = data.shape
    crow = torch.arange(0, g * R * K + 1, K, device=data.device, dtype=torch.int64)
    offs = (torch.arange(g, device=data.device) * N)[:, None, None]
    col = (cols.long() + offs).reshape(-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "CSR support is in beta"
        return torch.sparse_csr_tensor(
            crow, col, data.reshape(-1), size=(g * R, g * N), check_invariants=False
        )


def device_events(prof) -> dict:
    """``{name: [count, device µs]}`` of the device-side events (kernels,
    copies, sets) of a finished ``torch.profiler`` session, read straight
    from its kineto results as ``key_averages()`` reads them (hidden and
    asynchronous events left out, each event's span from its start to its
    end), but without building its tree of host ops: that took 14-45 s for
    a window of ten decode steps at full size (PERF.md §6)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CPU or getattr(e, "is_hidden_event", lambda: False)() or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        us = (e.end_ns() - e.start_ns()) / 1e3
        if us > 0:
            row = out.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += us
    return out


def device_profile(fn, steps: int, top_n: int = 8) -> tuple:
    """Device ms per step and the top kernels of ``fn()`` (``steps`` steps)
    under ``torch.profiler``.  Device-side events only (kernels, copies,
    :func:`device_events`): an aten op's self device time repeats that of
    the kernels it launched.  A profiler that records no device time fails
    the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        raise AssertionError("torch.profiler recorded no device time")
    device_ms = sum(us for _, us in events.values()) / 1e3 / steps
    top = [
        {"name": name[:80], "calls_per_step": count / steps, "us_per_step": us / steps}
        for name, (count, us) in sorted(events.items(), key=lambda kv: -kv[1][1])[:top_n]
    ]
    return device_ms, top


#: aten ops by the device work they launch: a kernel counts for the
#: innermost op that launched it (that op's self device time), so the
#: classes do not overlap; kernels launched outside any op (the port's own,
#: through ctypes) are classed by kernel name
OP_CLASSES = {
    "expert_gemms": ("aten::bmm",),
    "other_gemms": ("aten::mm", "aten::addmm"),
    "routing_moves": ("aten::index", "aten::scatter_", "aten::gather", "aten::sort", "aten::cummax",
                      "aten::bincount", "aten::topk"),
    "exchange_gathers": ("aten::index_select", "aten::index_copy_"),
}


def device_split(fn, op_classes: dict, kernel_classes: dict = None) -> dict:
    """Device ms of ``fn()`` under one ``torch.profiler`` session, split by
    class: ``kernel_classes`` maps a class to a kernel-name substring,
    ``op_classes`` to aten op names; ``other`` is the rest (elementwise
    work and copies).  A profiler that records no device time fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type != DeviceType.CPU and self_us(e) > 0]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    total = sum(self_us(e) for e in kernels)
    split = {name: sum(self_us(e) for e in kernels if pat in e.key) for name, pat in (kernel_classes or {}).items()}
    for name, ops in op_classes.items():
        split[name] = sum(self_us(e) for e in events if e.device_type == DeviceType.CPU and e.key in ops)
    split["other"] = total - sum(split.values())
    out = {"device_ms": total / 1e3, **{k: v / 1e3 for k, v in split.items()}}
    out["top_kernels"] = [{"name": e.key[:80], "calls": e.count, "us": self_us(e)}
                          for e in sorted(kernels, key=self_us, reverse=True)[:8]]
    ops = [e for e in events if e.device_type == DeviceType.CPU and self_us(e) > 0]
    out["top_ops"] = [{"name": e.key, "calls": e.count, "us": self_us(e)}
                      for e in sorted(ops, key=self_us, reverse=True)[:12]]
    return out


class Lap:
    """Host seconds between successive calls (the first from its making),
    for a phase's record of where its own time goes."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self) -> float:
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt


def median_ms(torch, fn, reps: int = 7) -> float:
    """Median ms of ``reps`` calls of ``fn`` between CUDA events, after one
    warm call (each call may read the device from the host)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(ctx) -> None:
    """Build the three CUDA libraries, one ``nvcc`` each, all at once.  In a
    whole run (``ctx["whole_run"]``, set by :func:`main`) phase
    fused_profile's child starts first and runs beside the build
    (:func:`start_fused_profile`: it imports torch and builds its operator on
    the host before it needs B1's library, the quickest to compile), and so
    does the fork server of this process's worlds (it imports torch and the
    port once, and never touches the card)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.world import start_rank_server

    if ctx.get("whole_run"):
        start_rank_server()
        start_fused_profile(ctx)
    t0 = time.perf_counter()
    built = kbuild.build()
    seconds = time.perf_counter() - t0
    for name, info in built.items():
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] done in {seconds:.2f} s ({len(built)} compiled)")
    ctx["details"]["build_s"] = seconds


def build_case_study() -> dict:
    """The case study's two systems and their partitions, built on the host:
    ``topo``, ``A``, ``part``, ``B``, ``part_b`` and the ``seconds`` it took."""
    from repro_torch.comm import PodTopology
    from repro_torch.solve import shifted_system, spd_system
    from repro_torch.sparse import partition_csr, thermal_like

    t0 = time.perf_counter()
    topo = PodTopology(npods=NPODS, ppn=PPN)
    A = spd_system(thermal_like(SIDE * SIDE, np.random.default_rng(SEED)))
    part = partition_csr(A, topo)
    B = shifted_system(thermal_like(SIDE * SIDE, np.random.default_rng(SEED + 1)))
    part_b = partition_csr(B, topo)
    return dict(topo=topo, A=A, part=part, B=B, part_b=part_b, seconds=time.perf_counter() - t0)


def start_setup(ctx) -> None:
    """Start :func:`build_case_study` on a thread of this process, so that
    host work runs while phase examples waits for its children; phase setup
    takes its result."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    ctx["setup_future"] = pool.submit(build_case_study)
    pool.shutdown(wait=False)


def phase_setup(ctx) -> None:
    future = ctx.pop("setup_future", None)
    built = future.result() if future is not None else build_case_study()
    seconds = built.pop("seconds")
    ctx.update(built)
    A, part, topo = built["A"], built["part"], built["topo"]
    log(
        f"[setup] n={A.n} nnz={A.nnz} ranks={topo.nranks} L={part.rows_per_rank} "
        f"diag K={part.diag.data.shape[1]} off K={part.off.data.shape[1]} "
        f"halo H={part.halo_width} needs={len(part.pattern.needs)} "
        f"({seconds:.1f} s on the host{', beside phase examples' if future is not None else ''})"
    )


def phase_kernels(ctx) -> None:
    import torch
    from repro_torch.comm import IrregularExchange
    from repro_torch.core.split_plan import split_rows
    from repro_torch.kernels import spmv_ell as K

    part, topo = ctx["part"], ctx["topo"]
    g, L = topo.nranks, part.rows_per_rank
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(a, device=dev).contiguous()

    dd, dc = t(part.diag.data.reshape(g, L, -1)), t(part.diag.cols.reshape(g, L, -1))
    od, oc = t(part.off.data.reshape(g, L, -1)), t(part.off.cols.reshape(g, L, -1))
    v = t(rng.normal(size=(g, L)).astype(np.float32))
    halo = IrregularExchange(part.pattern, "two_step")(v)
    halo_dep = part.off_row_nnz.reshape(g, L) > 0
    bnd = t(split_rows(halo_dep, K.TILE_R).boundary_tiles.astype(np.int32))
    bnd_mm = t(split_rows(halo_dep, K.TILE_R_MM).boundary_tiles.astype(np.int32))
    V = {c: t(rng.normal(size=(g, L, c)).astype(np.float32)) for c in MM_CHECK_COLS}
    H = {c: IrregularExchange(part.pattern, "two_step")(V[c]) for c in MM_CHECK_COLS}
    errs = ctx["details"].setdefault("kernel_checks", [])

    def check(name, got, want, tol):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        errs.append({"case": name, "max_abs_err": err, "tol": tol, "ok": bool(ok)})
        log(f"[kernels] {name}: max_abs_err={err:.3e} (rtol=atol={tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return err

    rows = K.rows_of_tiles
    max_err = {"spmv_ell": 0.0, "spmm_ell": 0.0}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        d_, o_, x_, h_ = dd.to(dtype), od.to(dtype), v.to(dtype), halo.to(dtype)
        cases = [
            ("spmv_ell", f"diag {tag}", K.spmv_ell(d_, dc, x_), K.spmv_ell_ref(d_, dc, x_)),
            ("spmv_ell", f"off {tag}", K.spmv_ell(o_, oc, h_), K.spmv_ell_ref(o_, oc, h_)),
            ("spmv_ell", f"off masked {tag}", K.spmv_ell(o_, oc, h_, bnd),
             K.spmv_ell_masked_ref(o_, oc, h_, rows(bnd, K.TILE_R, L))),
            ("spmv_ell", f"diag masked {tag}", K.spmv_ell(d_, dc, x_, bnd),
             K.spmv_ell_masked_ref(d_, dc, x_, rows(bnd, K.TILE_R, L))),
        ]
        for c in MM_CHECK_COLS:
            X, Hc = V[c].to(dtype), H[c].to(dtype)
            mask_rows = rows(bnd_mm, K.TILE_R_MM, L)
            cases += [
                ("spmm_ell", f"diag C={c} {tag}", K.spmm_ell(d_, dc, X), K.spmm_ell_ref(d_, dc, X)),
                ("spmm_ell", f"diag masked C={c} {tag}", K.spmm_ell(d_, dc, X, bnd_mm),
                 K.spmm_ell_masked_ref(d_, dc, X, mask_rows)),
                ("spmm_ell", f"off C={c} {tag}", K.spmm_ell(o_, oc, Hc), K.spmm_ell_ref(o_, oc, Hc)),
                ("spmm_ell", f"off masked C={c} {tag}", K.spmm_ell(o_, oc, Hc, bnd_mm),
                 K.spmm_ell_masked_ref(o_, oc, Hc, mask_rows)),
            ]
        for kname, name, got, want in cases:
            err = check(f"{kname} {name}", got, want, tol)
            if dtype == torch.float32:
                max_err[kname] = max(max_err[kname], err)
        one = V[1][..., 0].contiguous().to(dtype)
        same = torch.equal(K.spmm_ell(d_, dc, one[..., None]).squeeze(-1), K.spmv_ell(d_, dc, one))
        log(f"[kernels] spmm(C=1) == spmv bitwise ({tag}): {same}")
        if not same:
            raise AssertionError("spmm_ell at C=1 differs from spmv_ell")
        # every column of an 8-column product is B1 on that column, bitwise,
        # and a masked launch's active tiles are the unmasked launch's
        X8, H8 = V[MM_COLS].to(dtype), H[MM_COLS].to(dtype)
        full = K.spmm_ell(d_, dc, X8)
        cols_same = all(
            torch.equal(full[..., c], K.spmv_ell(d_, dc, X8[..., c].contiguous())) for c in range(MM_COLS)
        )
        off_full, off_masked = K.spmm_ell(o_, oc, H8), K.spmm_ell(o_, oc, H8, bnd_mm)
        mrows = rows(bnd_mm, K.TILE_R_MM, L)
        mask_same = torch.equal(off_masked[mrows], off_full[mrows]) and not off_masked[~mrows].any()
        log(f"[kernels] spmm(X)[..., c] == spmv(X[..., c]) bitwise for c < {MM_COLS} ({tag}): {cols_same}; "
            f"masked active tiles == unmasked bitwise: {mask_same}")
        if not (cols_same and mask_same):
            raise AssertionError("spmm_ell breaks its bitwise invariants against spmv_ell / its masked launch")

    timer = Timer(torch)
    csr = ell_as_csr(torch, dd, dc, L)
    rows_all = g * L
    timings = {}
    for kname, shape, fn, plain, lib, nbytes, flops in (
        (
            "spmv_ell", [g, L, dd.shape[2]],
            lambda: K.spmv_ell(dd, dc, v), lambda: K.spmv_ell_ref(dd, dc, v),
            lambda: csr @ v.reshape(rows_all, 1),
            dd.nbytes + dc.nbytes + v.nbytes + v.nbytes,
            2 * dd.numel(),
        ),
        (
            "spmm_ell", [g, L, dd.shape[2], MM_COLS],
            lambda: K.spmm_ell(dd, dc, V[MM_COLS]), lambda: K.spmm_ell_ref(dd, dc, V[MM_COLS]),
            lambda: csr @ V[MM_COLS].reshape(rows_all, MM_COLS),
            dd.nbytes + dc.nbytes + 2 * V[MM_COLS].nbytes,
            2 * dd.numel() * MM_COLS,
        ),
    ):
        torch.testing.assert_close(lib().reshape(fn().shape), fn(), rtol=TOL_F32, atol=TOL_F32)
        b_ms, b_by = bound(nbytes, flops)
        timings[kname] = {
            "source": "src/repro_torch/csrc/spmv_ell.cu",
            "replaces": f"src/repro/kernels/spmv_ell.py:{131 if kname == 'spmv_ell' else 173}",
            "dtype": "float32",
            "shape": shape,
            "ms": timer(fn),
            "plain_ms": timer(plain),
            "library_ms": timer(lib),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "max_abs_err": max_err[kname],
        }
        log(f"[kernels] {kname} {shape} f32: " + json.dumps(timings[kname]))
    # B2 in bf16 at the main path's shape: bf16 data and X, int32 cols
    db, Xb = dd.to(torch.bfloat16), V[MM_COLS].to(torch.bfloat16)
    csr_b = ell_as_csr(torch, db, dc, L)
    try:
        lib_b = timer(lambda: csr_b @ Xb.reshape(rows_all, MM_COLS))
    except RuntimeError as e:  # a library without a bf16 CSR product: no yardstick
        lib_b = None
        log(f"[kernels] torch.sparse CSR @ dense in bf16 unavailable: {str(e).splitlines()[0]}")
    b_ms, b_by = bound(db.nbytes + dc.nbytes + 2 * Xb.nbytes, 2 * db.numel() * MM_COLS)
    bf = {
        "shape": [g, L, dd.shape[2], MM_COLS],
        "ms": timer(lambda: K.spmm_ell(db, dc, Xb)),
        "plain_ms": timer(lambda: K.spmm_ell_ref(db, dc, Xb)),
        "library_ms": lib_b,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    log("[kernels] spmm_ell bf16: " + json.dumps(bf))
    ctx["details"].setdefault("extra_timings", {})["spmm_ell bf16"] = bf
    # the off block and the masked off pass, for the record
    for name, fn in (
        ("spmv_ell off f32", lambda: K.spmv_ell(od, oc, halo)),
        ("spmv_ell off masked f32", lambda: K.spmv_ell(od, oc, halo, bnd)),
    ):
        ms = timer(fn)
        b_ms, _ = bound(od.nbytes + oc.nbytes + halo.nbytes + v.nbytes, 2 * od.numel())
        log(f"[kernels] {name} {list(od.shape)}: ms={ms:.5f} bound_ms={b_ms:.5f}")
        ctx["details"].setdefault("extra_timings", {})[name] = {"ms": ms, "bound_ms": b_ms}
    ctx["timings"] = timings


def phase_exchange(ctx) -> None:
    import torch
    from repro_torch.comm import IrregularExchange, execute_numpy

    part, topo = ctx["part"], ctx["topo"]
    rng = np.random.default_rng(SEED + 3)
    g, L = topo.nranks, part.rows_per_rank
    for shape in ((g, L), (g, L, 3)):
        local = rng.normal(size=shape).astype(np.float32)
        dev_local = torch.as_tensor(local, device="cuda")
        for strat in STRATEGIES:
            ex = IrregularExchange(part.pattern, strat)
            want = execute_numpy(ex.plan, local)
            barrier = ex(dev_local).cpu().numpy()
            split = ex.start(dev_local).finish().cpu().numpy()
            ok = np.array_equal(barrier, want) and np.array_equal(split, want)
            log(f"[exchange] {strat} feat={shape[2:]} barrier/split == execute_numpy: {ok}")
            if not ok:
                raise AssertionError(f"exchange {strat} differs from execute_numpy")


def phase_spmv(ctx) -> None:
    import torch
    from repro_torch.comm import PodTopology
    from repro_torch.solve import cg, spd_system
    from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like

    A, part, topo = ctx["A"], ctx["part"], ctx["topo"]
    g, L = topo.nranks, part.rows_per_rank
    rng = np.random.default_rng(SEED + 4)
    v = rng.normal(size=(g, L)).astype(np.float32)
    V = rng.normal(size=(g, L, MM_COLS)).astype(np.float32)
    w64 = csr_product64(A, v.reshape(-1))
    scale = csr_product64(A, v.reshape(-1), absolute=True) + 1e-30
    for strat in STRATEGIES:
        sp = DistributedSpMV(part, strategy=strat)
        ov = DistributedSpMV(part, strategy=strat, overlap=True)
        w = sp(v)
        same = torch.equal(ov(v), w)
        rel = float((np.abs(w.cpu().numpy().reshape(-1) - w64) / scale).max())
        mm = sp.matmat(V)
        mm_same = torch.equal(mm, sp.matmat_looped(V)) and torch.equal(ov.matmat(V), mm)
        log(
            f"[spmv] {strat}: overlap == barrier {same}; max |w - w64| / (|A||v|) = {rel:.3e} "
            f"(tol {TOL_SPMV}); matmat(k={MM_COLS}) == matmat_looped, overlap == barrier {mm_same}"
        )
        if not (same and mm_same and rel <= TOL_SPMV):
            raise AssertionError(f"distributed SpMV {strat} failed its checks")
    # a small system, solved on the card and on the CPU by the same code
    small_topo = PodTopology(npods=2, ppn=4)
    S = spd_system(thermal_like(4096, np.random.default_rng(SEED + 5)))
    sp_part = partition_csr(S, small_topo)
    b = rng.normal(size=(small_topo.nranks, sp_part.rows_per_rank)).astype(np.float32)
    on_card = cg(DistributedSpMV(sp_part, strategy="split"), b, tol=TOL_SOLVE)
    on_cpu = cg(DistributedSpMV(sp_part, strategy="split", device="cpu"), b, tol=TOL_SOLVE)
    dx = float((on_card.x.cpu() - on_cpu.x).abs().max())
    log(
        f"[spmv] small CG card vs cpu: {on_card.status}/{on_cpu.status} "
        f"iterations {on_card.iterations}/{on_cpu.iterations} max |dx| = {dx:.3e}"
    )
    if not (on_card.converged and on_cpu.converged and abs(on_card.iterations - on_cpu.iterations) <= 1
            and dx <= 1e-4):
        raise AssertionError("small CG on the card disagrees with the CPU")


def phase_solve(ctx) -> None:
    import torch
    from repro_torch.comm import cache_stats, clear_caches
    from repro_torch.kernels.spmv_ell import spmm_ell, spmv_ell
    from repro_torch.solve import bicgstab, cg
    from repro_torch.sparse import DistributedSpMV

    A, B, part, part_b, topo = ctx["A"], ctx["B"], ctx["part"], ctx["part_b"], ctx["topo"]
    g, L = topo.nranks, part.rows_per_rank
    rng = np.random.default_rng(SEED + 6)
    b = torch.as_tensor(rng.normal(size=(g, L)).astype(np.float32), device="cuda")
    b2 = torch.as_tensor(rng.normal(size=(g, L)).astype(np.float32), device="cuda")
    V = torch.as_tensor(rng.normal(size=(g, L, MM_COLS)).astype(np.float32), device="cuda")
    clear_caches()
    torch.cuda.synchronize()

    # ---- the main path: counts reset just before, read just after ----
    spmv_ell.launches = 0
    spmm_ell.launches = 0
    t0 = time.perf_counter()
    op = DistributedSpMV(part, strategy="auto")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = cg(op, b, tol=TOL_SOLVE, maxiter=1000)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stats = cache_stats()
    op_b = DistributedSpMV(part_b, strategy="auto")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    res_b = bicgstab(op_b, b2, tol=TOL_SOLVE, maxiter=1000)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    W = op.matmat(V)
    torch.cuda.synchronize()
    launches = {"spmv_ell": spmv_ell.launches, "spmm_ell": spmm_ell.launches}
    # ---- end of the main path ----

    x64 = res.x.double().cpu().numpy().reshape(-1)
    true_rel = np.linalg.norm(b.double().cpu().numpy().reshape(-1) - csr_product64(A, x64)) / float(
        b.double().norm()
    )
    xb64 = res_b.x.double().cpu().numpy().reshape(-1)
    true_rel_b = np.linalg.norm(
        b2.double().cpu().numpy().reshape(-1) - csr_product64(B, xb64)
    ) / float(b2.double().norm())
    W64 = csr_product64(A, V.cpu().numpy().reshape(-1, MM_COLS))
    mm_rel = float(
        np.abs(W.cpu().numpy().reshape(-1, MM_COLS) - W64).max() / np.abs(W64).max()
    )
    summary = {
        "cg": {
            "strategy": op.strategy,
            "status": res.status,
            "iterations": res.iterations,
            "matvecs": res.matvecs,
            "final_residual": res.final_residual,
            "true_residual": true_rel,
            "setup_s": t1 - t0,
            "solve_s": t2 - t1,
            "ms_per_iteration": (t2 - t1) / max(res.iterations, 1) * 1e3,
            "plan_misses": stats.plan_misses,
        },
        "bicgstab": {
            "status": res_b.status,
            "iterations": res_b.iterations,
            "matvecs": res_b.matvecs,
            "final_residual": res_b.final_residual,
            "true_residual": true_rel_b,
            "solve_s": t4 - t3,
            "ms_per_iteration": (t4 - t3) / max(res_b.iterations, 1) * 1e3,
        },
        "matmat_rel_err": mm_rel,
        "launches": launches,
    }
    ctx["details"]["solve"] = summary
    log("[solve] " + json.dumps(summary))
    matvecs = res.matvecs + res_b.matvecs
    checks = {
        "cg converged": res.converged,
        "bicgstab converged": res_b.converged,
        "one plan miss in the CG solve": stats.plan_misses == 1,
        "CG true residual <= 1e-5": true_rel <= 1e-5,
        "BiCGStab true residual <= 1e-5": true_rel_b <= 1e-5,
        "matmat agrees with float64 (1e-5)": mm_rel <= 1e-5,
        f"spmv_ell launches {launches['spmv_ell']} >= 2 x {matvecs} matvecs":
            launches["spmv_ell"] >= 2 * matvecs,
        "spmm_ell launched": launches["spmm_ell"] >= 2,
    }
    for name, ok in checks.items():
        log(f"[solve] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("main path failed: " + ", ".join(k for k, ok in checks.items() if not ok))
    ctx.setdefault("launches", {}).update(launches)
    ctx.update(op=op, b=b)


def phase_profile(ctx) -> None:
    """Where a CG iteration's time goes (outside the main path's counts):
    host wall per iteration, barrier and overlapped, and the device time by
    kernel from ``torch.profiler`` over ten iterations."""
    import torch

    from repro_torch.solve import cg
    from repro_torch.sparse import DistributedSpMV

    op, b, iters = ctx["op"], ctx["b"], 10
    wall = {}
    for overlap in (False, True):
        run = op if not overlap else DistributedSpMV(ctx["part"], strategy=op.strategy, overlap=True)
        cg(run, b, tol=0.0, maxiter=2)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(run, b, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
        wall["overlap" if overlap else "barrier"] = (time.perf_counter() - t0) / res.iterations * 1e3

    device_ms, top = device_profile(lambda: cg(op, b, tol=0.0, maxiter=iters), iters)
    summary = {
        "strategy": op.strategy,
        "wall_ms_per_iteration": wall,
        "device_ms_per_iteration": device_ms,
        "device_busy_share": device_ms / wall["barrier"],
        "top_kernels": top,
    }
    ctx["details"]["profile"] = summary
    log("[profile] " + json.dumps(summary))


def wire_payload(shape, seed: int) -> np.ndarray:
    """A halo payload for the codecs: values over many binades, and in each
    rank's first and last grid rows (the rows its neighbours receive) an
    inf, a nan, a -inf and a value beyond float16's range."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
    x[:, 5], x[:, 17], x[:, 29], x[:, -7] = np.inf, np.nan, 7e4, -np.inf
    return x


def phase_faults(ctx) -> None:
    """The exchange's wire codecs, integrity checks, fault injection and
    recovery ladder on the card at the case study's size (1,048,576 rows,
    16 ranks), held against the host oracle ``execute_numpy``; CG with the
    int8 wire, with checks, and through injected faults."""
    import torch
    from repro_torch.comm import (
        WIRE_CODECS,
        ExchangeIntegrityError,
        FaultPlan,
        FaultSpec,
        IrregularExchange,
        execute_numpy,
        merge_split_phase,
        split_phase,
    )
    from repro_torch.solve import cg
    from repro_torch.sparse import DistributedSpMV

    A, part, topo = ctx["A"], ctx["part"], ctx["topo"]
    g, L = topo.nranks, part.rows_per_rank
    local = wire_payload((g, L), SEED + 8)
    dev_local = torch.as_tensor(local, device="cuda")
    sp = split_phase(part.pattern)
    timer = Timer(torch)
    summary = {"exchange": [], "detection": [], "cg": {}}
    failures = []

    # 1-2. every strategy x codec, barrier and split-phase, bitwise the
    # oracle (on a payload with non-finite and out-of-range values); checked
    # on a normal payload, clean: no violation, codec none included
    normal = np.random.default_rng(SEED + 12).normal(size=(g, L)).astype(np.float32)
    dev_normal = torch.as_tensor(normal, device="cuda")

    def oracle(ex, x, codec):
        remote, local_ex, _ = ex._two_phase
        split = merge_split_phase(
            sp, execute_numpy(local_ex.plan, x), execute_numpy(remote.plan, x, codec)
        )
        return execute_numpy(ex.plan, x, codec), split

    for strat in STRATEGIES:
        for codec in WIRE_CODECS:
            ex = IrregularExchange(part.pattern, strat, wire=codec)
            checked = IrregularExchange(part.pattern, strat, wire=codec, verify=True)
            got = ex(dev_local).cpu().numpy()
            split = ex.start(dev_local).finish().cpu().numpy()
            want, want_split = oracle(ex, local, codec)
            got_v = checked(dev_normal).cpu().numpy()
            split_v = checked.start(dev_normal).finish().cpu().numpy()
            want_v, want_split_v = oracle(ex, normal, codec)
            _, viols = checked._program.run(dev_normal, codec, verify=True)
            max_viol = float(viols.max()) if viols.numel() else float("-inf")
            ok = (
                np.array_equal(got, want, equal_nan=True)
                and np.array_equal(split, want_split, equal_nan=True)
                and np.array_equal(got_v, want_v)
                and np.array_equal(split_v, want_split_v)
                and not checked.health.failures
                and max_viol <= 0.0
            )
            row = {
                "strategy": strat, "codec": codec, "bitwise": ok, "max_violation": max_viol,
                "checked_hops": len(checked._program.hops),
                "wire_bytes_inter": ex.wire_bytes[1],
                "ms": timer.per_call(lambda: ex(dev_normal)),
                "verify_ms": timer.per_call(lambda: checked(dev_normal)),
                "split_ms": timer.per_call(lambda: ex.start(dev_normal).finish()),
            }
            summary["exchange"].append(row)
            log("[faults] exchange " + json.dumps(row))
            if not ok:
                failures.append(f"{strat}/{codec} exchange")

    # 3. seeded faults: the oracle's diagnostics, barrier and split-phase
    for strat in STRATEGIES:
        for kind, codec in (("corrupt", "none"), ("perturb", "bf16"), ("zero", "int8")):
            fp = FaultPlan(seed=SEED + 9, specs=(FaultSpec(kind=kind, prob=0.5),))
            ex = IrregularExchange(part.pattern, strat, wire=codec, verify=True, faults=fp,
                                   max_retries=0, fallback=False)
            seen = {}
            for mode, run, plan_ in (
                ("barrier", lambda: ex(dev_normal), ex.plan),
                ("split", lambda: ex.start(dev_normal).finish(), None),
            ):
                try:
                    run()
                    got = None
                except ExchangeIntegrityError as e:
                    got = e.diagnostics()
                plan_ = plan_ if plan_ is not None else ex._two_phase[0].plan
                try:
                    execute_numpy(plan_, normal, codec, faults=fp, verify=True)
                    want = None
                except ExchangeIntegrityError as e:
                    want = e.diagnostics()
                seen[mode] = got is not None and got == want
            row = {"strategy": strat, "kind": kind, "codec": codec, **seen}
            summary["detection"].append(row)
            log("[faults] detection " + json.dumps(row))
            if not all(seen.values()):
                failures.append(f"{strat}/{kind}/{codec} detection")

    # 4-5. CG at 1M rows: int8 wire, verified, a transient fault recovered
    # by a retry, and a persistent lossy-codec fault cured by demotion
    strat = ctx["op"].strategy
    rng = np.random.default_rng(SEED + 10)
    b = torch.as_tensor(rng.normal(size=(g, L)).astype(np.float32), device="cuda")
    b64 = b.double().cpu().numpy().reshape(-1)
    runs = {
        "none": dict(),
        "int8": dict(wire="int8"),
        "verify": dict(verify=True),
        "retry": dict(verify=True, faults=FaultPlan(
            seed=SEED + 11, specs=(FaultSpec(kind="corrupt"),), active_calls=(0,))),
        "demote": dict(wire="int8", verify=True, faults=FaultPlan(
            seed=SEED + 11, specs=(FaultSpec(kind="corrupt", codecs=("lossy",)),))),
    }
    want_status = {
        "none": "converged", "int8": "converged", "verify": "converged",
        "retry": f"converged+exchange:retry:{strat}/none",
        "demote": f"converged+exchange:demote:{strat}/none",
    }
    results = {}
    for name, kw in runs.items():
        op = DistributedSpMV(part, strategy=strat, **kw)
        if "faults" not in kw:  # a warm-up would spend the faulted call
            cg(op, b, tol=0.0, maxiter=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(op, b, tol=TOL_SOLVE, maxiter=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        x64 = res.x.double().cpu().numpy().reshape(-1)
        true_rel = float(np.linalg.norm(b64 - csr_product64(A, x64)) / np.linalg.norm(b64))
        results[name] = res
        # the int8 halo moves the operator itself: its solution sits the
        # codec's error away from the exact one (see TOL_TRUE_INT8)
        true_tol = TOL_TRUE_INT8 if name == "int8" else 1e-5
        row = {
            "status": res.status, "iterations": res.iterations, "final_residual": res.final_residual,
            "true_residual": true_rel, "true_tol": true_tol,
            "ms_per_iteration": wall / max(res.iterations, 1) * 1e3,
            "recoveries": op.health.recovery_count if op.health is not None else 0,
        }
        summary["cg"][name] = row
        log(f"[faults] cg {name}: " + json.dumps(row))
        if not (res.converged and res.status == want_status[name] and true_rel <= true_tol):
            failures.append(f"cg {name}")
    # a recovered solve is the clean one: after the retry (or with every
    # halo demoted to "none") each halo is exact
    same = (results["retry"].residuals == results["none"].residuals
            and results["demote"].residuals == results["none"].residuals
            and results["verify"].residuals == results["none"].residuals)
    log(f"[faults] recovered / verified CG residual histories == clean: {same}")
    if not same:
        failures.append("recovered histories")
    ctx["details"]["faults"] = summary
    if failures:
        raise AssertionError("faults phase failed: " + ", ".join(failures))


#: the fixed horizon of the fused-vs-host timings (tol = 0: no early exit)
FUSED_TIMED_ITERS = 200
#: block sizes timed beside the fused solver's own (``repro_torch.solve.fused.U``),
#: each on the main path's converging solves and on the fixed horizon
FUSED_BLOCK_SWEEP = (1, 2, 4, 8, 16, 32)
#: interleaved rounds of the block sweep (the median is kept)
FUSED_SWEEP_ROUNDS = 5
#: fused residual histories against the host loop's, relative
TOL_FUSED_HIST = 1e-10

#: the serving simulator's seeded case (small random patterns, a burst trace
#: and a fault storm) and its trace hash, which the CPU tests pin to the
#: reference's ``simulate`` on the same case
SIM_SEED = 11
SIM_TRACE_HASH = "c2105ef2ef531b4fcd9f35f6dfb7d8af205be013"


def sim_case(comm, serving, testing):
    """The simulator case through the given package (the port's here; the
    CPU tests pass the reference's too): 4 classes of random patterns on 2
    pods of 4, 200 burst arrivals, a perturb/corrupt/slow storm."""
    topo = comm.PodTopology(npods=2, ppn=4)
    classes = {
        f"c{i}": serving.WorkloadClass.from_pattern(
            comm.random_pattern(np.random.default_rng(100 + i), topo, local_size=32, max_elems=4),
            fp=f"c{i}")
        for i in range(4)
    }
    trace = testing.make_trace(SIM_SEED, 200, sorted(classes), pattern="burst", rate=50000.0,
                               skew=1.2, burst=16)
    storm = comm.FaultPlan(seed=SIM_SEED, specs=(
        comm.FaultSpec(kind="perturb", prob=0.3, frac=0.1, strategies=("two_step",)),
        comm.FaultSpec(kind="corrupt", prob=0.1, codecs=("lossy",)),
        comm.FaultSpec(kind="slow", prob=0.1, delay_s=2e-3),
    ))
    return serving.simulate(classes, trace, serving.SimConfig(
        window=1e-3, max_width=8, chaos=storm, deadline_s=0.05, strategy="two_step"))


def fused_profile() -> dict:
    """The fused CG's profiled solve (``python3 chip_smoke.py --fused-profile
    OUT``, a process of its own): the case study's operator with the
    advisor's strategy, one warm-up solve of ``FUSED_TIMED_ITERS`` iterations
    (it captures), then the same solve under ``torch.profiler``: its wall and
    device ms per iteration, busy share, top kernels, and B1's kernels in the
    trace beside the launches counted from the graph replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm import PodTopology
    from repro_torch.kernels.spmv_ell import spmv_ell
    from repro_torch.solve import fused_cg, spd_system
    from repro_torch.solve import fused as F
    from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like

    topo = PodTopology(npods=NPODS, ppn=PPN)
    part = partition_csr(spd_system(thermal_like(SIDE * SIDE, np.random.default_rng(SEED))), topo)
    op = DistributedSpMV(part, strategy="auto")
    rng = np.random.default_rng(SEED + 13)
    b = torch.as_tensor(rng.normal(size=(topo.nranks, part.rows_per_rank)).astype(np.float32), device="cuda")
    fused_cg(op, b, tol=0.0, maxiter=FUSED_TIMED_ITERS)  # warm-up and capture
    torch.cuda.synchronize()

    # the launch count derived from the replays, held to the profiler's
    # count of B1 kernels in the same solve
    spmv_ell.launches = 0
    F.graph_launches.update(spmv_ell=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = fused_cg(op, b, tol=0.0, maxiter=FUSED_TIMED_ITERS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    device_ms = sum(us for _, us in events.values()) / 1e3
    return {
        "strategy": op.strategy,
        "iterations": r.iterations,
        "wall_ms_per_iteration": wall / r.iterations,
        "device_ms_per_iteration": device_ms / r.iterations,
        "device_busy_share": device_ms / wall,
        "b1_kernels_in_trace": sum(count for name, (count, _) in events.items() if "spmv_ell" in name),
        "b1_launches_counted": spmv_ell.launches + F.graph_launches["spmv_ell"],
        "top_kernels": [
            {"name": name[:80], "calls_per_iteration": count / r.iterations, "us_per_iteration": us / r.iterations}
            for name, (count, us) in sorted(events.items(), key=lambda kv: -kv[1][1])[:10]
        ],
    }


def start_fused_profile(ctx) -> None:
    """Start :func:`fused_profile` in a child process (``python3
    chip_smoke.py --fused-profile OUT``), unless it runs already; its output
    goes to files, and a child still running when this script exits is
    killed then."""
    import atexit
    import tempfile

    if "fused_profile_child" in ctx:
        return
    out = os.path.join(HERE, "chiprun_out", "fused_profile.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
    files = [tempfile.TemporaryFile("w+") for _ in range(2)]
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fused-profile", out], stdout=files[0],
                            stderr=files[1], text=True, cwd=HERE, env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    ctx["fused_profile_child"] = {"proc": proc, "files": files, "out": out, "t0": time.perf_counter()}


def phase_fused_profile(ctx) -> None:
    """:func:`fused_profile` in a child process, started beside the build
    (:func:`start_fused_profile`, from phase build), before any other
    process has used the card: after many graph replays, or with
    other processes on the card before it, a profiler in one process has
    recorded no device activity or lost B1 records (ROADMAP §C).  The B1
    kernels in its trace must equal the launches counted from the replays,
    exactly."""
    start_fused_profile(ctx)
    child = ctx.pop("fused_profile_child")
    proc = child["proc"]
    stdout, stderr = _finish_child(proc, child["files"], timeout_s=600.0)
    if proc.returncode != 0:
        raise AssertionError(f"fused_profile: exit {proc.returncode}\n{stdout[-2000:]}\n{stderr[-3000:]}")
    with open(child["out"]) as f:
        prof = json.load(f)
    prof["child_s"] = time.perf_counter() - child["t0"]
    ctx["fused_profile"] = prof
    log("[fused_profile] " + json.dumps(prof))
    if prof["b1_kernels_in_trace"] == 0:
        raise AssertionError("fused_profile: the profiler recorded no B1 kernel")
    if prof["b1_kernels_in_trace"] != prof["b1_launches_counted"]:
        raise AssertionError(f"fused_profile: B1 kernels in the trace {prof['b1_kernels_in_trace']} != "
                             f"launches counted from the replays {prof['b1_launches_counted']}")


def phase_fused(ctx) -> None:
    """The whole-solve CG/BiCGStab as replayed CUDA graphs at the case
    study's size, against the host loops on the same operators (the
    profiled solve is ``fused_profile``'s, in a process of its own)."""
    import torch

    from repro_torch.comm import (
        ExchangeIntegrityError,
        FaultPlan,
        FaultSpec,
        cache_stats,
        clear_caches,
    )
    from repro_torch.kernels.spmv_ell import spmv_ell
    from repro_torch.solve import bicgstab, cg, fused_bicgstab, fused_cg
    from repro_torch.solve import fused as F
    from repro_torch.sparse import DistributedSpMV

    A, B, part, part_b, topo = ctx["A"], ctx["B"], ctx["part"], ctx["part_b"], ctx["topo"]
    strat = ctx["op"].strategy
    g, L = topo.nranks, part.rows_per_rank
    rng = np.random.default_rng(SEED + 13)
    b = torch.as_tensor(rng.normal(size=(g, L)).astype(np.float32), device="cuda")
    b2 = torch.as_tensor(rng.normal(size=(g, L)).astype(np.float32), device="cuda")
    op = DistributedSpMV(part, strategy=strat)
    op_b = DistributedSpMV(part_b, strategy="auto")
    clear_caches()
    torch.cuda.synchronize()
    failures = []
    summary = {"strategy": strat, "block": F.U}

    # ---- the main path: counts reset just before, read just after ----
    spmv_ell.launches = 0
    F.graph_launches.update(spmv_ell=0)
    t0 = time.perf_counter()
    f = fused_cg(op, b, tol=TOL_SOLVE, maxiter=1000)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reads = {"cg": F.host_reads}
    first = cache_stats()
    f_again = fused_cg(op, b, tol=TOL_SOLVE, maxiter=1000)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    second = cache_stats()
    fb = fused_bicgstab(op_b, b2, tol=TOL_SOLVE, maxiter=1000)
    torch.cuda.synchronize()
    reads["bicgstab"] = F.host_reads
    launches = spmv_ell.launches + F.graph_launches["spmv_ell"]
    main_replays = F.graph_launches["spmv_ell"]
    # ---- end of the main path ----
    log(f"[fused] B1 launches {launches}: {spmv_ell.launches} eager (warm-ups), "
        f"{main_replays} by graph replays (captured per graph x replays)")

    def rel_hist(a, c):
        return max(abs(x - y) / max(abs(y), 1e-300) for x, y in zip(a.residuals, c.residuals))

    def true_res(M, bb, res):
        x64 = res.x.double().cpu().numpy().reshape(-1)
        b64 = bb.double().cpu().numpy().reshape(-1)
        return float(np.linalg.norm(b64 - csr_product64(M, x64)) / np.linalg.norm(b64))

    h = cg(op, b, tol=TOL_SOLVE, maxiter=1000)
    hb = bicgstab(op_b, b2, tol=TOL_SOLVE, maxiter=1000)
    for name, fused, host, M, bb in (("cg", f, h, A, b), ("bicgstab", fb, hb, B, b2)):
        row = {
            "status": fused.status, "iterations": fused.iterations, "matvecs": fused.matvecs,
            "restarts": fused.restarts, "host": [host.status, host.iterations, host.matvecs],
            "hist_rel_diff": rel_hist(fused, host), "bitwise": fused.residuals == host.residuals,
            "x_bitwise": bool(torch.equal(fused.x, host.x)), "true_residual": true_res(M, bb, fused),
            "host_reads": reads[name],
            "host_read_bound": math.ceil(fused.iterations / F.U) + F.HOST_READ_SLACK,
        }
        summary[name] = row
        log(f"[fused] {name} vs host loop: " + json.dumps(row))
        same = (fused.status, fused.iterations, fused.matvecs, fused.restarts) == (
            host.status, host.iterations, host.matvecs, host.restarts)
        if not (fused.converged and same and row["hist_rel_diff"] <= TOL_FUSED_HIST
                and row["true_residual"] <= 1e-5 and row["host_reads"] <= row["host_read_bound"]):
            failures.append(f"{name} vs host loop")
    summary["cache"] = {"first": [first.fused_misses, first.fused_hits],
                        "second": [second.fused_misses, second.fused_hits]}
    # the first solve warms up and captures; the second replays
    summary["cg"].update(first_solve_s=t1 - t0, second_solve_s=t2 - t1)
    log(f"[fused] CG wall: first solve (warm-up and capture) {t1 - t0:.4f} s, "
        f"second {t2 - t1:.4f} s ({(t2 - t1) / f.iterations * 1e3:.4f} ms/iteration)")
    if (first.fused_misses, first.fused_hits, second.fused_misses, second.fused_hits) != (1, 0, 1, 1) \
            or f_again.residuals != f.residuals:
        failures.append("fused cache: one miss then a hit")

    # graph replay against the same program run eagerly on the card
    eager = F._fused_solve(op, b, None, TOL_SOLVE, 1000, None, "cg", capture=False)
    summary["graph_equals_eager"] = eager.residuals == f.residuals and bool(torch.equal(eager.x, f.x))
    if not summary["graph_equals_eager"]:
        failures.append("graph vs eager body")

    # bitwise across strategies x barrier/overlap
    across = {}
    for s in STRATEGIES:
        for overlap in (False, True):
            r = fused_cg(DistributedSpMV(part, strategy=s, overlap=overlap), b, tol=TOL_SOLVE,
                         maxiter=1000)
            across[f"{s}/{'split' if overlap else 'barrier'}"] = (
                r.residuals == f.residuals and bool(torch.equal(r.x, f.x)))
    summary["across_strategies"] = across
    log("[fused] histories bitwise across strategies x overlap: " + json.dumps(across))
    if not all(across.values()):
        failures.append("strategies x overlap")

    # a persistent fault under checks: the host path's error fields
    persistent = FaultPlan(seed=SEED + 15, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),))
    errs = {}
    for name, solve in (("host", cg), ("fused", fused_cg)):
        bad = DistributedSpMV(part, strategy=strat, verify=True, faults=persistent)
        bad.exchange.max_retries, bad.exchange.fallback = 0, False
        try:
            solve(bad, b, tol=TOL_SOLVE, maxiter=50)
            errs[name] = None
        except ExchangeIntegrityError as e:
            errs[name] = {k: getattr(e, k) for k in
                          ("strategy", "codec", "stage_kind", "op_index", "round_index")}
    summary["integrity_error"] = errs
    log("[fused] integrity error fields: " + json.dumps(errs))
    if errs["fused"] is None or errs["fused"] != errs["host"]:
        failures.append("integrity error fields")

    # a transient fault under checkpoint_every=5 on the configured strategy:
    # the ladder resumes the fused solve from the checkpoint (a retry meets
    # the same call again; the re-advised strategy does not), so the history
    # is the clean one
    transient = FaultPlan(seed=SEED + 16, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0,
                                                           strategies=(strat,)),),
                          active_calls=(7,))
    clean = fused_cg(DistributedSpMV(part, strategy=strat, verify=True), b, tol=TOL_SOLVE, maxiter=1000)
    res = fused_cg(DistributedSpMV(part, strategy=strat, verify=True, faults=transient), b,
                   tol=TOL_SOLVE, maxiter=1000, checkpoint_every=5)
    summary["resume"] = {"status": res.status, "iterations": res.iterations,
                         "history_equals_clean": res.residuals == clean.residuals}
    log("[fused] resume: " + json.dumps(summary["resume"]))
    if not (res.converged and "+resume:1" in res.status and res.residuals == clean.residuals):
        failures.append("resume")

    # timings: a fixed horizon, fused and host loop, per wire; then the
    # block sweep and the fused solve's device busy share
    timings = {}
    for name, kw in (("none", {}), ("int8", dict(wire="int8")), ("verify", dict(verify=True))):
        o = DistributedSpMV(part, strategy=strat, **kw)
        row = {}
        for path, run in (
            ("host", lambda: cg(o, b, tol=0.0, maxiter=FUSED_TIMED_ITERS)),
            ("fused", lambda: fused_cg(o, b, tol=0.0, maxiter=FUSED_TIMED_ITERS)),
        ):
            run()  # warm-up (and capture)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run()
            torch.cuda.synchronize()
            row[f"{path}_ms_per_iteration"] = (time.perf_counter() - t0) / r.iterations * 1e3
            row[f"{path}_iterations"] = r.iterations
        timings[name] = row
        log(f"[fused] {FUSED_TIMED_ITERS} iterations, wire {name}: " + json.dumps(row))
    if not timings["none"]["fused_ms_per_iteration"] < timings["none"]["host_ms_per_iteration"]:
        failures.append("fused ms/iteration not below the host loop's")
    # the block sweep: U patched module-wide (it is part of the cache key),
    # each block size on the main path's converging solves and on the fixed
    # horizon, in interleaved rounds
    cases = {
        "cg_converging": lambda: fused_cg(op, b, tol=TOL_SOLVE, maxiter=1000),
        "bicgstab_converging": lambda: fused_bicgstab(op_b, b2, tol=TOL_SOLVE, maxiter=1000),
        f"cg_{FUSED_TIMED_ITERS}": lambda: fused_cg(op, b, tol=0.0, maxiter=FUSED_TIMED_ITERS),
    }
    own_u = F.U
    times = {(u, c): [] for u in FUSED_BLOCK_SWEEP for c in cases}
    sweep = {u: {} for u in FUSED_BLOCK_SWEEP}
    try:
        for rnd in range(FUSED_SWEEP_ROUNDS + 1):  # round 0 captures
            for u in FUSED_BLOCK_SWEEP:
                F.U = u
                for c, run in cases.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = run()
                    torch.cuda.synchronize()
                    if rnd:
                        times[(u, c)].append((time.perf_counter() - t0) * 1e3)
                    sweep[u][c] = {"iterations": r.iterations, "host_reads": F.host_reads,
                                   "history": r.residuals}
    finally:
        F.U = own_u
    for u in FUSED_BLOCK_SWEEP:
        for c in cases:
            row = sweep[u][c]
            row["ms_per_solve"] = float(np.median(times[(u, c)]))
            row["ms_per_iteration"] = row["ms_per_solve"] / row["iterations"]
            row["same_history"] = row["history"] == sweep[FUSED_BLOCK_SWEEP[0]][c]["history"]
    for per_u in sweep.values():
        for row in per_u.values():
            del row["history"]
    timings["block_sweep"] = sweep
    log(f"[fused] block sweep (median of {FUSED_SWEEP_ROUNDS} interleaved rounds): " + json.dumps(sweep))
    if not all(row["same_history"] for per_u in sweep.values() for row in per_u.values()):
        failures.append("block sweep: a block size changed a history")

    # the profiled solve ran in a process of its own right after the build
    # (phase fused_profile): its operator's strategy is this one's
    timings["profile"] = ctx["fused_profile"]
    if timings["profile"]["strategy"] != strat:
        failures.append(f"the profiled solve ran {timings['profile']['strategy']}, not {strat}")
    summary["timings"] = timings
    ctx["details"]["fused"] = summary
    ctx["launches"]["spmv_ell"] += launches
    summary["launches"] = {"spmv_ell": launches, "by_graph_replays": main_replays}
    if failures:
        raise AssertionError("fused phase failed: " + ", ".join(failures))


def phase_serving(ctx) -> None:
    """The serving executor on the case study's operators: coalesced vs
    sequential replay, and a simulated schedule drained through ``matmat``
    (kernel B2) under seeded faults."""
    import torch

    from repro_torch import comm, serving, testing
    from repro_torch.comm import FaultPlan, FaultSpec, HealthTracker
    from repro_torch.kernels.spmv_ell import spmm_ell
    from repro_torch.serving import (
        Batch,
        BatchExecutor,
        SimConfig,
        WorkloadClass,
        measure_spmv_replay,
        simulate,
    )
    from repro_torch.sparse import DistributedSpMV
    from repro_torch.testing import make_trace

    part, part_b, topo = ctx["part"], ctx["part_b"], ctx["topo"]
    strat = ctx["op"].strategy
    g, L = topo.nranks, part.rows_per_rank
    failures = []
    summary = {}

    replay = measure_spmv_replay(DistributedSpMV(part, strategy=strat), 64, MM_COLS,
                                 np.random.default_rng(SEED + 17), repeats=3)
    summary["replay"] = replay
    log("[serving] measure_spmv_replay: " + json.dumps(replay))
    if replay["parity"] != 0.0:
        failures.append("coalesced != sequential")

    # a schedule from the simulator, drained under a seeded fault plan: the
    # configured strategy's exchange fails its checks on some calls and the
    # executor's ladder (not the exchange's) recovers the batch
    parts = {"cg": part, "bicgstab": part_b}
    classes = {fp: WorkloadClass.from_pattern(p.pattern, fp=fp) for fp, p in parts.items()}
    trace = make_trace(SEED + 18, 48, sorted(classes), pattern="burst", rate=20000.0, burst=8)
    sim = simulate(classes, trace, SimConfig(max_width=MM_COLS, strategy=strat))
    faults = FaultPlan(seed=SEED + 19, specs=(FaultSpec(kind="corrupt", strategies=(strat,)),),
                       active_calls=(1, 4, 5))
    plain = {fp: DistributedSpMV(p, strategy=strat) for fp, p in parts.items()}
    health = HealthTracker()
    ex = BatchExecutor(health=health)
    variants = {}

    def family(fp):
        def make(strategy, wire):
            key = (fp, strategy, wire)
            if key not in variants:
                v = DistributedSpMV(parts[fp], strategy=strategy, wire=wire, verify=True,
                                    faults=faults, health=health)
                v.exchange.max_retries, v.exchange.fallback = 0, False
                variants[key] = v
            return variants[key].matmat
        return make

    for fp in classes:
        ex.register_variants(fp, family(fp))
    by_rid = {r.rid: r for r in trace}
    rng = np.random.default_rng(SEED + 20)
    batches, payloads = [], []
    for ev in sim.events:
        if ev[0] == "dispatch":
            _, _, fp, width, key, rids = ev
            batches.append(Batch(fp=fp, requests=tuple(by_rid[r] for r in rids), payload_width=width,
                                 resident_bytes=classes[fp].bytes_per_request * width,
                                 strategy=strat, wire="none", key=key, predicted_time=0.0,
                                 kind="spmv"))
            payloads.append(torch.as_tensor(rng.normal(size=(g, L, width)).astype(np.float32),
                                            device="cuda"))
    torch.cuda.synchronize()
    # ---- the main path: counts reset just before, read just after ----
    spmm_ell.launches = 0
    t0 = time.perf_counter()
    outcomes = ex.run_schedule(batches, payloads)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = spmm_ell.launches
    # ---- end of the main path ----
    completed = sum(o.batch.width for o in outcomes if o.ok)
    shed = sum(len(o.shed_rids) for o in outcomes if not o.ok)
    exact = all(torch.equal(o.value, plain[o.batch.fp].matmat(V))
                for o, V in zip(outcomes, payloads) if o.ok)
    # every completed batch against the plain product: the unpartitioned
    # matrix in float64 CSR on the card, error relative to |A| |V|
    def csr64(M, absolute):
        data = np.abs(M.data) if absolute else M.data
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "CSR support is in beta"
            return torch.sparse_csr_tensor(
                torch.as_tensor(M.indptr, dtype=torch.int64), torch.as_tensor(M.indices, dtype=torch.int64),
                torch.as_tensor(data, dtype=torch.float64), size=(M.n, M.n), device="cuda")

    mats = {fp: (csr64(M, False), csr64(M, True)) for fp, M in (("cg", ctx["A"]), ("bicgstab", ctx["B"]))}
    rel = 0.0
    for o, V in zip(outcomes, payloads):
        if o.ok:
            S, S_abs = mats[o.batch.fp]
            V64 = V.reshape(-1, o.batch.width).double()
            err = (o.value.reshape(V64.shape).double() - S @ V64).abs() / (S_abs @ V64.abs() + 1e-30)
            rel = max(rel, float(err.max()))
    drain = {
        "batches": len(outcomes), "admitted": sim.completed, "completed": completed, "shed": shed,
        "recoveries": [o.recovery for o in outcomes if o.recovery],
        "attempts": sum(o.attempts for o in outcomes), "results_equal_matmat": exact,
        "widths": sorted({o.batch.width for o in outcomes}), "max_rel_err_vs_csr64": rel,
        "drain_s": drain_s, "spmm_ell_launches": launches,
    }
    summary["drain"] = drain
    log("[serving] run_schedule: " + json.dumps(drain))
    outcome_ok = all((o.ok and not o.shed_rids) or (not o.ok and o.shed_rids ==
                     tuple(r.rid for r in o.batch.requests)) for o in outcomes)
    if not (outcome_ok and completed + shed == sim.completed and exact and rel <= TOL_SPMV
            and drain["recoveries"] and len(outcomes) == sim.batches):
        failures.append("drained schedule")

    got = sim_case(comm, serving, testing)
    summary["trace_hash"] = got.trace_hash
    log(f"[serving] simulate() trace_hash for seed {SIM_SEED}: {got.trace_hash} "
        f"(expected {SIM_TRACE_HASH}); {got.fault_events} faults, {got.recoveries} recoveries")
    if got.trace_hash != SIM_TRACE_HASH:
        failures.append("trace hash")
    ctx["details"]["serving"] = summary
    ctx["launches"]["spmm_ell"] += launches
    if failures:
        raise AssertionError("serving phase failed: " + ", ".join(failures))


def serve_b3_shapes() -> dict:
    """kernels-line name -> (serve phase, q, k, v shapes, causal, window):
    every shape at which this slice's serve phases launch B3 on their main
    paths, from the configs -- MLA's prefill attention; whisper's encoder
    (non-causal over the frames), decoder self-attention and cross-attention
    over the frames; the vlm's self-attention and cross-attention over the
    image tokens."""
    from repro_torch.configs import get_config

    def heads(b, sq, sk, h, kv, d, dv=None):
        return (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, dv or d)

    mla, wh, vl = get_config(MLA_ARCH), get_config(WH_ARCH), get_config(VLM_ARCH)
    m, frames = mla.mla, wh.encoder.context
    mla_heads = (mla.n_heads, mla.n_heads, m.nope_head_dim + m.rope_head_dim, m.v_head_dim)
    wh_heads = (wh.n_heads, wh.n_kv_heads, wh.resolved_head_dim)
    vl_heads = (vl.n_heads, vl.n_kv_heads, vl.resolved_head_dim)
    return {
        "flash_attention_mla": ("serve_mla", *heads(MLA_BATCH, MLA_PROMPT, MLA_PROMPT, *mla_heads), True, mla.window),
        "flash_attention_whisper_encoder": ("serve_whisper", *heads(WH_BATCH, frames, frames, *wh_heads), False,
                                            wh.window),
        "flash_attention_whisper_self": ("serve_whisper", *heads(WH_BATCH, WH_PROMPT, WH_PROMPT, *wh_heads), True,
                                         wh.window),
        "flash_attention_whisper_cross": ("serve_whisper", *heads(WH_BATCH, WH_PROMPT, frames, *wh_heads), False,
                                          wh.window),
        "flash_attention_vlm_self": ("serve_vlm", *heads(VLM_BATCH, VLM_PROMPT, VLM_PROMPT, *vl_heads), True,
                                     vl.window),
        "flash_attention_vlm_cross": ("serve_vlm", *heads(VLM_BATCH, VLM_PROMPT, vl.cross_context, *vl_heads), False,
                                      vl.window),
    }


def sdpa_backends(q, k, v, causal: bool, window=None) -> dict:
    """backend -> ``scaled_dot_product_attention`` on ``q [B,Sq,H,Dqk]``,
    ``k``, ``v`` (a window, or causal with Sq != Sk, as a boolean mask)
    pinned to that backend, for each fused backend (flash, cuDNN,
    memory-efficient) that takes the shapes, dtype and mask; the math
    backend only where none does."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    Sq, Sk, mask = q.shape[1], k.shape[1], None
    if window or (causal and Sq != Sk):  # is_causal would put query 0 at key 0
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = (kpos <= qpos) | (not causal)
        if window:
            mask &= kpos > qpos - window
    fns = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        if backend == SDPBackend.MATH and fns:
            break

        def fn(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                                                      enable_gqa=True)

        try:
            fn()
        except RuntimeError:
            continue
        fns[backend.name.lower()] = fn
    return fns


def phase_lm_kernels(ctx) -> None:
    """B3 and B4 at the serving path's shapes (and a few others) against
    their plain versions; times of kernel, plain version and library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.ssd import ssd_chunked as ssd_plain

    cfg = get_config(LM_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    H, KV, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.window
    Hs, P, N, Q = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.chunk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    checks = ctx["details"].setdefault("lm_kernel_checks", [])

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def check(name, got, want, tol):
        """``tol`` is one number (rtol = atol) or ``(rtol, atol)``; the log
        gives the largest share of the allowance an element used."""
        rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        ok = used <= 1.0
        checks.append({"case": name, "max_abs_err": err, "rtol": rtol, "atol": atol,
                       "allowance_used": used, "ok": ok})
        log(f"[lm_kernels] {name}: max_abs_err={err:.3e} (rtol={rtol}, atol={atol}; "
            f"{used:.3f} of it used) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return err

    # ---- B3 at every shape a serving path gives it, each timed beside its
    # plain version, SDPA and the bound; then, checked only, ragged S,
    # Sq < Sk, non-causal, no window, and stablelm-3b's 80 over 32/32 heads
    # and qwen3-32b's 128 over 64/8, each with a ragged S and a window edge
    # inside a 64-key tile
    def heads(b, sq, sk, h, kv, d):
        return (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)

    slm = get_config(SLM_ARCH)
    slm_heads = (slm.n_heads, slm.n_kv_heads, slm.resolved_head_dim)
    moe = get_config(MOE_ARCH)
    moe_heads = (moe.n_heads, moe.n_kv_heads, moe.resolved_head_dim)
    attn_cases = [  # tag, q, k, v shapes, causal, window
        ("path", *heads(B, S, S, H, KV, D), True, W),
        ("ragged S=1000 window=300", *heads(2, 1000, 1000, H, KV, D), True, 300),
        ("Sq=100 < Sk=1000", *heads(2, 100, 1000, H, KV, D), True, 256),
        ("non-causal S=600", *heads(2, 600, 600, H, KV, D), False, None),
        ("causal no window S=1000", *heads(2, 1000, 1000, H, KV, D), True, None),
        ("stablelm-3b path", *heads(SLM_BATCH, SLM_PROMPT, SLM_PROMPT, *slm_heads), True, slm.window),
        ("stablelm-3b heads ragged S=1000 window=300", *heads(2, 1000, 1000, *slm_heads), True, 300),
        ("llama4-scout path", *heads(MOE_BATCH, MOE_PROMPT, MOE_PROMPT, *moe_heads), True, moe.window),
        ("qwen3-32b heads ragged S=1000 window=300", *heads(2, 1000, 1000, 64, 8, 128), True, 300),
    ]
    # tag -> its kernels-line name (None: timed, not in the line)
    timed = {"path": "flash_attention", "stablelm-3b path": "flash_attention_d80",
             "llama4-scout path": "flash_attention_d128"}
    for line, (phase, *case) in serve_b3_shapes().items():
        tag = f"{phase} {line.removeprefix('flash_attention_')}"
        attn_cases.append((tag, *case))
        timed[tag] = line
    timer = Timer(torch)
    timings = ctx.setdefault("timings", {})
    for tag, qs, ks, vs, causal, win in attn_cases:
        q32, k32, v32 = randn(*qs), randn(*ks), randn(*vs)
        for dtype, tol, peak in ((torch.float32, TOL_ATTN_F32, FP32_FLOPS),
                                 (torch.bfloat16, TOL_ATTN_BF16, BF16_TENSOR_FLOPS)):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            name = f"flash_attention {tag} {list(qs)}/{list(ks)}/{list(vs)} {dtype}".replace("torch.", "")

            def kern():
                return FA.flash_attention(q, k, v, causal=causal, window=win)

            got = kern()
            if got.dtype != dtype or got.shape != (*qs[:3], vs[3]):
                raise AssertionError(f"{name}: returned {got.dtype} {tuple(got.shape)}")
            err = check(name, got, FA.attention_ref(q.float(), k.float(), v.float(), causal=causal, window=win), tol)
            del got
            if tag not in timed:
                continue
            # the library call: SDPA on its fastest backend that takes the inputs
            libs = sdpa_backends(q, k, v, causal, win)
            lib_ms = {backend: timer(fn) for backend, fn in libs.items()}
            backend = min(lib_ms, key=lib_ms.get) if lib_ms else None
            if backend is not None:
                check(f"sdpa ({backend}) yardstick vs kernel {tag} {dtype}".replace("torch.", ""),
                      libs[backend]().transpose(1, 2), kern(),
                      TOL_ATTN_F32 if dtype == torch.float32 else TOL_SDPA_BF16)
            pairs = attention_pairs(qs[1], ks[1], causal, win) * qs[0] * qs[2]
            nbytes = q.nbytes + k.nbytes + v.nbytes + q.nbytes // qs[3] * vs[3]
            b_ms, b_by = bound(nbytes, 2 * (qs[3] + vs[3]) * pairs, peak)
            t = {
                "name": "flash_attention",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:72",
                "path": tag,
                "shape": [list(qs), list(ks), list(vs)],
                "dtype": str(dtype).replace("torch.", ""),
                "causal": causal,
                "window": win,
                "ms": timer(kern),
                "plain_ms": timer(lambda: FA.attention_ref(q, k, v, causal=causal, window=win)),
                "library_ms": lib_ms.get(backend),
                "library": f"scaled_dot_product_attention ({backend})" if backend else "none",
                "library_ms_by_backend": lib_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "max_abs_err": err,
                "visible_pairs": pairs,
            }
            log(f"[lm_kernels] flash_attention {tag} {t['dtype']}: " + json.dumps(t))
            ctx["details"].setdefault("lm_kernel_timings", []).append(t)
            if dtype == torch.bfloat16 and timed[tag]:  # the dtype the serving paths run
                timings[timed[tag]] = t
        del q32, k32, v32, q, k, v
        torch.cuda.empty_cache()

    # ---- why B3 keeps two bf16 kernels: at each row the wgmma route serves
    # (hymba's D 64, stablelm-3b's D 80, llama4-scout's and the vlm's D 128,
    # deepseek's MLA (192, 128)) the wgmma kernel the wrapper runs beside the
    # mma.sync kernel that serves the tiny presets' widths, called through
    # its own entry (not counted), each checked against the float32 plain
    # version; the wgmma kernel must be the faster
    two_routes = [("path", *heads(B, S, S, H, KV, D), True, W),
                  ("stablelm-3b path", *heads(SLM_BATCH, SLM_PROMPT, SLM_PROMPT, *slm_heads), True, slm.window),
                  ("llama4-scout path", *heads(MOE_BATCH, MOE_PROMPT, MOE_PROMPT, *moe_heads), True, moe.window)]
    two_routes += [(f"{phase} {line.removeprefix('flash_attention_')}", *case)
                   for line, (phase, *case) in serve_b3_shapes().items() if phase in ("serve_mla", "serve_vlm")]
    routes = ctx["details"].setdefault("flash_attention_routes", {})
    for tag, qs, ks, vs, causal, win in two_routes:
        if FA.kernel_route(qs[3], vs[3], torch.bfloat16) != "wgmma":
            raise AssertionError(f"{tag}: bf16 at ({qs[3]}, {vs[3]}) does not take the wgmma route")
        q, k, v = randn(*qs).bfloat16(), randn(*ks).bfloat16(), randn(*vs).bfloat16()
        want = FA.attention_ref(q.float(), k.float(), v.float(), causal=causal, window=win)
        shape = f"{list(qs)}/{list(ks)}/{list(vs)}"
        errs = {route: check(f"flash_attention {route} kernel {tag} {shape} bfloat16", fn(q, k, v, causal=causal,
                                                                                            window=win), want,
                             TOL_ATTN_BF16)
                for route, fn in (("wgmma", FA.flash_attention), ("mma.sync", FA.flash_attention_mma))}
        del want
        torch.cuda.empty_cache()
        t = {
            "shape": [list(qs), list(ks), list(vs)], "dtype": "bfloat16", "causal": causal, "window": win,
            "wgmma_ms": timer(lambda: FA.flash_attention(q, k, v, causal=causal, window=win)),
            "mma_sync_ms": timer(lambda: FA.flash_attention_mma(q, k, v, causal=causal, window=win)),
            "max_abs_err": errs,
        }
        log(f"[lm_kernels] flash_attention bf16 wgmma vs mma.sync, {tag}: " + json.dumps(t))
        routes[tag] = t
        del q, k, v
        torch.cuda.empty_cache()
    slower = [tag for tag, t in routes.items() if t["wgmma_ms"] >= t["mma_sync_ms"]]
    if slower:
        raise AssertionError(f"the wgmma route is not faster than mma.sync at {slower}")

    # ---- B3 at qwen3-32b's heads (64/8, D 128), S 4096, causal, no window,
    # beside SDPA (is_causal: its flash route), for the record
    q, k, v = (randn(1, S, h, 128).bfloat16() for h in (64, 8, 8))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    t = {
        "shape": [[1, S, 64, 128], [1, S, 8, 128]], "dtype": "bfloat16", "causal": True,
        "ms": timer(lambda: FA.flash_attention(q, k, v, causal=True)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": bound(2 * q.nbytes + k.nbytes + v.nbytes,
                          4 * 128 * attention_pairs(S, S, True, None) * 64, BF16_TENSOR_FLOPS)[0],
    }
    log("[lm_kernels] flash_attention D=128 S=4096 causal bf16: " + json.dumps(t))
    ctx["details"].setdefault("extra_timings", {})["flash_attention D=128 S=4096 causal"] = t
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # ---- B4: the path's shapes against the chunked plain version and the
    # sequential oracle, chunk invariance, and a ragged S
    def ssd_inputs(b, s):
        return (randn(b, s, Hs, P), (-torch.rand((b, s, Hs), generator=gen, device="cuda") * 0.2),
                randn(b, s, N), randn(b, s, N))

    x, loga, bb, cc = ssd_inputs(B, S)
    y = SSD.ssd_chunked(x, loga, bb, cc, Q)
    err = check(f"ssd_chunked path [{B},{S},{Hs},{P}] N={N} Q={Q} vs chunked", y, ssd_plain(x, loga, bb, cc, Q), TOL_SSD)
    check("ssd_chunked path vs sequential oracle", y, SSD.ssd_scan_ref(x, loga, bb, cc), TOL_SSD_SEQ)
    check("ssd_chunked path Q=64 vs Q=128 (chunk invariance)", SSD.ssd_chunked(x, loga, bb, cc, 64), y, TOL_SSD)
    xr, lr, br, cr = ssd_inputs(2, 1000)
    check("ssd_chunked ragged S=1000 vs chunked", SSD.ssd_chunked(xr, lr, br, cr, Q), ssd_plain(xr, lr, br, cr, Q), TOL_SSD)
    nbytes = 2 * x.nbytes + loga.nbytes + bb.nbytes + cc.nbytes
    b_ms, b_by = bound(nbytes, ssd_flops(S, SSD.kernel_chunk(Q, S, P, N, x.device), Hs, P, N) * B)
    t = {
        "name": "ssd_chunked",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:57",
        "shape": [[B, S, Hs, P], [B, S, N]],
        "dtype": "float32",
        "ms": timer(lambda: SSD.ssd_chunked(x, loga, bb, cc, Q)),
        "plain_ms": timer(lambda: ssd_plain(x, loga, bb, cc, Q)),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "bound_ms": b_ms,
        "bound_by": b_by,
        "max_abs_err": err,
    }
    # one call's CUDA launches and their device time, averaged over three
    # calls in one session (outside the main path's counts)
    def three_calls():
        for _ in range(3):
            SSD.ssd_chunked(x, loga, bb, cc, Q)

    _, t["launch_profile"] = device_profile(three_calls, 3, 8)
    log("[lm_kernels] ssd_chunked path float32: " + json.dumps(t))
    ctx["details"].setdefault("lm_kernel_timings", []).append(t)
    timings["ssd_chunked"] = t


def phase_serve(ctx) -> None:
    """hymba-1.5b at full width and depth through the port's serving entry
    point: float32 checks of the kernel route against the plain route and of
    decode against the full forward, then the bfloat16 main path (counts
    reset just before, read just after), its times and memory, and the
    device's busy share over ten decode steps."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch.serve import build, generate, make_prompts

    dev = torch.device("cuda")
    B, S, G = LM_BATCH, LM_PROMPT, LM_GEN
    lap, seconds = Lap(), {}
    model, p32 = build(LM_ARCH, "full", seed=SEED, device=dev, dtype=torch.float32)
    L = model.cfg.n_layers
    prompts = torch.as_tensor(make_prompts(model.cfg.vocab_size, B, S, SEED), device=dev)
    summary = {"arch": LM_ARCH, "parameters": model.param_count(), "layers": L,
               "batch": B, "prompt": S, "gen": G, "window": model.cfg.window}
    log(f"[serve] {LM_ARCH}: {summary['parameters']:,} parameters, {L} layers, batch {B}, "
        f"prompt {S}, {G} greedy tokens")

    # ---- float32: the kernel route against the plain route ----
    FA.flash_attention.launches = SSD.ssd_chunked.launches = 0
    k_out = generate(model, p32, prompts, G, impl="kernel")
    f32_launches = (FA.flash_attention.launches, SSD.ssd_chunked.launches)
    c_out = generate(model, p32, prompts, G, impl="chunked")
    scale = k_out["logits"][0].abs().max().item()
    prefill_rel = (k_out["logits"][0] - c_out["logits"][0]).abs().max().item() / scale
    tol_abs = TOL_LOGITS * scale
    compared, tokens_ok = 0, True
    for row in range(B):
        for t in range(G):
            gap = min(
                float(torch.topk(out["logits"][t][row], 2).values.diff().abs()) for out in (k_out, c_out)
            )
            if gap < tol_abs:
                break
            if k_out["tokens"][row, t] != c_out["tokens"][row, t]:
                tokens_ok = False
                break
            compared += 1
    # decode against the full forward over the same tokens
    with torch.inference_mode():
        full = model.apply(p32, torch.cat([prompts, k_out["tokens"][:, :3]], dim=1), impl="kernel")
    decode_err, decode_ok = 0.0, True
    for t in range(3):
        got, want = k_out["logits"][t + 1], full[:, S + t].float()
        decode_err = max(decode_err, (got - want).abs().max().item())
        decode_ok &= torch.allclose(got, want, rtol=TOL_DECODE, atol=TOL_DECODE)
    f32_finite = all(bool(torch.isfinite(lg).all()) for out in (k_out, c_out) for lg in out["logits"])
    summary["float32"] = {
        "prefill_rel_err": prefill_rel, "max_abs_logit": scale,
        "tokens_compared": compared, "tokens_equal": tokens_ok,
        "decode_vs_apply_max_abs_err": decode_err, "launches": f32_launches,
        "prefill_s": {"kernel": k_out["prefill_s"], "chunked": c_out["prefill_s"]},
    }
    del p32, k_out, c_out, full
    torch.cuda.empty_cache()
    seconds["float32_check"] = lap()

    # ---- bfloat16: the main path, counts reset just before, read just after ----
    model, p16 = build(LM_ARCH, "full", seed=SEED, device=dev)
    generate(model, p16, prompts[:, :256], 2, impl="kernel")  # warm: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = SSD.ssd_chunked.launches = 0
    out = generate(model, p16, prompts, G, impl="kernel")
    launches = {"flash_attention": FA.flash_attention.launches, "ssd_chunked": SSD.ssd_chunked.launches}
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path ----
    seconds["bfloat16_build_warm_and_main_path"] = lap()
    bf16_finite = all(bool(torch.isfinite(lg).all()) for lg in out["logits"])

    cache, token, pos = out["cache"], out["tokens"][:, -1:], S + G - 1

    def decode(n):
        nonlocal cache, pos
        with torch.inference_mode():
            for _ in range(n):
                _, cache = model.decode_step(p16, token, cache, pos)
                pos += 1

    n0 = (FA.flash_attention.launches, SSD.ssd_chunked.launches)
    decode(2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(10)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 10 * 1e3
    decode_extra = (FA.flash_attention.launches - n0[0], SSD.ssd_chunked.launches - n0[1])
    seconds["decode_timed"] = lap()
    device_ms, top = device_profile(lambda: decode(10), 10)
    seconds["decode_profiled"] = lap()
    with torch.inference_mode():
        prefill_device_ms, prefill_top = device_profile(lambda: model.prefill(p16, prompts, impl="kernel"), 1, 10)
    seconds["prefill_profiled"] = lap()
    summary["seconds"] = seconds
    summary["bfloat16"] = {
        "prefill_ms": out["prefill_s"] * 1e3,
        "prefill_tokens_per_s": B * S / out["prefill_s"],
        "decode_ms_per_token": out["decode_s"] / (G - 1) * 1e3,
        "decode_tokens_per_s": B * (G - 1) / out["decode_s"],
        "max_memory_allocated": peak,
        "launches": launches,
        "decode_profile": {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
                           "device_busy_share": device_ms / wall_ms, "top_kernels": top},
        "prefill_profile": {"device_ms": prefill_device_ms, "top_kernels": prefill_top},
        "tokens": out["tokens"][:, :8].tolist(),
    }
    ctx["details"]["serve"] = summary
    log("[serve] " + json.dumps(summary))
    checks = {
        f"float32 kernel route launched B3/B4 {f32_launches} = {L} each (one prefill, none in decode)":
            f32_launches == (L, L),
        f"bfloat16 main path launched B3/B4 {tuple(launches.values())} = {L} each":
            tuple(launches.values()) == (L, L),
        f"decode launches no B3/B4 {decode_extra}": decode_extra == (0, 0),
        f"float32 prefill logits kernel vs chunked {prefill_rel:.3e} <= {TOL_LOGITS}": prefill_rel <= TOL_LOGITS,
        f"greedy tokens equal up to the first top-2 gap under tol ({compared} compared)": tokens_ok,
        f"decode vs apply within {TOL_DECODE} (max abs err {decode_err:.3e})": bool(decode_ok),
        "every logit finite (float32 and bfloat16)": f32_finite and bf16_finite,
    }
    for name, ok in checks.items():
        log(f"[serve] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("serving path failed: " + ", ".join(k for k, ok in checks.items() if not ok))
    ctx.setdefault("launches", {}).update(launches)


def phase_serve_stablelm(ctx) -> None:
    """stablelm-3b (dense, 32 heads of 80) at full width and depth in
    bfloat16 through the serving entry point: counts reset just before, read
    just after; every B3 launch of the prefill by the wgmma route at the
    shape ``lm_kernels`` checked and timed; the prefill's device time by
    class."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch.serve import build, generate, make_prompts

    dev = torch.device("cuda")
    B, S, G = SLM_BATCH, SLM_PROMPT, SLM_GEN
    model, params = build(SLM_ARCH, "full", seed=SEED, device=dev)
    cfg, L = model.cfg, model.cfg.n_layers
    prompts = torch.as_tensor(make_prompts(cfg.vocab_size, B, S, SEED), device=dev)
    generate(model, params, prompts[:, :256], 2, impl="kernel")  # warm: cuBLAS handles, allocator
    torch.cuda.synchronize()
    FA.flash_attention.launches = SSD.ssd_chunked.launches = 0
    FA.flash_attention.by_route.clear()
    FA.flash_attention.by_shape.clear()
    out = generate(model, params, prompts, G, impl="kernel")
    launches = (FA.flash_attention.launches, SSD.ssd_chunked.launches)
    by_route = dict(FA.flash_attention.by_route)
    by_shape = {str(k): n for k, n in FA.flash_attention.by_shape.items()}
    # ---- end of the main path ----
    finite = all(bool(torch.isfinite(lg).all()) for lg in out["logits"])
    D = cfg.resolved_head_dim
    row = str(((B, S, cfg.n_heads, D), (B, S, cfg.n_kv_heads, D), (B, S, cfg.n_kv_heads, D), True, cfg.window))
    with torch.inference_mode():
        split = device_split(lambda: model.prefill(params, prompts, impl="kernel"), OP_CLASSES,
                             {"flash_attention": "flash_fwd"})
    summary = {
        "arch": SLM_ARCH, "parameters": model.param_count(), "layers": L,
        "head_pairs": sorted(model.attention_head_pairs), "batch": B, "prompt": S, "gen": G,
        "prefill_ms": out["prefill_s"] * 1e3, "decode_ms_per_token": out["decode_s"] / (G - 1) * 1e3,
        "launches": launches, "flash_attention_launches_by_route": by_route,
        "flash_attention_launches_by_shape": by_shape, "prefill_split": split,
        "tokens": out["tokens"].tolist(),
    }
    ctx["details"]["serve_stablelm"] = summary
    log("[serve_stablelm] " + json.dumps(summary))
    log(f"[serve_stablelm] prefill device split: {split['device_ms']:.3f} ms, GEMMs "
        f"{split['other_gemms'] + split['expert_gemms']:.3f}, B3 {split['flash_attention']:.3f}, "
        f"elementwise and copies {split['other']:.3f}")
    checks = {
        f"B3/B4 launches {launches} = ({L}, 0)": launches == (L, 0),
        f"every B3 launch at {sorted(model.attention_head_pairs)} went by wgmma, none by mma.sync ({by_route})":
            by_route == {"wgmma": L},
        f"every B3 launch at the shape lm_kernels checked and timed, {row} ({by_shape})": by_shape == {row: L},
        "every logit finite": finite,
    }
    for name, ok in checks.items():
        log(f"[serve_stablelm] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("stablelm-3b serving failed: " + ", ".join(k for k, ok in checks.items() if not ok))
    ctx.setdefault("launches", {})["flash_attention_d80"] = launches[0]


def phase_moe_dispatch(ctx) -> None:
    """One llama4-scout MoE layer at full width on 16 stacked ranks (one
    expert each): the exchange dispatch bitwise the all-to-all for every
    strategy on uniform and skewed routing, the int8 wire within its
    envelope, the exchange cache under a jittered skewed count stream, and a
    simulated MoE serving schedule drained through ``register_moe``; times,
    slot counts and the device-time split."""
    import torch

    from repro_torch.comm import STRATEGY_NAMES, PodTopology, cache_stats, clear_caches, exchange_for
    from repro_torch.comm import wire as W
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoELayer
    from repro_torch.models.moe_dispatch import MoEDispatcher
    from repro_torch.models.sharding import init_params
    from repro_torch.serving import Batch, BatchExecutor, SimConfig, WorkloadClass, simulate
    from repro_torch.testing import make_trace

    cfg = get_config(MOE_ARCH)
    M, E = cfg.d_model, cfg.moe.n_experts
    topo = PodTopology(npods=MOE_NPODS, ppn=MOE_PPN)
    n = topo.nranks
    B, S = MOE_DISPATCH_BATCH, MOE_DISPATCH_SEQ
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    base = MoELayer(M, cfg.moe, cfg.act)
    params = init_params(base.params(), gen, torch.bfloat16, "cuda")
    # the reference benchmark's inputs: a constant bias skews the router's
    # top-k towards a few hot experts (benchmarks/bench_moe_dispatch.py)
    bias = torch.randn((M,), generator=gen, device="cuda")
    inputs = {
        "uniform": torch.randn((B, S, M), generator=gen, device="cuda").bfloat16(),
        "skewed": (torch.randn((B, S, M), generator=gen, device="cuda") * 0.3 + bias).bfloat16(),
    }
    del bias
    _, e_local, t, cap = base._shard_shapes(B, S, topo)
    summary = {"arch": MOE_ARCH, "d_model": M, "experts": E, "d_ff_expert": cfg.moe.d_ff_expert,
               "top_k": cfg.moe.top_k, "shared": cfg.moe.n_shared, "ranks": n, "batch": [B, S],
               "capacity_per_pair": cap, "capacity_per_expert": max(int(n * cap / e_local), 1)}
    log(f"[moe_dispatch] {MOE_ARCH} layer: M {M}, {E} experts of {cfg.moe.d_ff_expert}, top-{cfg.moe.top_k}, "
        f"{n} ranks ({MOE_NPODS}x{MOE_PPN}), batch {B} x {S}, capacity {cap} per pair")
    failures = []

    # ---- (a) exchange == all_to_all bitwise, every strategy, both inputs
    results = {}
    for name, x in inputs.items():
        a2a = MoELayer(M, cfg.moe, cfg.act)
        y0 = a2a(params, x, topo)
        row = {"finite": bool(torch.isfinite(y0).all()), "all_to_all_ms": median_ms(torch, lambda: a2a(params, x, topo))}
        tally0 = a2a.tally.read()
        row["slots"] = {"routed": t * n, "dropped": tally0["dropped"] // tally0["calls"]}
        for strategy in STRATEGY_NAMES + ("auto",):
            layer = MoELayer(M, cfg.moe, cfg.act, dispatch="exchange", strategy=strategy)
            equal = torch.equal(layer(params, x, topo), y0)
            row[strategy] = {"bitwise": equal, "ms": median_ms(torch, lambda: layer(params, x, topo))}
            tally = layer.tally.read()
            row[strategy]["shipped_slots"] = tally["shipped"] // tally["calls"]
            if strategy == "auto":
                row[strategy]["picked"] = next(iter(layer.dispatcher._strategies.values()))
            if not equal:
                failures.append(f"exchange {strategy} != all_to_all on {name}")
        if not row["finite"]:
            failures.append(f"non-finite output on {name}")
        results[name] = row
        log(f"[moe_dispatch] {name}: " + json.dumps(row))
    summary["dispatch"] = results

    # ---- (b) the int8 wire: the dispatch hop within the codec's
    # per-element envelope -- half an int8 step of the block's largest
    # magnitude (bounded by the whole buffer's), with the reference wire
    # tests' 1e-6 slack for float32 rounding, plus the bf16 rounding of the
    # decoded value -- and the layer beside full precision
    lossy = {}
    for name, x in inputs.items():
        layer = MoELayer(M, cfg.moe, cfg.act, dispatch="exchange", strategy="two_step", wire="int8")
        y = layer(params, x, topo)
        y0 = MoELayer(M, cfg.moe, cfg.act)(params, x, topo)
        top_p, top_e = base.route(params, x)
        send = base._stage_send(x, top_p, top_e, n, e_local, t, cap)[0]
        bundle = layer.dispatcher.bucketer(cap).bundle
        exact = exchange_for(bundle.pattern_dispatch, "two_step", device="cuda")(send).float()
        wired = exchange_for(bundle.pattern_dispatch, "two_step", device="cuda", wire="int8")(send).float()
        step = W.REL_ERROR_BOUND["int8"] * send.float().abs().max() * (1 + 1e-6)
        envelope = step * (1 + 2.0 ** -8) + (2.0 ** -8 + 2.0 ** -22) * exact.abs()
        used = float(((wired - exact).abs() / envelope.clamp_min(1e-30)).max())
        lossy[name] = {"hop_envelope_used": used, "hop_max_abs_err": float((wired - exact).abs().max()),
                       "layer_max_abs_err": float((y.float() - y0.float()).abs().max()),
                       "layer_max_abs": float(y0.float().abs().max()), "finite": bool(torch.isfinite(y).all())}
        if used > 1.0 or not lossy[name]["finite"]:
            failures.append(f"int8 wire outside its envelope on {name}")
        del send, exact, wired, envelope
    summary["int8"] = lossy
    log("[moe_dispatch] int8 wire: " + json.dumps(lossy))

    # ---- (c) a jittered skewed count stream through MoEDispatcher: the
    # reference benchmark's stream (three hot destination ranks at 20
    # slots, +-3 jitter), at 16 ranks and this layer's capacity
    clear_caches()
    disp = MoEDispatcher(topo, strategy="auto", quantum=8, device="cuda")
    rng = np.random.default_rng(SEED + 31)
    hot = np.zeros((n, n), np.int64)
    hot[:, :3] = 20
    np.fill_diagonal(hot, 0)
    for _ in range(MOE_STREAM_BATCHES):
        disp.step(hot + rng.integers(-3, 4, size=(n, n)) * (hot > 0), cap, payload_width=M)
    st = cache_stats()
    hit_rate = st.exchange_hits / max(st.exchange_hits + st.exchange_misses, 1)
    summary["stream"] = {"batches": MOE_STREAM_BATCHES, "replans": disp.bucketer(cap).replans,
                         "bucket_hit_rate": disp.bucketer(cap).hit_rate, "exchange_hit_rate": hit_rate,
                         "exchange_hits": st.exchange_hits, "exchange_misses": st.exchange_misses,
                         "plan_misses": st.plan_misses, "strategy": next(iter(disp._strategies.values()))}
    log("[moe_dispatch] stream: " + json.dumps(summary["stream"]))
    if hit_rate < MOE_HIT_RATE:
        failures.append(f"exchange-cache hit rate {hit_rate:.3f} < {MOE_HIT_RATE}")

    # ---- (d) a simulated MoE serving schedule drained through
    # register_moe: each request one token batch of a row per rank, each
    # coalesced batch one exchange-dispatch layer call, bitwise the
    # all-to-all layer on the same stacked payload
    skew_layer = MoELayer(M, cfg.moe, cfg.act, dispatch="exchange", strategy="auto")
    skew_layer(params, inputs["skewed"], topo)
    counts = np.rint(skew_layer.dispatcher.histogram.counts).astype(np.int64)
    classes = {"moe": WorkloadClass.from_routing(counts, ppn=topo.ppn, d_model=M, fp="moe")}
    trace = make_trace(SEED + 32, MOE_SIM_REQUESTS, ["moe"], pattern="poisson", rate=2000.0, kinds={"moe": "moe"})
    sim = simulate(classes, trace, SimConfig(max_width=8))
    by_rid = {r.rid: r for r in trace}
    batches, payloads = [], []
    for ev in sim.events:
        if ev[0] == "dispatch":
            _, _, fp, width, key, rids = ev
            batches.append(Batch(fp=fp, requests=tuple(by_rid[r] for r in rids), payload_width=width,
                                 resident_bytes=classes[fp].bytes_per_request * width, strategy="auto",
                                 wire="none", key=key, predicted_time=0.0, kind="moe"))
            payloads.append(torch.randn((width * n, MOE_SIM_SEQ, M), generator=gen, device="cuda").bfloat16())
    served = MoELayer(M, cfg.moe, cfg.act, dispatch="exchange", strategy="auto")
    ex = BatchExecutor()
    ex.register_moe("moe", served, params, topo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outcomes = ex.run_schedule(batches, payloads)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    a2a = MoELayer(M, cfg.moe, cfg.act)
    exact = all(o.ok and torch.equal(o.value, a2a(params, V, topo)) for o, V in zip(outcomes, payloads))
    summary["drain"] = {"requests": MOE_SIM_REQUESTS, "batches": len(outcomes),
                        "widths": sorted({o.batch.width for o in outcomes}),
                        "completed": sum(o.batch.width for o in outcomes if o.ok),
                        "bitwise_all_to_all": exact, "drain_s": drain_s, "tally": served.tally.read()}
    log("[moe_dispatch] register_moe drain: " + json.dumps(summary["drain"]))
    if not (exact and len(outcomes) == sim.batches and summary["drain"]["completed"] == MOE_SIM_REQUESTS):
        failures.append("register_moe drain")
    del payloads, outcomes

    # ---- where one layer call's device time goes: all-to-all and exchange
    summary["profile"] = {}
    for dispatch in ("all_to_all", "exchange"):
        layer = MoELayer(M, cfg.moe, cfg.act, dispatch=dispatch, strategy="auto")
        layer(params, inputs["uniform"], topo)
        summary["profile"][dispatch] = device_split(lambda: layer(params, inputs["uniform"], topo), OP_CLASSES)
        log(f"[moe_dispatch] device split of one {dispatch} call (uniform): "
            + json.dumps(summary["profile"][dispatch]))
    ctx["details"]["moe_dispatch"] = summary
    if failures:
        raise AssertionError("moe_dispatch phase failed: " + ", ".join(failures))


def phase_serve_moe(ctx) -> None:
    """llama4-scout-17b-a16e at full width through the port's serving entry
    point, 8 of its 48 layers: a 2-layer float32 check of the kernel route
    against the plain route, then the bfloat16 main path (counts reset just
    before, read just after), its times, memory, capacity drops and prefill
    device split, and the dispatch advice, serving simulation and chaos
    storm on the served tokens."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import build, generate, make_prompts, rehome_cache, report_dispatch

    dev = torch.device("cuda")
    torch.cuda.empty_cache()

    # ---- float32, 2 layers: the kernel route against the plain route ----
    B, S, G = MOE_CHECK_BATCH, MOE_CHECK_PROMPT, MOE_CHECK_GEN
    model, p32 = build(MOE_ARCH, "full", seed=SEED, device=dev, dtype=torch.float32, layers=MOE_CHECK_LAYERS)
    prompts = torch.as_tensor(make_prompts(model.cfg.vocab_size, B, S, SEED), device=dev)
    FA.flash_attention.launches = 0
    k_out = generate(model, p32, prompts, G, impl="kernel")
    f32_launches = FA.flash_attention.launches
    c_out = generate(model, p32, prompts, G, impl="chunked")
    scale = k_out["logits"][0].abs().max().item()
    tol_abs = TOL_LOGITS * scale
    logit_err, compared, tokens_ok = 0.0, 0, True
    for t in range(G):  # every step's logits up to the first top-2 gap under tol
        gap = min(float(torch.topk(out["logits"][t], 2).values.diff().abs().min()) for out in (k_out, c_out))
        logit_err = max(logit_err, (k_out["logits"][t] - c_out["logits"][t]).abs().max().item())
        if not torch.equal(k_out["tokens"][:, t], c_out["tokens"][:, t]):
            tokens_ok = gap < tol_abs  # a flip only where the top two are within tol
            break
        compared += 1
        if gap < tol_abs:
            break
    f32 = {"layers": MOE_CHECK_LAYERS, "batch": [B, S], "gen": G, "launches": f32_launches,
           "max_abs_logit": scale, "logits_rel_err": logit_err / scale, "steps_compared": compared,
           "tokens_equal": tokens_ok, "finite": all(bool(torch.isfinite(lg).all())
                                                    for out in (k_out, c_out) for lg in out["logits"])}
    del model, p32, k_out, c_out, prompts
    torch.cuda.empty_cache()

    # ---- bfloat16, 8 layers: the main path, counts reset just before, read just after ----
    B, S, G = MOE_BATCH, MOE_PROMPT, MOE_GEN
    model, p16 = build(MOE_ARCH, "full", seed=SEED, device=dev, layers=MOE_LAYERS)
    L = model.cfg.n_layers
    moe = model.segments[0].block.moe
    prompts = torch.as_tensor(make_prompts(model.cfg.vocab_size, B, S, SEED), device=dev)
    summary = {"arch": MOE_ARCH, "parameters": model.param_count(), "layers": L,
               "layers_published": 48, "batch": B, "prompt": S, "gen": G, "float32": f32}
    log(f"[serve_moe] {MOE_ARCH}: {summary['parameters']:,} parameters in {L} of 48 layers, batch {B}, "
        f"prompt {S}, {G} greedy tokens")
    generate(model, p16, prompts[:, :256], 2, impl="kernel")  # warm: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0
    FA.flash_attention.by_route.clear()
    moe.tally.reset()
    out = generate(model, p16, prompts, G, impl="kernel")
    launches = FA.flash_attention.launches
    by_route = dict(FA.flash_attention.by_route)
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path ----
    served_tally = moe.tally.read()
    finite = all(bool(torch.isfinite(lg).all()) for lg in out["logits"])

    # 22 more decode steps (warm, timed, profiled) need a deeper cache: the
    # model has no window ring to wrap
    cache = rehome_cache(model, out["cache"], B, S + G + 24)
    token, pos = out["tokens"][:, -1:], S + G - 1

    def decode(n):
        nonlocal cache, pos
        with torch.inference_mode():
            for _ in range(n):
                _, cache = model.decode_step(p16, token, cache, pos)
                pos += 1

    decode(2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(10)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 10 * 1e3
    device_ms, top = device_profile(lambda: decode(10), 10)
    moe.tally.reset()
    with torch.inference_mode():
        split = device_split(lambda: model.prefill(p16, prompts, impl="kernel"), OP_CLASSES,
                             {"flash_attention": "flash_fwd"})
    prefill_tally = moe.tally.read()
    summary["bfloat16"] = {
        "prefill_ms": out["prefill_s"] * 1e3,
        "prefill_tokens_per_s": B * S / out["prefill_s"],
        "decode_ms_per_token": out["decode_s"] / (G - 1) * 1e3,
        "decode_tokens_per_s": B * (G - 1) / out["decode_s"],
        "max_memory_allocated": peak,
        "flash_attention_launches": launches,
        "flash_attention_launches_by_route": by_route,
        "dropped": {"prefill": prefill_tally["dropped"], "decode": served_tally["dropped"] - prefill_tally["dropped"],
                    "routed_prefill": prefill_tally["routed"],
                    "routed_decode": served_tally["routed"] - prefill_tally["routed"]},
        "decode_profile": {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
                           "device_busy_share": device_ms / wall_ms, "top_kernels": top},
        "prefill_split": split,
        "tokens": out["tokens"][:, :8].tolist(),
    }
    served = np.concatenate([prompts.cpu().numpy(), out["tokens"].cpu().numpy()], axis=1)
    del cache, out
    report = report_dispatch(p16, model.cfg, served, 2, 4, simulate_n=64, chaos=1)
    summary["dispatch"] = {
        "counts_total": int(report["counts"].sum()), "best": report["advice"].best.key,
        "speedup": report["report"]["speedup"], "trace_hash": report["storm"].trace_hash,
        "storm": {k: getattr(report["storm"], k) for k in ("completed", "shed", "fault_events", "recoveries")},
    }
    ctx["details"]["serve_moe"] = summary
    log("[serve_moe] " + json.dumps(summary))
    checks = {
        f"float32 kernel route launched B3 {f32_launches} = {MOE_CHECK_LAYERS} (one prefill, none in decode)":
            f32_launches == MOE_CHECK_LAYERS,
        f"float32 logits kernel vs chunked {f32['logits_rel_err']:.3e} <= {TOL_LOGITS} of max |logit|":
            f32["logits_rel_err"] <= TOL_LOGITS,
        f"float32 greedy tokens equal up to the first top-2 gap under tol ({compared} steps)": tokens_ok,
        f"bfloat16 main path launched B3 {launches} = {L} (one prefill, none in decode)": launches == L,
        f"every bfloat16 B3 launch at (128, 128) went by wgmma, none by mma.sync ({by_route})":
            by_route == {"wgmma": launches},
        "every logit finite (float32 and bfloat16)": finite and f32["finite"],
    }
    for name, ok in checks.items():
        log(f"[serve_moe] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("MoE serving failed: " + ", ".join(k for k, ok in checks.items() if not ok))
    ctx.setdefault("launches", {})["flash_attention_d128"] = launches


def _check_config(arch: str, check: dict):
    """The float32 full-width config of ``arch`` at ``check``'s depth (and the
    encoder's depth and the MoE capacity factor it names)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), dtype="float32", n_layers=check["layers"])
    if "encoder_layers" in check:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, n_layers=check["encoder_layers"]))
    if "capacity_factor" in check:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=check["capacity_factor"]))
    return cfg


def _b3_per_prefill(model) -> int:
    """B3 launches one kernel-route prefill makes: one per self / MLA /
    cross attention of every decoder and encoder layer."""
    return sum(s.count * (bool(s.block.self_attn) + bool(s.block.mla) + bool(s.block.cross))
               for s in model.segments + model.enc_segments)


def _moe_tally(model):
    moe = [s.block.moe for s in model.segments if s.block.moe is not None]
    return moe[0].tally if moe else None


def serve_family(ctx, tag: str, arch: str, layers, batch: int, prompt: int, gen: int, check: dict) -> None:
    """One of this slice's serving paths through the port's serving entry
    point (``build``'s model at full width and ``layers`` deep, or whole where
    that is ``None``; ``make_context``; ``generate``):

    1. float32 at ``check``'s depth: the kernel route against the plain
       route (every step's logits within 1e-3 of the largest and the greedy
       tokens equal up to the first top-2 gap under that), B3 launched once
       per attention of the prefill and never in decode, and decode against
       the full forward over the same tokens within 5e-2;
    2. the bfloat16 main path at ``layers`` (counts reset just before, read
       just after): B3 launches per prefill and none in decode, each at a
       shape of :func:`serve_b3_shapes` (which ``lm_kernels`` checked and
       timed), finite logits, its times, peak memory, capacity drops where it has MoE
       layers, the decode busy share over ten steps and the prefill's
       device time by class.
    """
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import build, generate, make_context, rehome_cache
    from repro_torch.models.lm import LMModel

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    lap, seconds = Lap(), {}

    def inputs(model, b, s):
        p, c = make_context(model.cfg.vocab_size, b, s, model.ctx_len(), model.cfg.d_model, SEED)
        return torch.as_tensor(p, device=dev), None if c is None else torch.as_tensor(c, device=dev)

    # ---- float32 at a small depth: kernel route vs plain route, decode vs apply ----
    cfg = _check_config(arch, check)
    model = LMModel(cfg)
    p32 = model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    B, S, G = check["batch"], check["prompt"], check["gen"]
    prompts, cx = inputs(model, B, S)
    tally = _moe_tally(model)
    if tally is not None:
        tally.reset()
    FA.flash_attention.launches = 0
    k_out = generate(model, p32, prompts, G, impl="kernel", ctx=cx)
    f32_launches = FA.flash_attention.launches
    f32_drops = int(tally.read()["dropped"]) if tally is not None else 0
    c_out = generate(model, p32, prompts, G, impl="chunked", ctx=cx)
    scale = k_out["logits"][0].abs().max().item()
    tol_abs = TOL_LOGITS * scale
    logit_err, compared, tokens_ok = 0.0, 0, True
    for t in range(G):  # every step's logits up to the first top-2 gap under tol
        gap = min(float(torch.topk(out["logits"][t], 2).values.diff().abs().min()) for out in (k_out, c_out))
        logit_err = max(logit_err, (k_out["logits"][t] - c_out["logits"][t]).abs().max().item())
        if not torch.equal(k_out["tokens"][:, t], c_out["tokens"][:, t]):
            tokens_ok = gap < tol_abs  # a flip only where the top two are within tol
            break
        compared += 1
        if gap < tol_abs:
            break
    with torch.inference_mode():
        full = model.apply(p32, torch.cat([prompts, k_out["tokens"][:, :3]], dim=1), cx, impl="kernel")
    decode_err = max((k_out["logits"][t + 1] - full[:, S + t].float()).abs().max().item() for t in range(3))
    decode_ok = all(torch.allclose(k_out["logits"][t + 1], full[:, S + t].float(), rtol=TOL_DECODE, atol=TOL_DECODE)
                    for t in range(3))
    f32 = {"layers": cfg.n_layers, "encoder_layers": cfg.encoder.n_layers if cfg.encoder else 0,
           "batch": [B, S], "ctx_len": model.ctx_len(), "gen": G, "launches": f32_launches,
           "launches_expected": _b3_per_prefill(model), "dropped": f32_drops,
           "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
           "max_abs_logit": scale, "logits_rel_err": logit_err / scale, "steps_compared": compared,
           "tokens_equal": tokens_ok, "decode_vs_apply_max_abs_err": decode_err, "decode_vs_apply_ok": decode_ok,
           "finite": all(bool(torch.isfinite(lg).all()) for out in (k_out, c_out) for lg in out["logits"])}
    log(f"[{tag}] float32 check: " + json.dumps(f32))
    del model, p32, k_out, c_out, full, prompts, cx
    torch.cuda.empty_cache()
    seconds["float32_check"] = lap()

    # ---- bfloat16: the main path, counts reset just before, read just after ----
    model, p16 = build(arch, "full", seed=SEED, device=dev, dtype=torch.bfloat16, layers=layers)
    cfg = model.cfg
    L = cfg.n_layers
    expected = _b3_per_prefill(model)
    prompts, cx = inputs(model, batch, prompt)
    summary = {"arch": arch, "parameters": model.param_count(), "layers": L,
               "encoder_layers": cfg.encoder.n_layers if cfg.encoder else 0, "ctx_len": model.ctx_len(),
               "head_pairs": sorted(model.attention_head_pairs), "batch": batch, "prompt": prompt, "gen": gen,
               "float32": f32, "seconds": seconds}
    seconds["bfloat16_build"] = lap()
    log(f"[{tag}] {arch}: {summary['parameters']:,} parameters, {L} layers "
        f"(+{summary['encoder_layers']} encoder), batch {batch}, prompt {prompt}, context {model.ctx_len()}, "
        f"{gen} greedy tokens")
    generate(model, p16, prompts[:, :256], 2, impl="kernel", ctx=cx)  # warm: cuBLAS handles, allocator
    tally = _moe_tally(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if tally is not None:
        tally.reset()
    FA.flash_attention.launches = 0
    FA.flash_attention.by_shape.clear()
    FA.flash_attention.by_route.clear()
    out = generate(model, p16, prompts, gen, impl="kernel", ctx=cx)
    launches = FA.flash_attention.launches
    by_shape = dict(FA.flash_attention.by_shape)
    by_route = dict(FA.flash_attention.by_route)
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path ----
    seconds["bfloat16_warm_and_main_path"] = lap()
    # B3's launches at each of this path's shapes in serve_b3_shapes
    per_shape = {line: by_shape.get(tuple(case), 0)
                 for line, (phase, *case) in serve_b3_shapes().items() if phase == tag}
    # the route each of its width pairs takes in bf16 (all wgmma on these paths)
    routes = {FA.kernel_route(qk, v, torch.bfloat16) for qk, v in model.attention_head_pairs}
    served_tally = tally.read() if tally is not None else None
    finite = all(bool(torch.isfinite(lg).all()) for lg in out["logits"])

    cache = rehome_cache(model, out["cache"], batch, prompt + gen + 24)
    token, pos = out["tokens"][:, -1:], prompt + gen - 1

    def decode(n):
        nonlocal cache, pos
        with torch.inference_mode():
            for _ in range(n):
                _, cache = model.decode_step(p16, token, cache, pos)
                pos += 1

    n0 = FA.flash_attention.launches
    decode(2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(10)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 10 * 1e3
    decode_extra = FA.flash_attention.launches - n0
    seconds["decode_timed"] = lap()
    device_ms, top = device_profile(lambda: decode(10), 10)
    seconds["decode_profiled"] = lap()
    if tally is not None:
        tally.reset()
    with torch.inference_mode():
        split = device_split(lambda: model.prefill(p16, prompts, cx, impl="kernel"), OP_CLASSES,
                             {"flash_attention": "flash_fwd"})
    seconds["prefill_profiled"] = lap()
    summary["bfloat16"] = {
        "prefill_ms": out["prefill_s"] * 1e3,
        "prefill_tokens_per_s": batch * prompt / out["prefill_s"],
        "decode_ms_per_token": out["decode_s"] / (gen - 1) * 1e3,
        "decode_tokens_per_s": batch * (gen - 1) / out["decode_s"],
        "max_memory_allocated": peak,
        "flash_attention_launches": launches,
        "flash_attention_launches_by_shape": per_shape,
        "flash_attention_launches_by_route": by_route,
        "decode_profile": {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
                           "device_busy_share": device_ms / wall_ms, "top_kernels": top},
        "prefill_split": split,
        "tokens": out["tokens"][:, :8].tolist(),
    }
    if tally is not None:
        prefill_tally = tally.read()
        summary["bfloat16"]["dropped"] = {
            "prefill": prefill_tally["dropped"], "routed_prefill": prefill_tally["routed"],
            "decode": served_tally["dropped"] - prefill_tally["dropped"],
            "routed_decode": served_tally["routed"] - prefill_tally["routed"]}
    ctx["details"][tag] = summary
    log(f"[{tag}] " + json.dumps(summary))
    checks = {
        f"float32 kernel route launched B3 {f32_launches} = {f32['launches_expected']} (one prefill, none in decode)":
            f32_launches == f32["launches_expected"],
        f"float32 logits kernel vs chunked {f32['logits_rel_err']:.3e} <= {TOL_LOGITS} of max |logit|":
            f32["logits_rel_err"] <= TOL_LOGITS,
        f"float32 greedy tokens equal up to the first top-2 gap under tol ({compared} steps)": tokens_ok,
        f"float32 nothing dropped by capacity ({f32_drops})": f32_drops == 0,
        f"float32 decode vs apply within {TOL_DECODE} (max abs err {decode_err:.3e})": decode_ok,
        f"bfloat16 main path launched B3 {launches} = {expected} (one prefill, none in decode)": launches == expected,
        f"decode launches no B3 ({decode_extra})": decode_extra == 0,
        f"every B3 launch at a shape lm_kernels checked and timed, each of them launched ({per_shape})":
            sum(per_shape.values()) == launches and all(per_shape.values()),
        f"every bfloat16 B3 launch at {sorted(model.attention_head_pairs)} went by wgmma, none by mma.sync "
        f"({by_route})": routes == {"wgmma"} and by_route == {"wgmma": launches},
        "every logit finite (float32 and bfloat16)": finite and f32["finite"],
    }
    if tally is not None:
        checks["capacity drops reported"] = "dropped" in summary["bfloat16"]
    for name, ok in checks.items():
        log(f"[{tag}] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} failed: " + ", ".join(k for k, ok in checks.items() if not ok))
    ctx.setdefault("launches", {}).update(per_shape)
    del model, p16, out, cache
    torch.cuda.empty_cache()


def phase_serve_mla(ctx) -> None:
    """deepseek-v2-lite-16b whole: MLA (B3 at q/k 192 / v 128) + MoE."""
    serve_family(ctx, "serve_mla", MLA_ARCH, None, MLA_BATCH, MLA_PROMPT, MLA_GEN, MLA_CHECK)


def phase_serve_whisper(ctx) -> None:
    """whisper-large-v3 whole: encoder (B3 non-causal over the frames),
    decoder self- and cross-attention."""
    serve_family(ctx, "serve_whisper", WH_ARCH, None, WH_BATCH, WH_PROMPT, WH_GEN, WH_CHECK)


def phase_serve_vlm(ctx) -> None:
    """llama-3.2-vision-90b at 20 of 100 layers: self-attention and
    cross-attention over the image tokens."""
    serve_family(ctx, "serve_vlm", VLM_ARCH, VLM_LAYERS, VLM_BATCH, VLM_PROMPT, VLM_GEN, VLM_CHECK)


#: profiler labels of the trainer's two phases outside the model
TRAIN_RANGES = ("train.adamw", "train.cast")


def train_split(prof, seq: int, steps: int) -> dict:
    """Device ms per step of a profiled training window, by class: the
    AdamW update with its clipping and the master -> working cast (ops under
    those ``record_function`` ranges), GEMMs (``mm``/``bmm``/``addmm``,
    forward and backward), the attention's elementwise work (any other op
    with an input whose last two dims are ``seq x seq``: the scores and
    probabilities, and their gradients), and the rest.  Each kernel counts
    for the innermost aten op that launched it; ``device_events_ms`` is the
    device's own record of its kernels, copies and sets (the busy share's
    numerator)."""
    from torch.autograd import DeviceType

    def self_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    def label(e):
        p = e.cpu_parent
        while p is not None:
            if p.name in TRAIN_RANGES:
                return p.name
            p = p.cpu_parent
        return None

    split = {"gemms": 0.0, "attention_elementwise": 0.0, "adamw_and_clip": 0.0, "master_cast": 0.0, "other": 0.0}
    names = {"train.adamw": "adamw_and_clip", "train.cast": "master_cast"}
    device_events = 0.0  # kernels, copies and sets as the device recorded them
    ops = {}
    for e in prof.events():
        us = self_us(e)
        if e.name in TRAIN_RANGES or us <= 0:  # a range's own span is not work
            continue
        if e.device_type != DeviceType.CPU:
            device_events += us
            continue
        if not e.name.startswith("aten::"):  # runtime markers ("Command Buffer Full") repeat op time
            continue
        ops[e.name] = ops.get(e.name, 0.0) + us
        where = label(e)
        if where:
            split[names[where]] += us
        elif e.name in ("aten::mm", "aten::bmm", "aten::addmm"):
            split["gemms"] += us
        elif any(len(sh) >= 2 and tuple(sh[-2:]) == (seq, seq) for sh in (e.input_shapes or ())):
            split["attention_elementwise"] += us
        else:
            split["other"] += us
    out = {k: v / 1e3 / steps for k, v in split.items()}
    out["device_ms"] = sum(out.values())
    out["device_events_ms"] = device_events / 1e3 / steps
    if out["device_ms"] <= 0 or device_events <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    out["top_ops"] = [{"name": k, "ms_per_step": v / 1e3 / steps}
                      for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:15]]
    return out


def phase_train(ctx) -> None:
    """The training path through ``repro_torch.runtime.Trainer``:

    1. stablelm-3b at full width and depth, bf16 compute on float32
       masters, batch 2 x 4096, 10 steps (counts reset just before, read
       just after: no B3/B4 launch, since the trainer runs ``attend_dot``
       and the plain SSD under autograd); ms per step, tokens/s, MFU on
       6·N·T, peak memory; then 2 profiled steps: busy share and device ms
       by class; gates: finite losses, the mean of steps 8-10 under step 1's,
       the working copy equal to ``master.to(bf16)`` bitwise;
    2. the 100m preset in float32: 3 steps on the card against the same 3
       on the CPU from the same masters (losses within 1e-4, masters by
       ``compare_trajectories``), then checkpoints every 2 steps, a failure
       at step 3 and a resume to step 6, bitwise an uninterrupted run.
    """
    import gc
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.checkpoint import flatten_state, map_state
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch.presets import PRESETS
    from repro_torch.models.sharding import tree_items
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig
    from repro_torch.runtime import trainer as trainer_mod
    from repro_torch.testing.trajectory import compare_trajectories, noisy_steps

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    FA.flash_attention.launches = SSD.ssd_chunked.launches = 0
    lap, seconds = Lap(), {}

    def adamw_opt(steps):  # the launcher's
        return AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=max(steps // 10, 1), total_steps=steps)

    # ---- 1. stablelm-3b, full: the main path ----
    B, S, N = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    cfg = get_config(TRAIN_ARCH)
    trainer = Trainer(cfg, TrainerConfig(steps=N, batch=B, seq_len=S, log_every=1), adamw_opt(N), device=dev)
    n_params = trainer.model.param_count()
    step_ms = []
    inner = trainer.step_fn

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.step_fn = timed
    torch.cuda.reset_peak_memory_stats()
    seconds["stablelm_build"] = lap()
    t0 = time.perf_counter()
    out = trainer.run()
    run_s = time.perf_counter() - t0
    seconds["stablelm_run"] = lap()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in out["history"]]
    state = out["state"]
    work_equal = all(torch.equal(w.detach(), m.to(w.dtype))
                     for (_, w), (_, m) in zip(tree_items(inner.work), tree_items(state["params"])))
    ms = float(np.median(step_ms[2:]))
    flops = 6 * n_params * B * S

    # two more steps under the profiler, the update and the cast labelled
    plain_update, plain_cast = trainer_mod.adamw_update, inner.cast

    def labelled_update(*a, **k):
        with record_function("train.adamw"):
            return plain_update(*a, **k)

    def labelled_cast(masters):
        with record_function("train.cast"):
            return plain_cast(masters)

    trainer_mod.adamw_update, inner.cast = labelled_update, labelled_cast
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            t1 = time.perf_counter()
            for k in range(2):
                state, _ = inner(state, trainer.data.batch_at(N + k))
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t1) * 1e3 / 2
    finally:
        trainer_mod.adamw_update = plain_update
        del inner.cast
    seconds["stablelm_profiled_steps"] = lap()
    split = train_split(prof, S, 2)
    seconds["stablelm_profile_read"] = lap()
    launches = (FA.flash_attention.launches, SSD.ssd_chunked.launches)
    main = {
        "arch": TRAIN_ARCH, "parameters": n_params, "layers": cfg.n_layers, "batch": B, "seq": S,
        "steps": N, "dtype": cfg.dtype, "masters": "float32", "remat": "full", "lr": TRAIN_LR,
        "losses": losses, "step_ms": step_ms, "ms_per_step": ms, "tokens_per_s": B * S / ms * 1e3,
        "model_tflop_per_step": flops / 1e12, "mfu": flops / (ms / 1e3) / BF16_TENSOR_FLOPS,
        "max_memory_allocated": peak, "run_s": run_s,
        "profile": {"wall_ms_per_step": prof_wall_ms, "busy_share": split["device_events_ms"] / prof_wall_ms,
                    "busy_share_vs_unprofiled_step": split["device_events_ms"] / ms, **split},
        "launches": launches,
    }
    log("[train] " + json.dumps(main))
    del state, out, trainer, inner, prof
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2. the 100m preset in float32: the card against the CPU, and resume ----
    c = TRAIN_CHECK
    cfg = PRESETS[c["preset"]](get_config(TRAIN_ARCH))

    def small(steps, device, **kw):
        return Trainer(cfg, TrainerConfig(steps=steps, batch=c["batch"], seq_len=c["seq"], log_every=1, **kw),
                       adamw_opt(steps), device=device)

    cpu = small(c["steps"], "cpu")
    n_small = cpu.model.param_count()
    init = cpu.init_state(SEED)  # drawn on the CPU, copied to the card: the same masters
    card_init = map_state(lambda _, t: t.to(dev, copy=True), init)
    on_card = small(c["steps"], dev)
    on_card.init_state = lambda rng_seed=0: card_init
    cpu.init_state = lambda rng_seed=0: init
    # copies: on the CPU .numpy() would alias the moments the next step updates in place
    flat = lambda tree: flatten_state(tree, copy=True)
    moments = {"cpu": [], "card": []}  # after each step, to mark Adam's noise-driven elements

    def recording(trainer, name):
        inner = trainer.step_fn

        def step(state, batch):
            state, metrics = inner(state, batch)
            moments[name].append((flat(state["opt"].mu), flat(state["opt"].nu)))
            return state, metrics

        trainer.step_fn = step

    recording(cpu, "cpu")
    recording(on_card, "card")
    seconds["float32_setup"] = lap()
    card_out = on_card.run()
    seconds["float32_card_steps"] = lap()
    cpu_out = cpu.run()
    seconds["float32_cpu_steps"] = lap()
    noisy = None
    for t, ((mu_card, _), (mu_cpu, nu_cpu)) in enumerate(zip(moments["card"], moments["cpu"]), start=1):
        noisy = noisy_steps(noisy, mu_card, mu_cpu, nu_cpu, t)
    del moments
    lr_sum = sum(float(warmup_cosine(adamw_opt(c["steps"]), torch.tensor(s)))
                 for s in range(1, c["steps"] + 1))
    card_losses = [h["loss"] for h in card_out["history"]]
    cpu_losses = [h["loss"] for h in cpu_out["history"]]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    cmp = compare_trajectories(flat(card_out["state"]["params"]), flat(cpu_out["state"]["params"]), noisy, lr_sum)
    del card_out, cpu_out, init, card_init, cpu, on_card

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        R, every = c["resume_steps"], c["every"]
        full = small(R, dev, checkpoint_every=every, checkpoint_dir=os.path.join(tmp, "full")).run()
        failing = small(R, dev, checkpoint_every=every, checkpoint_dir=os.path.join(tmp, "cut"),
                        fail_at_step=c["fail_at"])
        try:
            failing.run()
            failed = False
        except SimulatedFailure:
            failed = True
        failing.ckpt.wait()  # the save submitted before the failure commits
        resumed = small(R, dev, checkpoint_every=every, checkpoint_dir=os.path.join(tmp, "cut")).run()
        ends = [(x["state"]["params"], x["state"]["opt"].mu, x["state"]["opt"].nu) for x in (full, resumed)]
        resume_equal = (resumed["history"] == full["history"][every:]
                        and torch.equal(full["state"]["opt"].step, resumed["state"]["opt"].step)
                        and all(torch.equal(a, b) for ta, tb in zip(*ends)
                                for (_, a), (_, b) in zip(tree_items(ta), tree_items(tb))))
        resume = {"failed_at": c["fail_at"], "resumed_history": resumed["history"],
                  "uninterrupted_history": full["history"]}
        del full, failing, resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = (FA.flash_attention.launches, SSD.ssd_chunked.launches)
    seconds["float32_compare_and_resume"] = lap()
    check = {
        "preset": c["preset"], "parameters": n_small, "seconds": seconds,
        "card_losses": card_losses, "cpu_losses": cpu_losses, "loss_rel_err": loss_rel,
        "masters": cmp, "resume": resume,
    }
    log("[train] float32 check " + json.dumps(check))
    ctx["details"]["train"] = {"stablelm_full": main, "float32_check": check, "launches": launches}
    gc.collect()
    torch.cuda.empty_cache()

    checks = {
        f"every loss finite ({len(losses)} steps)": len(losses) == N and all(math.isfinite(x) for x in losses),
        f"mean loss of steps 8-10 {np.mean(losses[7:10]):.4f} < step 1's {losses[0]:.4f}":
            bool(np.mean(losses[7:10]) < losses[0]),
        "working copy == master.to(bf16) bitwise after the last step": work_equal,
        f"B3/B4 launches across the phase {launches} = (0, 0)": launches == (0, 0),
        f"100m float32 losses card vs CPU {loss_rel:.3e} <= {TOL_TRAIN_LOSS}": loss_rel <= TOL_TRAIN_LOSS,
        f"100m float32 masters card vs CPU ({cmp['noise_driven']} of {cmp['elements']} driven by gradient noise, "
        f"at most {cmp['max_marked_share']:.3e} of leaf {cmp['max_marked_leaf']}; out of tolerance "
        f"{cmp['out_of_tolerance']}, marked beyond the share {cmp['marked_beyond_share']})": cmp["ok"],
        f"failure injected at step {c['fail_at']} raised": failed,
        "resume after the failure bitwise the uninterrupted run (history, masters, moments)": resume_equal,
    }
    for name, ok in checks.items():
        log(f"[train] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("training path failed: " + ", ".join(k for k, ok in checks.items() if not ok))


def phase_dryrun(ctx) -> None:
    """The dry-run's op analyser (``repro_torch.launch.op_analysis``, run by
    ``repro_torch.launch.dryrun`` on meta tensors) held to the card:

    1. stablelm-3b prefill at 2 x 2048 (serve_stablelm's shape), analysed on
       meta tensors (``dryrun.analyse_cell``) and on the card's real tensors
       (``op_analysis.analyze`` of ``model.prefill``).  Gates: (a) the
       argument bytes, meta and card, equal the bytes of the parameters
       ``build`` placed on the card plus the prompts', exactly; (b) with
       ``impl="chunked"`` on both sides the counted FLOPs are equal; (c) the
       FLOPs counted for ``impl="kernel"`` on the card equal those counted for
       ``impl="fused"`` on meta (B3 and the stub are both invisible to the
       counter), with B3 launched once per layer, all by wgmma; (d) the
       predicted temp + output bytes (meta, chunked) within 10% of
       ``max_memory_allocated`` minus what was allocated before one chunked
       prefill on the card (not under the analyser).
    2. stablelm-3b training at 2 x 4096, ``impl="dot"`` (phase ``train``'s
       step): the predicted peak (arguments + temp + output, meta) within 10%
       of the ``max_memory_allocated`` phase ``train`` recorded; the counted
       FLOPs beside its 6·N·T.

    It prints the roofline shares a benchmark reads: the prefill's counted +
    analytic (B3) FLOPs over its CUDA-event time (median of 5) and 989
    TFLOP/s, and the train step's counted FLOPs over phase ``train``'s ms per
    step.  No profiler.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.serve import build, make_prompts
    from repro_torch.models.lm import LMModel
    from repro_torch.models.sharding import tree_items

    if "train" not in ctx["details"]:
        raise RuntimeError("phase dryrun reads phase train's peak memory and step time: run train first")
    card = ctx["details"]["card"]
    dev = torch.device("cuda")
    B, S = SLM_BATCH, SLM_PROMPT
    cfg = get_config(SLM_ARCH)
    L = cfg.n_layers
    shape = ShapeConfig(f"prefill_{B}x{S}", S, B, "prefill")
    meta = {impl: dryrun.analyse_cell(cfg, shape, impl) for impl in ("chunked", "fused")}
    b3_terms = dryrun.attention_kernel_terms(cfg, LMModel(cfg), shape)

    model, params = build(SLM_ARCH, "full", seed=SEED, device=dev)
    prompts = torch.as_tensor(make_prompts(cfg.vocab_size, B, S, SEED), device=dev)
    param_bytes = sum(t.nbytes for _, t in tree_items(params))
    for impl in ("chunked", "kernel"):  # warm: cuBLAS handles and workspaces, the kernel library
        model.prefill(params, prompts, impl=impl)
    torch.cuda.synchronize()
    on_card = {}
    for impl in ("chunked", "kernel"):
        FA.flash_attention.launches = 0
        FA.flash_attention.by_route.clear()
        t0 = time.perf_counter()
        st = op_analysis.analyze(model.prefill, params, prompts, impl=impl)
        torch.cuda.synchronize()
        on_card[impl] = {"stats": st, "seconds": time.perf_counter() - t0,
                         "launches": FA.flash_attention.launches, "by_route": dict(FA.flash_attention.by_route)}
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = model.prefill(params, prompts, impl="chunked")
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - before
    del out
    prefill_ms = median_ms(torch, lambda: model.prefill(params, prompts, impl="kernel"), reps=5)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    mem = meta["chunked"]["memory"]
    predicted = mem["temp_bytes"] + mem["output_bytes"]
    chunked, kernel = on_card["chunked"]["stats"], on_card["kernel"]["stats"]
    fused_traced = meta["fused"]["counted_flops_per_chip"] - meta["fused"]["analytic_kernel_flops_per_chip"]
    prefill_flops = kernel.flops + b3_terms["flops"]
    prefill = {
        "arch": SLM_ARCH, "batch": B, "prompt": S, "parameter_bytes": param_bytes, "prompt_bytes": prompts.nbytes,
        "meta": meta,
        "card": {impl: {"flops": v["stats"].flops, "mem_bytes": v["stats"].mem_bytes,
                        "argument_bytes": v["stats"].argument_bytes, "peak_bytes": v["stats"].peak_bytes,
                        "output_bytes": v["stats"].output_bytes, "seconds": v["seconds"],
                        "b3_launches": v["launches"], "b3_by_route": v["by_route"]} for impl, v in on_card.items()},
        "predicted_temp_plus_output": predicted, "measured_peak_minus_before": measured,
        "allocated_before": before, "memory_ratio": predicted / measured,
        "b3_analytic_flops": b3_terms["flops"], "prefill_ms": prefill_ms,
        "roofline_share": prefill_flops / (prefill_ms / 1e3) / BF16_TENSOR_FLOPS,
    }
    log(f"[dryrun] stablelm-3b prefill {B} x {S}: counted FLOPs chunked {chunked.flops:.6e} (meta "
        f"{meta['chunked']['counted_flops_per_chip']:.6e}), kernel route {kernel.flops:.6e} + B3 analytic "
        f"{b3_terms['flops']:.6e}; {prefill_ms:.3f} ms (CUDA events, median of 5): "
        f"{prefill['roofline_share']:.4f} of 989 TFLOP/s ({card})")
    log(f"[dryrun] prefill memory: predicted temp + output {predicted} B (meta, chunked), measured "
        f"max_memory_allocated - before {measured} B (card, chunked): ratio {prefill['memory_ratio']:.4f}; the "
        f"analyser on the card's tensors {chunked.peak_bytes} B ({card})")

    train_run = ctx["details"]["train"]["stablelm_full"]
    tshape = ShapeConfig(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    trec = dryrun.analyse_cell(cfg, tshape, "dot")
    tmem = trec["memory"]
    predicted_peak = tmem["argument_bytes"] + tmem["temp_bytes"] + tmem["output_bytes"]
    measured_peak = train_run["max_memory_allocated"]
    six_nt = 6 * train_run["parameters"] * TRAIN_BATCH * TRAIN_SEQ
    train = {
        "arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "impl": "dot", "meta": trec,
        "predicted_peak": predicted_peak, "measured_peak": measured_peak,
        "memory_ratio": predicted_peak / measured_peak, "six_nt": six_nt,
        "counted_over_six_nt": trec["counted_flops_per_chip"] / six_nt, "ms_per_step": train_run["ms_per_step"],
        "roofline_share": trec["counted_flops_per_chip"] / (train_run["ms_per_step"] / 1e3) / BF16_TENSOR_FLOPS,
    }
    log(f"[dryrun] stablelm-3b train step {TRAIN_BATCH} x {TRAIN_SEQ} (dot, remat full): counted FLOPs "
        f"{trec['counted_flops_per_chip']:.6e} beside 6·N·T {six_nt:.6e} (x{train['counted_over_six_nt']:.4f}); "
        f"{train_run['ms_per_step']:.2f} ms per step (phase train): {train['roofline_share']:.4f} of 989 TFLOP/s "
        f"({card})")
    log(f"[dryrun] train memory: predicted peak {predicted_peak} B = arguments {tmem['argument_bytes']} + temp "
        f"{tmem['temp_bytes']} + output {tmem['output_bytes']} (meta); measured {measured_peak} B "
        f"(phase train's max_memory_allocated over its 10 steps): ratio {train['memory_ratio']:.4f} ({card})")
    # what the analyser cannot see: an op's allocations inside its own kernel,
    # here logsumexp over the train step's float32 logits (LMModel.loss)
    logits = torch.empty(TRAIN_BATCH, TRAIN_SEQ, LMModel(cfg).vocab, dtype=torch.float32, device=dev)
    seen = op_analysis.analyze(torch.logsumexp, logits, -1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lse = torch.logsumexp(logits, -1)
    torch.cuda.synchronize()
    inside = torch.cuda.max_memory_allocated() - before - lse.nbytes
    train["logsumexp"] = {"logits_bytes": logits.nbytes, "analyser_peak": seen.peak_bytes,
                          "output_bytes": lse.nbytes, "allocated_inside": inside}
    del logits, lse
    log(f"[dryrun] logsumexp over the step's f32 logits ({TRAIN_BATCH * TRAIN_SEQ * LMModel(cfg).vocab * 4} B): "
        f"{inside} B allocated inside the op beyond its {train['logsumexp']['output_bytes']} B output, which "
        f"the analyser (peak {seen.peak_bytes} B) cannot see ({card})")
    ctx["details"]["dryrun"] = {"prefill": prefill, "train": train}

    checks = {
        f"(a) argument bytes meta {mem['argument_bytes']} = card {chunked.argument_bytes} = parameters "
        f"{param_bytes} + prompts {prompts.nbytes}":
            mem["argument_bytes"] == chunked.argument_bytes == kernel.argument_bytes == param_bytes + prompts.nbytes,
        f"(b) chunked counted FLOPs meta {meta['chunked']['counted_flops_per_chip']:.0f} == card {chunked.flops:.0f}":
            meta["chunked"]["counted_flops_per_chip"] == chunked.flops,
        f"(c) kernel-route FLOPs on the card {kernel.flops:.0f} == fused on meta {fused_traced:.0f}":
            kernel.flops == fused_traced,
        f"(c) B3 launches {on_card['kernel']['launches']} = {L}, all by wgmma ({on_card['kernel']['by_route']})":
            on_card["kernel"]["launches"] == L and on_card["kernel"]["by_route"] == {"wgmma": L},
        f"(d) predicted temp + output {predicted} within {TOL_DRYRUN_MEM:.0%} of measured {measured}":
            abs(predicted - measured) <= TOL_DRYRUN_MEM * measured,
        f"train: predicted peak {predicted_peak} within {TOL_DRYRUN_MEM:.0%} of measured {measured_peak}":
            abs(predicted_peak - measured_peak) <= TOL_DRYRUN_MEM * measured_peak,
    }
    for name, ok in checks.items():
        log(f"[dryrun] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("dry-run check failed: " + ", ".join(k for k, ok in checks.items() if not ok))


#: B1-B4's counters as the examples report them (``repro_torch.examples.launch_counts``)
EXAMPLE_KERNELS = ("spmv_ell", "spmm_ell", "flash_attention", "ssd_chunked")


def _no_kernel(launches: dict) -> bool:
    return not any(launches[k] for k in EXAMPLE_KERNELS)


#: phase ``examples``: (example, arguments, the reference's expected line,
#: launch gate).  The reference's smoke arguments first, then krylov_solve
#: without ``--fused``, serve_lm at its defaults and on an ssm arch, and
#: train_lm at its 300 steps and resumed; ``{ckpt}`` is a fresh directory
EXAMPLE_RUNS = (
    ("strategy_advisor", ["--messages", "32", "--nodes", "4", "--payload-width", "8"], "best strategy",
     _no_kernel),
    ("quickstart", [], "split", lambda n: n["spmv_ell"] > 0 and n["spmm_ell"] > 0),
    ("krylov_solve", ["--fused"], "fused whole-solve",
     lambda n: n["spmv_ell"] > 0 and n["spmv_ell_replayed"] > 0),
    ("krylov_solve", [], "DEVICE EXECUTION", lambda n: n["spmv_ell"] > 0),
    ("chaos_serving", [], "chaos serving", _no_kernel),
    ("serve_lm", ["--arch", "deepseek-v2-lite-16b", "--batch", "1", "--prompt-len", "8", "--gen", "3",
                  "--advise-dispatch"], "dispatch advice", lambda n: n["flash_attention"] > 0),
    ("serve_lm", [], "sample:", lambda n: n["flash_attention"] > 0),
    ("serve_lm", ["--arch", "mamba2-780m"], "sample:", lambda n: n["ssd_chunked"] > 0),
    ("train_lm", ["--ckpt", "{ckpt}"], "loss:", _no_kernel),
    ("train_lm", ["--ckpt", "{ckpt}", "--resume", "--steps", "320"], "over 320 steps", _no_kernel),
)


#: example runs at once in phase examples (a run that resumes another's
#: checkpoint runs after it, in the same lane)
EXAMPLE_LANES = 3


def phase_examples(ctx) -> None:
    """The six examples of ``repro_torch.examples`` as users start them
    (``python -m repro_torch.examples.<name>``, on the CUDA device), each in
    a process of its own: the ``--fused`` solve's graph replays stay out of
    this process, whose profiler phase ``fused`` still needs.  Each must exit
    0 (its own asserts hold), print the reference's expected line, and pass
    its launch gate on the counts it prints last (``REPRO_EXAMPLE_LAUNCHES``);
    the resumed train_lm run must start from step 300.  ``EXAMPLE_LANES``
    runs go at once (the two train_lm runs one after the other), so a run's
    wall seconds, in ``chip_smoke.json``, include the others' contention;
    each run's output goes to ``chiprun_out/examples/``.  Phase mesh's
    children start first and run beside them (:func:`start_mesh_children`),
    and so does phase setup's host build (:func:`start_setup`).
    """
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    out_dir = os.path.join(HERE, "chiprun_out", "examples")
    os.makedirs(out_dir, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src"), "REPRO_EXAMPLE_LAUNCHES": "1"}
    ckpt = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_examples_"), "ckpt")
    runs = {}
    start_mesh_children(ctx)
    start_setup(ctx)

    def run(name, args, expect, gate) -> None:
        args = [a.format(ckpt=ckpt) for a in args]
        label = " ".join([name, *args]).replace(ckpt, "CKPT")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *args],
                              capture_output=True, text=True, timeout=600, cwd=HERE, env=env)
        seconds = time.perf_counter() - t0
        fname = label.replace(" ", "_").replace("-", "").replace("/", "")
        with open(os.path.join(out_dir, f"{fname}.txt"), "w") as f:
            f.write(f"$ {label}\n{proc.stdout}\n--- stderr ---\n{proc.stderr}")
        if proc.returncode != 0:
            raise AssertionError(f"{label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        launches = json.loads(lines[-1])["launches"]
        checks = {"expected line": expect in proc.stdout, "launch gate": gate(launches)}
        if "--resume" in args:
            checks["resumed from step 300"] = "resumed from step 300" in proc.stderr
        runs[label] = {"seconds": seconds, "launches": launches, "checks": checks}
        log(f"[examples] {label}: {seconds:.2f} s, launches {launches}, checks {checks}")
        if not all(checks.values()):
            raise AssertionError(f"{label}: " + ", ".join(k for k, ok in checks.items() if not ok)
                                 + "\n" + "\n".join(lines[-20:]))

    # the train_lm runs share a checkpoint: one lane, in order, started first
    chains = [[r for r in EXAMPLE_RUNS if r[0] == "train_lm"]] + [[r] for r in EXAMPLE_RUNS if r[0] != "train_lm"]
    try:
        with ThreadPoolExecutor(EXAMPLE_LANES) as pool:
            for _ in pool.map(lambda chain: [run(*r) for r in chain], chains):
                pass
    finally:
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
        ctx["details"]["examples"] = runs
    example_kernel_checks(ctx)


def example_kernel_checks(ctx) -> None:
    """B1-B4 at the shapes the examples give them, each held to its plain
    version on the same seeded inputs, in this process: B1 and B2 (masked
    as the overlap path masks them) on quickstart's and krylov_solve's
    partitions, B3 in float32 at the shapes serve_lm's tiny qwen3-32b and
    deepseek-v2-lite prefills launch it with (read from ``by_shape``), B4 at
    the tiny mamba2-780m's.  These launches count toward no gate: the counts
    are set to 0 after them."""
    import torch
    from repro_torch.comm import IrregularExchange, PodTopology
    from repro_torch.configs import get_config
    from repro_torch.core.split_plan import split_rows
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import spmv_ell as K
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch.presets import tiny
    from repro_torch.launch.serve import build, make_context
    from repro_torch.models.ssd import ssd_chunked as ssd_plain
    from repro_torch.solve import spd_system
    from repro_torch.sparse import audikw_like, partition_csr, thermal_like

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    checks = ctx["details"].setdefault("example_kernel_checks", [])

    def check(name, got, want, tol):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        checks.append({"case": name, "max_abs_err": err, "tol": tol, "ok": bool(ok)})
        log(f"[examples] {name}: max_abs_err={err:.3e} (rtol=atol={tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")

    topo = PodTopology(npods=2, ppn=4)
    g = topo.nranks
    for tag, matrix, cols in (("quickstart", audikw_like(128, np.random.default_rng(0)), 8),
                              ("krylov_solve", spd_system(thermal_like(1024, np.random.default_rng(0))), 0)):
        part = partition_csr(matrix, topo)
        L = part.rows_per_rank

        def t(a):
            return torch.as_tensor(a, device=dev).contiguous()

        blocks = {"diag": (t(part.diag.data.reshape(g, L, -1)), t(part.diag.cols.reshape(g, L, -1))),
                  "off": (t(part.off.data.reshape(g, L, -1)), t(part.off.cols.reshape(g, L, -1)))}
        halo_dep = part.off_row_nnz.reshape(g, L) > 0
        v = torch.randn((g, L), generator=gen, device=dev)
        xs = {"diag": v, "off": IrregularExchange(part.pattern, "two_step", device=dev)(v)}
        bnd = t(split_rows(halo_dep, K.TILE_R).boundary_tiles.astype(np.int32))
        for blk, (data, idx) in blocks.items():
            check(f"spmv_ell {tag} {blk} {list(data.shape)}", K.spmv_ell(data, idx, xs[blk]),
                  K.spmv_ell_ref(data, idx, xs[blk]), TOL_F32)
        data, idx = blocks["off"]
        check(f"spmv_ell {tag} off masked", K.spmv_ell(data, idx, xs["off"], bnd),
              K.spmv_ell_masked_ref(data, idx, xs["off"], K.rows_of_tiles(bnd, K.TILE_R, L)), TOL_F32)
        if not cols:
            continue
        V = torch.randn((g, L, cols), generator=gen, device=dev)
        Xs = {"diag": V, "off": IrregularExchange(part.pattern, "two_step", device=dev)(V)}
        bnd_mm = t(split_rows(halo_dep, K.TILE_R_MM).boundary_tiles.astype(np.int32))
        for blk, (data, idx) in blocks.items():
            check(f"spmm_ell {tag} {blk} C={cols}", K.spmm_ell(data, idx, Xs[blk]),
                  K.spmm_ell_ref(data, idx, Xs[blk]), TOL_F32)
        check(f"spmm_ell {tag} off masked C={cols}", K.spmm_ell(data, idx, Xs["off"], bnd_mm),
              K.spmm_ell_masked_ref(data, idx, Xs["off"], K.rows_of_tiles(bnd_mm, K.TILE_R_MM, L)), TOL_F32)

    # B3: the shapes the examples' tiny prefills launch it with
    for arch, batch, prompt in (("qwen3-32b", 4, 64), ("deepseek-v2-lite-16b", 1, 8)):
        model, params = build(arch, "tiny", seed=0, device=dev)
        prompts, _ = make_context(model.cfg.vocab_size, batch, prompt, 0, model.cfg.d_model, seed=0)
        FA.flash_attention.by_shape.clear()
        with torch.inference_mode():
            model.prefill(params, torch.as_tensor(prompts, device=dev), None, impl="kernel")
        shapes = list(FA.flash_attention.by_shape)
        if not shapes:
            raise AssertionError(f"{arch}: the tiny prefill launched no B3")
        for (qs, ks, vs, causal, window) in shapes:
            q, k, v = (torch.randn(s, generator=gen, device=dev) for s in (qs, ks, vs))
            check(f"flash_attention {arch} tiny {list(qs)}/{list(ks)}/{list(vs)} causal={causal} "
                  f"window={window} float32", FA.flash_attention(q, k, v, causal=causal, window=window),
                  FA.attention_ref(q, k, v, causal=causal, window=window), TOL_ATTN_F32)
        del model, params
    FA.flash_attention.by_shape.clear()
    FA.flash_attention.by_route.clear()

    # B4: the tiny mamba2-780m's SSD at serve_lm's default batch 4 x 64
    cfg = tiny(get_config("mamba2-780m"))
    H, P, N, Q = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.chunk
    x = torch.randn((4, 64, H, P), generator=gen, device=dev)
    loga = -torch.rand((4, 64, H), generator=gen, device=dev) * 0.2
    bb, cc = (torch.randn((4, 64, N), generator=gen, device=dev) for _ in range(2))
    check(f"ssd_chunked mamba2-780m tiny [4,64,{H},{P}] N={N} Q={Q}", SSD.ssd_chunked(x, loga, bb, cc, Q),
          ssd_plain(x, loga, bb, cc, Q), TOL_SSD)
    K.spmv_ell.launches = K.spmm_ell.launches = 0
    FA.flash_attention.launches = SSD.ssd_chunked.launches = 0


def kernels_line(ctx) -> dict:
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape", "dtype")
    out = []
    for name in ("spmv_ell", "spmm_ell", "flash_attention", "ssd_chunked", "flash_attention_d80",
                 "flash_attention_d128", *serve_b3_shapes()):
        t = {**ctx["timings"][name], "name": name, "route": "cuda", "launches": ctx["launches"][name]}
        out.append({k: t[k] for k in keys})
    return {"kernels": out}


#: phase ``mesh``'s cells: stablelm-3b at every shape it runs, on both meshes
MESH_ARCH = "stablelm-3b"
MESH_SIZES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}

#: phase ``mesh``'s rank-0 program on the card, run as a child: its record on stdout's last line
MESH_RANK0 = """
import json, sys
import torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import run_on_card
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
init_fake_world(256, rank=0)
torch.cuda.set_device(0)
mesh = make_production_mesh(multi_pod=False)
out = run_on_card(get_config(sys.argv[1]), SHAPES["prefill_32k"], mesh, impl="chunked", seed=0)
out["device"] = torch.cuda.get_device_name(0)
print(json.dumps(out))
"""


def start_mesh_children(ctx) -> dict:
    """Start phase mesh's three children, unless they run already: the two
    meta dry-runs (CPU only) and rank 0's program on the card, all at once,
    their output in files under a fresh directory.  Phase examples starts
    them, so they run beside it; a child still running when this script
    exits is killed then."""
    import atexit
    import tempfile

    if "mesh_children" in ctx:
        return ctx["mesh_children"]
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")

    def spawn(name: str, cmd: list, env: dict) -> tuple:
        files = [open(os.path.join(out_dir, f"{name}.{part}"), "w+") for part in ("out", "err")]
        return subprocess.Popen(cmd, stdout=files[0], stderr=files[1], text=True, cwd=HERE, env=env), files

    procs = {kind: spawn(kind, [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", MESH_ARCH, "--mesh",
                                kind, "--out", out_dir], {**env, "CUDA_VISIBLE_DEVICES": ""})
             for kind in MESH_SIZES}
    procs["rank0"] = spawn("rank0", [sys.executable, "-c", MESH_RANK0, MESH_ARCH], env)
    atexit.register(lambda: [p.kill() for p, _ in procs.values() if p.poll() is None])
    ctx["mesh_children"] = {"out_dir": out_dir, "procs": procs, "t0": time.perf_counter()}
    return ctx["mesh_children"]


def _finish_child(proc, files, timeout_s: float = 900.0) -> tuple:
    """``(stdout, stderr)`` of a child whose output goes to ``files``
    (:func:`start_mesh_children`, :func:`start_fused_profile`), once it has
    ended."""
    proc.wait(timeout=timeout_s)
    out = []
    for f in files:
        f.seek(0)
        out.append(f.read())
        f.close()
    return tuple(out)


def phase_mesh(ctx) -> None:
    """The mesh half of the port (``repro_torch.models.sharding``,
    ``launch.mesh``, the dry-run's ``--mesh single|multi``), in child
    processes: a process group is global to its process.

    Its three children run beside phase examples, which starts them
    (:func:`start_mesh_children`); this phase waits for them and checks.

    1. On meta tensors: ``python -m repro_torch.launch.dryrun --arch
       stablelm-3b --mesh single`` and ``--mesh multi``, the two at once,
       each over a fake group of its mesh's size.  Gates: every cell OK
       (train_4k, prefill_32k, decode_32k; long_500k skipped as in the
       reference), each cell's per-chip ``argument_bytes`` equal to the sum
       of its arguments' local shards from ``spec_for``
       (``dryrun.spec_argument_bytes``), and every sharded cell issuing
       collectives.
    2. On the card, meanwhile: rank 0's program of stablelm-3b prefill_32k
       on the 16x16 mesh at full width (``dryrun.run_on_card``): a fake group of 256
       standing at rank 0 on a CUDA mesh, its local shards drawn from a seed
       on the card, ``impl="chunked"``.  A fake group leaves every gathered
       buffer uninitialised, so the run is gated on memory and FLOPs, not on
       values (``tests/test_torch_mesh.py`` holds the sharded programs'
       values, on a real gloo group of 4 processes).  Gates: its argument
       bytes equal the meta record's; the bytes it allocated at its peak
       beyond its arguments within 10% of the record's temp + output; its
       counted FLOPs equal the record's.  Its CUDA-event time is logged.
    Nothing is caught: any failure fails the phase.
    """
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import LMModel

    card = ctx["details"]["card"]
    children = start_mesh_children(ctx)
    out_dir, procs = children["out_dir"], children["procs"]
    outs = {name: _finish_child(*procs[name]) for name in procs}
    waited_s = time.perf_counter() - children["t0"]
    meta = {kind: procs[kind][0] for kind in MESH_SIZES}
    rank0, rank0_out = procs["rank0"][0], outs["rank0"]
    for kind, p in meta.items():
        if p.returncode != 0:
            raise AssertionError(f"dry-run --mesh {kind}: exit {p.returncode}\n{outs[kind][0][-3000:]}"
                                 f"\n{outs[kind][1][-3000:]}")
    checks, records = {}, {}
    model = LMModel(get_config(MESH_ARCH), tp=16)
    for kind, sizes in MESH_SIZES.items():
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            with open(os.path.join(out_dir, f"{MESH_ARCH}__{shape_name}__{kind}.json")) as f:
                rec = records[(kind, shape_name)] = json.load(f)
            mem = rec["memory"]
            want = dryrun.spec_argument_bytes(model, SHAPES[shape_name], sizes)
            log(f"[mesh] {MESH_ARCH} x {shape_name} x {kind} ({rec['chips']} chips, meta): trace "
                f"{rec['lower_s']:.1f} s, FLOPs/chip {rec['counted_flops_per_chip']:.6e} (x"
                f"{rec['counted_flops_per_chip'] * rec['chips'] / rec['model_flops']:.4f} model_flops), arguments "
                f"{mem['argument_bytes']} B (spec_for {want}), temp {mem['temp_bytes']} B, output "
                f"{mem['output_bytes']} B, collectives {rec['collective_ops']} ops "
                f"{ {k: int(v) for k, v in rec['collective_by_kind'].items()} } B")
            checks[f"{shape_name} x {kind}: OK, {rec['chips']} chips"] = \
                "error" not in rec and rec["chips"] == math.prod(sizes.values())
            checks[f"{shape_name} x {kind}: argument bytes {mem['argument_bytes']} = spec_for's {want}"] = \
                mem["argument_bytes"] == want
            checks[f"{shape_name} x {kind}: {rec['collective_ops']} collectives > 0"] = rec["collective_ops"] > 0

    if rank0.returncode != 0:
        raise AssertionError(f"rank 0's program: exit {rank0.returncode}\n{rank0_out[0][-3000:]}"
                             f"\n{rank0_out[1][-3000:]}")
    run = json.loads(rank0_out[0].strip().splitlines()[-1])
    rec = records[("single", "prefill_32k")]
    mem = rec["memory"]
    predicted = mem["temp_bytes"] + mem["output_bytes"]
    log(f"[mesh] rank 0 of 256, {MESH_ARCH} prefill_32k (32 x 32768, chunked) on the card: arguments "
        f"{run['argument_bytes']} B, peak beyond them {run['peak_beyond_arguments']} B (predicted temp + output "
        f"{predicted} B, ratio {predicted / run['peak_beyond_arguments']:.4f}), counted FLOPs {run['flops']:.6e}, "
        f"collectives {run['collective_ops']} ops, {run['ms']:.3f} ms (CUDA events, median of 3, beside phase "
        f"examples) ({card})")
    checks[f"card: argument bytes {run['argument_bytes']} = meta {mem['argument_bytes']}"] = \
        run["argument_bytes"] == mem["argument_bytes"]
    checks[f"card: peak beyond arguments {run['peak_beyond_arguments']} within {TOL_DRYRUN_MEM:.0%} of "
           f"predicted {predicted}"] = \
        abs(predicted - run["peak_beyond_arguments"]) <= TOL_DRYRUN_MEM * run["peak_beyond_arguments"]
    checks[f"card: counted FLOPs {run['flops']:.0f} = meta {rec['counted_flops_per_chip']:.0f}"] = \
        run["flops"] == rec["counted_flops_per_chip"]
    ctx["details"]["mesh"] = {"records": {f"{k}|{s}": r for (k, s), r in records.items()}, "rank0": run,
                              "children_seconds": waited_s}
    log(f"[mesh] the two meta dry-runs and rank 0's program, started with phase examples and run beside it, "
        f"had all ended {waited_s:.1f} s after their start")
    for name, ok in checks.items():
        log(f"[mesh] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("mesh check failed: " + ", ".join(k for k, ok in checks.items() if not ok))


#: phase ``world``: the case study on a gloo world of one process per rank
WORLD_TOPO = "4x4"
WORLD_TIMEOUT_S = 600
#: the launchers in phase world: a DATAxMODEL mesh of that many CUDA ranks on
#: this card, joined by the staged group (``repro_torch.comm.staged``), as a
#: user starts them: stablelm-3b and hymba-1.5b served at full width and
#: depth in bf16 (B3 and B4 per rank on head and batch shards), the same two
#: at 2 layers in float32 against one process (the correctness gate), and
#: stablelm-3b's 100m preset trained (it launches no kernel; each rank draws
#: the state whole before it shards it, so full width would be 4 x 11.2 GB of
#: float32 masters at once).  The serve worlds run a 1024-token prompt and 2
#: tokens: every decode step re-gathers each layer's weight shards through
#: host memory (the rules shard weights over ``data``), so at 2048 and 16
#: tokens the launcher decoded for 71.8 s (stablelm-3b) and 60.0 s
#: (hymba-1.5b) after prefills of 27.8 and 16.9 s (H100 80GB HBM3, 700 W,
#: torch 2.11), which would put the script past its time limit
LAUNCH_MESH = "2x2"
LAUNCH_SERVE_ARCHS = ("stablelm-3b", "hymba-1.5b")
LAUNCH_SERVE = ["--preset", "full", "--batch", "4", "--prompt-len", "1024", "--gen", "2", "--impl", "kernel"]
LAUNCH_SERVE_F32 = ["--preset", "full", "--layers", "2", "--batch", "4", "--prompt-len", "1024", "--gen", "2",
                    "--impl", "kernel", "--dtype", "float32"]
#: the f32 gate: rank 0's gathered prefill logits within this share of
#: max |logits| of one process (the serve phases' float32 tolerance)
TOL_LAUNCH_F32 = 1e-3
LAUNCH_TRAIN = ["--arch", "stablelm-3b", "--preset", "100m", "--batch", "8", "--seq", "512"]
LAUNCH_TRAIN_STEPS = 4
#: the checkpoint of the mesh run resumed on one process to this step
LAUNCH_RESUME_STEPS = 6


def _losses_agree(got: list, want: list, lr: float) -> dict:
    """Two launcher runs' loss histories, by ``compare_trajectories`` on the
    loss values (``lr`` an upper bound of each step's rate), as
    ``tests/test_torch_mesh.py`` holds them."""
    from repro_torch.testing.trajectory import compare_trajectories

    if [h["step"] for h in got] != [h["step"] for h in want]:
        return {"ok": False, "steps": [[h["step"] for h in got], [h["step"] for h in want]]}
    loss = lambda hist: {"loss": np.array([h["loss"] for h in hist], np.float64)}
    cmp = compare_trajectories(loss(got), loss(want), {"loss": np.zeros(len(want), bool)}, lr * len(want))
    return {"ok": bool(cmp["ok"]), "worst": cmp["max_err_over_max_abs"]}


def _one_process_serve(argv: list) -> tuple:
    """The launcher's serve of ``argv`` in this process, of the model the
    mesh serves: ``LMModel(tp=M)`` pads the heads to a multiple of the
    ``model`` axis (hymba-1.5b's 25 to 26, as in the reference), so ``--mesh
    1x1`` would serve another model.  ``(generate's output, launches)``."""
    import torch

    from repro_torch.examples import launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import parse_mesh

    args = serve.parse_args(argv)
    dev = torch.device("cuda", torch.cuda.current_device())
    before = launch_counts()
    model, params = serve.build(args.arch, args.preset, args.seed, dev, layers=args.layers,
                                dtype=None if args.dtype is None else getattr(torch, args.dtype),
                                tp=parse_mesh(LAUNCH_MESH)[1])
    prompts, _ = serve.make_context(model.cfg.vocab_size, args.batch, args.prompt_len, 0, 0, args.seed)
    out = serve.generate(model, params, torch.as_tensor(prompts, device=dev), args.gen, impl=args.impl)
    out = {"tokens": out["tokens"].cpu().tolist(), "logits": out["logits"][0].cpu().numpy()}
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def world_launchers(ctx) -> dict:
    """The launchers' ``--mesh`` on CUDA ranks of this card.

    1. Timed, the worlds at once (each one's seconds include the other's):
       ``launch.serve --mesh LAUNCH_MESH`` with ``LAUNCH_SERVE`` (bf16,
       ``--impl kernel``) for each of ``LAUNCH_SERVE_ARCHS``, as a user
       starts it.  Gates: every rank
       holds the same tokens, each rank launched B3 once per layer (all by
       wgmma) and B4 once per SSM layer, as many as one process's prefill of
       the same model (so none in decode), and its gathered prefill logits
       are finite.  The tokens against one process in bf16 are logged, not
       gated: random bf16 layers amplify rounding.
    2. Then at once, for their gates (their seconds include the others'):
       ``probe_collectives`` over plain gloo and over the staged group (one
       world of 2 CUDA ranks per collective), which must fail exactly
       ``GLOO_CUDA_MISSING`` and run all of ``PROBES`` with the right values
       respectively; the serves at 2 layers in float32 (``LAUNCH_SERVE_F32``),
       rank 0's gathered prefill logits within ``TOL_LAUNCH_F32`` of max
       |logits| of one process on the card; ``launch.train`` with
       ``LAUNCH_TRAIN`` for ``LAUNCH_TRAIN_STEPS`` on the mesh, checkpointed,
       its losses on every rank agreeing with the ``1x1`` run's (loss values
       by ``compare_trajectories``), no kernel launched on any rank.  This
       process runs the one-process references meanwhile.
    3. The mesh's checkpoint resumes on ``1x1`` to ``LAUNCH_RESUME_STEPS``,
       agreeing with the ``1x1`` run's own resumed as far.
    Logged beside the card's name and power limit: each world's seconds,
    the slowest rank's prefill and decode, each rank's device peak, B3's
    shapes per rank, and rank 0's staged collectives (calls, ms, bytes).
    """
    import contextlib
    import io
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import GLOO_CUDA_MISSING
    from repro_torch.launch.world import COLLECTIVES, PROBES, probe_collectives

    card = ctx["details"]["card"]
    checks, out = {}, {"worlds": {}}

    def world(tag: str, main, argv: list) -> dict:
        t1, started = time.perf_counter(), time.time()
        res = main([*argv, "--mesh", LAUNCH_MESH])  # rank 0 prints the launcher's lines
        ranks = res["ranks"]
        rec = {"seconds": time.perf_counter() - t1, "launches": [r["launches"] for r in ranks],
               # the slowest rank's seconds from the world's start to each
               # step of its start, and of the launcher's run
               "start_steps_s": {k: max(r["timeline"][k] for r in ranks) - started for k in ranks[0]["timeline"]},
               "run_s": max(r["run_s"] for r in ranks),
               "b3_routes": [r["b3_routes"] for r in ranks], "b3_shapes": [r["b3_shapes"] for r in ranks],
               "device_peak_bytes": [r["device_peak_bytes"] for r in ranks], "staged": ranks[0]["staged"]}
        if "prefill_s" in ranks[0]:
            rec.update(prefill_s=max(r["prefill_s"] for r in ranks), decode_s=max(r["decode_s"] for r in ranks))
        out["worlds"][tag] = rec
        timing = (f", prefill {rec['prefill_s']:.3f} s, decode {rec['decode_s']:.3f} s (slowest rank, host wall)"
                  if "prefill_s" in rec else "")
        staged_ms = {k: f"{v['calls']} calls {v['seconds'] * 1e3:.1f} ms {v['bytes'] / 1e6:.1f} MB"
                     for k, v in sorted(rec["staged"].items(), key=lambda kv: -kv[1]["seconds"])}
        log(f"[world] {tag} --mesh {LAUNCH_MESH} on {[r['device'] for r in ranks]}: world {rec['seconds']:.2f} s"
            f" (start by step {json.dumps({k: round(v, 2) for k, v in rec['start_steps_s'].items()})}, the "
            f"launcher's run {rec['run_s']:.2f} s){timing}; launches per rank {rec['launches']}, B3 routes "
            f"{rec['b3_routes']}, B3 shapes on rank 0 {rec['b3_shapes'][0]}; device peak allocated per rank "
            f"{rec['device_peak_bytes']} B; rank 0's staged "
            f"collectives {json.dumps(staged_ms)} ({card}, torch {torch.__version__})")
        return res

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    with ThreadPoolExecutor(len(LAUNCH_SERVE_ARCHS)) as pool:
        bf16 = dict(zip(LAUNCH_SERVE_ARCHS, pool.map(
            lambda arch: world(f"serve {arch} bf16", serve.main, ["--arch", arch, *LAUNCH_SERVE])["ranks"],
            LAUNCH_SERVE_ARCHS)))

    lr = train.parse_args([]).lr
    steps = ["--steps", str(LAUNCH_TRAIN_STEPS)]
    with tempfile.TemporaryDirectory(prefix="launch_train_") as d:
        on_mesh, alone = os.path.join(d, "mesh"), os.path.join(d, "one")
        jobs = {f"probe {b}": (lambda b=b: probe_collectives(backend=b)) for b in ("gloo", "staged")}
        for arch in LAUNCH_SERVE_ARCHS:
            jobs[f"serve {arch} f32 2 layers"] = (
                lambda arch=arch: world(f"serve {arch} f32 2 layers", serve.main, ["--arch", arch, *LAUNCH_SERVE_F32]))
        jobs["train"] = lambda: world("train stablelm-3b 100m", train.main, [*LAUNCH_TRAIN, *steps, "--ckpt", on_mesh])
        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = {tag: pool.submit(job) for tag, job in jobs.items()}
            # meanwhile, in this process: the one-process references
            refs = {(arch, kind): _one_process_serve(["--arch", arch, *argv]) for arch in LAUNCH_SERVE_ARCHS
                    for kind, argv in (("bf16", LAUNCH_SERVE), ("f32", LAUNCH_SERVE_F32))}
            release()
            with contextlib.redirect_stdout(io.StringIO()):
                one = train.main([*LAUNCH_TRAIN, *steps, "--ckpt", alone])["history"]
            done = {tag: f.result() for tag, f in futures.items()}
        out["concurrent_s"] = time.perf_counter() - t1
        log(f"[world] the probes, the f32 serve and train worlds and the one-process references, at once: "
            f"{out['concurrent_s']:.2f} s")

        probe = {b: done[f"probe {b}"] for b in ("gloo", "staged")}
        out["probe"] = probe
        log(f"[world] collectives on CUDA tensors, as DTensor issues them: {json.dumps(probe)} ({card})")
        checks[f"plain gloo on CUDA: every DTensor collective but {list(GLOO_CUDA_MISSING)} runs"] = all(
            (probe["gloo"][k] != "ok") == (k in GLOO_CUDA_MISSING) for k in COLLECTIVES)
        checks[f"staged on CUDA: all {len(PROBES)} collectives run with the right values"] = all(
            probe["staged"][k] == "ok" for k in PROBES)

        for arch in LAUNCH_SERVE_ARCHS:
            cfg, ranks = get_config(arch), bf16[arch]
            ref, ref_launches = refs[(arch, "bf16")]
            want = {"flash_attention": cfg.n_layers, "ssd_chunked": cfg.n_layers if cfg.ssm else 0}
            same = sum(a == b for x, y in zip(ranks[0]["tokens"], ref["tokens"]) for a, b in zip(x, y))
            log(f"[world] serve {arch} bf16: one process launched {ref_launches}; tokens equal to one process's "
                f"{same} of {sum(map(len, ref['tokens']))} (logged, not gated)")
            checks[f"serve {arch} bf16: every rank holds the same tokens"] = all(
                r["tokens"] == ranks[0]["tokens"] for r in ranks)
            checks[f"serve {arch} bf16: every rank launched B3 {want['flash_attention']} and B4 "
                   f"{want['ssd_chunked']}, as one process's prefill (none in decode)"] = all(
                all(r["launches"][k] == n == ref_launches[k] for k, n in want.items()) for r in ranks)
            checks[f"serve {arch} bf16: every B3 launch by wgmma"] = all(
                r["b3_routes"] == {"wgmma": want["flash_attention"]} for r in ranks)
            checks[f"serve {arch} bf16: gathered prefill logits finite on every rank"] = all(
                bool(np.isfinite(np.asarray(r["prefill_logits"], np.float32)).all()) for r in ranks)

            tag = f"serve {arch} f32 2 layers"
            want_logits = refs[(arch, "f32")][0]["logits"]
            got = np.asarray(done[tag]["ranks"][0]["prefill_logits"], np.float32)
            err = float(np.abs(got - want_logits).max()) / float(np.abs(want_logits).max())
            out["worlds"][tag]["max_err_over_max_abs"] = err
            log(f"[world] {tag}: rank 0's prefill logits {list(got.shape)} vs one process: max |diff| / max |logits| "
                f"= {err:.3e}")
            checks[f"{tag}: rank 0's prefill logits within {TOL_LAUNCH_F32} of max |logits| of one process"] = (
                got.shape == want_logits.shape and err <= TOL_LAUNCH_F32)

        res = done["train"]
        agree = [_losses_agree(r["history"], one, lr) for r in res["ranks"]]
        log(f"[world] train 100m: losses on the mesh {[h['loss'] for h in res['history']]}, one process "
            f"{[h['loss'] for h in one]}; agreement per rank {json.dumps(agree)}")
        checks["train 100m --mesh 2x2: every rank's losses agree with 1x1 on the card"] = all(a["ok"] for a in agree)
        checks["train 100m --mesh 2x2: no kernel launched on any rank"] = all(
            not any(r["launches"].values()) for r in res["ranks"])
        resume = [*LAUNCH_TRAIN, "--steps", str(LAUNCH_RESUME_STEPS), "--resume"]
        with contextlib.redirect_stdout(io.StringIO()):
            from_mesh = train.main([*resume, "--ckpt", on_mesh])["history"]
            from_one = train.main([*resume, "--ckpt", alone])["history"]
        resumed = _losses_agree(from_mesh, from_one, lr)
        log(f"[world] train 100m: the mesh's checkpoint resumed on 1x1 {[(h['step'], h['loss']) for h in from_mesh]}, "
            f"1x1's own {[(h['step'], h['loss']) for h in from_one]}: {json.dumps(resumed)}")
        checks[f"train 100m: the mesh's checkpoint resumes on 1x1 to step {LAUNCH_RESUME_STEPS}, agreeing with "
               f"1x1's own"] = resumed["ok"] and from_mesh[-1]["step"] == LAUNCH_RESUME_STEPS
    release()
    out["checks"] = checks
    return out


def phase_world(ctx) -> None:
    """The case study on a real process group (``repro_torch.launch.world``):
    ``spd_system(thermal_like(1 << 20))`` on ``PodTopology(4, 4)``, 16
    processes of 65,536 rows each, all on this card, joined by gloo (NCCL
    refuses two ranks of one communicator on one card, so every hop stages
    through host memory).  The world's CLI (``python -m
    repro_torch.launch.world``, its ``main``) runs in this process on phase
    setup's systems (``--problem``, written by ``write_problem``: rank 0
    loads them whole, every other rank its own rows and the pattern); its
    ranks fork from this process's fork server, started in phase build.
    ``main`` checks, and this phase re-reads, every gate of every rank
    (``chiprun_out/world/world.json``):

    * each rank's halo, for the four strategies x barrier/split-phase x
      codecs none/bf16/int8 on a ``[1, L, 3]`` payload, bitwise row ``r``
      of the stacked exchange on the card (gathered on rank 0), and the
      stacked exchange bitwise ``execute_numpy``;
    * ``DistributedSpMV(group=)``: overlap == barrier, ``matmat`` (k = 8) ==
      ``matmat_looped``, ``w`` equal across strategies and bitwise the
      stacked operator's row, and within 1e-5 of a float64 CSR product;
    * CG with each strategy and ``auto``, barrier, and on two_step also
      overlapped, and BiCGStab (``shifted_system``) on standard and two_step
      (``world.CARD_BICGSTAB``): converged to 1e-6, histories bitwise
      across them and across ranks, true residual under 1e-5, and the
      stacked host loop's status, iterations within one and ``x`` within
      1e-4;
    * checks, faults and the recovery ladder (every strategy barrier, and
      two_step split-phase, x codecs none/int8 on a ``[1, L]`` payload):
      checked clean calls raise
      nothing and equal the unchecked halo; a transient corruption (retry),
      an int8-only corruption (demote) and a persistent perturbation of the
      strategy (re-advise) give each rank's halo bitwise row ``r`` of the
      stacked guarded exchange, that one bitwise ``execute_numpy`` of the
      attempt that succeeded, and the stacked run's recovery key and health
      events on every rank; with ``fallback=False`` every rank raises the
      stacked raise's hop with one violation; CG checked and CG through a
      retried fault converge with the clean history bitwise and one status
      (``+exchange:retry:...``) on every rank;
    * the reductions: the tree bitwise ``_tree_sum`` of the gathered
      partials, ``Compressor()``'s dot one value on every rank within one
      quantum of the stacked ``TorchReductions``, a CG on the compressed
      tree with one history on every rank and the stacked loop's status;
    * the fused whole-solve on the group (after the host loops, so after
      ``fused_profile`` too, and profiling nothing): ``fused_cg`` and
      ``fused_bicgstab`` on ``DistributedSpMV(group=)`` for each strategy of
      CG and ``CARD_BICGSTAB`` of BiCGStab (barrier, codec none; CG also
      split-phase on two_step and with the int8 wire on two_step and
      three_step), a first solve that warms up
      and captures one CUDA graph per stretch of device work between two
      staged hops (the split phase: the on-pod sub-exchange's too), on
      two_step a second that replays them: history, ``x``, status,
      iterations and matvecs bitwise the grouped host loop of the same
      operator, and (rank 0) bitwise the stacked host loop in the group
      tree's summation order (``reductions=NumpyReductions``); converged to
      1e-6 with a true residual under 1e-5; B1 only by replays (two per
      matvec of each replayed init and block, none eager beyond the
      warm-up's); host reads at most one per block plus the slack; a
      checked solve, a persistent fault every rank raises as the stacked
      fused solve does, a transient one resumed from the same checkpoint on
      the same rung;
    * each rank's B1/B2 launches equal to the count predicted from its calls
      (2 B1 per matvec, 2 B2 per ``matmat``, the fused solves' warm-ups);
    * the guards (NCCL, a rank with another strategy, a rank with another
      fault plan) raise;
    * the MoE section: one llama4-scout layer at full width (the world's
      layer on CUDA ranks) on the 4 x 4 ``("pod", "local")`` ``DeviceMesh``,
      one expert per process, uniform and skewed routing: each rank's
      output bitwise across the four strategies and ``auto`` and bitwise the
      mesh all-to-all, the gathered rows bitwise the stacked exchange on
      rank 0, the slots summed over the ranks the stacked run's, the int8
      wire bitwise the stacked int8 run and not the full-precision output,
      no planning after the first of five calls.

    Then :func:`world_launchers`: the collective probe over plain gloo and
    over the staged group, and the train and serve launchers' ``--mesh
    2x2`` on CUDA ranks of this card.

    Logged beside the card's name and power limit: ms per staged exchange
    per strategy, ms per checked vs unchecked exchange, ms per dot (the
    tree, compressed, and one all-gather over the world), ms per CG
    iteration (plain, checked, retried, compressed reductions; the slowest
    rank's host wall), ms per fused CG / BiCGStab iteration against the
    host loop's per strategy and the capture seconds, the world's start and
    total seconds, memory per rank.  It runs last, after
    ``fused``: placed right after ``mesh`` it cost ``fused``'s profiler two
    B1 records (ROADMAP §C).  A world that outlives its timeout has every
    rank killed (``run_world``).  The combinations of the host worlds of
    ``tests/test_torch_world.py`` that are not run here (BiCGStab on
    three_step, split and ``auto``; the split-phase faults of the other
    strategies) are held there on CPU gloo.
    """
    import contextlib
    import io
    import shutil
    import tempfile
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.launch import world as W

    card = ctx["details"]["card"]
    out_dir = os.path.join(HERE, "chiprun_out", "world")
    # the CLI's own build of these systems is phase setup's, bit for bit
    problem = tempfile.mkdtemp(prefix="chip_smoke_world_")
    argv = ["--topo", WORLD_TOPO, "--rows", str(SIDE * SIDE), "--seed", str(SEED), "--mm-cols", str(MM_COLS),
            "--timeout", str(WORLD_TIMEOUT_S), "--problem", problem, "--out", out_dir]
    t0 = time.perf_counter()
    printed = io.StringIO()
    try:
        W.write_problem(problem, ctx["A"], ctx["B"], ctx["part"], ctx["part_b"])
        with contextlib.redirect_stdout(printed):
            code = W.main(argv)
    finally:
        shutil.rmtree(problem, ignore_errors=True)
    seconds = time.perf_counter() - t0
    lines = printed.getvalue().strip().splitlines()
    if code != 0:
        raise AssertionError("world: exit " + str(code) + "\n" + "\n".join(lines[-40:]))
    with open(os.path.join(out_dir, "world.json")) as f:
        rec = json.load(f)
    ranks = rec["ranks"]
    r0 = ranks[0]
    log(f"[world] {lines[-1]}")
    log(f"[world] {len(ranks)} processes on one card over gloo, n={r0['n']} nnz={r0['nnz']} L={r0['rows_per_rank']} "
        f"H={r0['halo_width']}: systems built once in {rec['build_s']:.2f} s, start {rec['start_s']:.2f} s (by step "
        f"{json.dumps({k: round(v, 2) for k, v in rec['start_steps_s'].items()})}), each rank's setup "
        f"{max(x['setup_s'] for x in ranks):.2f} s at most, world {rec['total_s']:.2f} s, phase {seconds:.2f} s; "
        f"sections (rank 0) {json.dumps({k: round(v, 2) for k, v in r0['phase_s'].items()})} ({card})")
    for key, ms in r0["exchange_ms"].items():
        log(f"[world] staged exchange {key}: {ms:.4f} ms (slowest rank, host wall, mean of 10) ({card})")
    for key, ms in r0["fault_ms"].items():
        log(f"[world] barrier exchange {key}: {ms:.4f} ms (slowest rank, host wall, mean of 10) ({card})")
    for key, ms in r0["reductions"]["dot_ms"].items():
        log(f"[world] dot {key}: {ms:.4f} ms (slowest rank, host wall, mean of 50) ({card})")
    solves = {**r0["solves"], **r0["fault_solves"], **{k: v for k, v in r0["reductions"].items()
                                                       if k.startswith("cg|")}}
    for key, res in solves.items():
        if "ms_per_iteration" in res:
            log(f"[world] {key} ({res['strategy']}): {res['status']} in {res['iterations']} iterations, "
                f"{res['ms_per_iteration']:.4f} ms/iteration (slowest rank) ({card})")
        else:
            log(f"[world] {key}: {json.dumps(res)}")
    log(f"[world] reductions: {json.dumps(r0['reductions']['values'])}")
    fused = r0["fused"]
    for key, row in fused.items():
        if key == "checks":
            log(f"[world] fused checks: {json.dumps(row)}")
        else:
            log(f"[world] fused {key}: {row['status']} in {row['iterations']} iterations, "
                f"{row['ms_per_iteration']:.4f} ms/iteration fused ({row['timed']}) vs "
                f"{row['host_ms_per_iteration']:.4f} host loop (slowest rank, host wall); first solve "
                f"{row['first_solve_s']:.3f} s, its warm-up and capture {row['capture_s']} s; host reads "
                f"{row['host_reads']}; B1 {row['b1_replayed']} by replays of {row['program_runs']}, "
                f"{row['b1_eager']} eager beyond the {row['b1_warm_up']} of the warm-up ({card})")
    recoveries = Counter(v["recovery"] for x in ranks for v in x["fault_records"].values())
    log(f"[world] recoveries over every rank and case: {dict(recoveries)}")
    mem = [x["memory"] for x in ranks]
    log(f"[world] memory per rank: device peak allocated {[m['device_peak_allocated_bytes'] for m in mem]} B, "
        f"reserved {[m['device_reserved_bytes'] for m in mem]} B, host max RSS after the setup "
        f"{[m['host_max_rss_after_setup_bytes'] for m in mem]} B and at the end "
        f"{[m['host_max_rss_bytes'] for m in mem]} B (shared library pages included), private at the end "
        f"{[m.get('host_private_bytes') for m in mem]} B ({card})")
    log(f"[world] launches per rank {[x['launches'] for x in ranks]}, predicted "
        f"{[x['predicted_launches'] for x in ranks]}")
    moe = r0["moe"]
    log(f"[world] moe: {MOE_ARCH} layer at full width on the 4x4 (pod, local) mesh, d_model {moe['d_model']}, "
        f"{moe['experts']} experts of {moe['d_ff_expert']}, top-{moe['top_k']}, batch {moe['batch']}, bf16")
    for key, ms in moe["ms"].items():
        log(f"[world] moe {key}: {ms:.4f} ms per call (slowest rank, host wall, mean of {W.MOE_TIMED} calls, the "
            f"count all-gather of 50; stacked: rank 0 alone) ({card})")
    log(f"[world] moe vs the stacked exchange on rank 0: {json.dumps(moe['stacked'])}; int8 wire max abs err "
        f"against full precision {moe['int8_max_abs_err']}; cache [after call 1, after call 5] "
        f"{json.dumps(moe['cache'])}; auto picked "
        f"{moe['uniform|auto_picked']} / {moe['skewed|auto_picked']}")
    log(f"[world] moe slots summed over the ranks (routed, dropped, shipped): "
        + json.dumps({k: v for k, v in moe["tally"].items() if k.endswith("|summed")}) + "; stacked "
        + json.dumps(moe["tally"]["stacked"]))
    log(f"[world] moe device peak allocated per rank (whole world run): "
        f"{[x['moe'].get('device_peak_allocated_bytes') for x in ranks]} B ({card})")
    def gates_of(part: str) -> int:
        return sum(k.startswith(part + " ") for x in ranks for k in x["gates"])

    checks = {
        f"{sum(len(x['gates']) for x in ranks)} gates on {len(ranks)} ranks, none failed": not rec["failed_gates"],
        "16 ranks": len(ranks) == 16,
        f"{gates_of('faults')} faults gates and {gates_of('reductions')} reductions gates ran": (
            gates_of("faults") > 0 and gates_of("reductions") > 0),
        "every retry, demote and re-advise case recovered on every rank": all(
            (v["recovery"] or "").startswith(k.split("|")[0]) for x in ranks for k, v in x["fault_records"].items()
            if k.split("|")[0] in ("retry", "demote", "readvise")),
        "every rank launched B1 and B2 as predicted": all(
            x["launches"] == x["predicted_launches"] and x["launches"]["spmv_ell"] > 0 and x["launches"]["spmm_ell"] > 0
            for x in ranks),
        f"{gates_of('moe')} moe gates ran, the full-width layer": gates_of("moe") > 0 and all(
            x["moe"]["d_model"] == get_config(MOE_ARCH).d_model for x in ranks),
        f"{gates_of('fused')} fused gates ran, CG of every strategy and BiCGStab of {list(W.CARD_BICGSTAB)}, "
        f"B1 by replays on every rank": (
            gates_of("fused") > 0 and all(
                x["fused"][f"{solver}|{s}|none|barrier"]["b1_replayed"] > 0
                and x["fused"][f"{solver}|{s}|none|barrier"]["b1_eager"] == 0
                for x in ranks for solver, strategies in (("cg", STRATEGIES), ("bicgstab", W.CARD_BICGSTAB))
                for s in strategies)),
    }
    ctx["details"]["world"] = {
        "seconds": seconds, "build_s": rec["build_s"], "start_s": rec["start_s"],
        "start_steps_s": rec["start_steps_s"], "total_s": rec["total_s"],
        "exchange_ms": r0["exchange_ms"], "solves": r0["solves"], "fault_ms": r0["fault_ms"],
        "fault_solves": r0["fault_solves"], "fused": fused, "reductions": r0["reductions"], "memory": mem,
        "launches": [x["launches"] for x in ranks], "setup_s": [x["setup_s"] for x in ranks],
        "phase_s": [x["phase_s"] for x in ranks], "spmv_rel_err": r0["spmv_rel_err"], "moe": moe,
    }
    launchers = world_launchers(ctx)
    ctx["details"]["world"]["launchers"] = launchers
    checks.update(launchers["checks"])
    for name, ok in checks.items():
        log(f"[world] {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("world check failed: " + ", ".join(k for k, ok in checks.items() if not ok)
                             + "\n" + "\n".join(rec["failed_gates"][:20]))


#: the phases in the order ``main`` runs them
PHASES = (
    ("build", phase_build),
    # its own process, before any other process has used the card
    ("fused_profile", phase_fused_profile),
    ("examples", phase_examples),
    ("mesh", phase_mesh),
    ("setup", phase_setup),
    ("kernels", phase_kernels),
    ("exchange", phase_exchange),
    ("spmv", phase_spmv),
    ("solve", phase_solve),
    ("profile", phase_profile),
    ("faults", phase_faults),
    ("serving", phase_serving),
    ("lm_kernels", phase_lm_kernels),
    ("serve", phase_serve),
    ("serve_stablelm", phase_serve_stablelm),
    ("moe_dispatch", phase_moe_dispatch),
    ("serve_moe", phase_serve_moe),
    ("serve_mla", phase_serve_mla),
    ("serve_whisper", phase_serve_whisper),
    ("serve_vlm", phase_serve_vlm),
    ("train", phase_train),
    ("dryrun", phase_dryrun),
    # after thousands of graph replays torch.profiler sessions in this
    # process record no device activity (PERF.md), and the phases above
    # gate on theirs
    ("fused", phase_fused),
    # after fused: with the 16 processes of phase world on the card earlier
    # in the run (right after mesh), fused's profiler saw 400 of its 402 B1
    # launches (PERF.md §6, the world); its children use nothing of this process
    ("world", phase_world),
)


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--fused-profile"]:
        with open(sys.argv[2], "w") as f:
            json.dump(fused_profile(), f)
        return 0
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available; this script runs only on a GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    ctx = {"details": {"card": smi}, "whole_run": True}
    t_all = time.perf_counter()
    for name, fn in PHASES:
        t0 = time.perf_counter()
        try:
            fn(ctx)
            torch.cuda.synchronize()
        except Exception:
            traceback.print_exc()
            log(f"chip_smoke: phase {name} FAILED")
            return 1
        # what a reference cycle keeps outlives its phase until the collector
        # runs (a caught fault's traceback once held serve_moe's 36.7 GiB of
        # weights into serve_mla): collect here, and show what stays
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    line = kernels_line(ctx)
    ctx["details"]["kernels"] = line["kernels"]
    ctx["details"]["seconds"] = time.perf_counter() - t_all
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(ctx["details"], f, indent=1)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
