"""Distributed Krylov solve: the iterative workload the paper's models
amortize over.

1. Build an SPD system with thermal2-like communication structure and ask
   the iteration-amortized advisor (`repro_torch.core.advise_solver`) which
   strategy wins a whole solve -- setup cost paid once, per-iteration
   exchange + hierarchical-reduction cost multiplied by the iteration count.
   Note the flip: a 1-iteration "solve" favours standard communication
   (no communicator construction), a real solve favours the node-aware
   winner.
2. Solve with CG on the numpy executor (`repro_torch.solve.NumpySpMV`)
   under every strategy, barrier and split-phase: one cached exchange plan
   serves all iterations (shown via `repro_torch.comm.cache_stats()`) and
   the residual histories are bitwise identical across all configurations.
3. Re-run on the device (`repro_torch.sparse.DistributedSpMV`, the 8 ranks
   stacked on ``--device``; on the card its local product is the kernel B1)
   with dot products through the node-aware hierarchical tree
   (`repro_torch.solve.TorchReductions`), including an int8-compressed
   inter-pod reduction variant.
4. With ``--fused``: compare the host-driven loop against the fused
   whole-solve (`repro_torch.solve.fused_cg`: CUDA graphs replayed until
   the device says the solve has ended; eager on the CPU), and ask the
   advisor's `LaunchModel` accounting (`advise_solver(fused="auto")`) at
   which horizon the one-time trace cost beats the per-iteration host
   dispatches.

The port's counterpart of ``examples/krylov_solve.py``: the same option
(``--fused``) and lines, plus ``--device``; steps 3 and 4 run in this
process.  Two departures show in step 4's line: the fused solve carries
float64 scalars, so its history equals the host loop's bitwise (drift 0);
and its cache holds one captured solve per operator (its key ends in the
operator's ``id``), so "program compile / cache hits" are the port's own
counts, printed as such, not the reference's per-pattern ones.

    PYTHONPATH=src python -m repro_torch.examples.krylov_solve [--fused] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.comm import Compressor, cache_stats, clear_caches
from repro_torch.comm.topology import PodTopology
from repro_torch.core import advise_solver, figure43_pattern
from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device_option, counts_launches, run
from repro_torch.solve import (REDUCTIONS_PER_ITER, NumpySpMV, TorchReductions, cg, fused_cg,
                               spd_system)
from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like


@counts_launches
def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fused", action="store_true")
    add_device_option(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    topo = PodTopology(npods=2, ppn=4)
    A = spd_system(thermal_like(1024, rng))
    part = partition_csr(A, topo)
    pattern = part.pattern.to_comm_pattern()
    b = rng.normal(size=(topo.nranks, part.rows_per_rank))
    out = {"advice": {}}

    print(f"SPD system n={A.n} nnz={A.nnz} on {topo.nranks} ranks\n")

    # 1. iteration-amortized strategy selection.  On the paper's flagship
    #    pattern (256 x 2 KiB messages to 16 nodes, Fig 4.3) the winner
    #    FLIPS with the horizon: standard wins a 1-iteration "solve" (no
    #    communicator construction), 2-Step wins once its setup amortizes.
    flagship = figure43_pattern(2048, 256, 16)
    for iters in (1, 200):
        adv = advise_solver(
            flagship, iters, machine="lassen",
            reductions_per_iter=REDUCTIONS_PER_ITER["cg"],
        )
        print(f"amortized advisor on the Fig 4.3 pattern, iters={iters}:")
        print(adv.table())
        print(f"-> best for a {iters}-iteration solve: {adv.best.key}\n")
        out["advice"][iters] = adv.table()
    #    ... while this small stencil system is latency-bound at every
    #    horizon: node-aware setup never pays for itself (also the paper's
    #    conclusion for small per-message volumes).
    adv = advise_solver(pattern, 200, machine="tpu_v5e_pod",
                        reductions_per_iter=REDUCTIONS_PER_ITER["cg"])
    print(f"this matrix's own pattern, iters=200 -> {adv.best.key} "
          f"(latency-bound: no flip)\n")
    out["own_pattern_best"] = adv.best.key

    # 2. CG on the numpy executor: every strategy, barrier + split-phase
    clear_caches()
    histories = {}
    for strategy in ("standard", "two_step", "three_step", "split"):
        for overlap in (False, True):
            op = NumpySpMV(part, strategy=strategy, overlap=overlap)
            res = cg(op, b, tol=1e-6)
            histories[(strategy, overlap)] = res.residuals
            assert res.converged
    ref = histories[("standard", False)]
    assert all(h == ref for h in histories.values())
    s = cache_stats()
    print(f"numpy executor: {len(histories)} strategy/overlap configs, "
          f"all converged in {len(ref) - 1} iterations with bitwise-identical "
          f"residual histories")
    print(f"plan cache over all solves: {s.plan_misses} misses "
          f"(one per distinct sub-pattern), {s.plan_hits} hits; "
          f"split decompositions: {s.split_misses} miss, {s.split_hits} hits\n")
    out["histories"] = histories
    out["cache"] = {k: getattr(s, k) for k in ("plan_misses", "plan_hits", "split_misses", "split_hits")}

    if args.fused:
        # 2b. where does the fused front-end win?  The LaunchModel charges
        #     the host loop t_launch per dispatch and the fused program one
        #     t_trace up front; the ranking flips to +fused once the trace
        #     amortizes (~t_trace / (launches_per_iter * t_launch) iters).
        for iters in (50, 400):
            adv = advise_solver(
                flagship, iters, machine="lassen", fused="auto",
                reductions_per_iter=REDUCTIONS_PER_ITER["cg"],
            )
            print(f"fused-aware advisor, iters={iters} -> {adv.best.key}")
            out["advice"][f"fused@{iters}"] = adv.best.key
        print()

    # 3. the device executor + hierarchical reductions, in this process
    print(f"re-running the solve on {device}...")
    out.update(_device_execution(topo, part, b, device, fused=args.fused))
    return out


def _device_execution(topo, part, b, device, fused=False) -> dict:
    print("DEVICE EXECUTION")
    bf = b.astype(np.float32)
    red = TorchReductions(topo)
    out = {"device": {}}
    for strategy, overlap in (("two_step", False), ("two_step", True)):
        op = DistributedSpMV(part, strategy=strategy, overlap=overlap, device=device)
        res = cg(op, bf, tol=1e-6, reductions=red)
        mode = "overlap" if overlap else "barrier"
        print(f"  {strategy:9s} {mode:8s} converged={res.converged} "
              f"iters={res.iterations} relres={res.final_residual:.2e}")
        out["device"][mode] = res.residuals
    comp = TorchReductions(topo, compressor=Compressor())
    res = cg(DistributedSpMV(part, strategy="two_step", device=device),
             bf, tol=1e-4, maxiter=200, reductions=comp)
    print(f"  two_step  int8-compressed inter-pod reductions: "
          f"converged={res.converged} iters={res.iterations} "
          f"relres={res.final_residual:.2e}")
    out["device"]["int8"] = res.residuals
    if not fused:
        return out
    # 4. fused whole-solve: same SolveResult contract, captured CUDA graphs
    #    replayed instead of per-iteration host dispatches
    op = DistributedSpMV(part, strategy="two_step", device=device)
    host = cg(op, bf, tol=1e-6, reductions=red)
    fres = fused_cg(op, bf, tol=1e-6)
    s = cache_stats()
    drift = max(
        abs(a - c) / max(abs(c), 1e-30)
        for a, c in zip(fres.residuals, host.residuals)
    )
    print(f"  two_step  fused whole-solve: converged={fres.converged} "
          f"iters={fres.iterations} (host {host.iterations}), "
          f"history drift {drift:.1e}, "
          f"{s.fused_misses} program compile / {s.fused_hits} cache hits "
          f"(the port's fused cache: one captured solve per operator)")
    out["fused"] = {"host": host.residuals, "fused": fres.residuals,
                    "misses": s.fused_misses, "hits": s.fused_hits}
    return out


if __name__ == "__main__":
    run(main)
