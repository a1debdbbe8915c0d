"""Quickstart: the paper's pipeline in ~80 lines.

1. Build an irregular communication pattern (a distributed SpMV halo).
2. Ask the model-driven advisor (paper §4.6) which node-aware strategy wins
   -- including the payload-width effect: batched ``k``-column payloads scale
   the byte terms while message counts stay fixed, which can flip the winner.
3. Execute every strategy and verify identical results: single-vector SpMV,
   the fused multi-vector ``matmat`` (ONE exchange for all ``k`` columns),
   and the split-phase ``overlap=True`` pipeline.

The port's counterpart of ``examples/quickstart.py``.  The 8 ranks are one
stacked tensor on ``--device`` (default: the CUDA device), so step 3 runs in
this process: on the card the local products are the kernels B1
(``spmv_ell``) and B2 (``spmm_ell``), with their ``tile_mask`` variants on
the overlap path; ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.comm.topology import PodTopology
from repro_torch.core import advise
from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device_option, counts_launches, run
from repro_torch.sparse import audikw_like, build, partition_csr

K = 8  # multi-vector payload width for the SpMM demo
STRATEGIES = ("standard", "two_step", "three_step", "split")


@counts_launches
def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    add_device_option(ap)
    device = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    topo = PodTopology(npods=2, ppn=4)

    # 1. the paper's case study: a row-partitioned sparse matrix induces an
    #    irregular point-to-point pattern
    A = audikw_like(128, rng)
    part = partition_csr(A, topo)
    pattern = part.pattern.to_comm_pattern()
    print(f"matrix n={A.n} nnz={A.nnz}; irregular pattern: "
          f"{len(pattern.messages)} messages, stats={pattern.stats()}\n")

    # 2. model-driven strategy selection (Table 6 composites), and how the
    #    batched payload width k moves the ranking (PatternStats.widened)
    tables = {}
    for k in (1, K):
        advice = advise(pattern, machine="tpu_v5e_pod", payload_width=k)
        print(f"advisor ranking (TPU registry, payload_width={k}):")
        print(advice.table())
        print(f"-> best at k={k}: {advice.best.key}\n")
        tables[k] = advice.table()

    # 3. execute all strategies on the stacked ranks and verify
    print(f"executing strategies on {device}...")
    print("EXECUTION")
    v = rng.normal(size=(A.n,)).astype(np.float32)
    V = rng.normal(size=(A.n, K)).astype(np.float32)
    want_v, want_V = A.spmv(v), A.spmm(V)
    wire_bytes, errors = {}, {}
    for strat in STRATEGIES:
        # single vector, barrier exchange
        sp = build(A, topo, strategy=strat, payload_width=K, device=device)
        out = sp(v.reshape(topo.nranks, -1)).cpu().numpy().reshape(-1)
        np.testing.assert_allclose(out, want_v, rtol=1e-4, atol=1e-4)
        # multi-vector: matmat runs ONE exchange + one fused blocked-ELL SpMM
        W = sp.matmat(V.reshape(topo.nranks, -1, K)).cpu().numpy()
        np.testing.assert_allclose(W.reshape(A.n, K), want_V, rtol=1e-4, atol=1e-4)
        # split-phase overlap: interior tiles compute during the inter-node
        # phase; results are bitwise-identical to the barrier path
        ov = build(A, topo, strategy=strat, overlap=True, device=device)
        np.testing.assert_array_equal(ov.matmat(V.reshape(topo.nranks, -1, K)).cpu().numpy(), W)
        wi, we = wire_bytes[strat] = sp.wire_bytes
        errors[strat] = (float(np.abs(out - want_v).max()),
                         float(np.abs(W.reshape(A.n, K) - want_V).max()))
        print(f"  {strat:11s} OK (spmv + matmat k={K} + overlap)   "
              f"intra-pod {wi:6d} B   inter-pod {we:6d} B")
    return {"n": A.n, "nnz": A.nnz, "stats": pattern.stats(), "tables": tables,
            "wire_bytes": wire_bytes, "max_abs_err": errors}


if __name__ == "__main__":
    run(main)
