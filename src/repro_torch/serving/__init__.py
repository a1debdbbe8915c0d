"""Multi-tenant serving front end: continuous batching over cached plans.

Concurrent SpMV/SpMM solve requests enter per-fingerprint FIFO lanes
(:class:`RequestQueue`, admission via
:class:`repro_torch.runtime.AdmissionController`), coalesce into wider
payload batches under a window and memory budget
(:class:`ContinuousBatcher`), and drain through the port's fused SpMM
(:class:`BatchExecutor`: ``DistributedSpMV.matmat``, kernel B2; MoE
dispatch batches through one ``MoELayer`` call each).  The seeded
virtual-clock simulator (:func:`simulate`) makes every scheduling decision
bit-reproducible; its ``trace_hash`` equals the reference's for the same
seed and config.
"""

from .batcher import Batch, ContinuousBatcher
from .executor import BatchExecutor, BatchOutcome, measure_spmv_replay
from .queue import RequestQueue
from .request import Request, WorkloadClass
from .sim import SimConfig, SimResult, sequential_baseline, serving_report, simulate

__all__ = [
    "Batch",
    "BatchExecutor",
    "BatchOutcome",
    "ContinuousBatcher",
    "Request",
    "RequestQueue",
    "SimConfig",
    "SimResult",
    "WorkloadClass",
    "measure_spmv_replay",
    "sequential_baseline",
    "serving_report",
    "simulate",
]
