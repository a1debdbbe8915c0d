"""Distributed sparse matrix substrate (the paper's SpMV case study)."""

from repro_torch.sparse.matrices import (
    GENERATORS,
    CSRMatrix,
    audikw_like,
    banded,
    random_block,
    thermal_like,
)
from repro_torch.sparse.partition import (
    EllBlock,
    RankSlice,
    SpmvPartition,
    partition_csr,
    partition_from_arrays,
    rank_partition,
    rank_slice,
)
from repro_torch.sparse.spmv import DistributedSpMV, build, reference, reference_mm

__all__ = [
    "GENERATORS",
    "CSRMatrix",
    "audikw_like",
    "banded",
    "random_block",
    "thermal_like",
    "EllBlock",
    "RankSlice",
    "SpmvPartition",
    "partition_csr",
    "partition_from_arrays",
    "rank_partition",
    "rank_slice",
    "DistributedSpMV",
    "build",
    "reference",
    "reference_mm",
]
