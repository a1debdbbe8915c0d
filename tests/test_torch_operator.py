"""The port's solver operators against the JAX package's.

* ``repro_torch.solve.NumpySpMV`` is a copy of the reference's numpy
  executor: its halos and products equal the reference's bitwise, for every
  strategy, barrier and split phase, codecs ``none`` and ``int8``, checked
  and not.
* ``traceable_operator`` lowers either operator flavor to a matvec that a
  CUDA graph can capture; on the CPU it equals ``DistributedSpMV`` bitwise
  (the same kernels' plain versions on the same halos) and the numpy
  executor within float32 rounding, and its violation vector raises the
  host executor's structured error.
"""

import numpy as np
import pytest
import torch

from repro.comm.topology import PodTopology as RefTopology
from repro.solve import NumpySpMV as RefNumpySpMV
from repro.solve import spd_system as ref_spd_system
from repro.sparse import partition_csr as ref_partition_csr
from repro.sparse import thermal_like as ref_thermal_like
from repro_torch.comm import (
    STRATEGY_NAMES,
    ExchangeIntegrityError,
    FaultPlan,
    FaultSpec,
    PodTopology,
    cache_stats,
    clear_caches,
)
from repro_torch.solve import NumpySpMV, build_numpy, spd_system, traceable_operator
from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like

TOPO = PodTopology(npods=2, ppn=4)
REF_TOPO = RefTopology(npods=2, ppn=4)
N = 256


def _parts(seed=5):
    A = spd_system(thermal_like(N, np.random.default_rng(seed)))
    RA = ref_spd_system(ref_thermal_like(N, np.random.default_rng(seed)))
    return A, partition_csr(A, TOPO), ref_partition_csr(RA, REF_TOPO)


A, PART, REF_PART = _parts()
L = PART.rows_per_rank


def _vectors(k=3, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((TOPO.nranks, L)).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("verify", [False, True], ids=["unchecked", "checked"])
@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "split"])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
def test_numpy_spmv_matches_reference(strategy, overlap, wire, verify):
    kw = dict(strategy=strategy, overlap=overlap, wire=wire, verify=verify)
    port, ref = NumpySpMV(PART, **kw), RefNumpySpMV(REF_PART, **kw)
    for v in _vectors():
        np.testing.assert_array_equal(port.halo(v), ref.halo(v))
        np.testing.assert_array_equal(port(v), ref(v))
    assert port.wire_bytes == ref.wire_bytes
    assert port.last_recovery is None and ref.last_recovery is None


def test_numpy_spmv_validates_and_plans_once():
    with pytest.raises(ValueError, match="unknown strategy"):
        NumpySpMV(PART, strategy="nope")
    with pytest.raises(ValueError):
        NumpySpMV(PART, wire="fp4")
    op = NumpySpMV(PART)
    with pytest.raises(ValueError, match="expected"):
        op(np.zeros((TOPO.nranks, L + 1), np.float32))
    clear_caches()
    op = build_numpy(A, TOPO, strategy="two_step")
    for v in _vectors():
        op(v)
    assert cache_stats().plan_misses == 1


def test_numpy_spmv_ladder_retries_a_transient_fault():
    fp = FaultPlan(seed=3, specs=(FaultSpec(kind="corrupt"),), active_calls=(0,))
    kw = dict(strategy="two_step", verify=True, faults=fp)
    port, ref = NumpySpMV(PART, **kw), RefNumpySpMV(REF_PART, **kw)
    v = _vectors(1)[0]
    np.testing.assert_array_equal(port(v), ref(v))
    assert port.last_recovery == ref.last_recovery == "retry:two_step/none"


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "split"])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
def test_traceable_operator_equals_distributed_spmv(strategy, overlap):
    op = DistributedSpMV(PART, strategy=strategy, overlap=overlap, device="cpu")
    top = traceable_operator(op)
    assert top.device == op.device and top.blocks is op._blocks and top.nviol == 0
    idx = torch.zeros((), dtype=torch.int64)
    for v in _vectors():
        v = torch.as_tensor(v)
        w, viols = top.matvec(v, idx)
        assert torch.equal(w, op(v)) and viols.numel() == 0


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "split"])
def test_traceable_numpy_operator_on_the_cpu(overlap):
    op = NumpySpMV(PART, strategy="three_step", overlap=overlap)
    top = traceable_operator(op, device="cpu")
    assert top.device == torch.device("cpu")
    idx = torch.zeros((), dtype=torch.int64)
    for v in _vectors():
        w, _ = top.matvec(torch.as_tensor(v), idx)
        # the fmaf chain of the kernel vs numpy's pairwise row sum
        np.testing.assert_allclose(w.numpy(), op(v), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="lives on"):
        traceable_operator(DistributedSpMV(PART, strategy="split", device="cpu"), device="meta")


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "split"])
def test_traceable_operator_checks_and_raises_like_the_host(overlap):
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),))
    op = DistributedSpMV(PART, strategy="two_step", overlap=overlap, verify=True, faults=fp,
                         device="cpu")
    op.exchange.max_retries, op.exchange.fallback = 0, False
    if overlap:
        op.exchange.start(torch.as_tensor(_vectors(1)[0]))  # builds the sub-exchanges
        op.exchange._two_phase[0].max_retries, op.exchange._two_phase[0].fallback = 0, False
    v = torch.as_tensor(_vectors(1)[0])
    with pytest.raises(ExchangeIntegrityError) as host:
        op(v)
    top = traceable_operator(op)
    w, viols = top.matvec(v, torch.zeros((), dtype=torch.int64))
    assert viols.numel() == top.nviol > 0 and float(viols.max()) > 0
    with pytest.raises(ExchangeIntegrityError) as fused:
        top.raise_viols(viols.numpy())
    for field in ("strategy", "codec", "stage_kind", "op_index", "round_index", "hop_class"):
        assert getattr(fused.value, field) == getattr(host.value, field), field
    top.raise_viols(np.zeros(top.nviol))  # clean: no raise


def test_traceable_operator_gates_faults_by_call_index():
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="corrupt", prob=1.0, frac=1.0),), active_calls=(2,))
    top = traceable_operator(DistributedSpMV(PART, strategy="split", verify=True, faults=fp,
                                             device="cpu"))
    clean = traceable_operator(DistributedSpMV(PART, strategy="split", verify=True, device="cpu"))
    v = torch.as_tensor(_vectors(1)[0])
    for call in range(5):
        idx = torch.tensor(call)
        w, viols = top.matvec(v, idx)
        w0, viols0 = clean.matvec(v, idx)
        assert torch.equal(w, w0) == (call != 2), call
        assert (float(viols.max()) > 0) == (call == 2), call
        assert float(viols0.max()) <= 0
