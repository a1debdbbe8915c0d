"""The port's partition and distributed SpMV against the JAX package's.

* ``partition_csr`` is a vectorised rewrite: its arrays and pattern must be
  bitwise the reference's for every generator.
* ``partition_from_arrays`` carries a reference partition into the port.
* ``DistributedSpMV(device="cpu")`` agrees with ``repro.solve.NumpySpMV``
  within float32 rounding (the two sum a row's slots in different orders),
  and keeps the port's bitwise invariants: overlap == barrier and
  ``matmat == matmat_looped``.
* One subprocess holds the port against the JAX ``DistributedSpMV`` with the
  Pallas kernels in interpret mode on 8 forced host devices.
"""

import numpy as np
import pytest
import torch

from repro.comm.topology import PodTopology as RefTopology
from repro.solve import NumpySpMV
from repro.sparse import partition_csr as ref_partition_csr
from repro.sparse.matrices import GENERATORS as REF_GENERATORS
from repro_torch.comm import STRATEGY_NAMES, PodTopology, cache_stats, clear_caches
from repro_torch.sparse import (
    GENERATORS,
    DistributedSpMV,
    build,
    partition_csr,
    partition_from_arrays,
    thermal_like,
)

TOPO = PodTopology(npods=2, ppn=4)
REF_TOPO = RefTopology(npods=2, ppn=4)
N = 144
TOL = 1e-5  # float32 rounding of rows of a few dozen slots, summed in two orders


def _matrices(name, seed=0, n=N):
    return (
        GENERATORS[name](n, np.random.default_rng(seed)),
        REF_GENERATORS[name](n, np.random.default_rng(seed)),
    )


def _arrays(part):
    return (
        part.diag.data, part.diag.cols, part.off.data, part.off.cols, part.off_row_nnz,
    )


def _carry(ref_part):
    """A reference partition as the port's, through plain arrays."""
    return partition_from_arrays(
        (ref_part.topo.npods, ref_part.topo.ppn),
        ref_part.rows_per_rank,
        [(n.dst, n.src, n.idx) for n in ref_part.pattern.needs],
        (ref_part.diag.data, ref_part.diag.cols),
        (ref_part.off.data, ref_part.off.cols),
        ref_part.halo_width,
        ref_part.off_row_nnz,
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_partition_matches_reference_bitwise(name, seed):
    A, RA = _matrices(name, seed)
    assert np.array_equal(A.indptr, RA.indptr) and np.array_equal(A.data, RA.data)
    port, ref = partition_csr(A, TOPO), ref_partition_csr(RA, REF_TOPO)
    for a, b in zip(_arrays(port), _arrays(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert port.halo_width == ref.halo_width
    assert port.pattern.fingerprint() == ref.pattern.fingerprint()
    assert [(n.dst, n.src, n.idx) for n in port.pattern.needs] == [
        (n.dst, n.src, n.idx) for n in ref.pattern.needs
    ]


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_partition_from_arrays_round_trips(name):
    A, RA = _matrices(name, 3)
    carried = _carry(ref_partition_csr(RA, REF_TOPO))
    port = partition_csr(A, TOPO)
    assert carried.topo == port.topo and carried.rows_per_rank == port.rows_per_rank
    assert carried.pattern == port.pattern
    for a, b in zip(_arrays(carried), _arrays(port)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_partition_rejects_indivisible():
    with pytest.raises(ValueError):
        partition_csr(thermal_like(100, np.random.default_rng(0)), TOPO)


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "overlap"])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
def test_spmv_matches_numpy_spmv(strategy, overlap):
    A, RA = _matrices("audikw_like", 4)
    ref_part = ref_partition_csr(RA, REF_TOPO)
    sp = DistributedSpMV(_carry(ref_part), strategy=strategy, overlap=overlap, device="cpu")
    ref = NumpySpMV(ref_part, strategy=strategy, overlap=overlap)
    rng = np.random.default_rng(5)
    v = rng.normal(size=(TOPO.nranks, N // TOPO.nranks)).astype(np.float32)
    w = sp(v)
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    np.testing.assert_allclose(w.numpy(), ref(v), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(w.numpy().reshape(-1), RA.spmv(v.reshape(-1)), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(sp.halo(v).numpy(), ref.halo(v))


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_overlap_and_matmat_are_bitwise(name):
    A, _ = _matrices(name, 6)
    part = partition_csr(A, TOPO)
    rng = np.random.default_rng(7)
    L = part.rows_per_rank
    v = rng.normal(size=(TOPO.nranks, L)).astype(np.float32)
    V = rng.normal(size=(TOPO.nranks, L, 4)).astype(np.float32)
    want_mm = A.spmm(V.reshape(-1, 4))
    for strategy in STRATEGY_NAMES:
        bar = DistributedSpMV(part, strategy=strategy, device="cpu")
        ov = DistributedSpMV(part, strategy=strategy, overlap=True, device="cpu")
        assert torch.equal(ov(v), bar(v))
        mm = bar.matmat(V)
        assert torch.equal(mm, bar.matmat_looped(V))
        assert torch.equal(ov.matmat(V), mm)
        assert torch.equal(bar(V), mm)  # a 3-D payload dispatches to matmat
        np.testing.assert_allclose(mm.numpy().reshape(-1, 4), want_mm, rtol=TOL, atol=TOL)


def test_auto_strategy_uses_lassen_and_plans_once():
    from repro_torch.core.advisor import EXECUTABLE_STRATEGY, advise

    clear_caches()
    A, _ = _matrices("thermal_like", 8, n=256)
    part = partition_csr(A, TOPO)
    sp = build(A, TOPO, device="cpu")
    want = advise(part.pattern.to_comm_pattern(), machine="lassen")
    assert sp.strategy == EXECUTABLE_STRATEGY[want.best.strategy]
    DistributedSpMV(part, device="cpu")
    for k in (None, 2, 3, 2):
        x = np.ones((TOPO.nranks, part.rows_per_rank) + (() if k is None else (k,)), np.float32)
        sp(x)
    s = cache_stats()
    assert s.plan_misses == 1 and s.plan_hits == 1, s
    # one compute program per payload width: vector, k=2, k=3
    assert s.compute_misses == 3, s


def test_wire_codecs_are_a_later_slice():
    """``wire=`` raised until the codecs slice (ROADMAP A.1); now the
    operator's halo is the reference's ``execute_numpy(wire="int8")``
    bitwise, and its product, barrier and overlapped, agrees with
    ``NumpySpMV(wire="int8")``'s within float32 rounding."""
    from repro.comm import execute_numpy as ref_execute_numpy

    A, R = _matrices("thermal_like", 0)
    sp = build(A, TOPO, strategy="two_step", wire="int8", device="cpu")
    ov = build(A, TOPO, strategy="two_step", wire="int8", device="cpu", overlap=True)
    ref_part = ref_partition_csr(R, REF_TOPO)
    ref = NumpySpMV(ref_part, strategy="two_step", wire="int8")
    ref_ov = NumpySpMV(ref_part, strategy="two_step", wire="int8", overlap=True)
    v = np.random.default_rng(1).normal(size=(TOPO.nranks, sp.rows_per_rank)).astype(np.float32)
    np.testing.assert_array_equal(sp.halo(v).numpy(), ref_execute_numpy(ref._plan, v, wire="int8"))
    w = sp(v)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref(v)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ov(v).numpy(), np.asarray(ref_ov(v)), rtol=TOL, atol=TOL)
    assert sp.wire_bytes[1] < build(A, TOPO, strategy="two_step", device="cpu").wire_bytes[1]


def test_port_matches_jax_distributed_spmv(subproc):
    """The JAX DistributedSpMV (Pallas, interpret mode, 8 host devices)
    against the port on the CPU, barrier and overlap."""
    subproc(
        """
import numpy as np, torch
from repro.comm.topology import PodTopology
from repro.sparse import build, partition_csr, thermal_like
from repro_torch.sparse import DistributedSpMV, partition_from_arrays

rng = np.random.default_rng(0)
topo = PodTopology(npods=2, ppn=4)
A = thermal_like(256, rng)
part = partition_csr(A, topo)
port_part = partition_from_arrays(
    (2, 4), part.rows_per_rank, [(n.dst, n.src, n.idx) for n in part.pattern.needs],
    (part.diag.data, part.diag.cols), (part.off.data, part.off.cols),
    part.halo_width, part.off_row_nnz)
v = rng.normal(size=(topo.nranks, part.rows_per_rank)).astype(np.float32)
V = rng.normal(size=(topo.nranks, part.rows_per_rank, 3)).astype(np.float32)
for strat in ("two_step", "split"):
    for overlap in (False, True):
        ref = build(A, topo, strategy=strat, overlap=overlap)
        port = DistributedSpMV(port_part, strategy=strat, overlap=overlap, device="cpu")
        np.testing.assert_allclose(port(v).numpy(), np.asarray(ref(v)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port.matmat(V).numpy(), np.asarray(ref.matmat(V)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(port.halo(v).numpy(), np.asarray(ref.halo(v)))
print("OK")
""",
        devices=8,
    )
