"""The port's MoE routing helpers and exchange front door against the JAX package's.

Everything here is numpy planning and must be **bitwise** the reference's:
``block_pattern`` / ``quantize_widths`` (needs, fingerprints, widths),
``recv_maps``, the ``RoutingBucketer``'s replans and bundles on the same
count streams, the ``ExpertLoadHistogram``'s EMA and its advice rankings,
and ``MoEDispatcher``'s ``"auto"`` strategy.  ``exchange_for`` and the
dispatcher's exchange-cache accounting are the reference's
``tests/test_moe_dispatch.py`` cases, run in process on the CPU (the
reference needs 8 host devices for them).
"""

import numpy as np
import pytest

from repro.comm import PodTopology as RefTopology
from repro.comm import block_pattern as ref_block_pattern
from repro.comm import quantize_widths as ref_quantize_widths
from repro.models import ExpertLoadHistogram as RefHistogram
from repro.models import MoEDispatcher as RefDispatcher
from repro.models import RoutingBucketer as RefBucketer
from repro.models import recv_maps as ref_recv_maps
from repro_torch.comm import (
    IrregularExchange,
    PodTopology,
    block_pattern,
    cache_sizes,
    cache_stats,
    clear_caches,
    exchange_for,
    quantize_widths,
    set_cache_limits,
)
from repro_torch.models import ExpertLoadHistogram, MoEDispatcher, RoutingBucketer, recv_maps

TOPOS = {(2, 2): (PodTopology(2, 2), RefTopology(2, 2)), (2, 4): (PodTopology(2, 4), RefTopology(2, 4))}
SEEDS = (0, 1, 2)


def _counts(n, seed=0, lo=0, hi=12):
    return np.random.default_rng(seed).integers(lo, hi, size=(n, n))


def _same_pattern(p, r):
    assert p.fingerprint() == r.fingerprint()
    assert p.local_size == r.local_size
    assert [(n.dst, n.src, n.idx) for n in p.needs] == [(n.dst, n.src, n.idx) for n in r.needs]


# ---------------------------------------------------------------------------
# block_pattern / quantize_widths / recv_maps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(TOPOS), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", (None,) + SEEDS, ids=lambda s: "full" if s is None else f"seed{s}")
def test_block_pattern_and_quantize_widths_match_reference(shape, seed):
    topo, ref_topo = TOPOS[shape]
    n, block = topo.nranks, 8
    w = None
    if seed is not None:
        c = _counts(n, seed, hi=20)
        w = quantize_widths(c, 4, block)
        np.testing.assert_array_equal(w, ref_quantize_widths(c, 4, block))
        assert w.dtype == ref_quantize_widths(c, 4, block).dtype
    _same_pattern(block_pattern(topo, block, w), ref_block_pattern(ref_topo, block, w))


def test_block_pattern_and_quantize_widths_reject_what_the_reference_rejects():
    topo = PodTopology(2, 2)
    with pytest.raises(ValueError, match="widths must be"):
        block_pattern(topo, 4, np.zeros((4, 5), int))
    with pytest.raises(ValueError, match="lie in"):
        block_pattern(topo, 4, np.full((4, 4), 5))
    with pytest.raises(ValueError, match="lie in"):
        block_pattern(topo, 4, -np.ones((4, 4), int))
    counts = np.array([[0, 1, 8, 9], [15, 16, 17, 100], [0, 0, 0, 0], [3, 7, 8, 12]])
    np.testing.assert_array_equal(quantize_widths(counts, 8, 16), ref_quantize_widths(counts, 8, 16))
    with pytest.raises(ValueError, match="quantum"):
        quantize_widths(counts, 0, 16)
    with pytest.raises(ValueError, match="non-negative"):
        quantize_widths(-counts, 8, 16)


@pytest.mark.parametrize("shape", sorted(TOPOS), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_recv_maps_match_reference(shape, seed):
    topo, ref_topo = TOPOS[shape]
    block = 8
    w = quantize_widths(_counts(topo.nranks, seed, hi=20), 4, block)
    np.fill_diagonal(w, 0)
    maps, H = recv_maps(topo, block, w)
    ref_maps, ref_H = ref_recv_maps(ref_topo, block, w)
    assert H == ref_H == block_pattern(topo, block, w).max_recv_size()
    assert maps.dtype == ref_maps.dtype
    np.testing.assert_array_equal(maps, ref_maps)
    with pytest.raises(ValueError, match="widths must be"):
        recv_maps(topo, block, np.zeros((topo.nranks, topo.nranks + 1), int))
    with pytest.raises(ValueError, match="lie in"):
        recv_maps(topo, block, np.full((topo.nranks, topo.nranks), block + 1))


# ---------------------------------------------------------------------------
# RoutingBucketer and ExpertLoadHistogram on the same count streams
# ---------------------------------------------------------------------------


def _stream(n, seed, steps=12):
    """Stationary skewed counts with jitter, then a burst that grows them."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n, n), np.int64)
    base[:, : max(n // 3, 1)] = 20
    np.fill_diagonal(base, 0)
    out = [np.maximum(base + rng.integers(-3, 4, size=(n, n)) * (base > 0), 0) for _ in range(steps)]
    return out + [base + 9, base - 3 * (base > 0), base]


@pytest.mark.parametrize("shape", sorted(TOPOS), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_bucketer_replans_and_bundles_match_reference(shape, seed):
    topo, ref_topo = TOPOS[shape]
    port, ref = RoutingBucketer(topo, block=32, quantum=8), RefBucketer(ref_topo, block=32, quantum=8)
    for counts in _stream(topo.nranks, seed):
        (pb, prp), (rb, rrp) = port.step(counts), ref.step(counts)
        assert prp == rrp
        np.testing.assert_array_equal(pb.widths, rb.widths)
        np.testing.assert_array_equal(pb.map_dispatch, rb.map_dispatch)
        np.testing.assert_array_equal(pb.map_return, rb.map_return)
        assert (pb.halo_dispatch, pb.halo_return) == (rb.halo_dispatch, rb.halo_return)
        _same_pattern(pb.pattern_dispatch, rb.pattern_dispatch)
        _same_pattern(pb.pattern_return, rb.pattern_return)
    assert (port.steps, port.replans, port.hit_rate) == (ref.steps, ref.replans, ref.hit_rate)
    with pytest.raises(ValueError, match="block"):
        RoutingBucketer(topo, block=0)


@pytest.mark.parametrize("machine", ["tpu_v5e_pod", "lassen"])
@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_ema_and_advice_match_reference(seed, machine):
    topo, _ = TOPOS[2, 4]
    port, ref = ExpertLoadHistogram(topo.nranks, decay=0.7), RefHistogram(topo.nranks, decay=0.7)
    for counts in _stream(topo.nranks, seed, steps=5):
        port.update(counts)
        ref.update(counts)
        np.testing.assert_array_equal(port.counts, ref.counts)
    pa = port.advise(ppn=topo.ppn, payload_width=64, machine=machine)
    ra = ref.advise(ppn=topo.ppn, payload_width=64, machine=machine)
    assert [(r.key, r.predicted_time) for r in pa.ranked] == [(r.key, r.predicted_time) for r in ra.ranked]
    assert pa.table() == ra.table()
    with pytest.raises(ValueError, match="counts must be"):
        port.update(np.zeros((topo.nranks, topo.nranks + 1)))
    with pytest.raises(ValueError, match="decay"):
        ExpertLoadHistogram(topo.nranks, decay=1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_auto_strategy_matches_reference(seed):
    """``strategy="auto"`` ranks the bucketed widths on the reference's
    machine, so the port picks the reference's strategy."""
    topo, ref_topo = TOPOS[2, 4]
    port = MoEDispatcher(topo, device="cpu")
    ref = RefDispatcher(ref_topo)
    for counts in _stream(topo.nranks, seed, steps=3):
        w = quantize_widths(counts, 8, 32)
        for width in (1, 16, 5120):
            assert port._resolve_strategy(w, width) == ref._resolve_strategy(w, width)
    with pytest.raises(ValueError, match="strategy must be"):
        MoEDispatcher(topo, strategy="nope", device="cpu")


# ---------------------------------------------------------------------------
# exchange_for and the dispatcher's cache accounting
# ---------------------------------------------------------------------------


def test_exchange_for_memoizes_per_request_and_device():
    topo = PodTopology(2, 4)
    pat = block_pattern(topo, 4)
    clear_caches()
    a = exchange_for(pat, "two_step", device="cpu")
    b = exchange_for(block_pattern(topo, 4), "two_step", device="cpu")  # equal fingerprint
    c = exchange_for(pat, "standard", device="cpu")
    d = exchange_for(pat, "two_step", device="cpu", wire="int8")
    assert a is b and a is not c and a is not d and isinstance(a, IrregularExchange)
    assert (a.device.type, d.wire) == ("cpu", "int8")
    s = cache_stats()
    assert (s.exchange_hits, s.exchange_misses) == (1, 3) and cache_sizes()["exchange"] == 3
    try:
        set_cache_limits(exchange=2)
        s = cache_stats()
        assert s.exchange_evictions == 1 and cache_sizes()["exchange"] == 2
        exchange_for(pat, "two_step", device="cpu")  # evicted: built again
        assert cache_stats().exchange_misses == 4
        with pytest.raises(ValueError, match="exchange cache limit"):
            set_cache_limits(exchange=0)
    finally:
        set_cache_limits(exchange=64)
        clear_caches()
    assert cache_sizes()["exchange"] == 0 and cache_stats().exchange_misses == 0


def test_dispatcher_uniform_load_pays_one_plan_miss():
    """The reference's pinned accounting: saturating uniform counts make
    dispatch and return one pattern -- one plan miss, one exchange miss."""
    topo = PodTopology(2, 4)
    n, block, batches = topo.nranks, 32, 12
    clear_caches()
    disp = MoEDispatcher(topo, strategy="two_step", quantum=8, device="cpu")
    full = np.full((n, n), 2 * block, np.int64)
    np.fill_diagonal(full, 0)
    for _ in range(batches):
        step = disp.step(full, block)
    s = cache_stats()
    assert disp.bucketer(block).replans == 1
    assert (s.plan_misses, s.exchange_misses, s.exchange_hits) == (1, 1, 2 * batches - 1)
    assert step.exchange_dispatch is step.exchange_return and step.strategy == "two_step"
    assert disp.histogram.updates == batches
    clear_caches()


def test_dispatcher_skewed_jitter_keeps_the_cache_hot():
    """Skewed stationary traffic with jitter: one replan, >= 90% exchange
    hits (the reference's acceptance number), distinct dispatch / return."""
    topo = PodTopology(2, 4)
    n, block, batches = topo.nranks, 32, 12
    clear_caches()
    disp = MoEDispatcher(topo, strategy="two_step", quantum=8, device="cpu")
    rng = np.random.default_rng(0)
    base = np.zeros((n, n), np.int64)
    base[:, :3] = 20
    np.fill_diagonal(base, 0)
    for _ in range(batches):
        disp.step(base + rng.integers(-3, 4, size=(n, n)) * (base > 0), block)
    s = cache_stats()
    assert disp.bucketer(block).replans == 1 and disp.bucketer(block).hit_rate >= 0.9
    assert (s.exchange_misses, s.exchange_hits) == (2, 2 * (batches - 1))
    assert s.exchange_hits / (s.exchange_hits + s.exchange_misses) >= 0.9
    clear_caches()


def test_dispatcher_skips_hops_without_needs():
    """Every token routed to its own shard: no exchange runs at all."""
    topo = PodTopology(2, 2)
    disp = MoEDispatcher(topo, strategy="standard", device="cpu")
    step = disp.step(np.diag([5, 6, 7, 8]), 8)
    assert step.exchange_dispatch is None and step.exchange_return is None
    assert step.bundle.halo_dispatch == 0
