"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.tracing``), on hand-built profiles and hand-set counters,
and the ``audikw1.cg`` cell at a small size on the CPU."""

import sys
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import controls, run  # noqa: E402
from portbench.trace import Profile  # noqa: E402
from repro_torch import tracing  # noqa: E402
from test_portbench_controls import CG_FAULTS, fails, limits  # noqa: E402

MS = 1_000_000  # ns
READERS = ("solve_idle_ms", "solve_host_reads", "queue_wait_ms", "dispatch_host_ms", "exchange_ms")
AUDIKW1_SMALL = {"generator": "stencil3d_dof_spd", "side": 6, "dof": 3, "shift": 1.0, "npods": 2, "ppn": 2}


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


#: the counts of a stretch: 20 solves, or 300 requests in 135 batches
STRETCH = {"solves": 20, "units": 300, "batch_widths": [2] * 105 + [3] * 30}


def traced(host=(), device=(), extra=None):
    """A run whose profiled stretch (0 to 100 ms) holds ``host`` spans and
    ``device`` events, each ``(name, start ns, end ns)``, and the
    stretch's counts ``extra``."""
    prof = Profile(device=list(device), host=list(host), stretch=(0, 100 * MS), extra=dict(extra or STRETCH))
    return run.Run(1.0, {}, prof, None, None)


def untraced():
    return run.Run(1.0, {"elapsed_s": 1.0, "solves": 3, "iterations": 78}, None, None, None)


def set_counters(**values):
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in values.items():
            tracing.count(name.replace("__", "."), n)


def read(name, r):
    return run.load_metric(name).read(r)


def test_solve_idle_ms_is_the_mean_idle_inside_the_solve_spans():
    host = [("repro_torch.solve.fused", 0, 10 * MS), ("repro_torch.solve.fused", 12 * MS, 20 * MS),
            ("repro_torch.solve.blocks", 1 * MS, 9 * MS), ("portbench.stretch", 0, 100 * MS)]
    device = [("k", 1 * MS, 4 * MS), ("k", 3 * MS, 9 * MS),  # 8 ms busy of 10: 2 idle
              ("k", 11 * MS, 13 * MS), ("k", 14 * MS, 16 * MS),  # 3 ms busy of 8: 5 idle
              ("k", 30 * MS, 40 * MS)]  # outside every solve
    assert read("solve_idle_ms", traced(host, device)) == pytest.approx(3.5)


def test_dispatch_host_ms_is_the_mean_execute_span():
    host = [("repro_torch.serve.execute", 1 * MS, 1 * MS + 300_000),
            ("repro_torch.serve.execute", 5 * MS, 5 * MS + 500_000),
            ("repro_torch.spmv.matmat", 5 * MS, 5 * MS + 400_000)]
    assert read("dispatch_host_ms", traced(host)) == pytest.approx(0.4)


def test_counter_readers_divide_the_program_s_counters():
    set_counters(solve__host_reads=300, serve__queue_wait_s=0.45)
    r = traced()
    assert read("solve_host_reads", r) == pytest.approx(15.0)
    assert read("queue_wait_ms", r) == pytest.approx(1.5)


def test_exchange_ms_is_stream_ms_per_batch(monkeypatch):
    monkeypatch.setattr(tracing, "stream_ms", lambda name: [0.5, 0.25, 0.75, 0.5] if name == "exchange" else [])
    assert read("exchange_ms", traced(extra={"units": 9, "batch_widths": [2, 3, 2, 2]})) == pytest.approx(0.5)


@pytest.mark.parametrize("name", READERS)
def test_an_untraced_run_reads_nothing(name, monkeypatch):
    set_counters(solve__host_reads=300, serve__queue_wait_s=0.01)
    monkeypatch.setattr(tracing, "stream_ms", lambda name: [1.0])
    assert read(name, untraced()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_stretch_without_spans_or_counters_reads_nothing(name):
    assert read(name, traced(device=[("k", 0, 5 * MS)])) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_tracing_module_reads_nothing(name, monkeypatch):
    """A program older than ``repro_torch.tracing`` records no span, and its
    counters cannot be imported: the readers find nothing and raise nothing."""
    import repro_torch

    set_counters(solve__host_reads=300, serve__queue_wait_s=0.01)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    with pytest.raises(ImportError):
        from repro_torch import tracing as _  # noqa: F401
    assert read(name, traced(device=[("k", 0, 5 * MS)])) is None


# -- the audikw1.cg cell, small, on the CPU ---------------------------------------


def test_audikw1_cg_passes_and_its_control_fails():
    got = controls.readings("audikw1.cg", 2**31 + 29, 0.5, True, "cpu", config=AUDIKW1_SMALL)
    lim = limits("audikw1.cg")
    assert fails(got["program"], lim) == []
    assert fails({**got["program"], **got["control"]}, lim) != []


@pytest.mark.parametrize("fault", sorted(CG_FAULTS))
def test_a_broken_audikw1_solve_is_not_correct(fault, monkeypatch):
    CG_FAULTS[fault](monkeypatch)
    assert not run.run_cell("audikw1.cg", 91, 0.4, False, "cpu", config=AUDIKW1_SMALL)["correct"]


def test_an_unbroken_audikw1_cg_run_is_correct():
    got = run.run_cell("audikw1.cg", 2**33 + 5, 0.4, False, "cpu", config=AUDIKW1_SMALL)
    assert got["correct"] and got["attempted"] > 0
    assert set(got["metrics"]) == {"solve_ms", "setup_s"}
    assert isinstance(got["metrics"]["solve_ms"]["value"], float)
