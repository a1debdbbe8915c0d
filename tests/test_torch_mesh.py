"""The sharded programs' values, on a real process group.

One spawned world of 4 CPU processes, joined by the launchers' staged group
(every collective staged through host memory around gloo), on a 2 x 2
``("data", "model")`` mesh (``python -m repro_torch.testing.mesh_world``, rendezvous through a
``file://`` store in a temporary directory, so workers running at once never
share a port) runs, on every rank:

* every family's sharded tiny ``prefill`` and one ``decode_step`` on its
  cache, against the one-card calls on the same weights, within the port's
  float32 tolerance for the LM (``tests/test_torch_lm.py``: 1e-4), and
  qwen3-32b's on a (1, 4) mesh, where its 2 key/value heads are fewer than
  the chips;
* the MoE's ``_dispatch_shard_map`` on a ``(4,)`` ``("data",)`` mesh against
  ``_dispatch_local``, the reference's ``test_moe_dispatch_shard_map_matches_local``
  case, within the port's MoE tolerance (1e-5);
* one sharded train step of stablelm-3b's tiny preset: the one-card loss
  within 1e-5, the updated masters held by
  :func:`~repro_torch.testing.trajectory.compare_trajectories` (a sharded
  reduction sums in another order, and AdamW magnifies that on elements whose
  gradient is at its rounding noise).

On a ``(2, 2)`` ``("pod", "local")`` mesh of the same world, the MoE case of
``mesh_world.moe_case`` (uniform and skewed inputs):

* ``MoELayer(ep_axis=("pod", "local"))`` runs the sharded all-to-all (a
  tuple of axes flattened into one group, as in the reference), within
  ``MOE_TOL`` of the reference's on 4 forced host devices, its tally the
  stacked path's per-pair capacity (on the parent commit a tuple ``ep_axis``
  silently ran the replicated local path);
* ``dispatch="exchange"`` for every strategy and ``auto`` is bitwise the
  port's mesh all-to-all on every rank, within ``MOE_TOL`` of the
  reference's exchange dispatch and of its all-to-all (ROADMAP §C caveat 2:
  the reference's two are not bitwise), and its tallies sum to the stacked
  exchange's; the reference's three errors; five calls plan once; the bf16
  wire within the reference's 0.05;

and the launchers' programs with ``--mesh 2x2 --device cpu`` in this world
(spawned by the launchers' own ``world.run_world``, each rank running what a
spawned launcher rank runs): stablelm-3b tiny's losses within
:func:`~repro_torch.testing.trajectory.compare_trajectories`' tolerance of
the one-rank run and rank 0's closing line, a one-rank checkpoint resumed on
the mesh within it of the one-rank continuation (with one rank's straggler
watchdog escalating: every rank takes part in its checkpoint), hymba-1.5b
tiny's greedy tokens (``--impl chunked``, float32) those of one rank; and
every collective a DTensor program issues, on the host.

A fake process group moves no data, so only this run shows that the
collectives are right.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_devices
from repro_torch.comm import PodTopology
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import serve
from repro_torch.models.moe import MoELayer
from repro_torch.testing import mesh_world as mw
from repro_torch.testing.mesh_world import ARCHS
from repro_torch.testing.trajectory import compare_trajectories

REPO = Path(__file__).resolve().parents[1]
LM_TOL = 1e-4
MOE_TOL = 1e-5
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's ranks' results, and :func:`_reference_moe`'s arrays,
    computed while the world runs."""
    out = tmp_path_factory.mktemp("mesh_world") / "results.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.testing.mesh_world", "--out", str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
                            start_new_session=True)
    try:
        reference = _reference_moe(tmp_path_factory.mktemp("moe_mesh"))
        _, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:  # the world's ranks with it
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, stderr[-4000:]
    got = json.loads(out.read_text())
    assert [r["rank"] for r in got["ranks"]] == [0, 1, 2, 3]
    return got["ranks"], reference


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_equals_one_card(world, arch, step):
    for rank in world:
        assert rank["serve"][arch][step] <= LM_TOL, (rank["rank"], rank["serve"][arch])


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_sharded_serve_with_fewer_key_value_heads_than_chips(world, step):
    """qwen3-32b on a (1, 4) mesh: its 2 key/value heads stay whole, and each
    chip attends with the ones its query heads read."""
    for rank in world:
        assert rank["serve_wide"][step] <= LM_TOL, (rank["rank"], rank["serve_wide"])


def test_moe_shard_map_dispatch_equals_local(world):
    for rank in world:
        assert rank["moe"] <= MOE_TOL, (rank["rank"], rank["moe"])


def test_sharded_train_step_equals_one_card(world):
    for rank in world:
        train = rank["train"]
        assert train["loss_err"] <= LOSS_TOL, (rank["rank"], train)
        assert train["masters_ok"] and not train["out_of_tolerance"], (rank["rank"], train)


# ---------------------------------------------------------------------------
# the MoE dispatch on a (2, 2) ("pod", "local") mesh
# ---------------------------------------------------------------------------

MOE_TOPO = PodTopology(npods=2, ppn=2)
MOE_CASES = [(inp, s) for inp in ("uniform", "skewed") for s in mw.EXCHANGE_STRATEGIES]


@pytest.fixture(scope="module")
def reference_moe(runs):
    return runs[1]


def _reference_moe(d: Path) -> dict:
    """The reference's all-to-all (``ep_axis=("pod", "local")``) and exchange
    dispatch of every strategy on a (2, 2) mesh of 4 forced host devices."""
    params, inputs = mw.moe_case()
    np.savez(d / "in.npz", **{f"p_{k}": v for k, v in params.items()}, **inputs)
    run_devices(
        f"""
        import numpy as np, jax.numpy as jnp
        from repro.comm import PodTopology, make_exchange_mesh
        from repro.configs.base import MoEConfig
        from repro.models.moe import MoELayer

        mesh = make_exchange_mesh(PodTopology(npods=2, ppn=2))
        cfg = MoEConfig(**{mw.MOE_CFG!r})
        data = np.load({str(d / "in.npz")!r})
        params = {{k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("p_")}}
        out = {{}}
        for name in ("uniform", "skewed"):
            x = jnp.asarray(data[name])
            out[name + "|all_to_all"] = np.asarray(MoELayer({mw.MOE_M}, cfg, ep_axis=("pod", "local"))(params, x, mesh))
            for s in {mw.EXCHANGE_STRATEGIES!r}:
                out[name + "|" + s] = np.asarray(MoELayer({mw.MOE_M}, cfg, dispatch="exchange", strategy=s)(params, x, mesh))
        np.savez({str(d / "out.npz")!r}, **out)
        """,
        devices=4,
    )
    return dict(np.load(d / "out.npz"))


def _stacked_tally(inp: str, dispatch: str) -> dict:
    """The port's stacked path on ``PodTopology(2, 2)``: its tally."""
    params, inputs = mw.moe_case()
    layer = MoELayer(mw.MOE_M, MoEConfig(**mw.MOE_CFG), dispatch=dispatch)
    layer({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(inputs[inp]), MOE_TOPO)
    return layer.tally.read()


def _summed(world, key: str) -> dict:
    return {f: sum(r["moe_exchange"]["tally"][key][f] for r in world) for f in ("routed", "dropped", "shipped")}


@pytest.mark.parametrize("inp", ["uniform", "skewed"])
def test_tuple_ep_axis_runs_the_sharded_all_to_all(world, reference_moe, inp):
    got = np.asarray(world[0]["moe_exchange"]["outputs"][f"{inp}|all_to_all"], np.float32)
    np.testing.assert_allclose(got, reference_moe[f"{inp}|all_to_all"], rtol=MOE_TOL, atol=MOE_TOL)
    # each rank routed its own t of the n * t assignments (the replicated
    # local path routes all of them on every rank), under the per-pair
    # capacity: the drops sum to the stacked all-to-all's
    t = mw.MOE_B // MOE_TOPO.nranks * mw.MOE_S * mw.MOE_CFG["top_k"]
    assert [r["moe_exchange"]["tally"][f"{inp}|all_to_all"]["routed"] for r in world] == [t] * MOE_TOPO.nranks
    assert _summed(world, f"{inp}|all_to_all")["dropped"] == _stacked_tally(inp, "all_to_all")["dropped"]


@pytest.mark.parametrize("inp, strategy", MOE_CASES)
def test_exchange_dispatch_on_a_mesh(world, reference_moe, inp, strategy):
    key = f"{inp}|{strategy}"
    assert all(r["moe_exchange"]["bitwise"][key] for r in world), [r["moe_exchange"]["bitwise"] for r in world]
    got = np.asarray(world[0]["moe_exchange"]["outputs"][key], np.float32)
    np.testing.assert_array_equal(got, np.asarray(world[0]["moe_exchange"]["outputs"][f"{inp}|all_to_all"],
                                                  np.float32))
    np.testing.assert_allclose(got, reference_moe[key], rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(got, reference_moe[f"{inp}|all_to_all"], rtol=MOE_TOL, atol=MOE_TOL)
    stacked = _stacked_tally(inp, "exchange")
    assert _summed(world, key) == {f: stacked[f] for f in ("routed", "dropped", "shipped")}


@pytest.mark.parametrize("case, words", [("mesh", "exchange mesh"), ("experts_exchange", "divisible"),
                                         ("experts_all_to_all", "divisible"), ("batch", "batch")])
def test_exchange_dispatch_on_a_mesh_raises_the_reference_errors(world, case, words):
    for r in world:
        msg = r["moe_exchange"]["errors"][case]
        assert msg.startswith("ValueError") and words in msg, (r["rank"], msg)


def test_exchange_dispatch_on_a_mesh_plans_once_and_takes_the_bf16_wire(world):
    for r in world:
        cache = r["moe_exchange"]["cache"]
        # all planning on the first of five batches; the rest are hits
        assert cache["plan_misses"][0] == cache["plan_misses"][1] > 0, cache
        assert cache["exchange_misses"][0] == cache["exchange_misses"][1] > 0, cache
        assert cache["exchange_hits"][1] > cache["exchange_hits"][0], cache
        assert r["moe_exchange"]["bf16_max_abs_err"] <= 0.05


# ---------------------------------------------------------------------------
# the launchers with --mesh 2x2
# ---------------------------------------------------------------------------

LM = ["--arch", "stablelm-3b", *mw.LAUNCH_ARGS]


def _losses_agree(got: list, want: list) -> dict:
    assert [h["step"] for h in got] == [h["step"] for h in want]
    loss = lambda hist: {"loss": np.array([h["loss"] for h in hist], np.float64)}
    lr_sum = 3e-3 * len(want)  # the launcher's peak rate, an upper bound of the steps' rates
    return compare_trajectories(loss(got), loss(want), {"loss": np.zeros(len(want), bool)}, lr_sum)


def test_train_launcher_on_a_mesh_follows_one_rank(world):
    """Each rank of the mesh runs what a spawned launcher rank runs; rank 0
    alone prints the reference's closing line, its own losses."""
    one = world[0]["launchers"]["train_1x1"]
    for r in world:
        cmp = _losses_agree(r["launchers"]["train"], one)
        assert cmp["ok"], (r["rank"], cmp)
    hist = world[0]["launchers"]["train"]
    assert world[0]["launchers"]["printed"].strip().splitlines()[-1] == (
        f"first loss {hist[0]['loss']:.4f} -> last loss {hist[-1]['loss']:.4f}")
    assert not any(r["launchers"]["printed"] for r in world[1:])


def test_one_rank_checkpoint_resumes_on_a_mesh(world):
    want = world[0]["launchers"]["resumed_1x1"]
    assert want[0]["step"] == mw.TRAIN_STEPS + 1 and want[-1]["step"] == 2 * mw.TRAIN_STEPS
    for r in world:
        cmp = _losses_agree(r["launchers"]["resumed"], want)
        assert cmp["ok"], (r["rank"], cmp)


@pytest.mark.parametrize("step", [mw.STRAGGLER_STEP + 1, 2 * mw.TRAIN_STEPS])
def test_one_rank_straggler_checkpoints_the_whole_mesh(world, step):
    """Rank 1's watchdog alone escalates in the resumed mesh run: every rank
    takes part in the straggler checkpoint (it gathers the state), the world
    ends, and the mesh run's straggler and final checkpoints hold the
    parameters of the one-rank run escalated at the same step."""
    got = world[0]["launchers"]["checkpoints"][str(step)]
    straggler = {"straggler": True} if step == mw.STRAGGLER_STEP + 1 else {}
    assert got["extra"] == [straggler, straggler], got
    assert got["ok"] and not got["out_of_tolerance"], got


def test_serve_launcher_on_a_mesh_gives_one_rank_tokens(world):
    one = serve.main(["--arch", "hymba-1.5b", *mw.LAUNCH_ARGS, "--impl", "chunked"])
    for r in world:
        assert r["launchers"]["serve_tokens"] == one["tokens"].tolist(), r["rank"]


def test_collectives_probe_takes_every_collective_on_the_host(world):
    """``world.collectives``: each collective a DTensor program issues, on
    the host, over this world's staged group (the launchers' backend, which
    stages every tensor through host memory around gloo).  Over plain gloo
    the same probe passes on the host (``tests/test_torch_staged.py``
    holds the two bitwise); on the card ``world.probe_collectives`` runs it
    over both backends, and plain gloo lacks the ones in
    ``launch.mesh.GLOO_CUDA_MISSING``."""
    from repro_torch.launch.world import PROBES

    for r in world:
        assert r["collectives"] == {"backend": "staged", **dict.fromkeys(PROBES, True)}, r["rank"]
