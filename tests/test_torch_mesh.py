"""The sharded programs' values, on a real process group.

One spawned gloo world of 4 CPU processes on a 2 x 2 ``("data", "model")``
mesh (``python -m repro_torch.testing.mesh_world``, rendezvous through a
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

A fake process group moves no data, so only this run shows that the
collectives are right.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.testing.mesh_world import ARCHS

REPO = Path(__file__).resolve().parents[1]
LM_TOL = 1e-4
MOE_TOL = 1e-5
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_world") / "results.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.testing.mesh_world", "--out", str(out)],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(out.read_text())
    assert [r["rank"] for r in got["ranks"]] == [0, 1, 2, 3]
    return got["ranks"]


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
