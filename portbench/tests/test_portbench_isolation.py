"""Nothing a benchmark run loads is JAX or the JAX package, and the
reference loads nothing of the program.  Each check runs in a fresh
interpreter: other test files import JAX into the test process."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_BOTH_CELLS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from portbench import controls, run
bench = json.loads(Path({root!r}, "BENCHMARK.json").read_text())
for m in bench["per_layer"]:
    run.load_metric(m["name"])
small = {{"thermal2": {{"generator": "stencil2d_spd", "side": 16, "shift": 1.0, "npods": 2, "ppn": 2,
                      "offsets": [[1, 0], [-1, 0], [0, 1], [0, -1], [1, 1], [-1, -1]]}},
         "audikw1": {{"generator": "stencil3d_dof_spd", "side": 4, "dof": 3, "shift": 1.0, "npods": 2, "ppn": 2}}}}
for w in bench["workloads"]:
    json.loads(Path({root!r}, "portbench", "traffic", w["traffic"] + ".json").read_text())
    json.loads(Path({root!r}, "portbench", "configs", w["config"] + ".json").read_text())
    run.run_cell(w["name"], 1, 0.2, False, "cpu", config=small[w["config"]])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ALONE = """
import json, sys
sys.path[:0] = [{root!r}]
import portbench.reference
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    got = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), src=str(ROOT / "src"))],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert got.returncode == 0, got.stderr[-4000:]
    return set(json.loads(got.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax_and_not_the_jax_package():
    names = top_level_modules(RUN_BOTH_CELLS)
    assert "repro_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_modules(REFERENCE_ALONE)
    assert "torch" in names
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
