import os
import subprocess
import sys
import textwrap

import pytest

def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-device subprocess tests, interpret-mode Pallas sweeps, "
        "and the heaviest property sweeps (solver-vs-dense, kernel oracles). "
        "Run by default -- the full suite is the verify tier; deselect with "
        "-m 'not slow' for a quick inner-loop pass",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU (the port's hand-written kernels); skips elsewhere",
    )


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_devices(code: str, devices: int = 8, timeout: int = 600) -> str:
    """Run ``code`` in a subprocess with N forced host devices.

    Multi-device tests must not set ``--xla_force_host_platform_device_count``
    in this process (smoke tests and benches should see 1 device), so they
    run in a child interpreter.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}"
        )
    return proc.stdout


@pytest.fixture
def subproc():
    return run_devices
