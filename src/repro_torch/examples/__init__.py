"""The reference's six examples as the port's entry points.

Each module is the counterpart of one script in the repo's ``examples/``
directory, run as a module of the package:

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # the CUDA device
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

* :mod:`.strategy_advisor` -- the Figure 4.3 planning tool (host only);
* :mod:`.quickstart` -- pattern -> advisor -> the four strategies
  (kernels B1, B2);
* :mod:`.krylov_solve` -- CG over the exchange, host loop and ``--fused``
  CUDA graphs (B1);
* :mod:`.chaos_serving` -- the serving simulator and the executor's
  recovery ladder under a fault storm;
* :mod:`.serve_lm` -- a ``tiny`` model served greedily (B3; B4 for the
  ``ssm`` and ``hybrid`` families);
* :mod:`.train_lm` -- the ``100m`` preset trained with checkpoints (no
  kernel: B1-B4 have no backward).

Each takes the reference script's options with its defaults, plus
``--device`` (left out: the CUDA device, and a machine without one raises;
``cpu`` runs the plain versions of the kernels).  Each prints the lines the
reference script prints, and ``main(argv)`` returns what it printed as
values, with ``"launches"``: the kernel launches its run made, per wrapper.
With the environment variable ``REPRO_EXAMPLE_LAUNCHES=1`` the module, run
as a script, prints those counts as one JSON line last.

They live in the package, not in ``examples/``: every file there is run
with no arguments under the reference's environment by the reference's
example smoke test, where a CUDA-default entry point would fail.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Dict

#: the environment variable that makes :func:`run` print the launch counts
LAUNCHES_ENV = "REPRO_EXAMPLE_LAUNCHES"


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters: B1 (``spmv_ell``), B2
    (``spmm_ell``), B3 (``flash_attention``), B4 (``ssd_chunked``, in calls
    of four launches), and B1's launches made by replays of the fused
    solve's CUDA graphs (``spmv_ell_replayed``)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.spmv_ell import spmm_ell, spmv_ell
    from repro_torch.kernels.ssd_scan import ssd_chunked
    from repro_torch.solve import fused

    return {
        "spmv_ell": spmv_ell.launches,
        "spmm_ell": spmm_ell.launches,
        "flash_attention": flash_attention.launches,
        "ssd_chunked": ssd_chunked.launches,
        "spmv_ell_replayed": fused.graph_launches["spmv_ell"],
    }


def counts_launches(main: Callable) -> Callable:
    """``main(argv) -> dict`` with ``"launches"`` added: the counters'
    growth over the call."""

    @functools.wraps(main)
    def wrapped(argv=None) -> dict:
        before = launch_counts()
        out = main(argv)
        out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
        return out

    return wrapped


def add_device_option(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (raises without one); 'cpu' runs the plain versions")


def run(main: Callable) -> None:
    """Run an example's ``main`` as a script."""
    out = main()
    if os.environ.get(LAUNCHES_ENV):
        print(json.dumps({"launches": out["launches"]}), flush=True)
