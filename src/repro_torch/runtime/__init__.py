"""Serving runtime control plane: straggler watchdog and admission control.

The trainer (``runtime/trainer.py`` in the reference) waits for ROADMAP A.4d.
"""

from repro_torch.runtime.watchdog import AdmissionController, StragglerWatchdog

__all__ = ["AdmissionController", "StragglerWatchdog"]
