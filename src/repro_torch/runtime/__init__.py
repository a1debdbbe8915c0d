"""Runtime: the trainer's step loop, straggler watchdog and admission control."""

from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainerConfig, build_train_step
from repro_torch.runtime.watchdog import AdmissionController, StragglerWatchdog

__all__ = [
    "AdmissionController",
    "SimulatedFailure",
    "StragglerWatchdog",
    "Trainer",
    "TrainerConfig",
    "build_train_step",
]
