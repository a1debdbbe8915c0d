"""Model zoo of the port: the ``dense``, ``ssm`` and ``hybrid`` families.

Import the modules themselves (``repro_torch.models.lm`` and its
neighbours); this package file imports nothing, so the kernel wrappers can
use :mod:`repro_torch.models.ssd` without an import cycle.
"""
