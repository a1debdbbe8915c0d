"""Model zoo of the port: every family of the reference (``dense``, ``moe``,
``ssm``, ``hybrid``, ``vlm``, ``enc_dec``).

Import the modules themselves (``repro_torch.models.lm`` and its
neighbours).  ``LMModel`` (the train / serve interface) and the MoE names
the reference exports from its package (``MoELayer``, ``MoEDispatcher``,
``RoutingBucketer``, ``ExpertLoadHistogram``, ``recv_maps``) resolve here on
first access, so importing this package file imports nothing and the kernel
wrappers can use :mod:`repro_torch.models.ssd` without an import cycle.
"""

_EXPORTS = {
    "LMModel": "repro_torch.models.lm",
    "MoELayer": "repro_torch.models.moe",
    "MoEDispatcher": "repro_torch.models.moe_dispatch",
    "RoutingBucketer": "repro_torch.models.moe_dispatch",
    "ExpertLoadHistogram": "repro_torch.models.moe_dispatch",
    "recv_maps": "repro_torch.models.moe_dispatch",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(_EXPORTS[name]), name)
