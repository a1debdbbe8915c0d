"""Device selection for the port's entry points.

Every entry point takes ``device=``.  Left out, it means the CUDA device, and
a machine without one raises instead of falling back to the CPU; the CPU
runs only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_for_rank(rank: int) -> torch.device:
    """The CUDA device of world rank ``rank``: ``cuda:(rank % device_count)``.

    On one card every rank of a process group shares ``cuda:0``.  A machine
    without a card raises, as :func:`resolve_device` does; a caller that
    wants the CPU passes ``device="cpu"`` instead of asking here.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


def as_device_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a contiguous tensor on ``device``."""
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()
