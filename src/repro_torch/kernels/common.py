"""Shared kernel plumbing: grid sizing and the device rule every entry
point of the port follows."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Raises when CUDA is wanted and absent — the port never
    carries on on the CPU behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def env_int(var: str, default: Optional[int] = None) -> Optional[int]:
    """Strict integer env knob (``torchrun``'s ``WORLD_SIZE``,
    ``LOCAL_RANK``): unset or empty returns ``default``; anything but a
    decimal integer raises."""
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{var}={raw!r}: expected an integer") from None
