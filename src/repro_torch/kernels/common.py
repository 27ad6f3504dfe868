"""Shared kernel plumbing: strict environment knobs, tiling helpers and the
device rule every entry point of the port follows.

This is the one module of the port that reads ``os.environ`` (repro-lint
RPR008 exempts the path suffix ``kernels/common.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def env_flag(var: str, default: bool = False) -> bool:
    """Strict boolean env knob: ``"1"`` / ``"0"`` only.

    Unset (or empty) returns ``default``; anything else raises, so a value
    such as ``false`` can never be read as true.
    """
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    if raw == "1":
        return True
    if raw == "0":
        return False
    raise ValueError(
        f"{var}={raw!r}: expected '0' or '1' (unset/empty = default)")


def env_choice(var: str, choices: tuple, default: str) -> str:
    """Strict enumerated env knob: the value must be one of ``choices``.

    Unset (or empty) returns ``default``; anything outside the set raises.
    """
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    if raw not in choices:
        raise ValueError(f"{var}={raw!r}: expected one of {choices}")
    return raw


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
