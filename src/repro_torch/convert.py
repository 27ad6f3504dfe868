"""Carry weights across from the reference package.

The reference initialises weights with its own random generator, which
PyTorch cannot reproduce; weights cross as numpy arrays instead.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


def params_from_numpy(params: Sequence[np.ndarray],
                      device: Union[str, torch.device, None] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Per-layer ``(C, Q, rf_total)`` float32 weight arrays -> the port's
    tuple of float32 tensors on ``device`` (``None`` = ``cuda``; raises
    when CUDA is absent)."""
    dev = resolve_device(device)
    out = []
    for i, p in enumerate(params):
        arr = np.asarray(p, dtype=np.float32)
        if arr.ndim != 3:
            raise ValueError(f"layer {i}: expected (C, Q, rf_total) weights, "
                             f"got shape {arr.shape}")
        out.append(torch.from_numpy(arr.copy()).to(dev))
    return tuple(out)
