"""Carry weights across from the reference package.

The reference initialises weights with its own random generator, which
PyTorch cannot reproduce; weights cross as numpy arrays instead.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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


def column_from_numpy(weights: np.ndarray,
                      device: Union[str, torch.device, None] = None
                      ) -> torch.Tensor:
    """One column's ``(q, n)`` float32 weight array -> a float32 tensor on
    ``device`` (``None`` = ``cuda``; raises when CUDA is absent)."""
    arr = np.asarray(weights, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError(f"expected (q, n) column weights, got shape "
                         f"{arr.shape}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


#: LM leaves the reference keeps in float32 whatever the model dtype (norm
#: scales, the SSD time-step bias and decay rate, the MoE router)
F32_LEAVES = frozenset({"final_norm", "norm", "norm1", "norm2", "dt_bias",
                        "a_log", "router"})


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                         device: Union[str, torch.device, None] = None
                         ) -> Dict[str, Any]:
    """The reference's LM parameter pytree, as numpy arrays (bfloat16
    leaves with the ``ml_dtypes`` dtype), -> the port's tree of tensors on
    ``device`` (``None`` = ``cuda``; raises when CUDA is absent), in the
    config's dtype except the :data:`F32_LEAVES`, which stay float32.

    ``torch.from_numpy`` refuses the ``ml_dtypes`` bfloat16 dtype, so every
    leaf goes through float32, which holds a bfloat16 value exactly.
    """
    dev = resolve_device(device)
    model = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]

    def convert(node, name):
        if isinstance(node, Mapping):
            return {k: convert(v, k) for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)
        dtype = torch.float32 if name in F32_LEAVES else model
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return convert(tree, "")
