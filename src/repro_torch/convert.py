"""Carry weights and training states across from the reference package.

The reference initialises weights with its own random generator, which
PyTorch cannot reproduce; weights and states cross as numpy arrays
instead.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.optim import grad_compression as GC
from repro_torch.optim import optimizers as O
from repro_torch.train import train_loop as TL


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
#: scales, the audio decoder's cross-attention norm among them, the SSD
#: time-step bias and decay rate, the MoE router)
F32_LEAVES = frozenset({"final_norm", "norm", "norm1", "norm2", "norm_x",
                        "dt_bias", "a_log", "router"})


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


def _float_tree(tree: Any, dev: torch.device) -> Any:
    """A tree of numpy arrays -> tensors on ``dev``, bfloat16 leaves (the
    ``ml_dtypes`` dtype) as bfloat16 and every other leaf as float32."""
    if isinstance(tree, Mapping):
        return {k: _float_tree(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    dtype = torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def train_state_from_numpy(state: Any, cfg: ModelConfig,
                           device: Union[str, torch.device, None] = None
                           ) -> TL.TrainState:
    """The reference's whole ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's
    :class:`repro_torch.train.train_loop.TrainState` on ``device``
    (``None`` = ``cuda``; raises when CUDA is absent): the parameters
    through :func:`lm_params_from_numpy`, the AdamW moments in their dtype
    (float32, or bfloat16 moments) and step, the error-feedback buffer
    (float32) when there is one, and the step. Both packages can then take
    the same step from the same state."""
    dev = resolve_device(device)

    def step(x) -> torch.Tensor:
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=dev)

    opt = O.AdamWState(_float_tree(state.opt.m, dev),
                       _float_tree(state.opt.v, dev), step(state.opt.step))
    ef = None if state.ef is None else GC.EFState(
        _float_tree(state.ef.error, dev))
    return TL.TrainState(lm_params_from_numpy(state.params, cfg, dev), opt,
                         ef, step(state.step))
