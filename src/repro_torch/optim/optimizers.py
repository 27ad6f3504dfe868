"""Optimizers as plain functions on parameter trees.

AdamW keeps f32 moments (m, v) regardless of parameter dtype (or bf16
ones, ``moments_dtype="bfloat16"``); parameters stay in their compute
dtype (bf16 master-less training, as in the reference). A
cosine-with-warmup schedule and global-norm clipping are included; both
are pure functions of the int32 step.

The reference's compiled rounding points are kept, so both packages take
the same step: the clip scale is cast to each gradient's dtype before the
product, which reaches the f32 update unrounded (XLA fuses it there), the
update is computed in f32 and cast back to the parameter's dtype, the
moments are rounded to their dtype. ``torch.optim.AdamW`` rounds
otherwise and is not used. Divisions by a scalar divide by a 0-dim tensor:
PyTorch divides by a Python number (and a Python number by a tensor)
through a reciprocal, which rounds twice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, tree_unzip

#: the elements of a leaf :func:`adamw_update` updates at once (rows of
#: its leading axis): the update's float32 temporaries are a few such
#: pieces, not a few float32 copies of the largest leaf
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    #: 'float32' (default) or 'bfloat16' — half-precision moments are the
    #: standard memory trade for >100B-param models
    moments_dtype: str = "float32"


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor         # () int32


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def init_adamw(params, cfg: AdamWConfig | None = None) -> AdamWState:
    dt = torch.bfloat16 if (cfg and cfg.moments_dtype == "bfloat16") \
        else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: Union[int, torch.Tensor]
             ) -> torch.Tensor:
    """The learning rate at ``step``: linear warm-up over ``warmup_steps``,
    then a cosine down to ``min_lr_ratio`` of ``lr`` at ``total_steps``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / _scalar(max(1.0, cfg.warmup_steps), s)
    prog = (s - cfg.warmup_steps) / _scalar(
        max(1.0, cfg.total_steps - cfg.warmup_steps), s)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_scalar(max_norm, norm) / torch.clamp(norm, min=1e-9),
                       max=1.0)


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the norm);
    the scale is cast to each gradient's dtype before the product."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState, *,
                 grad_norm: torch.Tensor | None = None, donate: bool = False
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: returns (new params, new state, {grad_norm, lr});
    the inputs are left as they were (but under ``donate``). A leaf is
    updated a piece of :data:`UPDATE_CHUNK` elements at a time (rows of
    its leading axis). ``grad_norm``: the global norm to clip by, where
    ``params``, ``grads`` and the moments are one rank's blocks of whole
    trees (the norm of the whole gradients); default the norm of
    ``grads``. ``donate``: the new values are written into
    ``params`` and ``state``'s tensors (each piece once all three of its
    new values are computed), which are returned; the same values."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step.add_(1) if donate else state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_scalar(b1, sf), sf)
    bc2 = 1 - torch.pow(_scalar(b2, sf), sf)

    def upd(p, g, m, v):
        # the clipped gradient reaches f32 unrounded: the reference's
        # compiled step fuses the product into the update
        gf = g.to(torch.float32) * scale.to(g.dtype).to(torch.float32)
        mf, vf = m.to(torch.float32), v.to(torch.float32)
        m2 = b1 * mf + (1 - b1) * gf
        v2 = b2 * vf + (1 - b2) * gf * gf
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p2 = p.to(torch.float32) - lr * delta
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    def upd_rows(p, g, m, v):
        # elementwise: the same values a piece at a time
        n = p.numel() // max(p.shape[0], 1) if p.dim() else p.numel()
        rows = max(1, UPDATE_CHUNK // max(n, 1))
        whole = p.dim() == 0 or rows >= p.shape[0]
        if whole and not donate:
            return upd(p, g, m, v)
        out = (p, m, v) if donate else (
            torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        parts = [...] if whole else [slice(lo, lo + rows)
                                     for lo in range(0, p.shape[0], rows)]
        with torch.no_grad():
            for part in parts:
                for buf, new in zip(out, upd(p[part], g[part], m[part],
                                             v[part])):
                    buf[part] = new
        return out

    new_params, new_m, new_v = tree_unzip(
        tree_map(upd_rows, params, grads, state.m, state.v), 3)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(new_m, new_v, step), metrics
