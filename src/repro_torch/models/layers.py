"""Shared neural layers: norms, embeddings, dense init, RoPE, gated MLP.

The reference's pure-functional convention carries over: each block is an
``init_*(generator, ...) -> params-dict`` plus an apply function on
tensors. Parameters are stored in the model compute dtype (bf16 by
default) except norm scales (f32); math that needs it (norm reductions,
the SSD state) runs in f32 and casts back. Random draws come from a
``torch.Generator`` on its own device and are moved to ``device``; they
follow the reference's distributions but cannot match its draws.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _normal(generator: torch.Generator, shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """Standard normal float32 draws from ``generator``, on ``device``. On
    the ``meta`` device nothing is drawn: a tree initialised there holds
    the shapes and dtypes alone (the sharding rules read those)."""
    where = torch.device(device)
    return torch.randn(tuple(shape), generator=generator,
                       device=where if where.type == "meta"
                       else generator.device,
                       dtype=torch.float32).to(device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device,
               scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) weight, used as ``x @ W``: N(0, 1/d_in) by default."""
    scale = scale if scale is not None else 1.0 / float(np.sqrt(d_in))
    return (_normal(generator, (d_in, d_out), device) * scale).to(dtype)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype where that is wider: the f32
    steps of the model keep a float64 forward (a reference for the float32
    one) in float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rmsnorm_init(d: int, device: torch.device) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = _f32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    step rounded to x's dtype: the reference's ``jax.nn.silu`` lowers to
    exactly these roundings in bf16 (``F.silu`` rounds once and differs
    from it in ~40 % of bf16 values)."""
    return x * (1 / (1 + torch.exp(-x)))


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return (_normal(generator, (vocab, d), device) * 0.02).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens``; every id must lie in the vocabulary
    (the reference fills out-of-range ids with NaN; the engine never sends
    one, see ``Engine._fill``)."""
    return table[tokens]


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """The rotary frequencies, computed in numpy float32 as the reference
    computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).

    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``, as the
    reference does; angles, cos and sin in float32, the result in x's
    dtype."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta)).to(x.device)  # (D/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = _f32(x[..., 0::2])
    x2 = _f32(x[..., 1::2])
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------- gated MLP
def mlp_init(generator: torch.Generator, d: int, d_ff: int,
             dtype: torch.dtype, device: torch.device
             ) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(generator, d, d_ff, dtype, device),
        "w_up": dense_init(generator, d, d_ff, dtype, device),
        "w_down": dense_init(generator, d_ff, d, dtype, device),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down( silu(gate(x)) * up(x) ), the product rounded to x's
    dtype before the down projection, as the reference's compiled form
    rounds it."""
    g = silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, *,
                  total: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in float32 (float64 for float64 logits):
    ``logsumexp`` minus the gold logit, averaged over the tokens, or over
    the tokens where ``mask`` is set (divided by ``max(sum(mask), 1)``).
    logits (..., V), labels (...) integer ids in the vocabulary.

    ``total``: for rows that are one block of a batch, the batch's token
    count (or mask sum) to divide by; the blocks' results then add up to
    the batch's (:func:`token_count` gives a block's own)."""
    logits = _f32(logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if total is not None:
        kept = nll if mask is None else nll * mask.to(nll.dtype)
        return torch.sum(kept) / torch.clamp(total.to(nll.dtype), min=1.0)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def token_count(labels: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The tokens :func:`cross_entropy` averages over, as a float32
    0-dim tensor: the mask's sum, or every label."""
    if mask is None:
        return torch.tensor(float(labels.numel()), device=labels.device)
    return torch.sum(mask.to(torch.float32))
