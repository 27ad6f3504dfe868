"""Mixture-of-experts layer with Catwalk-style top-k relocation dispatch.

Per token the router activates k of E experts. The router's gate (softmax
over E, top-k, renormalised) is :func:`repro_torch.kernels.ops.moe_gate_topk`:
the hand-written CUDA kernel on CUDA tensors, its plain version on CPU
tensors — one launch per layer per forward and per decode step. Dispatch
modes:

  * ``catwalk`` (default): the T*k assignments are *relocated* — stably
    sorted by expert id into contiguous per-expert blocks of bounded
    capacity C = min(T, max(k, int(T*k/E * capacity_factor))) — so the
    expert FFNs run as dense (E, C, D) batched products. Assignments past
    an expert's capacity are dropped: they land in a trash slot (index
    E*C) whose value is discarded.
  * ``dense``: every expert processes every token, combined by gate weight
    (the worst-case baseline).
  * ``catwalk_ep``: the reference's expert-parallel form; without a mesh
    it runs ``catwalk``, as the reference does. The multi-GPU form waits
    for the multi-GPU slice.

bf16 rounding points follow the reference's compiled layer: the gate
probabilities are rounded to the model dtype, the combine multiplies and
sums over k in the model dtype, and the SwiGLU product is rounded before
the down projection.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype, device: torch.device
             ) -> Dict[str, object]:
    e, f = cfg.n_experts, cfg.d_expert
    # experts stacked on axis 0: (E, D, F) / (E, F, D); the router in f32
    p: Dict[str, object] = {
        "router": L.dense_init(generator, d_model, e, torch.float32, device),
        "w_gate": _stack_expert(generator, e, d_model, f, dtype, device),
        "w_up": _stack_expert(generator, e, d_model, f, dtype, device),
        "w_down": _stack_expert(generator, e, f, d_model, dtype, device),
    }
    if cfg.n_shared:
        p["shared"] = L.mlp_init(generator, d_model, cfg.n_shared * f, dtype,
                                 device)
    return p


def _stack_expert(generator: torch.Generator, e: int, d_in: int, d_out: int,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(E, d_in, d_out): each expert N(0, 1/d_in), as ``dense_init``."""
    return (L._normal(generator, (e, d_in, d_out), device)
            * (1.0 / float(np.sqrt(d_in)))).to(dtype)


def _expert_ffn(p, x: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) -> (E, C, D): per-expert SwiGLU via batched products."""
    g = L.silu(torch.bmm(x, p["w_gate"]))
    u = torch.bmm(x, p["w_up"])
    return torch.bmm(g * u, p["w_down"])


def _aux_loss(probs_full: torch.Tensor, idx: torch.Tensor,
              e: int) -> torch.Tensor:
    """Switch-style load balancing: E * sum_e f_e * p_e."""
    load = torch.zeros((e,), dtype=torch.float32, device=idx.device)
    load = load.index_add(0, idx.reshape(-1).to(torch.int64),
                          torch.ones(idx.numel(), dtype=torch.float32,
                                     device=idx.device))
    load = load / torch.clamp(load.sum(), min=1.0)
    importance = torch.mean(probs_full, dim=0)
    return e * torch.sum(load * importance)


def _combine(contrib: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """sum over k of contrib (T, k, D) * probs (T, k), both in the model
    dtype: the reference's compiled combine takes the product and the sum
    in f32 and rounds once, to the model dtype."""
    return torch.sum(L._f32(contrib) * L._f32(probs)[..., None],
                     dim=1).to(contrib.dtype)


def _capacity(t: int, cfg: MoEConfig) -> int:
    k, e = cfg.top_k, cfg.n_experts
    return min(t, max(k, int(t * k / e * cfg.capacity_factor)))


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out, {'aux_loss': scalar})."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device

    logits = L._f32(xt) @ p["router"]
    probs_full = torch.softmax(logits, dim=-1)
    probs, idx = ops.moe_gate_topk(logits, k, renorm=True)
    probs = probs.to(x.dtype)

    if cfg.dispatch == "dense":
        # worst-case baseline: all experts on all tokens
        ys = _expert_ffn(p, xt.expand(e, t, d))                 # (E,T,D)
        gate = torch.zeros((t, e), dtype=x.dtype, device=dev)
        gate.scatter_(1, idx.to(torch.int64), probs)
        out = torch.einsum("te,etd->td", gate, ys)
    else:
        # ---- Catwalk relocation dispatch --------------------------------
        cap = _capacity(t, cfg)
        flat_e = idx.reshape(-1).to(torch.int64)                 # (T*k,)
        flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
        order = torch.argsort(flat_e, stable=True)               # relocate
        sorted_e = flat_e[order]
        # rank within expert segment = global sorted pos - segment start
        seg_start = torch.searchsorted(
            sorted_e, torch.arange(e, device=dev), side="left")
        rank = torch.arange(t * k, device=dev) - seg_start[sorted_e]
        keep = rank < cap                                        # clip at C
        slot = torch.where(keep, sorted_e * cap + rank, e * cap)  # overflow
        # slot -> source-token table; the trash entry e*cap is written by
        # every dropped assignment and its value is never read
        slot_src = torch.full((e * cap + 1,), t, dtype=torch.int64,
                              device=dev)
        slot_src[slot] = torch.where(keep, flat_tok[order], t)
        xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
        expert_in = xt_pad[slot_src[:-1]].reshape(e, cap, d)
        expert_out = _expert_ffn(p, expert_in)
        eo_flat = torch.cat([expert_out.reshape(e * cap, d),
                             expert_out.new_zeros((1, d))], 0)
        # per-assignment slot in TOKEN order (inverse relocation)
        inv = torch.argsort(order)
        token_slot = slot[inv]                                   # (T*k,)
        out = _combine(eo_flat[token_slot].reshape(t, k, d), probs)

    if cfg.n_shared:
        out = out + L.mlp_apply(p["shared"], xt)
    aux = cfg.router_aux_loss * _aux_loss(probs_full, idx, e)
    return out.reshape(b, s, d), {"aux_loss": aux}
