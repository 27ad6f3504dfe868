"""Mixture-of-experts layer with Catwalk-style top-k relocation dispatch.

Per token the router activates k of E experts. The router's gate (softmax
over E, top-k, renormalised) is :func:`repro_torch.kernels.ops.moe_gate_topk`:
the hand-written CUDA kernel on CUDA tensors, its plain version on CPU
tensors — one launch per layer per forward and per decode step (per rank
under a mesh). Dispatch modes:

  * ``catwalk`` (default): the T*k assignments are *relocated* — stably
    sorted by expert id into contiguous per-expert blocks of bounded
    capacity C = min(T, max(k, int(T*k/E * capacity_factor))) — so the
    expert FFNs run as dense (E, C, D) batched products. Assignments past
    an expert's capacity are dropped: they land in a trash slot (index
    E*C) whose value is discarded.
  * ``dense``: every expert processes every token, combined by gate weight
    (the worst-case baseline).
  * ``catwalk_ep``: expert parallelism over a ``("data", "model")`` mesh
    (:func:`moe_apply_ep`); without a mesh, or where the mesh cannot split
    the experts, it runs ``moe_apply``, as the reference does.

Under a mesh every rank holds a block of the batch's rows (over the DP
axes, and ``model`` too under ``batch_over_model``). ``moe_apply`` then
gathers the layer's tokens over those axes, runs the whole layer, and
keeps the rank's rows, so the capacity, the drops and the aux loss are
the whole batch's. ``moe_apply_ep`` routes each rank's own rows against
its own experts, with the capacity from the local token count, as the
reference's ``shard_map`` body does.

bf16 rounding points follow the reference's compiled layer: the gate
probabilities are rounded to the model dtype, the combine multiplies and
sums over k in f32 and rounds once, and the SwiGLU product is rounded
before the down projection.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import specs as SH


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
    return _balance(torch.mean(probs_full, dim=0), idx, e)


def _balance(importance: torch.Tensor, idx: torch.Tensor,
             e: int) -> torch.Tensor:
    """:func:`_aux_loss` from the mean router probability of each expert
    (``importance``, (E,)) and every assignment's expert (``idx``)."""
    load = torch.zeros((e,), dtype=torch.float32, device=idx.device)
    load = load.index_add(0, idx.reshape(-1).to(torch.int64),
                          torch.ones(idx.numel(), dtype=torch.float32,
                                     device=idx.device))
    load = load / torch.clamp(load.sum(), min=1.0)
    return e * torch.sum(load * importance)


def _combine(contrib: torch.Tensor, probs: torch.Tensor,
             f32: bool = False) -> torch.Tensor:
    """sum over k of contrib (T, k, D) * probs (T, k), both in the model
    dtype: the reference's compiled combine takes the product and the sum
    in f32 and rounds once, to the model dtype (``f32``: not yet)."""
    out = torch.sum(L._f32(contrib) * L._f32(probs)[..., None], dim=1)
    return out if f32 else out.to(contrib.dtype)


def _capacity(t: int, cfg: MoEConfig) -> int:
    k, e = cfg.top_k, cfg.n_experts
    return min(t, max(k, int(t * k / e * cfg.capacity_factor)))


def _route(p, xt: torch.Tensor, cfg: MoEConfig):
    """(full softmax (T, E) f32, top-k probabilities in xt's dtype, ids
    (T, k)) of the router over tokens ``xt`` (T, D): one gate launch."""
    logits = L._f32(xt) @ p["router"]
    probs_full = torch.softmax(logits, dim=-1)
    probs, idx = ops.moe_gate_topk(logits, cfg.top_k, renorm=True)
    return probs_full, probs.to(xt.dtype), idx


def _relocation(idx: torch.Tensor, cap: int, e_lo: int, e_loc: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Catwalk relocation of the assignments ``idx`` (T, k) to experts
    ``e_lo .. e_lo + e_loc``: stably sorted by expert in token order, each
    in its expert's block of ``cap`` slots, past ``cap`` dropped, as are
    the other experts' assignments. Returns (the source token of each of
    the ``e_loc * cap`` slots, T for an empty one; each assignment's slot
    in token order (T*k,), ``e_loc * cap`` (the trash slot) where it is
    dropped)."""
    t, k = idx.shape
    dev = idx.device
    flat = idx.reshape(-1).to(torch.int64)                       # (T*k,)
    mine = (flat >= e_lo) & (flat < e_lo + e_loc)
    flat_e = torch.where(mine, flat - e_lo, e_loc)       # e_loc = trash
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)                   # relocate
    sorted_e = flat_e[order]
    # rank within expert segment = global sorted pos - segment start
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e_loc + 1, device=dev), side="left")
    rank = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    keep = (sorted_e < e_loc) & (rank < cap)                     # clip at C
    slot = torch.where(keep, sorted_e * cap + rank, e_loc * cap)
    # slot -> source-token table; the trash entry e_loc*cap is written by
    # every dropped assignment and its value is never read
    slot_src = torch.full((e_loc * cap + 1,), t, dtype=torch.int64,
                          device=dev)
    slot_src[slot] = torch.where(keep, flat_tok[order], t)
    # per-assignment slot in TOKEN order (inverse relocation)
    return slot_src[:-1], slot[torch.argsort(order)]


def _gather_slots(expert_out: torch.Tensor, token_slot: torch.Tensor
                  ) -> torch.Tensor:
    """Each assignment's row of ``expert_out`` (E_loc, C, D) at its slot
    ``token_slot`` (T*k,), zero at the trash slot: (T*k, D)."""
    e_loc, cap, d = expert_out.shape
    eo_flat = torch.cat([expert_out.reshape(e_loc * cap, d),
                         expert_out.new_zeros((1, d))], 0)
    return eo_flat[token_slot]


def _relocate_ffn(p, xt: torch.Tensor, probs: torch.Tensor,
                  idx: torch.Tensor, cap: int, e_lo: int, e_loc: int
                  ) -> torch.Tensor:
    """The Catwalk relocation dispatch (:func:`_relocation`) over experts
    ``e_lo .. e_lo + e_loc`` (the leading axis of ``p``'s stacks) of the
    tokens ``xt`` (T, D): the (e_loc, cap, D) FFN runs and each token sums
    its kept contributions weighted by ``probs`` (T, k). Returns (T, D)."""
    t, d = xt.shape
    slot_src, token_slot = _relocation(idx, cap, e_lo, e_loc)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    expert_in = xt_pad[slot_src].reshape(e_loc, cap, d)
    contrib = _gather_slots(_expert_ffn(p, expert_in), token_slot)
    return _combine(contrib.reshape(t, idx.shape[1], d), probs)


def _local_dispatch_ffn(p_loc, xt: torch.Tensor, cfg: MoEConfig, e_lo: int,
                        e_loc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's part of the expert-parallel layer: ``xt`` (T, D) its
    tokens, ``p_loc`` its ``e_loc`` experts (whole d_ff) and its slice of
    the shared experts. Routes all T tokens (one gate launch), keeps the
    assignments to experts ``e_lo .. e_lo + e_loc`` at the capacity of T,
    and returns (its partial output (T, D): the kept contributions plus
    its shared slice's, which the ranks' sum completes; its aux loss over
    its tokens). With ``e_lo = 0, e_loc = E`` and the whole shared
    experts it is ``moe_apply``'s catwalk layer."""
    probs_full, probs, idx = _route(p_loc, xt, cfg)
    out = _relocate_ffn(p_loc, xt, probs, idx, _capacity(xt.shape[0], cfg),
                        e_lo, e_loc)
    if cfg.n_shared:
        out = out + L.mlp_apply(p_loc["shared"], xt)
    return out, cfg.router_aux_loss * _aux_loss(probs_full, idx,
                                                cfg.n_experts)


def _rows_entry(mesh, batch_axes) -> SH.Axis:
    """The axes of more than one rank the rows are split over, or None."""
    if mesh is None:
        return None
    axes = SH.dp_axes(mesh) if batch_axes is None else tuple(batch_axes)
    live = SH.live_axes(mesh, axes)
    return live or None


def plain_block_specs(cfg: MoEConfig, mesh) -> Dict[str, SH.Spec]:
    """Spec of each unstacked expert stack as the plain layer under
    ``mesh`` takes it (:func:`moe_apply`): as it rests under
    :func:`repro_torch.sharding.specs.param_pspec` (the experts over
    ``model``, their d_ff over the DP axes that divide it) where ``model``
    has more than one rank and divides the experts, else an empty dict
    (every leaf whole)."""
    m = SH.axis_size(mesh, "model") if "model" in SH.axis_names(mesh) else 1
    if m == 1 or cfg.n_experts % m or cfg.dispatch == "dense":
        return {}
    f = SH._fit(mesh, cfg.d_expert, SH.dp_axes(mesh))
    return {"w_gate": ("model", None, f), "w_up": ("model", None, f),
            "w_down": ("model", f, None)}


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig, *, mesh=None,
              batch_axes=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out, {'aux_loss': scalar}).

    Under ``mesh``, ``x`` is this rank's block of rows over ``batch_axes``
    (default the mesh's DP axes), the same on every ``model`` rank; the
    capacity, the drops and the aux loss are the whole batch's. Where
    ``p``'s expert stacks are this rank's blocks
    (:func:`plain_block_specs`), the rank computes its experts' slots of
    the whole batch (:func:`_plain_part`). Where they are whole (and the
    router and shared experts always), the rows of every rank are gathered
    (:func:`repro_torch.sharding.specs.gather_along`), the whole layer
    runs on each rank and each keeps its own rows; the aux loss's gradient
    then enters a sum of the ranks' gradients once
    (:func:`repro_torch.sharding.specs.count_once`)."""
    entry = _rows_entry(mesh, batch_axes)
    if mesh is not None and p["w_gate"].shape[0] < cfg.n_experts:
        return _plain_part(p, x, cfg, mesh, SH.live_axes(mesh, entry))
    if entry is not None:
        whole = SH.gather_along(x, 0, entry, mesh)
        out, stats = moe_apply(p, whole, cfg)
        rows = SH.block_slice(mesh, whole.shape[0], entry)
        return out[rows], {"aux_loss": SH.count_once(
            stats["aux_loss"], entry, mesh)}
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e = cfg.n_experts
    if cfg.dispatch != "dense":
        out, aux = _local_dispatch_ffn(p, xt, cfg, 0, e)
        return out.reshape(b, s, d), {"aux_loss": aux}
    # worst-case baseline: all experts on all tokens
    probs_full, probs, idx = _route(p, xt, cfg)
    ys = _expert_ffn(p, xt.expand(e, t, d))                      # (E,T,D)
    gate = torch.zeros((t, e), dtype=x.dtype, device=x.device)
    gate.scatter_(1, idx.to(torch.int64), probs)
    out = torch.einsum("te,etd->td", gate, ys)
    if cfg.n_shared:
        out = out + L.mlp_apply(p["shared"], xt)
    aux = cfg.router_aux_loss * _aux_loss(probs_full, idx, e)
    return out.reshape(b, s, d), {"aux_loss": aux}


def _plain_part(p, x: torch.Tensor, cfg: MoEConfig, mesh,
                rows: Tuple[str, ...]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`moe_apply` with the expert stacks as this rank's blocks
    (``rows``: the axes of more than one rank the rows are split over, not
    ``model``). The layer of the reference's ``expert_in`` pinned to
    ``("model", None, None)``:

    * the rank routes its own rows (one gate launch) and the ids are
      gathered over ``rows``, so every rank relocates every assignment of
      the batch (global token order, the whole batch's capacity) and knows
      its experts' slots;
    * each rank fills the slots its rows own and a sum over ``rows`` fills
      them all: no rank holds the whole batch's (E, C, D) buffer or other
      experts' rows;
    * the rank's experts run on their slots with their d_ff block, and a
      sum over the DP axes that split the d_ff completes them;
    * each rank combines its rows' contributions from its experts in
      float32; the sum over ``model`` completes the routed output, which
      is rounded once, and the whole shared experts add theirs.

    The aux loss is the whole batch's (the experts' mean probability
    summed over ``rows``). Gradients: every sum over an axis the rows are
    split over sums its gradient back (each rank's rows' loss is a part of
    the batch's), the rows and the gate probabilities enter the ranks'
    experts through :func:`repro_torch.sharding.specs.copy_to` over
    ``model``."""
    if "model" in rows:
        raise ValueError("the plain MoE layer takes its expert blocks with "
                         "the rows replicated over 'model'")
    e, f = cfg.n_experts, cfg.d_expert
    e_loc, f_loc = p["w_gate"].shape[0], p["w_gate"].shape[2]
    f_axes = () if f_loc == f else SH.live_axes(
        mesh, SH._fit(mesh, f, SH.dp_axes(mesh)))
    if f_loc * SH.axis_size(mesh, f_axes) != f \
            or e_loc * SH.axis_size(mesh, "model") != e:
        raise ValueError(f"expert blocks {tuple(p['w_gate'].shape)} are "
                         f"not this rank's under plain_block_specs")
    b, s, d = x.shape
    t_loc = b * s
    xt = x.reshape(t_loc, d)
    entry = rows or None
    t = t_loc * SH.axis_size(mesh, entry)
    r0 = SH.block_slice(mesh, t, entry).start
    probs_full, probs, idx = _route(p, xt, cfg)
    ids = SH.gather(idx, (entry, None), mesh)                    # (T, k)
    slot_src, token_slot = _relocation(
        ids, _capacity(t, cfg), SH.coordinate(mesh, "model") * e_loc, e_loc)
    # the sum over the rows' axes fills every slot (its gradient, summed
    # back, reaches each slot's owner)
    filled = _fill_slots(SH.copy_to(xt, "model", mesh), slot_src, r0)
    union = tuple(a for a in SH.dp_axes(mesh) if a in rows or a in f_axes)
    expert_in = SH.copy_to(SH.sum_over(filled, rows, mesh), union, mesh)
    part = _expert_ffn(p, expert_in.reshape(e_loc, -1, d))
    expert_out = SH.copy_to(SH.sum_over(part, f_axes, mesh),
                            tuple(a for a in f_axes if a in rows), mesh)
    routed = _rows_combine(expert_out, token_slot,
                           SH.copy_to(probs, "model", mesh), r0)
    out = SH.sum_over(routed, "model", mesh).to(x.dtype)
    if cfg.n_shared:
        out = out + L.mlp_apply(p["shared"], xt)
    # a true division, as the mean's (a Python divisor would go through
    # its reciprocal on the card)
    importance = SH.sum_over(torch.sum(probs_full, dim=0), rows, mesh) \
        / torch.tensor(float(t), device=xt.device)
    aux = cfg.router_aux_loss * _balance(importance, ids, e)
    return out.reshape(b, s, d), {"aux_loss": aux}


def _fill_slots(xt: torch.Tensor, slot_src: torch.Tensor, r0: int
                ) -> torch.Tensor:
    """The slots (``slot_src``, from :func:`_relocation` over the whole
    batch) whose source tokens are this rank's rows ``xt`` (T_loc, D),
    global rows ``r0 .. r0 + T_loc``, filled with them; every other slot
    zero: (E_loc * C, D). The ranks' fills summed are the whole batch's
    dispatch buffer."""
    t_loc, d = xt.shape
    local = slot_src - r0
    mine = (local >= 0) & (local < t_loc)
    pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    return pad[torch.where(mine, local, t_loc)]


def _rows_combine(expert_out: torch.Tensor, token_slot: torch.Tensor,
                  probs: torch.Tensor, r0: int) -> torch.Tensor:
    """The float32 combine (:func:`_combine`, not rounded) of this rank's
    rows, global rows ``r0 .. r0 + T_loc`` with top-k probabilities
    ``probs`` (T_loc, k), from the experts of ``expert_out`` (E_loc, C, D)
    at the whole batch's ``token_slot``: (T_loc, D). The sum over the
    ranks of every expert block is the routed output."""
    t_loc, k = probs.shape
    own = token_slot[r0 * k:(r0 + t_loc) * k]
    contrib = _gather_slots(expert_out, own)
    return _combine(contrib.reshape(t_loc, k, -1), probs, f32=True)


# ---------------------------------------------------------------------------
# Expert parallelism (the --opt layout). Rows are split over the DP axes
# and replicated over ``model``; experts are split over ``model``. Every
# rank routes its own rows, keeps the assignments to its own E / model
# experts, runs the dense (E_loc, C, D) FFN and the shared experts' d_ff
# slice, and one sum over ``model`` combines the partial outputs.
# ---------------------------------------------------------------------------


def ep_model_size(cfg: MoEConfig, mesh) -> int | None:
    """The ``model`` axis size the expert-parallel layer splits the
    experts over, or None where it runs ``moe_apply`` instead, as the
    reference's does: no mesh or no ``model`` axis, a ``model`` axis that
    does not divide the experts, or shared experts whose d_ff it does not
    divide."""
    if "model" not in SH.axis_names(mesh):
        return None
    m = SH.axis_size(mesh, "model")
    if cfg.n_experts % m:
        return None
    if cfg.n_shared and (cfg.n_shared * cfg.d_expert) % m:
        return None
    return m


def ep_fsdp_entry(cfg: MoEConfig, mesh, fsdp: bool) -> SH.Axis:
    """The DP axes the experts' d_ff stays split over in the
    expert-parallel layer's input (``fsdp``: the layout at rest,
    :func:`repro_torch.sharding.specs.param_pspec`), or None."""
    if not fsdp:
        return None
    return SH._fit(mesh, cfg.d_expert, SH.dp_axes(mesh))


def ep_block_specs(cfg: MoEConfig, mesh, fsdp: bool) -> Dict[str, SH.Spec]:
    """Spec of each unstacked MoE leaf as :func:`moe_apply_ep` takes it:
    the experts over ``model`` (d_ff also over the DP axes with
    ``fsdp``), the shared experts' d_ff over ``model``, the router
    whole."""
    f = ep_fsdp_entry(cfg, mesh, fsdp)
    out = {"router": (None, None), "w_gate": ("model", None, f),
           "w_up": ("model", None, f), "w_down": ("model", f, None)}
    if cfg.n_shared:
        out.update({"shared/w_gate": (None, "model"),
                    "shared/w_up": (None, "model"),
                    "shared/w_down": ("model", None)})
    return out


def moe_apply_ep(p, x: torch.Tensor, cfg: MoEConfig, fsdp: bool = False, *,
                 mesh=None, batch_axes=None, seq: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE over ``mesh``'s ``model`` axis; ``moe_apply``
    (under the same mesh) where :func:`ep_model_size` says the reference
    falls back.

    ``x`` (B, S, D) is this rank's block of rows over the DP axes
    (``batch_axes``, default the DP axes; raises where they leave out a
    DP axis of more than one rank or name ``model``), the same on every
    ``model`` rank of its data group; ``p``'s leaves are this
    rank's blocks under :func:`ep_block_specs` (its ``E / model`` experts;
    ``fsdp``: their d_ff still split over the DP axes, gathered here before
    use, the gradient reduce-scattered back). Each rank routes its rows
    (one gate launch), keeps the assignments to its experts at the
    capacity of its own token count, and adds its slice of the shared
    experts; one sum over ``model`` combines the partial outputs (its
    backward hands each rank the gradient unchanged), and the rows' and
    the router's gradients are summed over ``model``. The aux loss is the
    mean of the per-rank aux over the DP axes and ``model``. Returns
    (out (B, S, D), {'aux_loss'}).

    ``seq``: ``x`` is this rank's block of the sequence (dim 1) over
    ``model`` (sequence parallelism), and so is the output: the rows are
    all-gathered along the sequence where they would enter through the
    identity, and the partial outputs reduce-scattered where they would be
    summed; the fallback runs ``moe_apply`` on the whole sequence and
    keeps the block."""
    m = ep_model_size(cfg, mesh)
    if m is None:
        if not seq:
            return moe_apply(p, x, cfg, mesh=mesh, batch_axes=batch_axes)
        whole = SH.gather_along(x, 1, "model", mesh, summed=False)
        out, stats = moe_apply(p, whole, cfg, mesh=mesh,
                               batch_axes=batch_axes)
        return SH.split_along(out, 1, "model", mesh), stats
    dp = SH.dp_axes(mesh)
    rows = SH.live_axes(mesh, dp if batch_axes is None else batch_axes)
    if "model" in rows:
        raise ValueError("the expert-parallel layer needs the rows "
                         "replicated over 'model' (not batch_over_model)")
    if set(SH.live_axes(mesh, dp)) - set(rows):
        raise ValueError(f"the expert-parallel layer needs the rows split "
                         f"over every DP axis {dp} (they are split over "
                         f"{rows}); the reference's shard_map needs its "
                         f"tokens to split over them")
    fsdp = fsdp and bool(dp)
    e, f, d = cfg.n_experts, cfg.d_expert, x.shape[-1]
    e_loc = e // m
    whole = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
             "w_down": (e, f, d), "shared/w_gate": (d, cfg.n_shared * f),
             "shared/w_up": (d, cfg.n_shared * f),
             "shared/w_down": (cfg.n_shared * f, d)}
    p_loc = dict(p)
    for name, spec in ep_block_specs(cfg, mesh, fsdp).items():
        tree, leaf = (p["shared"], name[7:]) if name.startswith("shared/") \
            else (p, name)
        SH.maybe_wsc(tree[leaf], *spec, mesh=mesh, shape=whole[name])
    f_entry = ep_fsdp_entry(cfg, mesh, fsdp)
    if f_entry is not None:
        p_loc["w_gate"] = SH.gather_along(p["w_gate"], 2, f_entry, mesh)
        p_loc["w_up"] = SH.gather_along(p["w_up"], 2, f_entry, mesh)
        p_loc["w_down"] = SH.gather_along(p["w_down"], 1, f_entry, mesh)
    p_loc["router"] = SH.copy_to(p["router"], "model", mesh)
    if seq:
        x = SH.gather_along(x, 1, "model", mesh)
    b, s, _ = x.shape
    xt = x.reshape(b * s, d) if seq \
        else SH.copy_to(x.reshape(b * s, d), "model", mesh)
    e_lo = SH.coordinate(mesh, "model") * e_loc
    out, aux = _local_dispatch_ffn(p_loc, xt, cfg, e_lo, e_loc)
    aux = SH.mean_over(aux, dp + ("model",), mesh)
    if seq:
        return SH.scatter_along(out.reshape(b, s, d), 1, "model", mesh), \
            {"aux_loss": aux}
    out = SH.sum_over(out, "model", mesh)
    return out.reshape(b, s, d), {"aux_loss": aux}
