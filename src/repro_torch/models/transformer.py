"""Model assembly: every LM family of the reference from one set of blocks.

Families (configs/base.py):
  dense / vlm   GQA decoder with a SwiGLU MLP (vlm prepends projected
                patch embeddings: the vision frontend is a stub, as in the
                reference)
  moe           GQA or MLA attention + MoE FFN (shared experts or a dense
                residual branch)
  ssm           Mamba2 (SSD) stack, attention-free
  hybrid        Mamba2 backbone + ONE shared GQA block applied after every
                ``period``-th layer (Zamba2); one KV cache per site
  audio         encoder-decoder: a bidirectional GQA encoder over projected
                frame embeddings (frontend stub), a causal decoder whose
                blocks cross-attend to the encoder output

The parameter tree keeps the reference's layout: ``embed``, ``final_norm``,
``lm_head`` (unless tied) and ``layers``, whose leaves stack the layers on
a leading axis (audio adds the stacked ``encoder`` and ``frame_proj``, vlm
``patch_proj``, hybrid the unstacked ``shared`` block); dense weights are
``(d_in, d_out)`` and used as ``x @ W``. The reference scans the stacked
layers with ``lax.scan``; here each stacked leaf is split once per call
(``torch.unbind``, whose backward is one ``stack``) and a Python loop runs
the layers. With ``cfg.remat == "block"`` and gradients wanted, each block
runs under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``):
its activations are recomputed in the backward instead of kept. A hybrid
layer and the shared block applied after it are one checkpointed block.

A family outside the six raises ``ValueError``; so does the audio family
without ``frames=`` (the reference fails on ``None.astype`` there).

``forward(..., mesh=)`` runs one rank's part of a ``("data", "model")``
mesh (:func:`repro_torch.sharding.specs.lm_mesh`): the tokens are the
rank's rows (its block over the axes ``batch_axes`` names), and the
parameters are laid out by :func:`tp_plan`: the leaves it keeps split are
this rank's blocks, the others whole. Over a ``model`` axis of more than
one rank (unless ``batch_over_model`` gives that axis to the rows) the
layers are tensor-parallel as the reference's specs lay them out
(:class:`repro_torch.models.layers.TP`): the embedding and the head over
the vocabulary, attention and the Mamba2 mixer by heads, the MLP by d_ff,
each row-parallel projection's partial outputs summed over ``model``;
under ``act_sp`` the residual stream between layers is the rank's block
of the sequence (sequence parallelism) where ``model`` divides the
sequence. A split that is not head-aligned leaves the layer whole on
every rank. The MoE layer keeps its whole-width rows and its experts
over ``model`` (``moe_apply``'s rank part, or ``moe_apply_ep``'s expert
blocks under ``catwalk_ep``). Attention scores its queries a block at a
time, and a loss over a whole vocabulary takes the head's product a chunk
of tokens at a time (:func:`hidden`).

``decode_step(..., mesh=)`` and ``init_serve_state(..., mesh=)`` decode
on such a mesh with the serve state as each rank's blocks under the
reference's serve rules (:func:`decode_plan`). ``decode_step(...,
donate=True)`` writes the new caches into the serve state it was given,
as the reference's ``donate_argnums`` lets XLA do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.optim.tree import tree_map
from repro_torch.sharding import specs as SH
from repro_torch.train.checkpoint import _map_with_path

#: the LM families of the reference's model assembly
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.name}: {cfg.family!r} is not an LM family (one of "
            f"{', '.join(FAMILIES)}); TNN models are served by "
            f"repro_torch.serve.tnn_engine")


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree (one leaf at a time: use
    :func:`_unstack` for every layer)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer of a stacked tree, each leaf split once with
    ``torch.unbind``. Under autograd the split's backward is one ``stack``
    per leaf; indexing each layer would give each layer's index a backward
    that fills and adds a zero gradient the size of the whole stack."""
    keys = list(tree)
    cols = [_unstack(v) if isinstance(v, dict) else torch.unbind(v, 0)
            for v in tree.values()]
    return [dict(zip(keys, layer)) for layer in zip(*cols)]


def _needs_grad(tree: Dict[str, Any], x: torch.Tensor) -> bool:
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(
        _needs_grad(v, x) if isinstance(v, dict) else v.requires_grad
        for v in tree.values())


def _maybe_remat(fn: Callable, cfg: ModelConfig, lp: Dict[str, Any],
                 x: torch.Tensor):
    """``fn(x, lp)``, under activation checkpointing when ``cfg.remat`` is
    ``"block"`` and a gradient is wanted (the block's forward runs again
    in the backward; the model draws no random numbers, so no generator
    state is kept)."""
    if cfg.remat != "block" or not _needs_grad(lp, x):
        return fn(x, lp)
    return torch.utils.checkpoint.checkpoint(fn, x, lp, use_reentrant=False,
                                             preserve_rng_state=False)


def _stacked(n: int, make: Callable[[], Dict[str, Any]],
             place: Callable[[Dict[str, Any]], Dict[str, Any]] = lambda t: t
             ) -> Dict[str, Any]:
    """``n`` trees from ``make()`` stacked on a leading axis, each layer
    through ``place`` first (``init_params``' ``cut``). Each stacked leaf
    is allocated once and filled layer by layer, so the peak is the stack
    plus one layer (a list of layers and ``torch.stack`` would hold the
    model twice)."""
    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict)
                else v.new_empty((n,) + tuple(v.shape))
                for k, v in tree.items()}

    def fill(out, tree, i):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(out[k], v, i)
            else:
                out[k][i] = v

    first = place(make())
    out = alloc(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, place(make()), i)
    return out


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


# ============================================================ init =======
def _block_init(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, device: torch.device) -> Dict[str, Any]:
    """One decoder block (attention + FFN/MoE + norms)."""
    p: Dict[str, Any] = {"norm1": L.rmsnorm_init(cfg.d_model, device),
                         "norm2": L.rmsnorm_init(cfg.d_model, device)}
    if cfg.mla is not None:
        p["attn"] = A.mla_init(generator, cfg, dtype, device)
    else:
        p["attn"] = A.gqa_init(generator, cfg, dtype, device)
    if cfg.moe is not None:
        p["moe"] = M.moe_init(generator, cfg.d_model, cfg.moe, dtype, device)
        if cfg.moe.dense_residual:
            p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, dtype,
                                  device)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, dtype,
                              device)
    return p


def _enc_block_init(generator: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, device: torch.device
                    ) -> Dict[str, Any]:
    """One encoder block (bidirectional GQA + SwiGLU MLP + norms)."""
    return {"norm1": L.rmsnorm_init(cfg.d_model, device),
            "norm2": L.rmsnorm_init(cfg.d_model, device),
            "attn": A.gqa_init(generator, cfg, dtype, device),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, dtype,
                              device)}


def _dec_block_init(generator: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, device: torch.device
                    ) -> Dict[str, Any]:
    """One decoder block with cross-attention (the audio family)."""
    return {"norm1": L.rmsnorm_init(cfg.d_model, device),
            "norm_x": L.rmsnorm_init(cfg.d_model, device),
            "norm2": L.rmsnorm_init(cfg.d_model, device),
            "attn": A.gqa_init(generator, cfg, dtype, device),
            "xattn": A.gqa_init(generator, cfg, dtype, device),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, dtype,
                              device)}


#: ``cut(path, leaf)``: what the tree keeps of a leaf just drawn
Cut = Callable[[Tuple[str, ...], torch.Tensor], torch.Tensor]


def block_cut(pspecs, mesh) -> Cut:
    """The ``cut`` of :func:`init_params` that keeps this rank's block of
    each leaf under the spec tree ``pspecs`` (a stacked leaf's spec leads
    with the stack axis, cut off for its layers)."""
    def cut(path, leaf):
        spec = pspecs
        for k in path:
            spec = spec[k]
        if any(k in SH.STACK_KEYS for k in path[:-1]):
            spec = spec[1:]                  # one layer of a stacked leaf
        return SH.shard_of(leaf, spec, mesh)
    return cut


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Union[str, torch.device, None] = None, *,
                cut: Cut | None = None) -> Dict[str, Any]:
    """Random parameters from ``generator`` on ``device`` (``None`` =
    ``cuda``; raises when CUDA is absent), with the reference's
    distributions and dtypes.

    ``cut``: called on each leaf as soon as it is drawn, with its key path
    (``("layers", "attn", "wq")``; a stacked leaf layer by layer, its path
    naming the stack), and the tree keeps what it returns: a rank's block
    (:func:`repro_torch.train.train_loop.init_train_state` with
    ``mesh=``). The draws are the same with it or without."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = L._dtype(cfg.dtype)

    def put(path: Tuple[str, ...], tree):
        if cut is None:
            return tree
        if isinstance(tree, dict):
            return {k: put(path + (k,), v) for k, v in tree.items()}
        return cut(path, tree)

    def stack(name: str, n: int, make):
        return _stacked(n, make, lambda tree: put((name,), tree))

    params: Dict[str, Any] = {
        "embed": put(("embed",), L.embed_init(
            generator, cfg.vocab_size, cfg.d_model, dtype, dev)),
        "final_norm": put(("final_norm",), L.rmsnorm_init(cfg.d_model, dev)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = put(("lm_head",), L.dense_init(
            generator, cfg.d_model, cfg.vocab_size, dtype, dev))
    if cfg.family in ("ssm", "hybrid"):
        params["layers"] = stack("layers", cfg.n_layers, lambda: {
            "norm1": L.rmsnorm_init(cfg.d_model, dev),
            "ssm": S.ssm_init(generator, cfg, dtype, dev)})
        if cfg.family == "hybrid":
            params["shared"] = put(("shared",), _block_init(
                generator, cfg, dtype, dev))
    elif cfg.family == "audio":
        params["layers"] = stack(
            "layers", cfg.n_layers,
            lambda: _dec_block_init(generator, cfg, dtype, dev))
        params["encoder"] = stack(
            "encoder", cfg.encdec.n_encoder_layers,
            lambda: _enc_block_init(generator, cfg, dtype, dev))
        params["frame_proj"] = put(("frame_proj",), L.dense_init(
            generator, cfg.frontend.d_embed, cfg.d_model, dtype, dev))
    else:
        params["layers"] = stack(
            "layers", cfg.n_layers,
            lambda: _block_init(generator, cfg, dtype, dev))
        if cfg.family == "vlm":
            params["patch_proj"] = put(("patch_proj",), L.dense_init(
                generator, cfg.frontend.d_embed, cfg.d_model, dtype, dev))
    return params


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ====================================================== the TP plan ======
def tp_plan(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Per parameter (the tree of :func:`init_params`; a stacked leaf's
    spec leads with ``None``), the part of its spec at rest
    (:func:`repro_torch.sharding.specs.param_pspecs`) the forward under
    ``mesh`` keeps split; the forward takes every other leaf whole.

    Over ``model`` (not under ``batch_over_model``, whose rows take that
    axis): the embedding's and the head's vocabulary; GQA's ``wq`` and
    ``wo`` where the heads split head-aligned
    (:func:`repro_torch.models.attention.gqa_split`), ``wk`` and ``wv``
    where the KV heads divide too; MLA's ``wq``, ``w_ukv`` and ``wo`` where
    the heads divide; each MLP's three projections (not the MoE layer's
    shared experts) where d_ff divides; Mamba2's ``out_proj`` where its
    heads divide (``in_proj`` stays whole: its blocks at rest cross the
    x/z/B/C/dt boundaries). Under ``catwalk_ep`` the expert-parallel MoE
    layers' blocks (:func:`repro_torch.models.moe.ep_block_specs`); else,
    over ``model`` (not under ``batch_over_model``), the plain MoE layers'
    expert stacks as they rest where ``model`` divides the experts
    (:func:`repro_torch.models.moe.plain_block_specs`).
    Computed once a ``(cfg, mesh)``
    (:func:`repro_torch.sharding.specs.memo`)."""
    return SH.memo(mesh, ("tp_plan", cfg), lambda: _tp_plan(cfg, mesh))


def _tp_plan(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    whole = init_params(torch.Generator(), cfg, device="meta")
    pspecs = SH.param_pspecs(whole, mesh,
                             replicate_embed=cfg.batch_over_model)
    ep = (cfg.moe is not None and cfg.moe.dispatch == "catwalk_ep"
          and M.ep_model_size(cfg.moe, mesh) is not None)
    tp = "model" in SH.axis_names(mesh) and not cfg.batch_over_model
    moe_keep = {}
    if ep:
        moe_keep = M.ep_block_specs(cfg.moe, mesh, cfg.moe.ep_fsdp)
    elif cfg.moe is not None and tp:
        moe_keep = M.plain_block_specs(cfg.moe, mesh)
    m = SH.axis_size(mesh, "model") if tp else 1
    heads = {}
    if cfg.family != "ssm":
        if cfg.mla is not None:
            mla = cfg.n_heads % m == 0
            heads["attn"] = {"wq": mla, "w_ukv": mla, "wo": mla}
        gqa = A.gqa_split(cfg, m)
        kv = gqa and cfg.n_kv_heads % m == 0
        gqa_keep = {"wq": gqa, "wo": gqa, "wk": kv, "wv": kv}
        heads.setdefault("attn", gqa_keep)
        heads["xattn"] = gqa_keep
        mlp = cfg.d_ff % m == 0
        heads["mlp"] = {"w_gate": mlp, "w_up": mlp, "w_down": mlp}
    if cfg.ssm is not None:
        heads["ssm"] = {"out_proj": cfg.ssm.n_heads(cfg.d_model) % m == 0}

    def one(path, spec):
        stacked = path[0] in SH.STACK_KEYS
        inner = path[1:] if stacked else path
        if inner[0] == "moe":
            name = "/".join(inner[1:])
            keep = moe_keep.get(name)
            if keep is None:
                return (None,) * len(spec)
            return ((None,) if stacked else ()) + keep
        if not tp:
            return (None,) * len(spec)
        if inner[0] in ("embed", "lm_head") \
                or heads.get(inner[-2] if len(inner) > 1 else "",
                             {}).get(inner[-1], False):
            return spec
        return (None,) * len(spec)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else one(path + (k,), v) for k, v in tree.items()}
    return walk(pspecs, ())


def _keeps(spec) -> bool:
    """Whether a plan entry keeps its leaf split over ``model``."""
    return spec is not None and "model" in SH.spec_axes(spec)


def _tp_of(cfg: ModelConfig, mesh, batch_axes) -> L.TP | None:
    """The forward's tensor-parallel context under ``mesh``, or None where
    ``model`` has one rank or carries the rows."""
    if mesh is None or cfg.batch_over_model \
            or not SH.live_axes(mesh, "model" if "model"
                                in SH.axis_names(mesh) else None):
        return None
    if "model" in SH.live_axes(mesh, batch_axes):
        raise ValueError("tensor parallelism needs the rows replicated "
                         "over 'model' (they are split over it)")
    return L.TP(mesh)


def vocab_parallel(cfg: ModelConfig, mesh) -> bool:
    """Whether ``forward(..., logits_mode="all", mesh=mesh)`` returns the
    rank's block of the vocabulary (the head is column-parallel over a
    ``model`` axis of more than one rank), for
    :func:`repro_torch.models.layers.cross_entropy`'s ``tp=``."""
    if _tp_of(cfg, mesh, ()) is None:
        return False
    plan = tp_plan(cfg, mesh)
    return _keeps(plan["embed"] if cfg.tie_embeddings else plan["lm_head"])


def _layer_plan(plan) -> Dict[str, Any]:
    """One layer's plan from a stacked subtree's (the stack axis off)."""
    return {k: _layer_plan(v) if isinstance(v, dict) else v[1:]
            for k, v in plan.items()}


# ======================================================== forward ========
def _residual_norm(scale: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + a, rmsnorm(x + a))``, both in x's dtype: the reference's
    compiled block feeds the residual sum to the next norm unrounded, in
    f32, and rounds it for the residual path."""
    xa = L._f32(x) + L._f32(a)
    return xa.to(x.dtype), L.rmsnorm(scale, xa, cfg.norm_eps).to(x.dtype)


def _scale(w: torch.Tensor, tp: L.TP | None) -> torch.Tensor:
    """A norm scale applied to a rank's block of the sequence (under
    ``tp.seq``) enters through ``tp.whole``: its gradient is the sum of
    the blocks'."""
    return tp.whole(w) if tp is not None and tp.seq else w


def _mixer(fn: Callable, h: torch.Tensor, tp: L.TP | None,
           blocks: frozenset) -> torch.Tensor:
    """``fn(h, tp)`` for a layer whose weights the plan splits (``blocks``
    names its split leaves, which ``tp.blocks`` carries into the layer;
    the layer enters and leaves itself); otherwise ``fn(h, None)``, the
    layer whole on every rank (under ``tp.seq``: on the whole sequence,
    the rank's block kept)."""
    if tp is None:
        return fn(h, None)
    if blocks:
        return fn(h, tp._replace(blocks=blocks))
    return tp.seq_out(fn(tp.seq_in(h), None))


def _blocks(tp: L.TP | None, plan) -> Callable[[str], frozenset]:
    """The names of a module's leaves the plan keeps split (none without
    ``tp``)."""
    return lambda mod: frozenset() if tp is None else frozenset(
        k for k, v in plan[mod].items() if _keeps(v))


def _block_apply(p, x: torch.Tensor, cfg: ModelConfig,
                 cache: A.KVCache | None = None,
                 enc_out: torch.Tensor | None = None, mesh=None,
                 batch_axes=None, tp: L.TP | None = None, plan=None,
                 donate: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, A.KVCache | None]:
    """Returns (x, aux_loss, new_cache). With ``enc_out`` (the audio
    decoder), a cross-attention over it follows the self-attention; its
    K/V are computed from ``enc_out`` at every call, as the reference
    does (no cross cache). ``mesh``, ``batch_axes``: see
    :func:`forward`; ``tp``, ``plan``: its tensor-parallel context and
    this block's part of :func:`tp_plan` (with ``cache``: the decode on a
    mesh); ``donate``: the new cache written into ``cache``'s tensors."""
    split = _blocks(tp, plan)
    attn = A.mla_apply if cfg.mla is not None else A.gqa_apply
    h = L.rmsnorm(_scale(p["norm1"], tp), x, cfg.norm_eps)
    if tp is None:
        a, new_cache = attn(p["attn"], h, cfg, cache=cache, donate=donate)
    else:
        caches = []

        def mix(y, t):
            out, c = attn(p["attn"], y, cfg, cache=cache, tp=t,
                          donate=donate)
            caches.append(c)
            return out
        a = _mixer(mix, h, tp, split("attn"))
        new_cache = caches[-1]
    if enc_out is not None:
        x, h = _residual_norm(_scale(p["norm_x"], tp), x, a, cfg)
        a = _mixer(lambda y, t: A.gqa_apply(
            p["xattn"], y, cfg, kv_input=enc_out, causal=False, tp=t)[0],
            h, tp, split("xattn"))
    x, h = _residual_norm(_scale(p["norm2"], tp), x, a, cfg)
    if cfg.moe is not None:
        axes = SH.lm_batch_axes(mesh, cfg.batch_over_model) \
            if batch_axes is None else batch_axes
        if cfg.moe.dispatch == "catwalk_ep":
            out, stats = M.moe_apply_ep(p["moe"], h, cfg.moe,
                                        fsdp=cfg.moe.ep_fsdp, mesh=mesh,
                                        batch_axes=axes,
                                        seq=tp is not None and tp.seq)
        else:
            out, stats = M.moe_apply(p["moe"], h if tp is None
                                     else tp.seq_in(h), cfg.moe, mesh=mesh,
                                     batch_axes=axes)
            out = out if tp is None else tp.seq_out(out)
        aux = stats["aux_loss"]
        if cfg.moe.dense_residual:
            out = out + _mixer(lambda y, t: L.mlp_apply(p["mlp"], y, t), h,
                               tp, split("mlp"))
    else:
        out = _mixer(lambda y, t: L.mlp_apply(p["mlp"], y, t), h, tp,
                     split("mlp"))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux, new_cache


def _ssm_block(x: torch.Tensor, lp, cfg: ModelConfig,
               tp: L.TP | None = None, plan=None) -> torch.Tensor:
    h = L.rmsnorm(_scale(lp["norm1"], tp), x, cfg.norm_eps)
    out = _mixer(lambda y, t: S.ssm_apply(lp["ssm"], y, cfg, tp=t)[0], h,
                 tp, _blocks(tp, plan)("ssm"))
    return x + out


def _hybrid_block(x: torch.Tensor, p, cfg: ModelConfig,
                  tp: L.TP | None = None, plan=None) -> torch.Tensor:
    """A hybrid layer followed by the shared block (``p``, ``plan``: the
    layer's under ``"layer"``, the shared block's under ``"shared"``)."""
    plan = plan or {"layer": None, "shared": None}
    return _block_apply(p["shared"], _ssm_block(x, p["layer"], cfg, tp,
                                                plan["layer"]),
                        cfg, tp=tp, plan=plan["shared"])[0]


def _shared_site(cfg: ModelConfig, i: int) -> int | None:
    """The shared-block site after hybrid layer ``i`` (after every
    ``period``-th layer; the tail past the last whole period has none), or
    None."""
    if cfg.family != "hybrid":
        return None
    period = cfg.hybrid.period
    return i // period if i % period == period - 1 else None


def _enc_block(h: torch.Tensor, lp, cfg: ModelConfig,
               tp: L.TP | None = None, plan=None) -> torch.Tensor:
    split = _blocks(tp, plan)
    n = L.rmsnorm(lp["norm1"], h, cfg.norm_eps)
    a = _mixer(lambda y, t: A.gqa_apply(lp["attn"], y, cfg, causal=False,
                                        tp=t)[0], n, tp, split("attn"))
    h, n = _residual_norm(lp["norm2"], h, a, cfg)
    return h + _mixer(lambda y, t: L.mlp_apply(lp["mlp"], y, t), n, tp,
                      split("mlp"))


def _encode(params, cfg: ModelConfig, frames, tp: L.TP | None = None,
            plan=None) -> torch.Tensor:
    """The audio encoder: ``frames`` (B, S_enc, d_embed) projected to the
    model width, then the bidirectional encoder stack (under remat when a
    gradient is wanted; ``tp``, ``plan``: tensor-parallel, the encoder's
    sequence whole). Raises ``ValueError`` without frames."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family needs frames= "
                         f"(B, S_enc, {cfg.frontend.d_embed}) frame "
                         f"embeddings")
    proj = params["frame_proj"]
    h = torch.as_tensor(frames, device=proj.device).to(proj.dtype) @ proj
    lplan = None if tp is None else _layer_plan(plan["encoder"])
    for lp in _unstack(params["encoder"])[:cfg.encdec.n_encoder_layers]:
        h = _maybe_remat(lambda x, p: _enc_block(x, p, cfg, tp, lplan), cfg,
                         lp, h)
    return h


def forward(params, cfg: ModelConfig, tokens, *, patches=None, frames=None,
            logits_mode: str = "all", mesh=None, batch_axes=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    tokens (B, S) on the parameters' device (or host ids, copied there);
    patches (B, Np, d_embed) for vlm, prepended after ``patch_proj`` (the
    logits of ``"all"`` leave the prefix out); frames (B, S_enc, d_embed)
    for audio, required (other families ignore both, as the reference
    does). ``logits_mode='last'`` projects only the final position
    (prefill and scoring: avoids the (B, S, V) logits tensor). dense, vlm,
    audio: aux_loss is 0; ssm and hybrid: each layer runs the SSD scan
    once over the whole sequence (again in the backward under remat) and
    aux_loss is 0; moe: each layer runs the router gate once over all B*S
    tokens and aux_loss sums the layers' load-balancing losses.

    ``mesh``: a ``("data", "model")`` DeviceMesh this rank's part runs on
    (see the module docstring): ``params`` are laid out by
    :func:`tp_plan` (its split leaves this rank's blocks, the rest
    whole); the logits are the rank's rows', and under tensor parallelism
    with ``logits_mode="all"`` the rank's block of the vocabulary
    (:func:`vocab_parallel`; ``"last"`` gathers the whole vocabulary);
    the aux loss is the whole batch's (``catwalk_ep``: the mean of the
    ranks' aux, as the reference's ``pmean``). ``batch_axes``: the axes
    the rows are split over (default
    :func:`repro_torch.sharding.specs.lm_batch_axes`; the mesh train step
    passes :func:`repro_torch.sharding.specs.lm_row_axes`).
    """
    if logits_mode not in ("all", "last"):
        raise ValueError(f"logits_mode must be 'all' or 'last', got "
                         f"{logits_mode!r}")
    x, aux, n_prefix = _trunk(params, cfg, tokens, patches, frames, mesh,
                              batch_axes)
    if logits_mode == "all":
        return x[:, n_prefix:] @ _head(params, cfg), aux
    logits = x[:, -1:] @ _head(params, cfg)
    if vocab_parallel(cfg, mesh):
        logits = SH.gather_along(logits, 2, "model", mesh, summed=False)
    return logits, aux


def hidden(params, cfg: ModelConfig, tokens, *, patches=None, frames=None,
           mesh=None, batch_axes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, aux_loss): what :func:`forward` with ``logits_mode="all"``
    multiplies by the head (:func:`_head`), the final-normed hidden state
    of the text positions (B, S, D), so a loss can take the head's product
    a chunk of tokens at a time
    (:func:`repro_torch.models.layers.head_cross_entropy`). Arguments as
    :func:`forward`'s; under :func:`vocab_parallel` the head is the rank's
    block of the vocabulary."""
    x, aux, n_prefix = _trunk(params, cfg, tokens, patches, frames, mesh,
                              batch_axes)
    return x[:, n_prefix:], aux


def _trunk(params, cfg: ModelConfig, tokens, patches, frames, mesh,
           batch_axes) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(x, aux_loss, prefix length) of :func:`forward`: x (B, Np + S, D)
    the final-normed hidden state the head multiplies (under tensor
    parallelism whole on every rank, entered for a column-parallel
    head)."""
    _check_family(cfg)
    dev = params["embed"].device
    tp = _tp_of(cfg, mesh, SH.lm_batch_axes(mesh, cfg.batch_over_model)
                if batch_axes is None else batch_axes)
    plan = None if tp is None else tp_plan(cfg, mesh)
    x = L.embed_lookup(params["embed"], _tokens(tokens, dev),
                       tp if tp is not None and _keeps(plan["embed"])
                       else None)
    n_prefix = 0
    if cfg.family == "vlm" and patches is not None:
        proj = params["patch_proj"]
        px = torch.as_tensor(patches, device=dev).to(x.dtype) @ proj
        x = torch.cat([px, x], dim=1)
        n_prefix = px.shape[1]
    enc_out = _encode(params, cfg, frames, tp, plan) \
        if cfg.family == "audio" else None
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    # the reference pins the activations to (dp, model, None) between
    # layers under cfg.act_sp: here each rank then holds its block of the
    # sequence
    if tp is not None and cfg.act_sp and x.shape[1] % tp.size == 0:
        tp = tp._replace(seq=True)
        x = SH.split_along(x, 1, "model", mesh)
    lplan = None if tp is None else _layer_plan(plan["layers"])
    for i, lp in enumerate(_unstack(params["layers"])[:cfg.n_layers]):
        if cfg.family in ("ssm", "hybrid"):
            if _shared_site(cfg, i) is None:
                x = _maybe_remat(lambda h, p: _ssm_block(h, p, cfg, tp,
                                                         lplan), cfg, lp, x)
            else:
                x = _maybe_remat(
                    lambda h, p: _hybrid_block(
                        h, p, cfg, tp, None if tp is None else
                        {"layer": lplan, "shared": plan["shared"]}),
                    cfg, {"layer": lp, "shared": params["shared"]}, x)
        else:
            x, layer_aux = _maybe_remat(
                lambda h, p: _block_apply(p, h, cfg, enc_out=enc_out,
                                          mesh=mesh, batch_axes=batch_axes,
                                          tp=tp, plan=lplan)[:2],
                cfg, lp, x)
            aux = aux + layer_aux
    x = L.rmsnorm(_scale(params["final_norm"], tp), x, cfg.norm_eps)
    if tp is not None and _keeps(plan["embed"] if cfg.tie_embeddings
                                 else plan["lm_head"]):
        # column-parallel: this rank's block of the vocabulary
        return tp.enter(x), aux, n_prefix
    if tp is not None:
        x = tp.seq_in(x)
    return x, aux, n_prefix


# ========================================================= serving =======
class ServeState(NamedTuple):
    layer_caches: Any          # stacked per-layer caches (leading axis L)
    shared_cache: Any          # hybrid: KV caches on a leading site axis
    enc_out: Any               # audio: the encoder output (B, S_enc, D)
    pos: torch.Tensor          # () int32, or (B,) per slot


def _stack_cache(one, n: int):
    """``n`` zero copies of the cache ``one`` on a leading axis."""
    return type(one)(*(t.expand((n,) + tuple(t.shape)).clone() for t in one))


def init_serve_state(params, cfg: ModelConfig, batch: int, max_len: int, *,
                     frames=None, mesh=None) -> ServeState:
    """Zero caches for ``batch`` rows, stacked on a leading layer axis:
    ssm and hybrid, the conv window and the SSD state (``max_len`` does not
    bound a recurrent cache), and for hybrid one GQA K/V cache of
    ``max_len`` positions per shared-block site (``n_layers // period``
    sites: the weights are shared, the KV streams are not); the attention
    families, the GQA K/V or the MLA latent and rotary key, ``max_len``
    positions each, with one scalar position per layer. audio also encodes
    ``frames`` (required) once and holds the encoder output.

    ``mesh``: this rank's blocks (see :func:`decode_step`); ``params``
    are laid out by :func:`serve_pspecs`, ``frames`` whole."""
    _check_family(cfg)
    dev = params["embed"].device
    if mesh is not None:
        return _mesh_serve_state(params, cfg, batch, max_len, frames, mesh)
    caches, shared_cache = _zero_caches(cfg, batch, max_len, dev)
    enc_out = _encode(params, cfg, frames) if cfg.family == "audio" \
        else None
    return ServeState(caches, shared_cache, enc_out,
                      torch.zeros((), dtype=torch.int32, device=dev))


def _zero_caches(cfg: ModelConfig, batch: int, max_len: int,
                 device: Union[str, torch.device]):
    """(layer caches, hybrid shared caches or None) of
    :func:`init_serve_state`, zero, on ``device``."""
    dtype = L._dtype(cfg.dtype)
    dev = torch.device(device)
    if cfg.family in ("ssm", "hybrid"):
        caches = _stack_cache(S.ssm_cache_init(cfg, batch, dtype, dev),
                              cfg.n_layers)
        shared = None
        if cfg.family == "hybrid":
            shared = _stack_cache(
                A.gqa_cache_init(cfg, batch, max_len, dtype, dev),
                cfg.n_layers // cfg.hybrid.period)
        return caches, shared
    init = A.mla_cache_init if cfg.mla is not None else A.gqa_cache_init
    return _stack_cache(init(cfg, batch, max_len, dtype, dev),
                        cfg.n_layers), None


def _mesh_serve_state(params, cfg: ModelConfig, batch: int, max_len: int,
                      frames, mesh) -> ServeState:
    """:func:`init_serve_state` under ``mesh``: this rank's blocks under
    :func:`repro_torch.sharding.specs.serve_shardings`, zero; audio
    encodes the rank's rows of ``frames`` (whole) with ``params`` laid out
    by :func:`serve_pspecs`."""
    dev = params["embed"].device
    caches, shared = _zero_caches(cfg, batch, max_len, "meta")
    enc = None
    if cfg.family == "audio":
        if frames is None:
            _encode(params, cfg, frames)           # raises, naming frames
        enc = torch.empty((batch, frames.shape[1], cfg.d_model),
                          dtype=L._dtype(cfg.dtype), device="meta")
    meta = ServeState(caches, shared, enc,
                      torch.zeros((), dtype=torch.int32, device="meta"))
    state = _map_with_path(meta, lambda key, leaf: torch.zeros(
        SH.block_shape(leaf.shape, SH.cache_pspec(key, leaf, mesh), mesh),
        dtype=leaf.dtype, device=dev))
    if enc is None:
        return state
    rows = SH.cache_pspec("enc_out", enc, mesh)[0]
    tp = _tp_of(_serve_cfg(cfg), mesh, SH.live_axes(mesh, rows))
    mine = torch.as_tensor(frames)[SH.block_slice(mesh, batch, rows)]
    enc_out = _encode(_fetch(params, _fetch_specs(cfg, mesh), mesh),
                      _serve_cfg(cfg), mine, tp,
                      decode_plan(cfg, mesh))
    return state._replace(enc_out=enc_out)


def per_slot_state(state: ServeState, batch: int) -> ServeState:
    """Switch a fresh serve state to per-slot cache positions.

    Replaces every scalar position with its ``(B,)`` vector layout
    (``attention.KVCache.pos``) so each batch row advances on its own —
    the layout continuous batching decodes against
    (:meth:`repro_torch.serve.engine.Engine.serve`): a freed row's position
    is reset to 0 and the row re-fills with a new request while the other
    rows keep decoding. ``decode_step`` serves both layouts (the cache ops
    branch on ``pos.dim()``). Only attention KV caches position rows this
    way; other states raise ``ValueError``.
    """
    caches = state.layer_caches
    if not isinstance(caches, A.KVCache):
        raise ValueError(
            "per-slot positions need attention KV caches; family with "
            f"caches {type(caches).__name__} is served statically")
    if state.enc_out is not None or state.shared_cache is not None:
        raise ValueError("per-slot positions: audio/hybrid states are "
                         "served statically")
    n_layers = caches.pos.shape[0]
    dev = caches.pos.device
    return ServeState(
        caches._replace(pos=torch.zeros((n_layers, batch), dtype=torch.int32,
                                        device=dev)),
        state.shared_cache, state.enc_out,
        torch.zeros((batch,), dtype=torch.int32, device=dev))


def reset_slots(state: ServeState, free) -> ServeState:
    """Zero the cache positions of the rows selected by ``free`` (B,) bool.

    The admission reset for continuous batching: a re-filled slot starts
    writing at position 0 again. Stale K/V content above the reset
    position needs no clearing — the validity mask derived from ``pos``
    (``attention._cache_valid``) hides it. Requires a per-slot state
    (:func:`per_slot_state`).
    """
    caches = state.layer_caches
    if not isinstance(caches, A.KVCache) or caches.pos.dim() != 2:
        raise ValueError("reset_slots needs a per-slot state "
                         "(see per_slot_state)")
    free = torch.as_tensor(free, dtype=torch.bool, device=caches.pos.device)
    zero = torch.zeros((), dtype=torch.int32, device=caches.pos.device)
    return ServeState(
        caches._replace(pos=torch.where(free[None, :], zero, caches.pos)),
        state.shared_cache, state.enc_out,
        torch.where(free, zero, state.pos))


def _kv(caches: A.KVCache, i: int) -> A.KVCache:
    return A.KVCache(caches.k[i], caches.v[i], caches.pos[i])


def _new_stack(caches):
    """Empty buffers of a stacked cache's shapes (None for None), which a
    decode step fills layer by layer (:func:`_put`): the step then holds
    the old stack, the new one and one layer's update (a list of layers
    stacked at the end would hold the caches three times over)."""
    if caches is None:
        return None
    return type(caches)(*(torch.empty_like(t) for t in caches))


def _put(stack, i: int, cache) -> None:
    """Write one layer's (or site's) cache at index ``i`` of ``stack``."""
    for buf, t in zip(stack, cache):
        buf[i] = t


def decode_step(params, cfg: ModelConfig, state: ServeState,
                tokens, *, mesh=None, donate: bool = False
                ) -> Tuple[torch.Tensor, ServeState]:
    """One decode step. tokens (B, 1) -> logits (B, V), new state. ssm and
    hybrid: each layer runs the exact one-token recurrence (no kernel
    launch), and hybrid applies the shared block with its site's cache
    after every ``period``-th layer; the attention families: each layer
    attends over its cache (moe: and runs the router gate once; audio: and
    cross-attends to ``state.enc_out``).

    ``mesh``: one rank's step of a ``("data", "model")`` (or ``("pod",
    "data", "model")``) mesh, the step the reference's dry run compiles
    with ``param_shardings``, ``serve_shardings`` and batch-split tokens.
    ``params`` are this rank's blocks under :func:`serve_pspecs`, ``state``
    its blocks under :func:`repro_torch.sharding.specs.serve_shardings`
    (:func:`init_serve_state` with ``mesh=``; a static batch: scalar
    positions), ``tokens`` whole. The rank runs its rows (over the DP
    axes that divide the batch) and, over ``model``, its heads, as
    :func:`decode_plan` lays them out; it gathers the leaves the plan
    leaves whole, a layer's when the layer runs. Every rank returns the
    whole logits and its blocks of the new state. ``batch_over_model``
    and ``act_sp`` do not apply: the reference's decode cell splits the
    tokens over the DP axes alone.

    ``donate``: the reference's ``donate_argnums`` on the serve state. The
    step writes each layer's new K/V or MLA latent at its positions, its
    conv window and SSD state (once both are computed) and the positions
    into ``state``'s tensors, and returns them: bit for bit the functional
    step's values, the caches held once. On a mesh a leaf the step
    gathers gets the rank's block of its new value. The caller must not
    read the old state after such a step."""
    _check_family(cfg)
    dev = params["embed"].device
    tokens = _tokens(tokens, dev)
    b = tokens.shape[0]
    rows = live = tp = plan = lplan = table = lfetch = None
    mine = slice(None)
    given = state
    if mesh is not None:
        if state.pos.dim() != 0:
            raise ValueError("a decode step on a mesh serves a static batch "
                             "(scalar positions, not per_slot_state)")
        rows = SH._fit(mesh, b, SH.dp_axes(mesh))
        mine = SH.block_slice(mesh, b, rows)
        live = SH.live_axes(mesh, rows)
        plan = decode_plan(cfg, mesh)
        lplan = _layer_plan(plan["layers"])
        fetch = _fetch_specs(cfg, mesh)
        lfetch = _layer_plan(fetch["layers"])
        params = {k: v if k in _DECODE_SKIP else _fetch(v, fetch[k], mesh)
                  for k, v in params.items()}
        table = _state_specs(cfg, state, b, mesh)
        state = _map_with_path(state, lambda key, leaf: SH.gather(
            leaf, SH.spec_minus(*table[key]), mesh))
        cfg = _serve_cfg(cfg)
        tp = _tp_of(cfg, mesh, live)
    x = L.embed_lookup(params["embed"], tokens[mine],
                       tp if tp is not None and _keeps(plan["embed"])
                       else None)
    split = _blocks(tp, lplan)
    caches, shared = state.layer_caches, state.shared_cache
    new_caches, new_shared = (caches, shared) if donate else (
        _new_stack(caches), _new_stack(shared))
    layers = _unstack(params["layers"])[:cfg.n_layers]
    if cfg.family in ("ssm", "hybrid"):
        for i, lp in enumerate(layers):
            lp = _fetch(lp, lfetch, mesh)

            def ssm(y, t, lp=lp, i=i):
                out, c = S.ssm_apply(lp["ssm"], y, cfg, cache=S.SSMCache(
                    caches.conv[i], caches.state[i]), tp=t, donate=donate)
                if not donate:
                    _put(new_caches, i, c)
                return out
            hn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
            x = x + _mixer(ssm, hn, tp, split("ssm"))
            site = _shared_site(cfg, i)
            if site is None:
                continue
            if mesh is None:
                x, _, new_site = _block_apply(params["shared"], x, cfg,
                                              cache=_kv(shared, site),
                                              donate=donate)
                if not donate:
                    _put(new_shared, site, new_site)
            else:
                x = _site_step(params["shared"], x, cfg, shared, new_shared,
                               site, mine, rows,
                               table[".shared_cache/.k"][0][0], mesh, donate)
    else:
        for i, lp in enumerate(layers):
            lp = _fetch(lp, lfetch, mesh)
            x, _, new = _block_apply(lp, x, cfg, cache=_kv(caches, i),
                                     enc_out=state.enc_out, mesh=mesh,
                                     batch_axes=live, tp=tp, plan=lplan,
                                     donate=donate)
            if not donate:
                _put(new_caches, i, new)
    new_state = ServeState(new_caches, new_shared, state.enc_out,
                           state.pos.add_(1) if donate else state.pos + 1)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = x[:, 0] @ _head(params, cfg)
    if mesh is None:
        return logits, new_state
    if tp is not None and _keeps(plan["embed"] if cfg.tie_embeddings
                                 else plan["lm_head"]):
        logits = SH.gather(logits, (None, "model"), mesh)
    logits = SH.gather(logits, (rows, None), mesh)
    if donate:
        new = {}
        _map_with_path(new_state, lambda key, leaf: new.setdefault(key, leaf))
        return logits, _map_with_path(given, lambda key, leaf: SH.put_block(
            leaf, new[key], SH.spec_minus(*table[key]), mesh))

    def back(key, leaf):
        cut = SH.spec_minus(*table[key])
        if not any(SH.split(mesh, e) for e in cut):
            return leaf
        return SH.shard_of(leaf, cut, mesh)
    return logits, _map_with_path(new_state, back)


# ================================================== decoding on a mesh ====
def _site_step(p, x: torch.Tensor, cfg: ModelConfig, shared: A.KVCache,
               new_shared: A.KVCache, site: int, mine: slice, rows: SH.Axis,
               entry: SH.Axis, mesh, donate: bool = False) -> torch.Tensor:
    """The shared block at ``site`` of a decode step on ``mesh``, on the
    rank's rows ``mine`` of the batch (``x``; over the entry ``rows``).
    ``shared``: the rank's blocks of the site caches at rest (every row;
    the site axis over ``entry`` or whole, as ``cache_pspec`` lays it
    out; the positions whole). The site's cache is fetched from the ranks
    that hold it only now (a sum over ``entry`` to which only they add it:
    one site on every rank, dropped after), and the block reads the
    rank's rows of it. The new token's K/V of every row is gathered over
    ``rows`` and written, on the ranks that hold the site, into their
    block of the new stack ``new_shared``; every rank writes the site's
    new position. ``donate``: ``new_shared`` is ``shared``, and the block
    writes its rows and the position in place."""
    n_loc = shared.k.shape[0]
    j, owner = site % n_loc, site // n_loc
    held = SH.block_slice(mesh, shared.pos.shape[0], SH.split(mesh, entry)
                          ).start // n_loc == owner
    k_site, v_site = shared.k[j], shared.v[j]
    if SH.split(mesh, entry):
        k_site, v_site = (SH.all_reduce(t, entry, mesh) if held else
                          SH.all_reduce(torch.zeros_like(t), entry, mesh,
                                        copy=False)
                          for t in (k_site, v_site))
    at = A.cache_index(shared.pos[site], 1, k_site.shape[1])
    x, _, new = _block_apply(p, x, cfg, cache=A.KVCache(
        k_site[mine], v_site[mine], shared.pos[site]), donate=donate)
    if not donate:
        new_shared.pos[site] = new.pos
    for buf, old, upd in ((new_shared.k, k_site, new.k),
                          (new_shared.v, v_site, new.v)):
        token = SH.gather(upd[:, at], (rows, None, None, None), mesh)
        if held:
            if not donate:
                buf[j] = old
            buf[j][:, at] = token
    return x


def _serve_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config a decode step on a mesh plans with: the rows over the DP
    axes alone and no sequence split (one token)."""
    if not (cfg.batch_over_model or cfg.act_sp):
        return cfg
    return dataclasses.replace(cfg, batch_over_model=False, act_sp=False)


def serve_pspecs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The layout of the parameters a decode step on ``mesh`` takes: the
    reference's ``param_shardings`` in its decode cell (the vocabulary
    over ``model``, whatever ``batch_over_model`` says)."""
    return SH.memo(mesh, ("serve_pspecs", cfg), lambda: SH.param_pspecs(
        init_params(torch.Generator(), cfg, device="meta"), mesh))


def decode_plan(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Per parameter, the part of its :func:`serve_pspecs` spec a decode
    step on ``mesh`` keeps split: :func:`tp_plan` of the serve config,
    but the hybrid's shared block whole, since its site caches are whole
    over ``model`` and the batch (``cache_pspec`` reads only
    ``layer_caches`` as a stack, so it splits the leading site axis alone,
    over the DP axes where they divide it): the block runs on the rank's
    rows with every head (:func:`_site_step`)."""
    def make():
        plan = tp_plan(_serve_cfg(cfg), mesh)
        if "shared" in plan:
            plan = dict(plan, shared=tree_map(lambda s: (None,) * len(s),
                                              plan["shared"]))
        return plan
    return SH.memo(mesh, ("decode_plan", cfg), make)


#: the parameters a decode step does not gather at its start: the stacked
#: layers (each gathered when it runs) and those only the prefill reads
#: (the encoder, the frontend projections)
_DECODE_SKIP = ("layers", "encoder", "frame_proj", "patch_proj")


def _fetch_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Per parameter, the part of its :func:`serve_pspecs` spec that
    :func:`decode_plan` leaves whole (what a rank gathers)."""
    return SH.memo(mesh, ("decode_fetch", cfg), lambda: tree_map(
        SH.spec_minus, serve_pspecs(cfg, mesh), decode_plan(cfg, mesh)))


def _fetch(tree, fetch, mesh):
    """``tree`` (the rank's blocks of parameters) with each leaf gathered
    as far as its entry of ``fetch`` (a part of :func:`_fetch_specs`)
    says; ``tree`` itself without a mesh."""
    if mesh is None:
        return tree
    return tree_map(lambda x, f: SH.gather(x, f, mesh), tree, fetch)


def _state_specs(cfg: ModelConfig, state: ServeState, batch: int, mesh
                 ) -> Dict[str, Tuple[SH.Spec, SH.Spec]]:
    """Per leaf of a serve state of ``batch`` rows (by key; ``state``: a
    rank's blocks): its spec at rest (``cache_pspec`` of the whole leaf)
    and the part the decode step keeps split. The GQA caches keep their
    KV heads split where :func:`decode_plan` keeps ``wk`` split (else
    every rank attends over every head, or its groups of them); every
    other leaf stays as it is (the hybrid's site caches too: a site's is
    gathered only when its block runs, :func:`_site_step`)."""
    attn = state.shared_cache if cfg.family == "hybrid" \
        else state.layer_caches
    max_len = attn.k.shape[2] if isinstance(attn, A.KVCache) else 1
    enc = None if state.enc_out is None else tuple(state.enc_out.shape[1:])
    return SH.memo(mesh, ("state_specs", cfg, batch, max_len, enc),
                   lambda: _make_state_specs(cfg, batch, max_len, enc, mesh))


def _make_state_specs(cfg, batch, max_len, enc, mesh):
    kv = cfg.family not in ("ssm", "hybrid") and cfg.mla is None
    kv_split = kv and _keeps(decode_plan(cfg, mesh)["layers"]["attn"]["wk"])
    caches, shared = _zero_caches(cfg, batch, max_len, "meta")
    whole = ServeState(caches, shared, None if enc is None else torch.empty(
        (batch,) + enc, device="meta"), torch.zeros((), device="meta"))
    table = {}

    def one(key, leaf):
        rest = SH.cache_pspec(key, leaf, mesh)
        name = SH._leaf_name(key)
        keep = rest
        if kv and not kv_split and name in ("layer_caches/k",
                                              "layer_caches/v"):
            keep = rest[:3] + (None,) + rest[4:]
        table[key] = (rest, keep)
    _map_with_path(whole, one)
    return table
