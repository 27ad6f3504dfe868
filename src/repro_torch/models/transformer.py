"""Model assembly for the dense family (GQA decoder with a SwiGLU MLP),
the ssm family (Mamba2, attention-free) and the moe family (GQA or MLA
attention + MoE FFN, with shared experts or a dense residual branch).

The parameter tree keeps the reference's layout: ``embed``, ``final_norm``,
``lm_head`` (unless tied) and ``layers``, whose leaves stack the layers on
a leading axis; dense weights are ``(d_in, d_out)`` and used as
``x @ W``. The reference scans the stacked layers with ``lax.scan``; here
each stacked leaf is split once per call (``torch.unbind``, whose backward
is one ``stack``) and a Python loop runs the layers. With
``cfg.remat == "block"`` and gradients wanted, each block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
activations are recomputed in the backward instead of kept.

Other families raise ``NotImplementedError`` naming the slice of the port
that brings them (ROADMAP, Queue 1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

#: where each family not ported yet comes from (ROADMAP, Queue 1)
_LATER_SLICE = {
    "vlm": "the vlm slice (the patch frontend)",
    "audio": "the audio slice (the frame frontend, the encoder and "
             "cross-attention)",
    "hybrid": "the zamba2 hybrid-block slice",
}
_PORTED = ("dense", "ssm", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
        where = _LATER_SLICE.get(cfg.family, "no LM slice (TNN models are "
                                 "served by repro_torch.serve.tnn_engine)")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; it "
            f"comes with {where}. The port runs the dense, ssm and moe "
            f"families.")


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


def _stacked(n: int, make: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    """``n`` trees from ``make()`` stacked on a leading axis. Each stacked
    leaf is allocated once and filled layer by layer, so the peak is the
    stack plus one layer (a list of layers and ``torch.stack`` would hold
    the model twice)."""
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

    first = make()
    out = alloc(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, make(), i)
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


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Union[str, torch.device, None] = None
                ) -> Dict[str, Any]:
    """Random parameters from ``generator`` on ``device`` (``None`` =
    ``cuda``; raises when CUDA is absent), with the reference's
    distributions and dtypes."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = L._dtype(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                              dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dtype, dev)
    if cfg.family == "ssm":
        params["layers"] = _stacked(cfg.n_layers, lambda: {
            "norm1": L.rmsnorm_init(cfg.d_model, dev),
            "ssm": S.ssm_init(generator, cfg, dtype, dev)})
    else:
        params["layers"] = _stacked(
            cfg.n_layers, lambda: _block_init(generator, cfg, dtype, dev))
    return params


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ======================================================== forward ========
def _block_apply(p, x: torch.Tensor, cfg: ModelConfig,
                 cache: A.KVCache | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, A.KVCache | None]:
    """Returns (x, aux_loss, new_cache)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = A.mla_apply(p["attn"], h, cfg, cache=cache)
    else:
        a, new_cache = A.gqa_apply(p["attn"], h, cfg, cache=cache)
    # the reference's compiled block feeds the residual sum to the second
    # norm unrounded, in f32, and rounds it for the residual path
    xa = L._f32(x) + L._f32(a)
    h = L.rmsnorm(p["norm2"], xa, cfg.norm_eps).to(x.dtype)
    x = xa.to(x.dtype)
    if cfg.moe is not None:
        # "catwalk_ep" without a process group runs moe_apply, as the
        # reference does without a mesh
        out, stats = M.moe_apply(p["moe"], h, cfg.moe)
        aux = stats["aux_loss"]
        if cfg.moe.dense_residual:
            out = out + L.mlp_apply(p["mlp"], h)
    else:
        out = L.mlp_apply(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux, new_cache


def _ssm_block(x: torch.Tensor, lp, cfg: ModelConfig) -> torch.Tensor:
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    out, _ = S.ssm_apply(lp["ssm"], h, cfg)
    return x + out


def forward(params, cfg: ModelConfig, tokens, *,
            logits_mode: str = "all") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    tokens (B, S) on the parameters' device (or host ids, copied there).
    ``logits_mode='last'`` projects only the final position (prefill and
    scoring: avoids the (B, S, V) logits tensor). dense: aux_loss is 0;
    ssm: each layer runs the SSD scan once over the whole sequence (again
    in the backward under remat) and aux_loss is 0; moe: each layer runs
    the router gate once over all B*S tokens and aux_loss sums the layers'
    load-balancing losses.
    """
    _require_ported(cfg)
    if logits_mode not in ("all", "last"):
        raise ValueError(f"logits_mode must be 'all' or 'last', got "
                         f"{logits_mode!r}")
    dev = params["embed"].device
    x = L.embed_lookup(params["embed"], _tokens(tokens, dev))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for lp in _unstack(params["layers"])[:cfg.n_layers]:
        if cfg.family == "ssm":
            x = _maybe_remat(lambda h, p: _ssm_block(h, p, cfg), cfg, lp, x)
        else:
            x, layer_aux = _maybe_remat(
                lambda h, p: _block_apply(p, h, cfg)[:2], cfg, lp, x)
            aux = aux + layer_aux
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_mode == "last":
        return x[:, -1:] @ _head(params, cfg), aux
    return x @ _head(params, cfg), aux


# ========================================================= serving =======
class ServeState(NamedTuple):
    layer_caches: Any          # stacked per-layer caches (leading axis L)
    shared_cache: Any          # hybrid shared block cache (None here)
    enc_out: Any               # enc-dec encoder output (None here)
    pos: torch.Tensor          # () int32, or (B,) per slot


def init_serve_state(params, cfg: ModelConfig, batch: int,
                     max_len: int) -> ServeState:
    """Zero caches for ``batch`` rows, stacked on a leading layer axis:
    ssm, the conv window and the SSD state (``max_len`` does not bound a
    recurrent cache); dense and moe, the GQA K/V or the MLA latent and
    rotary key, ``max_len`` positions each, with one scalar position per
    layer."""
    _require_ported(cfg)
    dev = params["embed"].device
    dtype = L._dtype(cfg.dtype)
    n = cfg.n_layers
    if cfg.family == "ssm":
        one = S.ssm_cache_init(cfg, batch, dtype, dev)
        caches = S.SSMCache(
            *(t.expand((n,) + tuple(t.shape)).clone() for t in one))
    else:
        init = A.mla_cache_init if cfg.mla is not None else A.gqa_cache_init
        one = init(cfg, batch, max_len, dtype, dev)
        caches = A.KVCache(
            *(t.expand((n,) + tuple(t.shape)).clone() for t in one))
    return ServeState(caches, None, None,
                      torch.zeros((), dtype=torch.int32, device=dev))


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


def decode_step(params, cfg: ModelConfig, state: ServeState,
                tokens) -> Tuple[torch.Tensor, ServeState]:
    """One decode step. tokens (B, 1) -> logits (B, V), new state. ssm:
    each layer runs the exact one-token recurrence (no kernel launch);
    dense and moe: each layer attends over its cache (moe: and runs the
    router gate once)."""
    _require_ported(cfg)
    dev = params["embed"].device
    x = L.embed_lookup(params["embed"], _tokens(tokens, dev))
    caches = state.layer_caches
    if cfg.family == "ssm":
        convs, states = [], []
        for i, lp in enumerate(_unstack(params["layers"])[:cfg.n_layers]):
            hn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
            out, new = S.ssm_apply(lp["ssm"], hn, cfg,
                                   cache=S.SSMCache(caches.conv[i],
                                                    caches.state[i]))
            x = x + out
            convs.append(new.conv)
            states.append(new.state)
        new_caches = S.SSMCache(torch.stack(convs), torch.stack(states))
    else:
        ks, vs, ps = [], [], []
        for i, lp in enumerate(_unstack(params["layers"])[:cfg.n_layers]):
            x, _, new = _block_apply(
                lp, x, cfg, cache=A.KVCache(caches.k[i], caches.v[i],
                                            caches.pos[i]))
            ks.append(new.k)
            vs.append(new.v)
            ps.append(new.pos)
        new_caches = A.KVCache(torch.stack(ks), torch.stack(vs),
                               torch.stack(ps))
    new_state = ServeState(new_caches, None, state.enc_out, state.pos + 1)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x[:, 0] @ _head(params, cfg), new_state
