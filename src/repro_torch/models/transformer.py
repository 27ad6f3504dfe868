"""Model assembly for the ssm family (Mamba2, attention-free).

The parameter tree keeps the reference's layout: ``embed``, ``final_norm``,
``lm_head`` (unless tied) and ``layers``, whose leaves stack the layers on
a leading axis; dense weights are ``(d_in, d_out)`` and used as
``x @ W``. The reference scans the stacked layers with ``lax.scan``; here a
Python loop indexes them. ``cfg.remat`` only matters for training and is
ignored.

Other families raise ``NotImplementedError`` naming the slice of the port
that brings them (ROADMAP, Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

#: where each family not ported yet comes from (ROADMAP, Queue 1)
_LATER_SLICE = {
    "moe": "slice 4 (moe_gate, with models/attention.py and models/moe.py)",
    "dense": "the attention slice (GQA/MLA and continuous serving)",
    "vlm": "the attention slice (GQA/MLA and continuous serving)",
    "audio": "the attention slice (GQA/MLA and continuous serving)",
    "hybrid": "the zamba2 hybrid-block slice",
}


def _require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        where = _LATER_SLICE.get(cfg.family, "no LM slice (TNN models are "
                                 "served by repro_torch.serve.tnn_engine)")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; it "
            f"comes with {where}. This slice runs the ssm family.")


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


# ============================================================ init =======
def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Union[str, torch.device, None] = None
                ) -> Dict[str, Any]:
    """Random parameters from ``generator`` on ``device`` (``None`` =
    ``cuda``; raises when CUDA is absent), with the reference's
    distributions and dtypes."""
    _require_ssm(cfg)
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
    params["layers"] = _stack([
        {"norm1": L.rmsnorm_init(cfg.d_model, dev),
         "ssm": S.ssm_init(generator, cfg, dtype, dev)}
        for _ in range(cfg.n_layers)])
    return params


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ======================================================== forward ========
def forward(params, cfg: ModelConfig, tokens, *,
            logits_mode: str = "all") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    tokens (B, S) on the parameters' device (or host ids, copied there).
    ``logits_mode='last'`` projects only the final position (prefill and
    scoring: avoids the (B, S, V) logits tensor). Each layer runs the SSD
    scan once over the whole sequence; aux_loss is 0 for this family.
    """
    _require_ssm(cfg)
    if logits_mode not in ("all", "last"):
        raise ValueError(f"logits_mode must be 'all' or 'last', got "
                         f"{logits_mode!r}")
    dev = params["embed"].device
    x = L.embed_lookup(params["embed"], _tokens(tokens, dev))
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        out, _ = S.ssm_apply(lp["ssm"], h, cfg)
        x = x + out
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if logits_mode == "last":
        return x[:, -1:] @ _head(params, cfg), aux
    return x @ _head(params, cfg), aux


# ========================================================= serving =======
class ServeState(NamedTuple):
    layer_caches: Any          # stacked per-layer caches (leading axis L)
    shared_cache: Any          # hybrid shared block cache (None here)
    enc_out: Any               # enc-dec encoder output (None here)
    pos: torch.Tensor          # () int32


def init_serve_state(params, cfg: ModelConfig, batch: int,
                     max_len: int) -> ServeState:
    """Zero caches for ``batch`` rows: per layer the conv window and the
    SSD state, stacked on a leading layer axis. ``max_len`` does not bound
    a recurrent cache; it is kept for the reference's signature."""
    del max_len
    _require_ssm(cfg)
    dev = params["embed"].device
    one = S.ssm_cache_init(cfg, batch, L._dtype(cfg.dtype), dev)
    caches = S.SSMCache(
        *(t.expand((cfg.n_layers,) + tuple(t.shape)).clone() for t in one))
    return ServeState(caches, None, None,
                      torch.zeros((), dtype=torch.int32, device=dev))


def decode_step(params, cfg: ModelConfig, state: ServeState,
                tokens) -> Tuple[torch.Tensor, ServeState]:
    """One decode step. tokens (B, 1) -> logits (B, V), new state. Each
    layer runs the exact one-token recurrence (no kernel launch)."""
    _require_ssm(cfg)
    dev = params["embed"].device
    x = L.embed_lookup(params["embed"], _tokens(tokens, dev))
    convs, states = [], []
    caches = state.layer_caches
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        out, new = S.ssm_apply(lp["ssm"], hn, cfg,
                               cache=S.SSMCache(caches.conv[i],
                                                caches.state[i]))
        x = x + out
        convs.append(new.conv)
        states.append(new.state)
    new_state = ServeState(
        S.SSMCache(torch.stack(convs), torch.stack(states)), None,
        state.enc_out, state.pos + 1)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x[:, 0] @ _head(params, cfg), new_state

