"""Plain reference of a dense decoder with grouped-query attention
(InternLM2's layout): token embedding; per layer RMSNorm, causal GQA with
rotary positions, a residual add, RMSNorm, a SwiGLU MLP, a residual add;
a final RMSNorm and an untied head.

Everything is computed in float32 (:mod:`references.plain`). Rotary
positions rotate interleaved pairs of a head's channels (0 with 1, 2 with
3, ...), as the program under test lays them out; InternLM2's published
code rotates the two halves instead, which is the same model up to a
permutation of the query and key columns. No bias anywhere, as published.

The parameters, made by :func:`init` from the benchmark's seed, are a
tree of tensors: ``embed`` (V, D), ``final_norm`` (D,), ``lm_head`` (D,
V) and ``layers``, whose leaves stack the layers on a leading axis:
``norm1``, ``norm2`` (D,), ``attn.wq`` (D, H*hd), ``attn.wk``,
``attn.wv`` (D, G*hd), ``attn.wo`` (H*hd, D), ``mlp.w_gate``,
``mlp.w_up`` (D, F), ``mlp.w_down`` (F, D). Products are ``x @ W``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.utils.checkpoint

from references import plain

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: float32 scores held at once: attention runs over blocks of queries, as
#: many a block as fit, each against the keys up to its last query (a
#: training microbatch of 2 x 4,096 is one block; a 32,768-token prompt
#: takes 32)
SCORE_BYTES = 2 << 30


def init(gen: torch.Generator, cfg: Dict, device) -> Dict:
    """Random weights from ``gen`` on ``device``, one draw a leaf, as the
    published configuration initialises them: every weight N(0, r^2) with
    r its ``initializer_range`` (0.02), norm scales 1 (float32), the rest
    in the configuration's dtype."""
    dt = DTYPES[cfg["torch_dtype"]]
    n, d, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    h, g = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f = cfg["head_dim"], cfg["intermediate_size"]

    def normal(shape, std):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)
    r = cfg["initializer_range"]
    return {
        "embed": normal((v, d), r),
        "final_norm": ones((d,)),
        "lm_head": normal((d, v), r),
        "layers": {
            "norm1": ones((n, d)), "norm2": ones((n, d)),
            "attn": {"wq": normal((n, d, h * hd), r),
                     "wk": normal((n, d, g * hd), r),
                     "wv": normal((n, d, g * hd), r),
                     "wo": normal((n, h * hd, d), r)},
            "mlp": {"w_gate": normal((n, d, f), r),
                    "w_up": normal((n, d, f), r),
                    "w_down": normal((n, f, d), r)},
        },
    }


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated by position, interleaved pairs."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def _attention(p: Dict, x: torch.Tensor, cfg: Dict,
               prec: plain.Precision) -> torch.Tensor:
    b, s, _ = x.shape
    h, g = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    theta = cfg["rope_theta"]
    q = _rope(prec.mm(x, p["wq"]).reshape(b, s, h, hd), theta)
    k = _rope(prec.mm(x, p["wk"]).reshape(b, s, g, hd), theta)
    v = prec.mm(x, p["wv"]).reshape(b, s, g, hd)
    # query head i reads key/value group i // (h / g)
    q = q.transpose(1, 2)
    k = k.repeat_interleave(h // g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(h // g, dim=2).transpose(1, 2)
    n = max(1, SCORE_BYTES // (4 * b * h * s))
    out = torch.cat([_causal(q[:, :, lo:lo + n], k, v, lo)
                     for lo in range(0, s, n)], dim=2)
    return prec.mm(out.transpose(1, 2).reshape(b, s, h * hd), p["wo"])


def _causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lo: int) -> torch.Tensor:
    """Causal softmax attention of the queries at positions ``lo``,
    ``lo + 1``, ... (B, H, n, hd) over the keys and values up to the
    last of them."""
    n, hi = q.shape[2], lo + q.shape[2]
    scores = (q @ k[:, :, :hi].transpose(-1, -2)) / math.sqrt(q.shape[-1])
    causal = torch.ones((n, hi), dtype=torch.bool, device=q.device
                        ).tril(diagonal=lo)
    scores = scores.masked_fill(~causal, float("-inf"))
    return torch.softmax(scores, -1) @ v[:, :, :hi]


def _block(x: torch.Tensor, p: Dict, cfg: Dict,
           prec: plain.Precision) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    x = x + _attention(p["attn"], plain.rmsnorm(x, p["norm1"], eps), cfg,
                       prec)
    h = plain.rmsnorm(x, p["norm2"], eps)
    m = p["mlp"]
    return x + prec.mm(plain.silu(prec.mm(h, m["w_gate"]))
                       * prec.mm(h, m["w_up"]), m["w_down"])


def hidden(tree: Dict, tokens: torch.Tensor, cfg: Dict,
           prec: plain.Precision) -> torch.Tensor:
    """The final-normed hidden state (B, S, D), float32; each layer under
    activation checkpointing where a gradient is wanted."""
    layers = tree["layers"] if isinstance(tree["layers"], list) \
        else plain.layer_trees(tree)
    x = tree["embed"][tokens.long()].to(torch.float32)
    for p in layers:
        if torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _block, x, p, cfg, prec, use_reentrant=False)
        else:
            x = _block(x, p, cfg, prec)
    return plain.rmsnorm(x, tree["final_norm"], cfg["rms_norm_eps"])


def loss(tree: Dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: Dict,
         prec: plain.Precision) -> torch.Tensor:
    return plain.mean_nll(hidden(tree, tokens, cfg, prec), tree["lm_head"],
                          labels, prec)


def last_logits(tree: Dict, tokens: torch.Tensor, cfg: Dict,
                prec: plain.Precision) -> torch.Tensor:
    """The logits at each sequence's last position (B, V), float32."""
    with torch.no_grad():
        x = hidden(tree, tokens, cfg, prec)[:, -1]
        return prec.mm(x, tree["lm_head"])


# ------------------------------------------------------------ counts
def matmul_params(cfg: Dict) -> Dict[str, int]:
    """Weights that multiply every token, by part: the layers' and the
    head's (the embedding is a lookup)."""
    d, h, g = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["num_key_value_heads"])
    hd, f = cfg["head_dim"], cfg["intermediate_size"]
    layer = d * hd * (h + 2 * g) + h * hd * d + 3 * d * f
    return {"layers": cfg["num_hidden_layers"] * layer,
            "head": d * cfg["vocab_size"]}


def mixer_flops(cfg: Dict, batch: int, seq: int) -> int:
    """Forward FLOPs of causal attention over ``batch`` sequences of
    ``seq`` tokens: Q K^T and P V over the causal triangle (s <= t), 2 a
    multiply-add, every layer."""
    tri = seq * (seq + 1) // 2
    per_layer = 2 * 2 * cfg["num_attention_heads"] * cfg["head_dim"] * tri
    return batch * cfg["num_hidden_layers"] * per_layer
