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

from typing import Any, Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.sharding import specs as SH

#: the mesh axis tensor parallelism splits over
MODEL = "model"
#: the float32 logits one chunk of tokens holds at most in the chunked
#: cross-entropy (:func:`head_cross_entropy`)
CE_CHUNK_BYTES = 1 << 30


class TP(NamedTuple):
    """One rank's tensor-parallel context: ``mesh``'s ``model`` axis spans
    more than one rank and the layers split their heads, columns and
    vocabulary over it. ``seq``: the activations between the layers are
    this rank's block of the sequence (dim 1; sequence parallelism, the
    reference's ``act_sp``). ``blocks``: the names of the module's leaves
    that :func:`repro_torch.models.transformer.tp_plan` keeps split (this
    rank's blocks); the module's other leaves are whole."""
    mesh: Any
    seq: bool = False
    blocks: frozenset = frozenset()

    @property
    def size(self) -> int:
        return SH.axis_size(self.mesh, MODEL)

    @property
    def rank(self) -> int:
        return SH.coordinate(self.mesh, MODEL)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a layer whose weights are this rank's part: ``x`` whole
        on every rank (``seq``: all-gathered), its gradient the sum of the
        ranks' parts' gradients."""
        if self.seq:
            return SH.gather_along(x, 1, MODEL, self.mesh)
        return SH.copy_to(x, MODEL, self.mesh)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """Out of such a layer: the ranks' partial outputs summed
        (``seq``: reduce-scattered to this rank's sequence block)."""
        if self.seq:
            return SH.scatter_along(y, 1, MODEL, self.mesh)
        return SH.sum_over(y, MODEL, self.mesh)

    def whole(self, w: torch.Tensor) -> torch.Tensor:
        """A whole leaf used for this rank's part (or, under ``seq``, on
        its sequence block): the identity, its gradient summed over the
        ranks."""
        return SH.copy_to(w, MODEL, self.mesh)

    def leaves(self, p: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """A module's leaves for this rank's part: its blocks as they
        are, every whole leaf through :meth:`whole`."""
        return {k: v if k in self.blocks else self.whole(v)
                for k, v in p.items()}

    def seq_in(self, x: torch.Tensor) -> torch.Tensor:
        """Into a layer computed whole on every rank: the whole sequence
        under ``seq`` (each rank's gradient is the whole one, so the
        backward keeps the block), else ``x``."""
        if self.seq:
            return SH.gather_along(x, 1, MODEL, self.mesh, summed=False)
        return x

    def seq_out(self, y: torch.Tensor) -> torch.Tensor:
        """Out of such a layer: this rank's sequence block under ``seq``
        (the backward all-gathers the blocks' gradients), else ``y``."""
        if self.seq:
            return SH.split_along(y, 1, MODEL, self.mesh)
        return y

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable sum of the ranks' ``x`` (identity
        backward)."""
        return SH.sum_over(x, MODEL, self.mesh)


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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 tp: TP | None = None) -> torch.Tensor:
    """Rows of ``table`` at ``tokens``; every id must lie in the vocabulary
    (the reference fills out-of-range ids with NaN; the engine never sends
    one, see ``Engine._fill``).

    ``tp``: ``table`` is this rank's block of the vocabulary's rows; the
    ids outside it give zero rows, and the ranks' rows are summed over
    ``model`` (the whole embedding on every rank, ``tp.seq`` ignored)."""
    if tp is None:
        return table[tokens]
    local = tokens - tp.rank * table.shape[0]
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)]
    return tp.total(torch.where(inside[..., None], rows, 0.0))


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


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              tp: TP | None = None) -> torch.Tensor:
    """SwiGLU: down( silu(gate(x)) * up(x) ), the product rounded to x's
    dtype before the down projection, as the reference's compiled form
    rounds it. ``tp``: the weights are this rank's d_ff columns
    (``w_gate``, ``w_up``) and rows (``w_down``)."""
    if tp is not None:
        return tp.leave(mlp_apply(p, tp.enter(x)))
    g = silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, *,
                  total: torch.Tensor | None = None,
                  tp: TP | None = None) -> torch.Tensor:
    """Mean token cross-entropy in float32 (float64 for float64 logits):
    ``logsumexp`` minus the gold logit, averaged over the tokens, or over
    the tokens where ``mask`` is set (divided by ``max(sum(mask), 1)``).
    logits (..., V), labels (...) integer ids in the vocabulary.

    ``total``: for rows that are one block of a batch, the batch's token
    count (or mask sum) to divide by; the blocks' results then add up to
    the batch's (:func:`token_count` gives a block's own).

    ``tp``: ``logits`` are this rank's block of the vocabulary (the
    column-parallel head's); the max is all-reduced without a gradient,
    the sum of the exponentials summed over ``model``, the gold logit
    taken from the rank that holds it, all in float32 (see
    :func:`vocab_max`, :func:`vocab_sumexp`, :func:`vocab_gold`)."""
    if tp is None:
        return _mean_nll(_token_nll(logits, labels), mask, total)
    logits = _f32(logits)
    mx = SH.all_reduce(vocab_max(logits), MODEL, tp.mesh, op="max")
    logz = torch.log(tp.total(vocab_sumexp(logits, mx))) + mx
    gold = tp.total(vocab_gold(logits, labels, tp.rank * logits.shape[-1]))
    return _mean_nll(logz - gold, mask, total)


def head_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor | None = None,
                       *, total: torch.Tensor | None = None) -> torch.Tensor:
    """``cross_entropy(x @ head, labels, mask, total=total)`` with the
    head's product and the loss taken a chunk of tokens at a time (as many
    as hold :data:`CE_CHUNK_BYTES` of float32 logits): the whole
    (tokens, V) logits and their float32 copy are never held. x (..., D),
    head (D, V), labels (...). No chunk's logits are saved for the
    backward (:class:`_HeadNLL` recomputes them). Each token's loss, and
    the sum and the division after, are :func:`cross_entropy`'s."""
    n = labels.numel()
    xs, ls = x.reshape(n, x.shape[-1]), labels.reshape(n)
    rows = max(1, CE_CHUNK_BYTES // (4 * head.shape[-1]))
    nll = _HeadNLL.apply(xs, head, ls, rows)
    return _mean_nll(nll.reshape(labels.shape), mask, total)


def _head_nll(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor
              ) -> torch.Tensor:
    """Each token's loss of one chunk of :func:`head_cross_entropy`."""
    return _token_nll(x @ head, labels)


class _HeadNLL(torch.autograd.Function):
    """Each token's loss of ``xs @ head`` ((n, D) by (D, V)) against the
    labels ``ls`` (n,), ``rows`` tokens at a time. The backward recomputes
    a chunk's logits, takes the gradient of its float32 loss as autograd
    does (``exp(logits - logsumexp)`` times the token's gradient, less
    that at its label, rounded to the head's dtype) and its products with
    the head in that dtype; the head's gradient adds every chunk's product
    in float32 (exact products of the rounded operands) and is rounded to
    its dtype once, as one product over every token is."""

    @staticmethod
    def forward(ctx, xs, head, ls, rows):
        ctx.save_for_backward(xs, head, ls)
        ctx.rows = rows
        parts = [_head_nll(xs[lo:lo + rows], head, ls[lo:lo + rows])
                 for lo in range(0, ls.shape[0], rows)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    @staticmethod
    def backward(ctx, g_nll):
        xs, head, ls = ctx.saved_tensors
        rows = ctx.rows
        want_x, want_head = ctx.needs_input_grad[:2]
        acc = torch.zeros(head.shape, dtype=_f32(head).dtype,
                          device=head.device) if want_head else None
        dxs = []
        for lo in range(0, ls.shape[0], rows):
            x_c, gn = xs[lo:lo + rows], g_nll[lo:lo + rows, None]
            logits = _f32(x_c @ head)
            g = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True)
                          ) * gn
            del logits
            g.scatter_add_(1, ls[lo:lo + rows, None].long(), -gn)
            g = g.to(head.dtype)
            if want_x:
                dxs.append(g @ head.T)
            if want_head:
                # out= rather than addmm_: the FLOP counter (the dry run)
                # knows addmm, not its in-place form
                torch.addmm(acc, _f32(x_c).T, _f32(g), out=acc)
        dx = (dxs[0] if len(dxs) == 1 else torch.cat(dxs)) if want_x \
            else None
        return dx, None if acc is None else acc.to(head.dtype), None, None


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp`` minus its gold logit, in float32."""
    logits = _f32(logits)
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def _mean_nll(nll: torch.Tensor, mask: torch.Tensor | None,
              total: torch.Tensor | None) -> torch.Tensor:
    """The mean of :func:`cross_entropy` over its tokens' losses."""
    if total is not None:
        kept = nll if mask is None else nll * mask.to(nll.dtype)
        return torch.sum(kept) / torch.clamp(total.to(nll.dtype), min=1.0)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def vocab_max(logits: torch.Tensor) -> torch.Tensor:
    """A vocabulary block's largest logit per token, without a gradient
    (its all-reduced max shifts the exponentials)."""
    return torch.amax(logits.detach(), dim=-1)


def vocab_sumexp(logits: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """A vocabulary block's ``sum(exp(logits - mx))`` per token."""
    return torch.sum(torch.exp(logits - mx[..., None]), dim=-1)


def vocab_gold(logits: torch.Tensor, labels: torch.Tensor, v0: int
               ) -> torch.Tensor:
    """The gold logit of each token whose label lies in the block of
    vocabulary ids starting at ``v0``, else 0."""
    local = labels.long() - v0
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1,
                        torch.where(inside, local, 0)[..., None])[..., 0]
    return torch.where(inside, gold, 0.0)


def token_count(labels: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The tokens :func:`cross_entropy` averages over, as a float32
    0-dim tensor: the mask's sum, or every label."""
    if mask is None:
        return torch.tensor(float(labels.numel()), device=labels.device)
    return torch.sum(mask.to(torch.float32))
