"""Attention mixers: GQA (grouped-query) and MLA (multi-head latent).

Both run in two modes from the same parameters:
  * full-sequence (prefill / scoring): causal, or bidirectional for GQA;
  * cached decode: this call's tokens against a (B, S_max) KV cache.

MLA (deepseek-v2) caches the compressed latent c_kv (kv_lora_rank) and the
shared rotary key (d_rope) instead of full per-head K/V, and expands them
on use. Scores and softmax run in float32; the cache keeps the model dtype.

The functions are pure, as the reference's are: a cache update returns a
new buffer and leaves the old one as it was. With ``donate=True`` (a
decode step that donates its state, as the reference's dry run and
launcher let XLA do) the update writes into the cache's own buffers and
advances its position in place, after every read of the old position.

Under tensor parallelism (``tp=``, :class:`repro_torch.models.layers.TP`;
the full sequence, or a cached decode on a mesh) a rank computes its heads: GQA its ``n_heads / m``
query heads with the KV heads of their groups, MLA its heads of ``wq``
and ``w_ukv`` (the latent and rotary-key projections whole); ``wo`` is
row-parallel and the ranks' outputs are summed. The head counts come
from the weights' widths, so the same code computes a whole layer and a
rank's part (:func:`gqa_rank_params`, :func:`mla_rank_params`).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch._subclasses.fake_tensor import is_fake

from repro_torch import tracing
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import gqa_attention as K
from repro_torch.models import layers as L

NEG_INF = -1e30
#: the f32 scores one block of queries holds at most: attention scores its
#: queries block by block (:func:`_by_query_blocks`); where a gradient is
#: wanted, the backward holds several such blocks at once
SCORE_BLOCK_BYTES = 2 << 30


class KVCache(NamedTuple):
    """Decode KV cache. ``pos`` comes in two layouts:

    * ``()`` scalar — all rows share one write position (static batching);
    * ``(B,)`` vector — per-slot positions (continuous batching: row r
      writes at ``pos[r]`` and attends over its own ``pos[r] + s`` valid
      entries only).

    Both advance by ``s`` per call; the cache ops below branch on
    ``pos.dim()``.
    """

    k: torch.Tensor       # GQA: (B, S, Hkv, Dh) | MLA: (B, S, kv_lora)
    v: torch.Tensor       # GQA: (B, S, Hkv, Dh) | MLA: (B, S, d_rope)
    pos: torch.Tensor     # () | (B,) int32 — tokens already in cache


def _cache_positions(pos: torch.Tensor, s: int) -> torch.Tensor:
    """Absolute positions of this call's ``s`` new tokens: (1, s) for a
    scalar ``pos``, (B, s) for per-slot ``pos``."""
    base = torch.arange(s, dtype=torch.int32, device=pos.device)[None, :]
    return pos[:, None] + base if pos.dim() == 1 else pos + base


def _cache_update(buf: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor, donate: bool = False) -> torch.Tensor:
    """``buf`` (B, S, ...) with ``new`` (B, s, ...) written at ``pos``: a
    new buffer, or with ``donate`` ``buf`` itself, written in place.

    Scalar ``pos``: one slice shared by all rows, its start clamped to
    ``[0, S - s]`` as the reference's ``dynamic_update_slice`` clamps it.
    Per-slot ``(B,)`` pos: row r lands at ``pos[r]``; writes past S are
    dropped (the reference's ``mode='drop'``): they go to a trash row past
    the end, which is cut off, so no index leaves the buffer (in place:
    only the writes that land are made)."""
    b, s = new.shape[:2]
    big = buf.shape[1]
    steps = torch.arange(s, dtype=torch.int64, device=buf.device)
    if pos.dim() == 0:
        out = buf if donate else buf.clone()
        out[:, cache_index(pos, s, big)] = new
        return out
    t_idx = pos.to(torch.int64)[:, None] + steps[None, :]
    lands = (t_idx >= 0) & (t_idx < big)
    b_idx = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    if donate:
        buf[b_idx[lands], t_idx[lands]] = new[lands]
        return buf
    t_idx = torch.where(lands, t_idx, big)
    out = torch.cat([buf, buf.new_zeros((b, 1) + tuple(buf.shape[2:]))], 1)
    out[b_idx, t_idx] = new
    return out[:, :big]


def _advance(pos: torch.Tensor, s: int, donate: bool) -> torch.Tensor:
    """The cache position after ``s`` writes (``donate``: ``pos`` itself,
    advanced in place)."""
    return pos.add_(s) if donate else pos + s


def cache_index(pos: torch.Tensor, s: int, big: int) -> torch.Tensor:
    """The cache positions a write of ``s`` tokens at a scalar ``pos``
    lands on in a cache of ``big`` positions (:func:`_cache_update`: its
    start clamped to ``[0, big - s]``)."""
    start = pos.to(torch.int64).clamp(0, max(big - s, 0))
    return start + torch.arange(s, dtype=torch.int64, device=pos.device)


def _cache_valid(pos: torch.Tensor, s: int, s_max: int) -> torch.Tensor:
    """Validity mask over the cache axis after this call's ``s`` writes:
    (S,) for scalar ``pos``, (B, S) per-slot."""
    idx = torch.arange(s_max, device=pos.device)
    if pos.dim() == 0:
        return idx < (pos + s)
    return idx[None, :] < (pos[:, None] + s)


def _positions(cache: Optional[KVCache], s: int,
               device: torch.device) -> torch.Tensor:
    if cache is None:
        return torch.arange(s, dtype=torch.int32, device=device)[None, :]
    return _cache_positions(cache.pos, s)


def _inv_sqrt(d: int) -> float:
    """``1 / sqrt(d)`` as the reference's compiled division by ``sqrt(d)``
    applies it: a multiplication by the float32 reciprocal."""
    return float(np.float32(1.0) / np.float32(np.sqrt(d)))


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s steps: ``exp(x - max) / sum`` (``torch.softmax``
    multiplies by the reciprocal of the sum instead), the max without a
    gradient, as ``jax.nn.softmax`` stops it (so the backward keeps no
    copy of the scores)."""
    z = torch.exp(scores - torch.amax(scores.detach(), dim=-1,
                                      keepdim=True))
    return z / torch.sum(z, dim=-1, keepdim=True)


# =============================================================== GQA ======
def gqa_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device: torch.device
             ) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": L.dense_init(generator, d, cfg.n_heads * hd, dtype, device),
        "wk": L.dense_init(generator, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": L.dense_init(generator, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": L.dense_init(generator, cfg.n_heads * hd, d, dtype, device),
    }


def _block_queries(row_bytes: int) -> int:
    """The queries a block of scores holds: as many as fit
    :data:`SCORE_BLOCK_BYTES` at ``row_bytes`` a query, at least one."""
    return max(1, SCORE_BLOCK_BYTES // max(1, row_bytes))


def _by_query_blocks(fn: Callable[..., torch.Tensor],
                     queries: Tuple[torch.Tensor, ...], row_bytes: int,
                     keys: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """``fn(*query_blocks)`` over blocks of queries (dim 1 of every tensor
    of ``queries``), as many a block as hold :data:`SCORE_BLOCK_BYTES` of
    scores at ``row_bytes`` a query, joined along dim 1. ``fn`` reads
    ``keys`` (every key, whole) itself. Each block scores every key, so
    each query's softmax is whole. Where a
    gradient is wanted each block runs under ``torch.utils.checkpoint``:
    its scores are recomputed in the backward instead of kept."""
    sq = queries[0].shape[1]
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in queries + keys)
    n = _block_queries(row_bytes)
    outs = []
    for lo in range(0, sq, n):
        part = tuple(t[:, lo:lo + n] for t in queries)
        outs.append(torch.utils.checkpoint.checkpoint(
            fn, *part, use_reentrant=False, preserve_rng_state=False)
            if remat else fn(*part))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool,
          kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k/v (B,Sk,G,D) with H = G*rep. f32 softmax. Without a
    validity mask, bf16 operands the kernel takes
    (:func:`repro_torch.kernels.gqa_attention.supported`) go through
    :class:`_GQAAttention` (the fused kernel on CUDA); the rest, decode
    with a cache among them, through :func:`_sdpa_plain`."""
    with tracing.span("attention.scores"):
        if kv_valid is None and K.supported(q, k, v):
            return _GQAAttention.apply(q, k, v, causal)
        return _sdpa_plain(q, k, v, causal, kv_valid)


def _sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, kv_valid: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """The plain path of :func:`_sdpa`: f32 copies of K and V, every key
    scored over blocks of queries (:func:`_by_query_blocks`)."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    rows = torch.arange(sq, device=q.device)[None]
    # (B, G, D, Sk) and (B, G, Sk, D): the keys and values every block reads
    kt = L._f32(k).permute(0, 2, 3, 1).contiguous()
    vf = L._f32(v).permute(0, 2, 1, 3).contiguous()
    return _by_query_blocks(
        lambda qb, ib: _sdpa_block(qb, ib[0], kt, vf, causal, kv_valid),
        (q, rows), 4 * b * h * sk, (kt, vf))


class _GQAAttention(torch.autograd.Function):
    """:func:`_sdpa` without a validity mask, on operands the kernel takes.
    Forward: on CUDA the fused kernel
    (:func:`repro_torch.kernels.gqa_attention.gqa_attention`, under the span
    ``attention.kernel``), and on fake tensors (the dry run) the kernel's
    operator, which allocates only its output; on the CPU the plain
    blocked path (no gradient is recorded inside a function's forward);
    q, k and v are saved.
    Backward: the plain path recomputed one block of queries at a time
    (the blocks of :func:`_by_query_blocks`), each once, with a gradient,
    on detached leaves (the block's queries, the f32 keys and values), and
    the gradients of those leaves taken (``torch.autograd.grad``): the work
    the plain path's checkpointed blocks do in their backward. The keys'
    and values' gradients are summed in f32 over the blocks, last block
    first as autograd sums them, and cast once."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cuda" or is_fake(q):
            with tracing.span("attention.kernel"):
                return K.gqa_attention(q, k, v, causal, _inv_sqrt(q.shape[3]),
                                       q.dtype)
        return _sdpa_plain(q, k, v, causal, None)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        b, sq, h, _ = q.shape
        sk = k.shape[1]
        rows = torch.arange(sq, device=q.device)[None]
        kt = L._f32(k).permute(0, 2, 3, 1).contiguous().requires_grad_(need_k)
        vf = L._f32(v).permute(0, 2, 1, 3).contiguous().requires_grad_(need_v)
        dqs, dkt, dvf = [], None, None
        n = _block_queries(4 * b * h * sk)
        for lo in reversed(range(0, sq, n)):
            qb = q[:, lo:lo + n].detach().requires_grad_(need_q)
            leaves = [t for t in (qb, kt, vf) if t.requires_grad]
            with torch.enable_grad():
                out = _sdpa_block(qb, rows[0, lo:lo + n], kt, vf, ctx.causal,
                                  None)
            grads = dict(zip(map(id, leaves), torch.autograd.grad(
                out, leaves, grad[:, lo:lo + n])))
            if need_q:
                dqs.append(grads[id(qb)])
            if need_k:
                g = grads[id(kt)]
                dkt = g if dkt is None else dkt + g
            if need_v:
                g = grads[id(vf)]
                dvf = g if dvf is None else dvf + g
        # the blocks' query gradients joined once the blocks are done (a
        # buffer filled block by block would be held at their peak)
        dq = (dqs[0] if len(dqs) == 1 else torch.cat(dqs[::-1], dim=1)) \
            if need_q else None
        dk = None if dkt is None else dkt.permute(0, 3, 1, 2).to(k.dtype)
        dv = None if dvf is None else dvf.permute(0, 2, 1, 3).to(v.dtype)
        return dq, dk, dv, None


def _sdpa_block(q: torch.Tensor, rows: torch.Tensor, kt: torch.Tensor,
                vf: torch.Tensor, causal: bool,
                kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """One block of :func:`_sdpa`: queries ``q`` (B, n, H, D) at indices
    ``rows`` of the query axis, against every key (``kt`` (B, G, D, Sk),
    ``vf`` (B, G, Sk, D), f32). The products are batched over (B, G) with
    the group's queries (rep x n) as rows."""
    b, n, h, dh = q.shape
    g, sk = kt.shape[1], kt.shape[3]
    rep = h // g
    qf = L._f32(q).reshape(b, n, g, rep, dh).permute(0, 2, 3, 1, 4)
    scores = (qf.reshape(b, g, rep * n, dh) @ kt).reshape(
        b, g, rep, n, sk) * _inv_sqrt(dh)
    if causal:
        mask = rows[:, None] >= torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    if kv_valid is not None:                      # decode: mask empty slots
        kvm = (kv_valid[:, None, None, None, :] if kv_valid.dim() == 2
               else kv_valid)
        scores = torch.where(kvm, scores, NEG_INF)
    probs = _softmax(scores).reshape(b, g, rep * n, sk)
    out = (probs @ vf).reshape(b, g, rep, n, dh).permute(0, 3, 1, 2, 4)
    return out.reshape(b, n, h, dh).to(q.dtype)


def gqa_split(cfg: ModelConfig, m: int) -> bool:
    """Whether ``m`` ranks split GQA by heads: each rank's ``n_heads / m``
    query heads fill whole KV groups or lie in one."""
    h, rep = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    return h % m == 0 and ((h // m) % rep == 0 or rep % (h // m) == 0)


def _cols(w: torch.Tensor, lo: int, n: int, width: int) -> torch.Tensor:
    """Columns ``lo * width .. (lo + n) * width`` of ``w``."""
    return w[..., lo * width:(lo + n) * width]


def _rows(w: torch.Tensor, lo: int, n: int, width: int) -> torch.Tensor:
    return w[lo * width:(lo + n) * width]


def _cut(p: Dict[str, torch.Tensor], blocks: frozenset, **cuts
         ) -> Dict[str, torch.Tensor]:
    """``p``'s leaves, each whole one (not in ``blocks``) through its cut
    in ``cuts`` (none: kept whole); the leaves in ``blocks`` are already
    the rank's."""
    return {k: v if k in blocks or k not in cuts else cuts[k](v)
            for k, v in p.items()}


def _rank_groups(cfg: ModelConfig, rank: int, m: int) -> Tuple[int, int]:
    """The first KV group and the group count of rank ``rank`` of ``m``'s
    query heads (:func:`gqa_split` must hold)."""
    hq = cfg.n_heads // m
    rep = cfg.n_heads // cfg.n_kv_heads
    return rank * hq // rep, max(hq // rep, 1)


def gqa_rank_params(p: Dict[str, torch.Tensor], cfg: ModelConfig, rank: int,
                    m: int, blocks: frozenset = frozenset()
                    ) -> Dict[str, torch.Tensor]:
    """Rank ``rank`` of ``m``'s GQA weights (:func:`gqa_split` must
    hold): its query heads' columns of ``wq`` and rows of ``wo``, its
    groups' columns of ``wk`` and ``wv``. The leaves named in ``blocks``
    are already the rank's blocks."""
    hd = cfg.resolved_head_dim
    hq = cfg.n_heads // m
    q0 = rank * hq
    g0, gn = _rank_groups(cfg, rank, m)
    return _cut(p, blocks, wq=lambda w: _cols(w, q0, hq, hd),
                wk=lambda w: _cols(w, g0, gn, hd),
                wv=lambda w: _cols(w, g0, gn, hd),
                wo=lambda w: _rows(w, q0, hq, hd))


def gqa_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              *, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None,
              kv_input: Optional[torch.Tensor] = None, tp=None,
              kv_groups: Optional[Tuple[int, int]] = None,
              donate: bool = False
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B,S,D). kv_input: encoder output for cross-attention (no rope).

    With ``cache``: writes this call's K/V at cache.pos and attends over
    the whole cache (decode). Returns (out, new_cache | None); ``donate``:
    the new cache is ``cache``'s tensors, written in place.
    ``kv_groups``: (first, count) of the cache's KV groups the queries
    attend to (default all of them).

    ``tp``: ``wq``/``wo`` are this rank's query heads, ``wk``/``wv`` its
    KV heads where ``tp.blocks`` names them, else whole (then its groups'
    columns are taken); ``x`` enters through ``tp.enter``, ``kv_input``
    whole, and the output leaves through ``tp.leave``. With ``cache``
    (decode on a mesh) the cache holds the rank's KV heads where
    ``tp.blocks`` names ``wk``, else every KV head: then every head's
    K/V is computed and written, the same on every rank, and the rank's
    queries read their groups."""
    if tp is not None:
        leaves = tp.leaves(p)
        pr = gqa_rank_params(leaves, cfg, tp.rank, tp.size, tp.blocks)
        if cache is not None and "wk" not in tp.blocks:
            pr = {**pr, "wk": leaves["wk"], "wv": leaves["wv"]}
            kv_groups = _rank_groups(cfg, tp.rank, tp.size)
        out, new_cache = gqa_apply(pr, tp.enter(x), cfg, causal=causal,
                                   positions=positions, cache=cache,
                                   kv_input=None if kv_input is None
                                   else tp.whole(kv_input),
                                   kv_groups=kv_groups, donate=donate)
        return tp.leave(out), new_cache
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if positions is None:
        positions = _positions(cache, s, x.device)
    q = (x @ p["wq"]).reshape(b, s, p["wq"].shape[1] // hd, hd)
    src = x if kv_input is None else kv_input
    n_kv = p["wk"].shape[1] // hd
    k = (src @ p["wk"]).reshape(b, src.shape[1], n_kv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], n_kv, hd)
    if kv_input is None:                              # self-attn: rope
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        k_all = _cache_update(cache.k, k, cache.pos, donate)
        v_all = _cache_update(cache.v, v, cache.pos, donate)
        kv_valid = _cache_valid(cache.pos, s, k_all.shape[1])
        new_cache = KVCache(k_all, v_all, _advance(cache.pos, s, donate))
        if kv_groups is not None:
            g0, gn = kv_groups
            k_all, v_all = k_all[:, :, g0:g0 + gn], v_all[:, :, g0:g0 + gn]
        out = _sdpa(q, k_all, v_all, causal=False, kv_valid=kv_valid)
    else:
        out = _sdpa(q, k, v, causal=causal and kv_input is None)
    return out.reshape(b, s, -1) @ p["wo"], new_cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


# =============================================================== MLA ======
def mla_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device: torch.device
             ) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": L.dense_init(generator, d, h * (m.d_nope + m.d_rope), dtype,
                           device),
        "w_dkv": L.dense_init(generator, d, m.kv_lora_rank, dtype, device),
        "w_ukv": L.dense_init(generator, m.kv_lora_rank,
                              h * (m.d_nope + m.d_v), dtype, device),
        "w_kr": L.dense_init(generator, d, m.d_rope, dtype, device),
        "wo": L.dense_init(generator, h * m.d_v, d, dtype, device),
    }


def mla_rank_params(p: Dict[str, torch.Tensor], cfg: ModelConfig, rank: int,
                    m: int, blocks: frozenset = frozenset()
                    ) -> Dict[str, torch.Tensor]:
    """Rank ``rank`` of ``m``'s MLA weights (``n_heads % m == 0``): its
    heads' columns of ``wq`` and ``w_ukv`` and rows of ``wo``;
    ``w_dkv`` and ``w_kr`` whole. The leaves named in ``blocks`` are
    already the rank's blocks."""
    c, h = cfg.mla, cfg.n_heads
    hl = h // m
    q0 = rank * hl
    return _cut(p, blocks,
                wq=lambda w: _cols(w, q0, hl, c.d_nope + c.d_rope),
                w_ukv=lambda w: _cols(w, q0, hl, c.d_nope + c.d_v),
                wo=lambda w: _rows(w, q0, hl, c.d_v))


def mla_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              *, positions: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None, tp=None, donate: bool = False
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Multi-head latent attention; the cache holds (c_kv, k_rope)
    (``donate``: written in place, as :func:`gqa_apply`'s).

    ``tp``: ``wq``, ``w_ukv`` and ``wo`` are this rank's heads (as
    ``tp.blocks`` names them), ``w_dkv`` and ``w_kr`` whole; ``x`` enters
    through ``tp.enter`` and the output leaves through ``tp.leave``. The
    latent cache (decode on a mesh) is whole on every rank: each writes
    the same latent and rotary key, and its heads expand them."""
    if tp is not None:
        pr = mla_rank_params(tp.leaves(p), cfg, tp.rank, tp.size,
                             tp.blocks)
        out, new_cache = mla_apply(pr, tp.enter(x), cfg, positions=positions,
                                   cache=cache, donate=donate)
        return tp.leave(out), new_cache
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = p["wq"].shape[1] // (m.d_nope + m.d_rope)
    if positions is None:
        positions = _positions(cache, s, x.device)

    q = (x @ p["wq"]).reshape(b, s, h, m.d_nope + m.d_rope)
    q_nope, q_rope = q[..., :m.d_nope], q[..., m.d_nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = x @ p["w_dkv"]                               # (B,S,R) latent
    k_rope = L.apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0]      # (B,S,d_rope)

    kv_valid = None
    new_cache = None
    if cache is not None:
        c_all = _cache_update(cache.k, c_kv, cache.pos, donate)
        r_all = _cache_update(cache.v, k_rope, cache.pos, donate)
        kv_valid = _cache_valid(cache.pos, s, c_all.shape[1])
        new_cache = KVCache(c_all, r_all, _advance(cache.pos, s, donate))
        c_kv, k_rope = c_all, r_all

    kv = (c_kv @ p["w_ukv"]).reshape(b, c_kv.shape[1], h, m.d_nope + m.d_v)
    k_nope, v = kv[..., :m.d_nope], kv[..., m.d_nope:]

    kv_mask = None
    if cache is not None:
        kv_mask = (kv_valid[:, None, None, :] if kv_valid.dim() == 2
                   else kv_valid)
    # (B, H, d_nope, Sk), (B, 1, d_rope, Sk), (B, H, Sk, d_v): every block
    # reads them
    knt = L._f32(k_nope).permute(0, 2, 3, 1).contiguous()
    krt = L._f32(k_rope).transpose(1, 2)[:, None].contiguous()
    vf = L._f32(v).permute(0, 2, 1, 3).contiguous()
    out = _by_query_blocks(
        lambda qn, qr, pos: _mla_block(qn, qr, pos, knt, krt, vf, kv_mask,
                                       m),
        (q_nope, q_rope, positions), 4 * b * h * c_kv.shape[1],
        (knt, krt, vf))
    # f32 scores and values, rounded to the model dtype before wo
    out = out.reshape(b, s, -1).to(x.dtype)
    return out @ p["wo"], new_cache


def _mla_block(q_nope: torch.Tensor, q_rope: torch.Tensor,
               positions: torch.Tensor, knt: torch.Tensor, krt: torch.Tensor,
               vf: torch.Tensor, kv_mask: Optional[torch.Tensor],
               m: MLAConfig) -> torch.Tensor:
    """One block of queries of MLA's score pass (``positions`` theirs),
    against every key (f32: ``knt`` (B, H, d_nope, Sk), ``krt`` (B, 1,
    d_rope, Sk), ``vf`` (B, H, Sk, d_v)): causal by position without a
    cache, ``kv_mask`` with one. Returns (B, n, H, d_v) in f32."""
    scores = L._f32(q_nope).transpose(1, 2) @ knt
    scores = scores + L._f32(q_rope).transpose(1, 2) @ krt
    scores = scores * _inv_sqrt(m.d_nope + m.d_rope)
    sk = scores.shape[-1]
    if kv_mask is None:
        mask = positions[:, :, None] >= torch.arange(
            sk, device=scores.device)[None, None, :]
        scores = torch.where(mask[:, None], scores, NEG_INF)
    else:
        scores = torch.where(kv_mask, scores, NEG_INF)
    return (_softmax(scores) @ vf).transpose(1, 2)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device) -> KVCache:
    m = cfg.mla
    return KVCache(
        torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, m.d_rope), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))
