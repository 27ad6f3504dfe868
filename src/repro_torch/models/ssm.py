"""Mamba2 (SSD) block: projections + causal conv + chunked state scan.

The sequence mixer of the full-sequence branch is the SSD scan kernel
(:func:`repro_torch.kernels.ops.ssd_scan_mh`: the hand-written CUDA kernel
on CUDA tensors, its plain version on CPU tensors). The block follows the
Mamba2 layout with a single B/C group shared across heads:

    x,z,B,C,dt = in_proj(u)
    x = silu(causal_conv1d(x));  B,C conv'd likewise
    a_t = exp(-softplus(dt + dt_bias) * exp(A_log))        per head
    y = SSD(x * dt, log a, B, C);  y = rmsnorm(y * silu(z)); out_proj

Decode keeps (conv window, SSD state) as the cache and runs the exact
one-token recurrence, which launches no kernel. Casts follow the
reference: dt is cast to x's dtype before scaling x, log_decay stays f32,
B and C stay in the model dtype, the conv and the state run in f32.

Under tensor parallelism (``tp=``, :class:`repro_torch.models.layers.TP`;
the full sequence, or a cached decode on a mesh) a rank computes its
``H / m`` heads: the packed ``in_proj`` is whole (its
blocks at rest cross the x/z/B/C/dt boundaries) and the rank takes the x,
z and dt columns of its heads with B and C whole; ``conv_w``,
``dt_bias``, ``a_log`` and the norm scale are cut the same way (each
whole leaf's gradient summed over ``model``, :meth:`TP.whole`); the SSD
scan runs on the rank's ``(B * H / m, L, P)`` rows; the gated RMSNorm
over ``d_inner`` sums its squares over ``model``; ``out_proj`` is
row-parallel. The widths come from the weights, so the same code runs a
whole block and a rank's part (:func:`ssm_rank_params`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, K-1, d_conv_in) rolling conv window
    state: torch.Tensor   # (B, H, N, P) SSD state (f32)


def ssm_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device: torch.device
             ) -> Dict[str, torch.Tensor]:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    n = s.d_state
    d_in_proj = 2 * di + 2 * n + h          # x, z, B, C, dt
    return {
        "in_proj": L.dense_init(generator, d, d_in_proj, dtype, device),
        "conv_w": (L._normal(generator, (s.conv_kernel, di + 2 * n), device)
                   * 0.1).to(dtype),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": L.rmsnorm_init(di, device),
        "out_proj": L.dense_init(generator, di, d, dtype, device),
    }


def ssm_rank_params(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    rank: int, m: int, blocks: frozenset = frozenset()
                    ) -> Dict[str, torch.Tensor]:
    """Rank ``rank`` of ``m``'s Mamba2 weights (``m`` divides the heads):
    ``in_proj``'s x, z and dt columns of its heads with B and C whole,
    the same channels of ``conv_w``, its heads of ``dt_bias`` and
    ``a_log``, its channels of the norm scale and its rows of
    ``out_proj`` (as it is where ``blocks`` names it: already the
    rank's)."""
    s = cfg.ssm
    di, n = s.d_inner(cfg.d_model), s.d_state
    hl = s.n_heads(cfg.d_model) // m
    c0, c1 = rank * hl * s.head_dim, (rank + 1) * hl * s.head_dim
    out = p["out_proj"]
    return {
        "in_proj": _rank_columns(p["in_proj"], cfg, rank, m),
        "conv_w": _rank_columns(p["conv_w"], cfg, rank, m, conv=True),
        "dt_bias": p["dt_bias"][rank * hl:(rank + 1) * hl],
        "a_log": p["a_log"][rank * hl:(rank + 1) * hl],
        "norm": p["norm"][c0:c1],
        "out_proj": out if "out_proj" in blocks else out[c0:c1],
    }


def _rank_columns(t: torch.Tensor, cfg: ModelConfig, rank: int, m: int, *,
                  conv: bool = False) -> torch.Tensor:
    """Rank ``rank`` of ``m``'s columns of the last dim of ``t``, laid out
    as ``in_proj``'s output (x, z, B, C, dt), or with ``conv`` as the conv
    channels (x, B, C): the x, z and dt columns of its heads, B and C
    whole."""
    s = cfg.ssm
    di, n = s.d_inner(cfg.d_model), s.d_state
    hl = s.n_heads(cfg.d_model) // m
    c0, c1 = rank * hl * s.head_dim, (rank + 1) * hl * s.head_dim
    if conv:
        return torch.cat([t[..., c0:c1], t[..., di:di + 2 * n]], -1)
    h0 = 2 * di + 2 * n + rank * hl
    return torch.cat([t[..., c0:c1], t[..., di + c0:di + c1],
                      t[..., 2 * di:2 * di + 2 * n], t[..., h0:h0 + hl]], -1)


def _split(cfg: ModelConfig, proj: torch.Tensor, di: int):
    n = cfg.ssm.d_state
    x = proj[..., :di]
    z = proj[..., di:2 * di]
    b = proj[..., 2 * di:2 * di + n]
    c = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return x, z, b, c, dt


def _causal_conv(seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """seq (B, L, C), w (K, C) depthwise causal conv: the explicit shifted
    sum in f32, taps in the reference's order (a float32 ``conv1d`` on CUDA
    would go through cuDNN in TF32)."""
    k = w.shape[0]
    ln = seq.shape[1]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = torch.zeros(seq.shape, device=seq.device,
                      dtype=torch.promote_types(seq.dtype, torch.float32))
    for i in range(k):
        out = out + L._f32(pad[:, i:i + ln]) * L._f32(w[i])
    return out.to(seq.dtype)


def ssm_apply(p: Dict[str, torch.Tensor], u: torch.Tensor, cfg: ModelConfig,
              *, cache: Optional[SSMCache] = None, tp=None,
              donate: bool = False
              ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """u (B, L, D). With cache: L must be 1 (single-token decode).
    ``donate``: the new conv window and state are written into ``cache``'s
    tensors once both are computed, and ``cache`` is returned.

    ``tp``: ``out_proj`` is this rank's rows (``tp.blocks``), the other
    leaves whole (see the module docstring); ``u`` enters through
    ``tp.enter`` and the output leaves through ``tp.leave``. With
    ``cache`` (decode on a mesh) the state is the rank's heads and the
    conv window holds every channel: the whole projection shifts every
    channel into the window, the same on every rank, and the rank
    convolves and scans its own."""
    if tp is None:
        y, new_cache = ssm_gated(p, u, cfg, cache=cache)
        sumsq = torch.sum(y * y, dim=-1, keepdim=True)
        return ssm_project(p, y, sumsq, cfg, u.dtype), _written(
            cache, new_cache, donate)
    leaves = tp.leaves(p)
    pr = ssm_rank_params(leaves, cfg, tp.rank, tp.size, tp.blocks)
    u = tp.enter(u)
    if cache is None:
        y, new_cache = ssm_gated(pr, u, cfg)
    else:
        proj = u @ leaves["in_proj"]
        di = cfg.ssm.d_inner(cfg.d_model)
        x, _, b, c, _ = _split(cfg, proj, di)
        window = torch.cat([cache.conv, torch.cat([x, b, c], -1)], 1)
        y, rank_cache = ssm_gated(
            pr, u, cfg, proj=_rank_columns(proj, cfg, tp.rank, tp.size),
            cache=SSMCache(_rank_columns(cache.conv, cfg, tp.rank, tp.size,
                                         conv=True), cache.state))
        new_cache = SSMCache(window[:, 1:], rank_cache.state)
    # every rank normalises its own channels by the sum: the gradient of
    # the sum is summed over the ranks too
    sumsq = tp.whole(tp.total(torch.sum(y * y, dim=-1, keepdim=True)))
    return tp.leave(ssm_project(pr, y, sumsq, cfg, u.dtype)), _written(
        cache, new_cache, donate)


def _written(cache: Optional[SSMCache], new: Optional[SSMCache],
             donate: bool) -> Optional[SSMCache]:
    """``new``, or under ``donate`` ``cache`` with ``new`` copied in."""
    if not donate or cache is None:
        return new
    for old, t in zip(cache, new):
        old.copy_(t)
    return cache


def ssm_project(p: Dict[str, torch.Tensor], y: torch.Tensor,
                sumsq: torch.Tensor, cfg: ModelConfig, dtype: torch.dtype
                ) -> torch.Tensor:
    """The gated RMSNorm and the out projection of the channels ``y``
    (:func:`ssm_gated`; all, or a rank's), ``sumsq`` the squares of all
    ``d_inner`` channels summed (over the ranks): the output (a rank's
    partial output)."""
    var = sumsq / cfg.ssm.d_inner(cfg.d_model)
    y = (y * torch.rsqrt(var + cfg.norm_eps) * p["norm"]).to(dtype)
    return y @ p["out_proj"]


def ssm_gated(p: Dict[str, torch.Tensor], u: torch.Tensor, cfg: ModelConfig,
              *, cache: Optional[SSMCache] = None,
              proj: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """The block up to its norm: ``y * silu(z)`` in f32 over the heads
    the weights hold (all, or a rank's), and the new cache. ``proj``:
    ``u @ p["in_proj"]``, where the caller has it."""
    s = cfg.ssm
    n, pdim = s.d_state, s.head_dim
    di, h = p["out_proj"].shape[0], p["dt_bias"].shape[0]
    bsz, ln, _ = u.shape
    if proj is None:
        proj = u @ p["in_proj"]
    x, z, b, c, dt = _split(cfg, proj, di)
    conv_in = torch.cat([x, b, c], dim=-1)              # (B, L, di+2n)

    new_cache = None
    if cache is None:
        conv_out = _causal_conv(conv_in, p["conv_w"])
    else:
        if ln != 1:
            raise ValueError(f"decode with a cache takes one token, got {ln}")
        window = torch.cat([cache.conv, conv_in], dim=1)  # (B, K, C)
        conv_out = torch.einsum("bkc,kc->bc", window.float(),
                                p["conv_w"].float())[:, None]
        conv_out = conv_out.to(u.dtype)
        new_conv = window[:, 1:]
    conv_out = L.silu(conv_out)
    x = conv_out[..., :di]
    b = conv_out[..., di:di + n]
    c = conv_out[..., di + n:]

    dt = torch.logaddexp(L._f32(dt) + p["dt_bias"], torch.zeros((), device=u.device))  # softplus, (B,L,H)
    log_decay = -dt * torch.exp(p["a_log"])                     # (B,L,H)
    xh = x.reshape(bsz, ln, h, pdim)
    uin = xh * dt[..., None].to(x.dtype)                        # dt-scaled

    if cache is None:
        # heads fold into the kernel's rows; B/C shared across heads
        u_k = uin.permute(0, 2, 1, 3)                          # (B,H,L,P)
        ld_k = log_decay.permute(0, 2, 1)                      # (B,H,L)
        y = ops.ssd_scan_mh(u_k, ld_k, b, c, chunk=s.chunk)
        y = y.permute(0, 2, 1, 3)
    else:
        # exact single-step recurrence against the cached state
        a = torch.exp(log_decay[:, 0])                          # (B,H)
        st = cache.state * a[..., None, None] \
            + b[:, 0, None, :, None].float() \
            * uin[:, 0, :, None, :].float()                     # (B,H,N,P)
        y = torch.einsum("bn,bhnp->bhp", c[:, 0].float(), st)
        y = y[:, None].reshape(bsz, 1, h, pdim).to(u.dtype)
        new_cache = SSMCache(conv=new_conv, state=st)

    # the gate product goes to the norm unrounded, in f32: the reference's
    # compiled block (XLA) drops the bf16 rounding between the two
    return L._f32(y.reshape(bsz, ln, di)) * L._f32(L.silu(z)), new_cache


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> SSMCache:
    s = cfg.ssm
    d = cfg.d_model
    di, n, h = s.d_inner(d), s.d_state, s.n_heads(d)
    return SSMCache(
        conv=torch.zeros((batch, s.conv_kernel - 1, di + 2 * n), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, h, n, s.head_dim), dtype=torch.float32,
                          device=device),
    )
