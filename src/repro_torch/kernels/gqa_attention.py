"""Causal or bidirectional GQA self-attention's forward: a hand-written
CUDA kernel for Hopper and its plain PyTorch version.

For q (B, Sq, H, D) and k, v (B, Sk, G, D), H = G * rep (query head
g * rep + j reads KV group g), per query i and head:

    s_j = (q_i . k_j) * scale,  p_j = exp(s_j - max s) over the allowed j,
    out_i = sum_j p_j v_j / sum_j p_j

where key j is allowed when j < Sk and, causal, j <= i; the others count
as ``-inf`` and contribute exactly 0.

The kernel (``csrc/gqa_attention.cu``, built for ``sm_90a`` at first use
by :mod:`repro_torch.kernels.build`) takes bf16 q, k and v read in place
through their strides where its tensor maps can (the last one 1, the
others positive multiples of 8 elements, the start 16-byte aligned),
head dims :data:`HEAD_DIMS` and up to :data:`MAX_REP` query heads a
group. Its scores are bf16 products summed in f32 on the tensor
cores, times the f32 ``scale``; its softmax is f32 and online (a running
max and sum); P enters P V as a bf16 pair hi + lo, so nothing is rounded
below f32 before the output, which is rounded to its type once. Causal:
key tiles wholly above a block's last query are skipped. The source's
note has the design.

The plain version (:func:`gqa_attention_plain`) scores every key at once
in float32 (float64 when given float64). The model's own plain path, the
one the port's CPU runs and the kernel's forward replaces, is
``repro_torch.models.attention._sdpa``'s blocked form.

The wrapper reaches both through the operator ``repro::gqa_attention``
(a :class:`torch.library.Library` definition): given CPU tensors it runs the plain
version; given CUDA tensors it launches the kernel on the current stream
(operands whose layout its tensor maps cannot read are first copied to a
contiguous layout) or raises: it never falls back. On fake tensors
(``FakeTensorMode``: the dry run) the operator allocates only its output,
as the kernel does, and ``FlopCounterMode`` counts it at
:func:`model_flops`. Each launch adds one to ``LAUNCHES["gqa_attention"]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

#: the head dims the kernel is built for: the registry's configs' (64, 80,
#: 96, 128) and the smoke configs' 16
HEAD_DIMS = (16, 64, 80, 96, 128)
#: the most query heads a KV group may have (a block holds 128 rows of
#: queries x heads, at least one query)
MAX_REP = 128

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"gqa_attention": 0}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    """Set the launch count to 0."""
    LAUNCHES["gqa_attention"] = 0


def _library() -> ctypes.CDLL:
    """Build/load ``csrc/gqa_attention.cu`` and declare its C interface."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("gqa_attention")
            p, i = ctypes.c_void_p, ctypes.c_int
            lp = ctypes.POINTER(ctypes.c_longlong)
            lib.gqa_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                                 i, lp, lp, lp, lp, i,
                                                 ctypes.c_float, i, p]
            lib.gqa_attention_launch.restype = ctypes.c_int
            lib.gqa_attention_error_string.argtypes = [ctypes.c_int]
            lib.gqa_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def gqa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float) -> torch.Tensor:
    """The plain version: every key scored at once, in float32 (float64
    when given float64); returns (B, Sq, H, D) in that type."""
    f = torch.promote_types(q.dtype, torch.float32)
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    qf = q.to(f).reshape(b, sq, g, h // g, d)
    scores = torch.einsum("bigrd,bjgd->bgrij", qf, k.to(f)) * scale
    if causal:
        allowed = (torch.arange(sq, device=q.device)[:, None]
                   >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(allowed, scores, float("-inf"))
    z = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    probs = z / torch.sum(z, dim=-1, keepdim=True)
    out = torch.einsum("bgrij,bjgd->bigrd", probs, v.to(f))
    return out.reshape(b, sq, h, d)


def _layout_ok(t: torch.Tensor) -> bool:
    """What the kernel's tensor maps read: the last stride 1, the others
    positive multiples of 16 bytes, the start 16-byte aligned."""
    return (t.stride(-1) == 1 and all(s > 0 and s % 8 == 0
                                      for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where its layout is not one the
    kernel's tensor maps read."""
    return t if _layout_ok(t) else t.clone(
        memory_format=torch.contiguous_format)


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel takes these operands: bf16 q (B, Sq, H, D), k and
    v (B, Sk, G, D) on one device, D in :data:`HEAD_DIMS`, G dividing H in
    groups of at most :data:`MAX_REP`, Sk >= 1."""
    if not (q.dim() == 4 and k.dim() == 4 and k.shape == v.shape):
        return False
    b, _, h, d = q.shape
    if (k.shape[0] != b or k.shape[3] != d or d not in HEAD_DIMS
            or k.shape[1] < 1 or k.shape[2] < 1 or h % k.shape[2]
            or h // k.shape[2] > MAX_REP):
        return False
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        return False
    return len({t.device for t in (q, k, v)}) == 1


def model_flops(b: int, sq: int, sk: int, h: int, d: int,
                causal: bool) -> int:
    """Q K^T and P V over the allowed (query, key) pairs: 4 B H D a pair;
    causal, query i sees keys 0..i."""
    if not causal:
        pairs = sq * sk
    elif sq <= sk:
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sk * (sk + 1) // 2 + (sq - sk) * sk
    return 4 * b * h * d * pairs


def _out_dtype(out_f32: bool) -> torch.dtype:
    return torch.float32 if out_f32 else torch.bfloat16


def _op_cpu(q, k, v, causal, scale, out_f32):
    return gqa_attention_plain(q, k, v, causal, scale).to(_out_dtype(out_f32))


def _op_cuda(q, k, v, causal, scale, out_f32):
    return _launch(q, k, v, causal, scale, _out_dtype(out_f32))


def _op_meta(q, k, v, causal, scale, out_f32):
    return q.new_empty(q.shape, dtype=_out_dtype(out_f32))


#: the operator ``repro::gqa_attention``: the plain version on the CPU,
#: the kernel on CUDA, the output alone on meta and fake tensors
_LIB = torch.library.Library("repro", "DEF")
_LIB.define("gqa_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale, bool out_f32) -> Tensor")
for _impl, _key in ((_op_cpu, "CPU"), (_op_cuda, "CUDA"), (_op_meta, "Meta")):
    _LIB.impl("gqa_attention", _impl, _key)


@register_flop_formula(torch.ops.repro.gqa_attention)
def _op_flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    b, sq, h, d = q_shape
    return model_flops(b, sq, k_shape[1], h, d, causal)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k, v (B, Sk, G, D), scores times
    the float32 ``scale``; returns (B, Sq, H, D) in ``out_dtype`` (bfloat16
    or float32). CPU tensors run :func:`gqa_attention_plain`; CUDA tensors
    launch the kernel; ``ValueError`` for operands it does not take
    (:func:`supported`)."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    if not supported(q, k, v):
        raise ValueError(
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}: the kernel takes bf16 (B, Sq, H, "
            f"D) and (B, Sk, G, D) with D in {HEAD_DIMS} and H / G <= "
            f"{MAX_REP}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no GQA attention kernel for device {q.device}")
    return torch.ops.repro.gqa_attention(q, k, v, causal, float(scale),
                                         out_dtype == torch.float32)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of the kernel on the current stream."""
    q, k, v = map(_readable, (q, k, v))
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out

    def strides(t):
        return (ctypes.c_longlong * 4)(*t.stride())
    dev = q.device
    with torch.cuda.device(dev):
        lib = _library()
        code = lib.gqa_attention_launch(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, sq, sk, h, g, d, strides(q), strides(k), strides(v),
            strides(out), int(causal), scale,
            int(out_dtype == torch.float32),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if code != 0:
        msg = lib.gqa_attention_error_string(code).decode()
        raise RuntimeError(f"gqa_attention launch failed: {msg} "
                           f"(code {code})")
    LAUNCHES["gqa_attention"] += 1
    return out
