"""MoE router gate: a hand-written CUDA kernel and its plain PyTorch version.

For each token row of router logits x (E experts), in float32:

    m     = max(x);  denom = sum(exp(x - m))          over all experts
    k rounds of max-extract: the largest remaining logit, ties to the
    lowest expert id; each pick is masked to -1e30
    probs = exp(top - m) / denom;  renorm: probs / sum(probs)

The kernel (``csrc/moe_gate.cu``, built for ``sm_90a`` at first use by
:mod:`repro_torch.kernels.build`) runs one warp per row with the row's
logits in registers; it takes E up to :data:`MAX_EXPERTS`. The plain
version (:func:`moe_gate_topk_plain`) repeats the reference body's steps
with ``torch.argmax``, which returns the first maximum; ``torch.topk``
would not do, as its order among equal values is not specified.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel on the current stream or raises: it never falls back.
Each launch adds one to ``LAUNCHES["moe_gate_topk"]``.

Gradients: on CPU tensors autograd runs through the plain version. On
CUDA tensors :func:`moe_gate_topk` is an autograd function whose forward
is the kernel and whose backward (:func:`moe_gate_vjp`, plain PyTorch)
gives the gradient of the probabilities with respect to the logits at the
chosen ids, from the saved logits, probabilities and ids: the gradient of
the reference's differentiable gate (``kernels/ref.py`` ``moe_gate_topk``,
which its model calls). No gradient flows to the ids.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

#: the reference's mask value for picked experts
NEG = -1e30
#: the kernel holds at most this many experts per row (8 logits per lane of
#: one warp); larger E raises on CUDA (ROADMAP, Queue 3)
MAX_EXPERTS = 256

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"moe_gate_topk": 0}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    """Set the launch count to 0."""
    LAUNCHES["moe_gate_topk"] = 0


def _library() -> ctypes.CDLL:
    """Build/load ``csrc/moe_gate.cu`` and declare its C interface."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("moe_gate")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.moe_gate_launch.argtypes = [p, p, p, ll, i, i, i, p]
            lib.moe_gate_launch.restype = ctypes.c_int
            lib.moe_gate_error_string.argtypes = [ctypes.c_int]
            lib.moe_gate_error_string.restype = ctypes.c_char_p
            lib.moe_gate_max_experts.restype = ctypes.c_int
            if lib.moe_gate_max_experts() != MAX_EXPERTS:
                raise RuntimeError("csrc/moe_gate.cu and MAX_EXPERTS "
                                   "disagree")
            _lib = lib
        return _lib


def moe_gate_topk_plain(logits: torch.Tensor, k: int, renorm: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference body's steps in float32 (float64
    when given float64)."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    m = torch.amax(x, dim=-1, keepdim=True)
    denom = torch.sum(torch.exp(x - m), dim=-1, keepdim=True)
    work = x
    vals, idxs = [], []
    for _ in range(k):
        arg = torch.argmax(work, dim=-1, keepdim=True)
        vals.append(torch.gather(work, -1, arg))
        idxs.append(arg)
        # out of place: the gather above keeps ``work`` for its backward
        work = work.scatter(-1, arg, NEG)
    tv = torch.cat(vals, dim=-1)
    probs = torch.exp(tv - m) / denom
    if renorm:
        probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return probs, torch.cat(idxs, dim=-1).to(torch.int32)


def _check(logits: torch.Tensor, k: int) -> None:
    """Shapes and options, whatever the device."""
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    e = logits.shape[1]
    if not 1 <= k <= e:
        raise ValueError(f"k must lie in [1, E={e}], got {k}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no MoE gate for device {logits.device}")


def _moe_gate(logits: torch.Tensor, k: int, renorm: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate of ``logits`` (T, E): (probs (T, k) float32, ids (T, k)
    int32)."""
    _check(logits, k)
    if logits.device.type == "cpu":
        return moe_gate_topk_plain(logits, k, renorm)
    t, e = logits.shape
    if logits.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 logits, got "
                         f"{logits.dtype}")
    if e > MAX_EXPERTS:
        raise ValueError(f"E={e} experts: the CUDA kernel holds at most "
                         f"{MAX_EXPERTS}")
    if not logits.is_contiguous():
        raise ValueError("the kernel takes contiguous logits")
    dev = logits.device
    probs = torch.empty((t, k), dtype=torch.float32, device=dev)
    ids = torch.empty((t, k), dtype=torch.int32, device=dev)
    if t == 0:
        return probs, ids
    with torch.cuda.device(dev):
        lib = _library()
        code = lib.moe_gate_launch(
            ctypes.c_void_p(logits.data_ptr()),
            ctypes.c_void_p(probs.data_ptr()),
            ctypes.c_void_p(ids.data_ptr()), t, e, k, int(renorm),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if code != 0:
        msg = lib.moe_gate_error_string(code).decode()
        raise RuntimeError(f"moe_gate launch failed: {msg} "
                           f"(cuda error {code})")
    LAUNCHES["moe_gate_topk"] += 1
    return probs, ids


def moe_gate_vjp(logits: torch.Tensor, probs: torch.Tensor,
                 ids: torch.Tensor, grad_probs: torch.Tensor,
                 renorm: bool) -> torch.Tensor:
    """The gradient with respect to ``logits`` (T, E) of the gate's
    probabilities ``probs`` (T, k) at ``ids`` (T, k), given the gradient
    ``grad_probs`` of the probabilities, in float32 (float64 for float64
    logits). With ``renorm`` the probabilities are the softmax of the
    chosen logits, so only those get a gradient, p (g - sum(p g)); without
    it they are the full softmax s at the chosen ids, and every logit gets
    scatter(p g) - s sum(p g)."""
    f = torch.promote_types(logits.dtype, torch.float32)
    p, g = probs.to(f), grad_probs.to(f)
    pg = p * g
    dot = torch.sum(pg, dim=-1, keepdim=True)
    idx = ids.to(torch.int64)
    if renorm:
        base = torch.zeros(logits.shape, dtype=f, device=logits.device)
        return base.scatter_add(-1, idx, pg - p * dot)
    x = logits.to(f)
    z = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    s = z / torch.sum(z, dim=-1, keepdim=True)
    return (-s * dot).scatter_add(-1, idx, pg)


class _MoEGate(torch.autograd.Function):
    """The kernel's forward (:func:`_moe_gate`) with
    :func:`moe_gate_vjp` as its backward."""

    @staticmethod
    def forward(ctx, logits, k, renorm):
        probs, ids = _moe_gate(logits, k, renorm)
        ctx.renorm = renorm
        ctx.mark_non_differentiable(ids)
        ctx.save_for_backward(logits, probs, ids)
        return probs, ids

    @staticmethod
    def backward(ctx, grad_probs, grad_ids):
        del grad_ids
        logits, probs, ids = ctx.saved_tensors
        grad = moe_gate_vjp(logits, probs, ids, grad_probs, ctx.renorm)
        return grad.to(logits.dtype), None, None


def moe_gate_topk(logits: torch.Tensor, k: int, renorm: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused router, differentiable with respect to ``logits``.

    Args:
      logits: (T, E) router scores (float32 on CUDA).
      k: experts per token, 1 <= k <= E.
      renorm: renormalise the selected probabilities to sum to 1
        (deepseek-style) instead of keeping full-softmax mass.

    Returns:
      (probs (T, k) float32, ids (T, k) int32), in descending-probability
      order (ties to the lowest expert id first).
    """
    if logits.device.type == "cpu":
        return _moe_gate(logits, k, renorm)
    return _MoEGate.apply(logits, k, renorm)
