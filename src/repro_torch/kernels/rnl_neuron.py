"""Fused SRM0-RNL neuron bank: hand-written CUDA kernels and their plain
PyTorch versions.

Fuses the neuron pipeline — RNL response generation (Eq. 1), dendrite
accumulation (full PC or Catwalk top-k-clipped), soma threshold and
fire-time detection — into one tick sweep per (volley, neuron) pair. The
kernels live in ``csrc/rnl_neuron.cu`` (one source, built for ``sm_90a`` at
first use by :mod:`repro_torch.kernels.build`); beside each wrapper sits a
plain PyTorch version of the same function.

Three entry points, with the reference's signatures:

  * :func:`rnl_fire_times` — one neuron bank, ``(B, n) x (Q, n) -> (B, Q)``;
    the ``backend="fused"`` engine of a 2-D
    :func:`repro_torch.core.neuron.fire_times_bank`.
  * :func:`rnl_fire_times_layer` — C independent columns in one launch,
    ``(C, B, n) x (C, Q, n) -> (C, B, Q)``; serves every
    :class:`repro_torch.core.layer.TNNLayer`.
  * :func:`rnl_fire_times_compact` — the spike-compacted path
    (``backend="fused_compact"``): ``(B, s) x (B, Q, s) -> (B, Q)`` over
    volleys whose active lines were relocated to a dense prefix, with
    weights gathered per volley.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel on the current stream or raises — it never falls back.
Each launch adds one to :data:`LAUNCHES` under the wrapper's name.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.core.coding import NO_SPIKE
from repro_torch.kernels import build

#: kernel launches per wrapper name since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rnl_fire_times": 0, "rnl_fire_times_layer": 0,
                            "rnl_fire_times_compact": 0}

_INT32_MAX = 2**31 - 1
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    """Build/load ``csrc/rnl_neuron.cu`` and declare its C interface."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("rnl_neuron")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rnl_fire_times_layer_launch.argtypes = (
                [p, p, p, p] + [i] * 8 + [p])
            lib.rnl_fire_times_launch.argtypes = [p, p, p, p] + [i] * 7 + [p]
            lib.rnl_fire_times_compact_launch.argtypes = (
                [p, p, p] + [i] * 7 + [p])
            for fn in (lib.rnl_fire_times_layer_launch,
                       lib.rnl_fire_times_launch,
                       lib.rnl_fire_times_compact_launch):
                fn.restype = ctypes.c_int
            lib.rnl_error_string.argtypes = [ctypes.c_int]
            lib.rnl_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# ------------------------------------------------------------ plain versions

def _sweep_bound(times: torch.Tensor, w: torch.Tensor, t_steps: int,
                 threshold: int) -> int:
    """First tick past the last possible ramp bit, clamped to
    ``[0, t_steps]``: ``min(T, max(times + w))`` over the lines with
    ``times < T`` (0 elsewhere), floored at 1 when ``threshold <= 0`` —
    a zero potential already meets such a threshold, so tick 0 must run.
    ``times`` is (..., B, 1, n); ``w`` broadcasts against it."""
    t_l = times.to(torch.int64)
    contrib = torch.where(t_l < t_steps, t_l + w.to(torch.int64), 0)
    t_hi = min(t_steps, int(contrib.max())) if contrib.numel() else 0
    floor = min(1, t_steps) if threshold <= 0 else 0
    return max(t_hi, floor)


def _tick_sweep(times: torch.Tensor, w: torch.Tensor, *, t_steps: int,
                threshold: int, k: Optional[int]):
    """Shared tick loop. ``times`` (..., B, n); ``w`` (..., Q, n), or
    (..., B, Q, n) per volley. Returns int32 ``(fire, clip)`` (..., B, Q).

    Stops at the launch's last breakpoint tick (ticks past it carry no ramp
    bits, so stopping there is exact)."""
    tt = times[..., :, None, :]
    ww = w if w.dim() == times.dim() + 1 else w[..., None, :, :]
    t_hi = _sweep_bound(tt, ww, t_steps, threshold)
    shape = torch.broadcast_shapes(tt.shape, ww.shape)[:-1]
    pot = torch.zeros(shape, dtype=torch.int32, device=times.device)
    fired = torch.full(shape, NO_SPIKE, dtype=torch.int32, device=times.device)
    clip = torch.zeros(shape, dtype=torch.int32, device=times.device)
    for t in range(t_hi):
        rel = t - tt
        raw = ((rel >= 0) & (rel < ww)).sum(dim=-1, dtype=torch.int32)
        if k is not None:
            inc = torch.clamp(raw, max=k)
            clip += (raw > k).to(torch.int32)
        else:
            inc = raw
        pot += inc
        newly = (pot >= threshold) & (fired == NO_SPIKE)
        fired = torch.where(newly, t, fired)
    return fired, clip


def rnl_fire_times_plain(times, weights, *, t_steps, threshold, k=None,
                         with_clip=False):
    """Plain PyTorch version of :func:`rnl_fire_times`; with a leading
    column axis on both operands, of :func:`rnl_fire_times_layer`."""
    fire, clip = _tick_sweep(times, weights, t_steps=t_steps,
                             threshold=threshold, k=k)
    return (fire, clip) if with_clip else fire


rnl_fire_times_layer_plain = rnl_fire_times_plain


def rnl_fire_times_compact_plain(times, weights, *, t_steps, threshold,
                                 k=None):
    """Plain PyTorch version of :func:`rnl_fire_times_compact`."""
    fire, _ = _tick_sweep(times, weights, t_steps=t_steps,
                          threshold=threshold, k=k)
    return fire


# ------------------------------------------------------------------ wrappers

def _check(times: torch.Tensor, weights: torch.Tensor, t_steps: int,
           threshold: int, k: Optional[int]) -> str:
    """Validate operands; returns the device type they share."""
    for name, x in (("times", times), ("weights", weights)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if times.device != weights.device:
        raise ValueError(f"times on {times.device}, weights on "
                         f"{weights.device}")
    for name, v in (("t_steps", t_steps), ("threshold", threshold)):
        if not -_INT32_MAX <= int(v) <= _INT32_MAX:
            raise ValueError(f"{name}={v} does not fit int32")
    if k is not None and not 0 <= int(k) <= _INT32_MAX:
        raise ValueError(f"k={k}: expected None or a non-negative int32")
    kind = times.device.type
    if kind == "cuda":
        if not (times.is_contiguous() and weights.is_contiguous()):
            raise ValueError("CUDA kernels take contiguous times/weights")
    elif kind != "cpu":
        raise ValueError(f"no RNL kernel for device {times.device}")
    return kind


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _library().rnl_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cuda error {code})")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def rnl_fire_times(times: torch.Tensor, weights: torch.Tensor, *,
                   t_steps: int, threshold: int, k: Optional[int] = None,
                   with_clip: bool = False):
    """Fire times of a neuron bank.

    Args:
      times:   (B, n) int32 input spike times (NO_SPIKE = silent line).
      weights: (Q, n) int32 synaptic weights (one row per neuron).
      t_steps: gamma-cycle length.
      threshold: firing threshold.
      k: None -> full-PC dendrite; int -> Catwalk top-k clipped dendrite.
      with_clip: also return per-(volley, neuron) clip-event counts.

    Returns:
      (B, Q) int32 fire times (NO_SPIKE where the neuron stays silent);
      with ``with_clip`` a ``(fire, clip)`` tuple, clip (B, Q) int32 counts
      of ticks whose raw popcount exceeded k (all-zero when k is None).
    """
    if times.dim() != 2 or weights.dim() != 2 \
            or times.shape[1] != weights.shape[1]:
        raise ValueError(f"expected (B, n) x (Q, n), got {tuple(times.shape)}"
                         f" x {tuple(weights.shape)}")
    if _check(times, weights, t_steps, threshold, k) == "cpu":
        return rnl_fire_times_plain(times, weights, t_steps=t_steps,
                                    threshold=threshold, k=k,
                                    with_clip=with_clip)
    (bsz, n), qsz = times.shape, weights.shape[0]
    fire = torch.empty((bsz, qsz), dtype=torch.int32, device=times.device)
    clip = torch.empty_like(fire) if with_clip else None
    if fire.numel():
        with torch.cuda.device(times.device):
            code = _library().rnl_fire_times_launch(
                _ptr(times), _ptr(weights), _ptr(fire), _ptr(clip), bsz, qsz,
                n, t_steps, threshold, int(k is not None), k or 0,
                _stream(times.device))
        _raise_on(code, "rnl_fire_times")
        LAUNCHES["rnl_fire_times"] += 1
    return (fire, clip) if with_clip else fire


def rnl_fire_times_layer(times: torch.Tensor, weights: torch.Tensor, *,
                         t_steps: int, threshold: int,
                         k: Optional[int] = None, with_clip: bool = False):
    """Fire times of C independent neuron banks (a TNN layer of columns).

    One launch: column c pairs volley slice ``times[c]`` with weight bank
    ``weights[c]``.

    Args:
      times:   (C, B, n) int32 per-column input spike times.
      weights: (C, Q, n) int32 per-column synaptic weights.
      with_clip: also return clip-event counts.

    Returns:
      (C, B, Q) int32 fire times; with ``with_clip`` a ``(fire, clip)``
      tuple of that shape.
    """
    if times.dim() != 3 or weights.dim() != 3 \
            or times.shape[0] != weights.shape[0] \
            or times.shape[2] != weights.shape[2]:
        raise ValueError(f"expected (C, B, n) x (C, Q, n), got "
                         f"{tuple(times.shape)} x {tuple(weights.shape)}")
    if _check(times, weights, t_steps, threshold, k) == "cpu":
        return rnl_fire_times_layer_plain(times, weights, t_steps=t_steps,
                                          threshold=threshold, k=k,
                                          with_clip=with_clip)
    (csz, bsz, n), qsz = times.shape, weights.shape[1]
    fire = torch.empty((csz, bsz, qsz), dtype=torch.int32,
                       device=times.device)
    clip = torch.empty_like(fire) if with_clip else None
    if fire.numel():
        with torch.cuda.device(times.device):
            code = _library().rnl_fire_times_layer_launch(
                _ptr(times), _ptr(weights), _ptr(fire), _ptr(clip), csz, bsz,
                qsz, n, t_steps, threshold, int(k is not None), k or 0,
                _stream(times.device))
        _raise_on(code, "rnl_fire_times_layer")
        LAUNCHES["rnl_fire_times_layer"] += 1
    return (fire, clip) if with_clip else fire


def rnl_fire_times_compact(times: torch.Tensor, weights: torch.Tensor, *,
                           t_steps: int, threshold: int,
                           k: Optional[int] = None) -> torch.Tensor:
    """Fire times over spike-compacted volleys.

    Volleys arrive with each row's active lines in a dense prefix of width
    ``s`` (``NO_SPIKE`` padding past it) and weights gathered through the
    same line-index map, per volley. Bit-exact vs :func:`rnl_fire_times`
    on the uncompacted inputs because dropped lines carry no ramp bits.

    Args:
      times:   (B, s) int32 compacted spike times
        (:func:`repro_torch.core.compaction.compact_volleys`).
      weights: (B, Q, s) int32 per-volley gathered weights
        (:func:`repro_torch.core.compaction.gather_weights`).
      t_steps, threshold, k: as in :func:`rnl_fire_times`.

    Returns:
      (B, Q) int32 fire times.
    """
    if times.dim() != 2 or weights.dim() != 3 \
            or times.shape[0] != weights.shape[0] \
            or times.shape[1] != weights.shape[2]:
        raise ValueError(f"expected (B, s) x (B, Q, s), got "
                         f"{tuple(times.shape)} x {tuple(weights.shape)}")
    if _check(times, weights, t_steps, threshold, k) == "cpu":
        return rnl_fire_times_compact_plain(times, weights, t_steps=t_steps,
                                            threshold=threshold, k=k)
    (bsz, s), qsz = times.shape, weights.shape[1]
    fire = torch.empty((bsz, qsz), dtype=torch.int32, device=times.device)
    if fire.numel():
        with torch.cuda.device(times.device):
            code = _library().rnl_fire_times_compact_launch(
                _ptr(times), _ptr(weights), _ptr(fire), bsz, qsz, s, t_steps,
                threshold, int(k is not None), k or 0,
                _stream(times.device))
        _raise_on(code, "rnl_fire_times_compact")
        LAUNCHES["rnl_fire_times_compact"] += 1
    return fire
