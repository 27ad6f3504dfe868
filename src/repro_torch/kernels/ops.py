"""Kernel entry points of the LM path: the SSD scan, one head per row or
with heads sharing B and C, and the MoE router gate.

The device of the tensors decides: CUDA tensors launch the hand-written
kernel, CPU tensors run its plain version. Both are differentiable: on
CUDA through autograd functions whose backward is plain PyTorch (the SSD
scan's the plain chunked form's vector-Jacobian product, the gate's that
of its top-k softmax), on the CPU through the plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import moe_gate as _moe
from repro_torch.kernels import ssd_scan as _ssd


def ssd_scan(u: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = _ssd.CHUNK) -> torch.Tensor:
    """SSD scan on (BH, L, ·) operands; see :func:`repro_torch.kernels.ssd_scan.ssd_scan`."""
    return _ssd.ssd_scan(u, log_decay, b, c, chunk)


def ssd_scan_mh(u: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int = _ssd.CHUNK) -> torch.Tensor:
    """Multi-head SSD with shared B/C (u (B,H,L,P); log_decay (B,H,L);
    b, c (B,L,N)) -> y (B,H,L,P).

    The heads fold into the kernel's rows; each row reads B and C at its
    batch row, so they are never repeated per head (the reference's Pallas
    path repeats them H times).
    """
    bsz, h, L, p = u.shape
    y = _ssd.ssd_scan_rows(u.reshape(bsz * h, L, p).contiguous(),
                           log_decay.reshape(bsz * h, L).contiguous(),
                           b.contiguous(), c.contiguous(), chunk, heads=h)
    return y.reshape(bsz, h, L, p)


def moe_gate_topk(logits: torch.Tensor, k: int, renorm: bool = True):
    """Softmax gate + top-k of router logits (T, E) -> (probs (T, k)
    float32, ids (T, k) int32); see
    :func:`repro_torch.kernels.moe_gate.moe_gate_topk`."""
    return _moe.moe_gate_topk(logits, k, renorm)
