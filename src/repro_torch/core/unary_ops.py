"""Gate-level evaluation of unary CAS networks on bit-plane tensors.

The circuit processes one bit per wire per clock tick; here whole
bit-planes are evaluated at once: a ``(..., n)`` tensor holds the per-tick
dendrite bits of every batch element, and each CAS unit becomes two
elementwise gates on wires ``i`` / ``j``:

    bottom (j) <- OR  (max: hot if either input is hot)
    top    (i) <- AND (min)

A *sorting* network evaluated this way yields the popcount thermometer
(0-1 principle); a pruned top-k network keeps its bottom k wires, so
``sum(bottom_k) == min(popcount, k)``, the formal Catwalk correctness
condition. These are the readable plain versions: the CUDA kernel of
:mod:`repro_torch.kernels.unary_topk` computes the same function, and its
plain version reuses them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.topk_prune import TopKNetwork


def _wires(bits: torch.Tensor) -> list:
    b = bits.to(torch.bool)
    return [b[..., w] for w in range(b.shape[-1])]


def apply_cas_bits(bits: torch.Tensor,
                   network: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Apply a CAS network bitwise: AND to wire i, OR to wire j.

    ``bits``: (..., n) bool or integer (non-zero = hot). Returns the same
    shape as bool.
    """
    cols = _wires(bits)
    for i, j in network:
        cols[i], cols[j] = cols[i] & cols[j], cols[i] | cols[j]
    return torch.stack(cols, dim=-1)


def apply_cas_waves(waves: torch.Tensor,
                    network: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The same network on monotone temporal waves (..., T, n): the gates
    act on each tick independently, so this is :func:`apply_cas_bits` with
    the time axis folded into the batch."""
    return apply_cas_bits(waves, network)


def sort_bits(bits: torch.Tensor,
              network: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Gate-level unary sort of a bit-plane: the popcount thermometer."""
    return apply_cas_bits(bits, network)


def topk_bits(bits: torch.Tensor, net: TopKNetwork) -> torch.Tensor:
    """Gate-level unary top-k (Fig. 4b dendrite): the bottom k wires,
    (..., k) bool, with ``sum(out) == min(popcount(bits), k)``."""
    return apply_cas_bits(bits, net.units)[..., net.n - net.k:]


def topk_bits_fast(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Algebraic shortcut for :func:`topk_bits`: ``min(popcount, k)``
    expanded back to a k-wire thermometer. Equal to the gate network
    whenever it is a valid top-k selector."""
    pc = bits.sum(dim=-1, keepdim=True, dtype=torch.int32)
    idx = torch.arange(k, dtype=torch.int32, device=bits.device)
    return idx >= (k - torch.clamp(pc, max=k))


def topk_count(bits: torch.Tensor, net: TopKNetwork) -> torch.Tensor:
    """Small-PC output: the number of hot wires among the selected k,
    (...,) int32 (``min(popcount, k)`` for a valid top-k selector)."""
    return topk_bits(bits, net).sum(dim=-1, dtype=torch.int32)


def half_unit_masked(bits: torch.Tensor, net: TopKNetwork) -> torch.Tensor:
    """Gate-level evaluation honouring half units: each dropped output is
    replaced by an X (here 0), which must not reach the selected wires.
    Returns the bottom k wires, (..., k) bool."""
    cols = _wires(bits)
    drop_by_unit = dict(net.dropped_output)  # unit index -> dropped wire
    for p, (i, j) in enumerate(net.units):
        lo, hi = cols[i] & cols[j], cols[i] | cols[j]
        dw = drop_by_unit.get(p)
        cols[i] = torch.zeros_like(lo) if dw == i else lo
        cols[j] = torch.zeros_like(hi) if dw == j else hi
    return torch.stack(cols, dim=-1)[..., net.n - net.k:]
