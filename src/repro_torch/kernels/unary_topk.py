"""Unary top-k relocation over spike bit-planes: a hand-written CUDA kernel
for the pruned CAS network and its plain PyTorch version.

The ASIC applies the CAS network to one n-bit volley per clock; here whole
gamma cycles go through at once: the input is a ``(rows, n)`` bit-plane
(rows = batch x time flattened by the caller) and the network is
evaluated gate by gate on every row. The output is the relocated
bit-plane restricted to the bottom k wires (the Catwalk dendrite's PC
input), or its per-row count, ``min(popcount, k)`` for a valid top-k
selector. The kernel lives in ``csrc/unary_topk.cu`` (built for
``sm_90a`` at first use by :mod:`repro_torch.kernels.build`).

Two public entry points, with the reference's signatures:
:func:`unary_topk_relocate` and :func:`unary_topk_count`. Both go through
one private entry, :func:`_unary_topk`, which takes the network as
``(units, n, k)`` so that a full sorter summed over its bottom k wires
(the ``sorting_pc`` dendrite) runs through the same kernel.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel on the current stream or raises: it never falls back.
Each launch adds one to :data:`LAUNCHES` under the output's name.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import unary_ops
from repro_torch.core.topk_prune import TopKNetwork
from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv

#: kernel launches per output kind since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"unary_topk_relocate": 0, "unary_topk_count": 0}

#: the widest row the kernel holds (wire indices are kept in 8 bits and a
#: block's bit-sliced words in shared memory); wider rows raise on CUDA
MAX_WIRES = 256
#: rows per block: one warp, each lane holding 32 rows bit-sliced
#: (``kRowsPerBlock`` in ``csrc/unary_topk.cu``)
ROWS_PER_BLOCK = 1024

Units = Tuple[Tuple[int, int], ...]

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tables: Dict[Tuple[Units, int, int, torch.device], torch.Tensor] = {}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    """Build/load ``csrc/unary_topk.cu`` and declare its C interface."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("unary_topk")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.unary_topk_launch.argtypes = [p, p, i, p, ll, i, i, i, i, ll,
                                              p]
            lib.unary_topk_launch.restype = ctypes.c_int
            lib.unary_topk_error_string.argtypes = [ctypes.c_int]
            lib.unary_topk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def pack_layers(units: Sequence[Tuple[int, int]], n: int):
    """Greedily pack CAS units into layers of disjoint wire pairs, keeping
    their order.

    Returns per-layer ``(partner_perm, take_min_mask, take_max_mask)``
    numpy arrays (int32, bool, bool; each of length n); wires a layer does
    not touch keep their value (perm = identity, both masks false).
    Applying the layers in turn equals applying ``units`` in order.
    """
    layers = []
    current: list = []
    busy: set = set()
    for (i, j) in units:
        if i in busy or j in busy:
            layers.append(current)
            current, busy = [], set()
        current.append((i, j))
        busy.update((i, j))
    if current:
        layers.append(current)

    packed = []
    for layer in layers:
        perm = np.arange(n, dtype=np.int32)
        take_min = np.zeros((n,), dtype=bool)
        take_max = np.zeros((n,), dtype=bool)
        for (i, j) in layer:
            perm[i], perm[j] = j, i
            take_min[i] = True      # wire i <- AND / min
            take_max[j] = True      # wire j <- OR / max
        packed.append((perm, take_min, take_max))
    return packed


# ------------------------------------------------------------ plain versions

def _unary_topk_plain(bits: torch.Tensor, units: Sequence[Tuple[int, int]],
                      n: int, k: int, *, count: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`_unary_topk`."""
    bottom = unary_ops.apply_cas_bits(bits, units)[..., n - k:]
    if count:
        return bottom.sum(dim=-1, dtype=torch.int32)
    return bottom.to(torch.int8)


def unary_topk_relocate_plain(bits: torch.Tensor,
                              net: TopKNetwork) -> torch.Tensor:
    """Plain PyTorch version of :func:`unary_topk_relocate`."""
    return _unary_topk_plain(bits, net.units, net.n, net.k, count=False)


def unary_topk_count_plain(bits: torch.Tensor,
                           net: TopKNetwork) -> torch.Tensor:
    """Plain PyTorch version of :func:`unary_topk_count`."""
    return _unary_topk_plain(bits, net.units, net.n, net.k, count=True)


# ------------------------------------------------------------------ wrappers

def _check(bits: torch.Tensor, n: int, k: int) -> None:
    if bits.dim() < 1 or bits.shape[-1] != n:
        raise ValueError(f"bits of shape {tuple(bits.shape)} do not end in "
                         f"the network's n={n} wires")
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k} n={n}")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no unary top-k kernel for device {bits.device}")
    if bits.device.type == "cuda" and n > MAX_WIRES:
        raise ValueError(f"n={n} wires: the CUDA kernel holds at most "
                         f"{MAX_WIRES}")


def _table(units: Units, n: int, k: int,
           device: torch.device) -> torch.Tensor:
    """The network as one int32 per unit, ``i | j << 16``, on ``device``:
    checked and copied once per network and device, then reused."""
    key = (units, n, k, device)
    table = _tables.get(key)
    if table is None:
        if any(not (0 <= i < n and 0 <= j < n and i != j)
               for i, j in units):
            raise ValueError(f"CAS units must join two distinct wires of "
                             f"0..{n - 1}")
        packed = [i | (j << 16) for i, j in units] or [0]
        table = torch.tensor(packed, dtype=torch.int32).to(device)
        _tables[key] = table
    return table


def _byte_plane(bits: torch.Tensor) -> torch.Tensor:
    """The bits as one contiguous byte per wire (non-zero = hot)."""
    if bits.dtype not in (torch.bool, torch.int8, torch.uint8):
        bits = bits != 0
    return bits.contiguous().view(torch.uint8)


def _unary_topk(bits: torch.Tensor, units: Sequence[Tuple[int, int]],
                n: int, k: int, *, count: bool) -> torch.Tensor:
    """Apply the CAS network ``units`` on ``n`` wires to every row of
    ``bits`` (..., n) and keep the bottom ``k`` wires: (..., k) int8, or
    with ``count`` their per-row sum, (...,) int32."""
    units = tuple((int(i), int(j)) for i, j in units)
    _check(bits, n, k)
    if bits.device.type == "cpu":
        return _unary_topk_plain(bits, units, n, k, count=count)
    lead = tuple(bits.shape[:-1])
    x = _byte_plane(bits)
    rows = x.numel() // n
    dev = x.device
    if count:
        out = torch.empty(lead, dtype=torch.int32, device=dev)
    else:
        out = torch.empty(lead + (k,), dtype=torch.int8, device=dev)
    if rows == 0:
        return out
    ptr = x.data_ptr()
    vec = 16 if n % 16 == 0 and ptr % 16 == 0 else \
        4 if n % 4 == 0 and ptr % 4 == 0 else 1
    table = _table(units, n, k, dev)
    with torch.cuda.device(dev):
        lib = _library()
        code = lib.unary_topk_launch(
            ctypes.c_void_p(ptr), ctypes.c_void_p(table.data_ptr()),
            len(units), ctypes.c_void_p(out.data_ptr()), rows, n, k, vec,
            int(count), cdiv(rows, ROWS_PER_BLOCK),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if code != 0:
        msg = lib.unary_topk_error_string(code).decode()
        raise RuntimeError(f"unary_topk launch failed: {msg} "
                           f"(cuda error {code})")
    LAUNCHES["unary_topk_count" if count else "unary_topk_relocate"] += 1
    return out


def unary_topk_relocate(bits: torch.Tensor, net: TopKNetwork) -> torch.Tensor:
    """Relocate active bits to the bottom-k wires via the CAS network.

    Args:
      bits: (..., n) bool / int8 per-tick dendrite bits (non-zero = hot).
      net:  a pruned top-k network (:mod:`repro_torch.core.topk_prune`).

    Returns:
      (..., k) int8 relocated bits (thermometer of ``min(popcount, k)``).
    """
    return _unary_topk(bits, net.units, net.n, net.k, count=False)


def unary_topk_count(bits: torch.Tensor, net: TopKNetwork) -> torch.Tensor:
    """Small-PC output: per-row count of relocated bits, (...,) int32."""
    return _unary_topk(bits, net.units, net.n, net.k, count=True)
