"""Unary top-k relocation over spike bit-planes, and the gate-level neuron
with its ramp bits made on the card: hand-written CUDA kernels for the
pruned CAS network and their plain PyTorch versions.

The ASIC applies the CAS network to one n-bit volley per clock; here whole
gamma cycles go through at once. The bit-plane kernel takes a ``(rows,
n)`` bit-plane (rows = batch x time flattened by the caller) and evaluates
the network gate by gate on every row; its output is the relocated
bit-plane restricted to the bottom k wires (the Catwalk dendrite's PC
input), or its per-row count, ``min(popcount, k)`` for a valid top-k
selector. The gate-level kernel takes spike times and weights instead and
makes each tick's ramp bits itself (line i is hot at tick t iff
``times[i] <= t < times[i] + w[i]``), runs the same network on them and
returns the membrane potential (the running sum of the bottom k wires'
count) and the clip count (ticks whose popcount exceeds k): the bit-plane
never reaches memory. Both kernels live in ``csrc/unary_topk.cu`` (built
for ``sm_90a`` at first use by :mod:`repro_torch.kernels.build`); the
networks sit in its constant memory, copied once per network and device.

Public entry points: :func:`unary_topk_relocate` and
:func:`unary_topk_count`, with the reference's signatures, go through one
private entry, :func:`_unary_topk`, which takes the network as ``(units,
n, k)`` so that a full sorter summed over its bottom k wires (the
``sorting_pc`` dendrite) runs through the same kernel;
:func:`gate_level_trace` is the gate-level neuron's, in the bank form of
the RNL kernels.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel on the current stream or raises: it never falls back.
Each launch adds one to :data:`LAUNCHES` under its entry's name.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import coding, unary_ops
from repro_torch.core.topk_prune import TopKNetwork
from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv

#: kernel launches per output kind since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"unary_topk_relocate": 0, "unary_topk_count": 0,
                            "gate_level_trace": 0}

#: the widest row the kernels hold (their bit-sliced words live in shared
#: memory); wider rows raise on CUDA
MAX_WIRES = 256
#: rows a block bit-slices at once: 32 groups of 32 rows, one 32-bit word
#: a wire each (``kRowsPerTile`` in ``csrc/unary_topk.cu``)
ROWS_PER_BLOCK = 1024

Units = Tuple[Tuple[int, int], ...]

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: per device index: the offset and length of each network (units and
#: width: the padding names the spare wire n) in the kernels' constant
#: arena, and the arena's first free word
_arena: Dict[int, Tuple[Dict[Tuple[Units, int], Tuple[int, int]],
                        List[int]]] = {}


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
            lib.unary_topk_launch.argtypes = [p, i, i, p, ll, i, i, i, i, ll,
                                              p]
            lib.gate_level_launch.argtypes = [p, p, i, i, p, p, ll, ll, ll,
                                              i, i, i, p]
            lib.unary_topk_put_units.argtypes = [p, i, i]
            for fn in (lib.unary_topk_launch, lib.gate_level_launch,
                       lib.unary_topk_put_units, lib.unary_topk_arena_units):
                fn.restype = ctypes.c_int
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


def gate_level_trace_plain(times: torch.Tensor, weights: torch.Tensor,
                           units: Sequence[Tuple[int, int]], n: int, k: int,
                           t_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`gate_level_trace`: every pair's
    bit-plane (``coding.rnl_response_bits``), the network on it, the bottom
    k wires' count and its running sum, and the ticks whose popcount
    exceeds k."""
    shape = times.shape[:-1] + (weights.shape[-2], n)
    bits = coding.rnl_response_bits(
        torch.broadcast_to(times[..., :, None, :], shape),
        torch.broadcast_to(weights[..., None, :, :], shape), t_steps)
    inc = _unary_topk_plain(bits, units, n, k, count=True)
    potential = torch.cumsum(inc, dim=-1, dtype=torch.int32)
    raw = bits.sum(dim=-1, dtype=torch.int32)
    return potential, (raw > k).sum(dim=-1, dtype=torch.int32)


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


def _network_words(units: Units, n: int) -> np.ndarray:
    """The network as the kernels read it (one word ``i | j << 16`` a
    unit): in layers of units on disjoint wires, each unit in the earliest
    layer after the last earlier unit on either of its wires (so every
    wire sees its units in their order: the same function), each layer
    padded to a multiple of 8 with units that join the spare wire ``n`` to
    itself, which change nothing."""
    depth = [0] * n
    layers: list = []
    for i, j in units:
        d = max(depth[i], depth[j])
        depth[i] = depth[j] = d + 1
        if d == len(layers):
            layers.append([])
        layers[d].append(i | (j << 16))
    spare = n | (n << 16)
    words: list = []
    for layer in layers:
        words += layer + [spare] * (-len(layer) % 8)
    return np.array(words, dtype=np.uint32)


def _units_offset(units: Units, n: int,
                  device: torch.device) -> Tuple[int, int]:
    """Where the network ``units`` sits in the kernels' constant arena on
    ``device``, and its length in words: checked against ``n`` and copied
    once per network and device (the copy ends in a device synchronise,
    so a launch on any stream sees it). A full arena is emptied after a
    device synchronise, so no running kernel reads a network that is
    overwritten."""
    if not units:
        return 0, 0
    with _lib_lock:
        offsets, cursor = _arena.setdefault(device.index, ({}, [0]))
        found = offsets.get((units, n))
        if found is not None:
            return found
    if any(not (0 <= i < n and 0 <= j < n and i != j) for i, j in units):
        raise ValueError(f"CAS units must join two distinct wires of "
                         f"0..{n - 1}")
    lib = _library()
    capacity = lib.unary_topk_arena_units()
    packed = _network_words(units, n)
    if len(packed) > capacity:
        raise ValueError(f"a network of {len(units)} CAS units: the CUDA "
                         f"kernels hold at most {capacity} words of them")
    with _lib_lock:
        off = -(-cursor[0] // 16) * 16        # 64-byte aligned
        if off + len(packed) > capacity:
            torch.cuda.synchronize(device)
            offsets.clear()
            off = 0
        with torch.cuda.device(device):
            code = lib.unary_topk_put_units(
                ctypes.c_void_p(packed.ctypes.data), len(packed), off)
        if code != 0:
            msg = lib.unary_topk_error_string(code).decode()
            raise RuntimeError(f"unary_topk: copying a network failed: "
                               f"{msg} (cuda error {code})")
        offsets[units, n] = (off, len(packed))
        cursor[0] = off + len(packed)
    return off, len(packed)


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
    vec = 16 if n % 16 == 0 else 4 if n % 4 == 0 else 1
    with torch.cuda.device(dev):
        off, n_words = _units_offset(units, n, dev)
        lib = _library()
        code = lib.unary_topk_launch(
            ctypes.c_void_p(x.data_ptr()), off, n_words,
            ctypes.c_void_p(out.data_ptr()), rows, n, k, vec, int(count),
            cdiv(rows, ROWS_PER_BLOCK),
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


def gate_level_trace(times: torch.Tensor, weights: torch.Tensor,
                     units: Sequence[Tuple[int, int]], n: int, k: int,
                     t_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate-level clipped dendrite and soma of every (volley, neuron)
    pair: each tick's ramp bits, the CAS network ``units`` on ``n`` wires
    (Catwalk's pruned top-k network, or a full sorter for ``sorting_pc``),
    the count of its bottom ``k`` wires, and that count's running sum.

    Args:
      times:   (..., B, n) int32 spike times (``NO_SPIKE`` = silent).
      weights: (..., Q, n) int32 weights >= 0, the same leading axes.
      units, n, k: the network, its width and the wires kept.
      t_steps: gamma-cycle length in ticks.

    Returns:
      ``(potential, clip)``: (..., B, Q, t_steps) int32 membrane potential
      trace and (..., B, Q) int32 count of ticks whose popcount exceeds k.
    """
    units = tuple((int(i), int(j)) for i, j in units)
    if times.dim() < 2 or weights.dim() < 2 or times.shape[-1] != n \
            or weights.shape[-1] != n \
            or times.shape[:-2] != weights.shape[:-2]:
        raise ValueError(f"times {tuple(times.shape)} and weights "
                         f"{tuple(weights.shape)} must be (..., B, {n}) and "
                         f"(..., Q, {n}) with the same leading axes")
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k} n={n}")
    if t_steps < 0:
        raise ValueError(f"t_steps={t_steps} < 0")
    if times.device.type not in ("cpu", "cuda") \
            or weights.device != times.device:
        raise ValueError(f"no gate-level kernel for devices {times.device} "
                         f"and {weights.device}")
    if times.device.type == "cuda" and n > MAX_WIRES:
        raise ValueError(f"n={n} wires: the CUDA kernel holds at most "
                         f"{MAX_WIRES}")
    if times.device.type == "cpu":
        return gate_level_trace_plain(times, weights, units, n, k, t_steps)
    lead, b, q = tuple(times.shape[:-2]), times.shape[-2], weights.shape[-2]
    dev = times.device
    pot = torch.empty(lead + (b, q, t_steps), dtype=torch.int32, device=dev)
    if pot.numel() == 0:
        return pot, torch.zeros(lead + (b, q), dtype=torch.int32, device=dev)
    # the kernel writes every count
    clip = torch.empty(lead + (b, q), dtype=torch.int32, device=dev)
    t = times.to(torch.int32).contiguous()
    w = weights.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        off, n_words = _units_offset(units, n, dev)
        lib = _library()
        code = lib.gate_level_launch(
            ctypes.c_void_p(t.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            off, n_words, ctypes.c_void_p(pot.data_ptr()),
            ctypes.c_void_p(clip.data_ptr()),
            int(np.prod(lead, dtype=np.int64)), b, q, n, k, t_steps,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if code != 0:
        msg = lib.unary_topk_error_string(code).decode()
        raise RuntimeError(f"gate_level_trace launch failed: {msg} "
                           f"(cuda error {code})")
    LAUNCHES["gate_level_trace"] += 1
    return pot, clip
