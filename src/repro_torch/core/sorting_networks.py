"""Comparator (compare-and-swap) network generators.

A network is a list of wire-index tuples ``(i, j)``. The convention
throughout this repo is: after a CAS unit fires, wire ``j`` (the *second*
element) holds the **larger** value and wire ``i`` holds the **smaller**
one. Most generators emit ``i < j``; bitonic descending blocks emit
``i > j`` (same unit, swapped outputs). For temporal-coded unary signals (Fig. 3 of the paper)
the bottom output is the OR gate and the top output is the AND gate, so a
full network clusters the "larger" (active/earlier-spiking) signals at the
bottom — exactly the relocation Catwalk exploits.

Networks provided:
  * ``bitonic_network(n)``        — classic bitonic sorter (n = power of 2).
  * ``odd_even_merge_network(n)`` — Batcher odd-even mergesort.
  * ``optimal_network(n)``        — best-known-size networks. Exact lists are
    hard-coded for n = 2, 4, 8, 16 (sizes 1/5/19/60, matching the smallest
    known counts used by the paper via Dobbelaere's tables). For n = 32/64
    the public best-known lists (185/521 CAS) are not reproducible from
    memory, so we return Batcher networks (191/543 CAS, <= 4.2% larger) and
    flag it via ``optimal_is_exact(n)``. Algorithm 1 pruning is agnostic to
    the source network.

All generators are pure Python (static metaprogramming); evaluation on data
lives in :mod:`repro_torch.core.unary_ops`.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

Network = List[Tuple[int, int]]


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def bitonic_network(n: int) -> Network:
    """Bitonic sorting network with directions folded to (i,j) normal form.

    The textbook bitonic sorter alternates ascending/descending blocks; a
    descending CAS on wires (i, j) is identical to an ascending CAS on
    (j, i). Since our CAS primitive is "max to the second wire", we emit the
    swapped pair for descending blocks. Size = n * p * (p+1) / 4 with
    p = log2(n): 24 CAS for n=8 (paper Fig. 5a), 80 for 16, 240 for 32,
    672 for 64.
    """
    if not _is_pow2(n):
        raise ValueError(f"bitonic requires power-of-2 n, got {n}")
    net: Network = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            for i in range(n):
                l = i ^ j
                if l > i:
                    if (i & k) == 0:
                        net.append((i, l))  # ascending
                    else:
                        net.append((l, i))  # descending (max to wire i)
            j //= 2
        k *= 2
    return net


def odd_even_merge_network(n: int) -> Network:
    """Batcher odd-even mergesort network for power-of-2 ``n``.

    Sizes: 5 (n=4), 19 (n=8), 63 (n=16), 191 (n=32), 543 (n=64).
    """
    if not _is_pow2(n):
        raise ValueError(f"odd_even_merge_network requires power-of-2 n, got {n}")
    net: Network = []

    def merge(lo: int, length: int, r: int) -> None:
        step = r * 2
        if step < length:
            merge(lo, length, step)
            merge(lo + r, length, step)
            for i in range(lo + r, lo + length - r, step):
                net.append((i, i + r))
        else:
            net.append((lo, lo + r))

    def sort(lo: int, length: int) -> None:
        if length > 1:
            m = length // 2
            sort(lo, m)
            sort(lo + m, m)
            merge(lo, length, 1)

    sort(0, n)
    return net


# ---------------------------------------------------------------------------
# Best-known ("optimal") networks. Each list is verified exhaustively by the
# 0-1 principle in tests (2^n Boolean vectors for n <= 16).
# ---------------------------------------------------------------------------

_OPTIMAL: dict[int, Network] = {
    1: [],
    2: [(0, 1)],
    3: [(0, 1), (0, 2), (1, 2)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    # 19-CAS 8-input network (smallest known; equals Batcher's count).
    8: [
        (0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6), (0, 4), (3, 7),
        (1, 5), (2, 6),
        (1, 4), (3, 6),
        (2, 4), (3, 5),
        (3, 4),
    ],
    # Green's 60-comparator 16-input network (smallest known).
    16: [
        (0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13), (14, 15),
        (0, 2), (1, 3), (4, 6), (5, 7), (8, 10), (9, 11), (12, 14), (13, 15),
        (0, 4), (1, 5), (2, 6), (3, 7), (8, 12), (9, 13), (10, 14), (11, 15),
        (0, 8), (1, 9), (2, 10), (3, 11), (4, 12), (5, 13), (6, 14), (7, 15),
        (5, 10), (6, 9), (3, 12), (13, 14), (7, 11), (1, 2), (4, 8),
        (1, 4), (7, 13), (2, 8), (11, 14),
        (2, 4), (5, 6), (9, 10), (11, 13), (3, 8), (7, 12),
        (6, 8), (10, 12), (3, 5), (7, 9),
        (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
        (6, 7), (8, 9),
    ],
}

#: Best-known sizes from Dobbelaere's "Smallest and Fastest Sorting Networks"
#: tables (the paper's reference [2]) — used to report the gap when we fall
#: back to Batcher for n = 32 / 64.
BEST_KNOWN_SIZE = {2: 1, 4: 5, 8: 19, 16: 60, 32: 185, 64: 521}


def optimal_is_exact(n: int) -> bool:
    """True when ``optimal_network(n)`` returns a best-known-size network."""
    return n in _OPTIMAL


def optimal_network(n: int) -> Network:
    """Smallest-known sorting network; Batcher fallback for n = 32/64."""
    if n in _OPTIMAL:
        return list(_OPTIMAL[n])
    if _is_pow2(n):
        return odd_even_merge_network(n)
    raise ValueError(f"no optimal/fallback network for n={n}")


def selection_network(n: int, k: int) -> Network:
    """Direct top-k *selection* network (the paper's §IV.B future-work
    direction: "directly selecting the top k without full sorting could be
    even more resource-efficient").

    Recursive construction: top-k of each half, then keep the top k of the
    merge of the two sorted k-prefixes (odd-even merge pruned by Algorithm 1
    — we inline the equivalent slice here to avoid an import cycle). The
    selected values land on the *last* k wires, matching the convention used
    by the pruned sorters. For k=2 this yields S(n) = 2*S(n/2) + 3 units:
    13 / 29 / 61 / 125 for n = 8 / 16 / 32 / 64 — the pruned best-known
    sorters of the paper coincide with this structure where we can check
    (pruned Green-16 top-2 == 29 units).
    """
    if not _is_pow2(n) or not _is_pow2(k):
        raise ValueError(f"selection_network needs power-of-2 n,k; got {n},{k}")
    if k >= n:
        return optimal_network(n)

    def merge_topk(lo_wires: Sequence[int], hi_wires: Sequence[int]) -> Network:
        """Merge two ascending k-runs (on arbitrary wire lists), keeping the
        top k on ``hi_wires`` (ascending). Batcher merge restricted to the
        wires whose values can still reach the top-k outputs."""
        kk = len(lo_wires)
        wires = list(lo_wires) + list(hi_wires)
        m = len(wires)
        # Batcher odd-even merge on 2k wires, then backward-slice to the
        # top k outputs (wires m-k .. m-1 of the merged run).
        net_local: Network = []

        def oddeven_merge(lo: int, length: int, r: int) -> None:
            step = r * 2
            if step < length:
                oddeven_merge(lo, length, step)
                oddeven_merge(lo + r, length, step)
                for t in range(lo + r, lo + length - r, step):
                    net_local.append((wires[t], wires[t + r]))
            else:
                net_local.append((wires[lo], wires[lo + r]))

        net_local = []
        oddeven_merge(0, m, 1)
        # backward slice to outputs = last k wires of ``wires``
        needed = set(wires[m - kk:])
        kept = []
        for (a, b) in reversed(net_local):
            if a in needed or b in needed:
                kept.append((a, b))
                needed.add(a)
                needed.add(b)
        return list(reversed(kept))

    def sel(wire_lo: int, length: int) -> Tuple[Network, List[int]]:
        if length == k:
            base = [(wire_lo + a, wire_lo + b) for (a, b) in optimal_network(k)]
            return base, list(range(wire_lo, wire_lo + k))
        half = length // 2
        net_a, out_a = sel(wire_lo, half)
        net_b, out_b = sel(wire_lo + half, half)
        merge_net = merge_topk(out_a, out_b)
        return net_a + net_b + merge_net, out_b

    net, outs = sel(0, n)
    # Relocate outputs onto the final k wires (n-k .. n-1) if not already
    # there, using direct CAS-free wire identity: outs is always the high
    # half's output wires; for the top-level call that is the last k wires
    # of the high half. Add pass-through comparators only if needed.
    target = list(range(n - k, n))
    if outs != target:
        # outs are ascending and distinct from target; emit swaps via CAS
        # with known-empty partners is impossible — instead note that for
        # power-of-2 recursion outs == target always holds.
        raise AssertionError(f"selection outputs misplaced: {outs}")
    return net


_GENERATORS = {
    "bitonic": bitonic_network,
    "odd_even": odd_even_merge_network,
    "optimal": optimal_network,
}


@functools.lru_cache(maxsize=None)
def get_network(kind: str, n: int) -> Tuple[Tuple[int, int], ...]:
    """Cached accessor: ``kind`` in {'bitonic', 'odd_even', 'optimal'}."""
    if kind not in _GENERATORS:
        raise ValueError(f"unknown network kind {kind!r}")
    return tuple(_GENERATORS[kind](n))


def network_size(kind: str, n: int) -> int:
    return len(get_network(kind, n))


def network_depth(network: Sequence[Tuple[int, int]]) -> int:
    """Number of layers when CAS units are greedily packed in parallel."""
    wire_time: dict[int, int] = {}
    depth = 0
    for i, j in network:
        t = max(wire_time.get(i, 0), wire_time.get(j, 0)) + 1
        wire_time[i] = wire_time[j] = t
        depth = max(depth, t)
    return depth


def apply_network(values, network: Sequence[Tuple[int, int]]):
    """Reference evaluation on a Python list of comparable values.

    Returns a new list: larger values migrate toward larger indices
    ("clustered at the bottom", Fig. 3b). Pure Python — the vectorized
    evaluation on tensors lives in :mod:`repro_torch.core.unary_ops`.
    """
    out = list(values)
    for i, j in network:
        if out[i] > out[j]:
            out[i], out[j] = out[j], out[i]
    return out


def check_sorting_network(network: Sequence[Tuple[int, int]], n: int,
                          exhaustive_limit: int = 16) -> bool:
    """0-1 principle check. Exhaustive for n <= exhaustive_limit."""
    import itertools
    import random

    if n <= exhaustive_limit:
        cases = itertools.product((0, 1), repeat=n)
    else:
        rng = random.Random(0)
        cases = (tuple(rng.randint(0, 1) for _ in range(n)) for _ in range(20000))
    for bits in cases:
        out = apply_network(list(bits), network)
        if any(out[t] > out[t + 1] for t in range(n - 1)):
            return False
    return True
