"""Algorithm 1 from the paper: prune a unary sorter into a unary top-k
selector, and identify half compare-and-swap units.

Given a sorting network ``S`` (ordered CAS list, second tuple element = max
output) and ``k``, the top-k outputs are the bottom ``k`` wires
``{n-k, ..., n-1}``. Walking ``S`` in reverse, a unit is *mandatory* iff one
of its wires is (transitively) needed by the top-k outputs; keeping it makes
both of its input wires needed. The surviving list ``T`` computes the same
bottom-k values as the full sorter (the removed units only affect discarded
wires).

A mandatory unit is a *half* unit when one of its two outputs is never
consumed — neither by a later mandatory unit nor as a final top-k output.
The dashed gate of Fig. 4b (one of AND/OR) can then be dropped: a CAS unit
costs 2 gates, a half unit costs 1.

The paper's Fig. 5 x/y/z annotation maps to
``(len(sorter), len(result.units), len(result.half))``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import FrozenSet, Sequence, Tuple

from repro_torch.core import sorting_networks as sn

Network = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class TopKNetwork:
    """A pruned unary top-k selector.

    Attributes:
      n: number of input wires.
      k: number of selected outputs (bottom wires ``n-k .. n-1``).
      units: ordered mandatory CAS units (subset of the source sorter).
      half: set of unit indices (into ``units``) that are half units.
      dropped_output: for each half unit index, which wire's output gate is
        dropped (the unused one).
      source_size: CAS count of the unpruned source sorter.
      source_kind: generator name of the source sorter.
    """

    n: int
    k: int
    units: Network
    half: FrozenSet[int]
    dropped_output: Tuple[Tuple[int, int], ...]  # (unit_idx, wire)
    source_size: int
    source_kind: str

    @property
    def num_units(self) -> int:
        return len(self.units)

    @property
    def num_half(self) -> int:
        return len(self.half)

    @property
    def gate_count(self) -> int:
        """2 gates per full CAS, 1 per half CAS (Fig. 6a accounting)."""
        return 2 * self.num_units - self.num_half

    @property
    def output_wires(self) -> Tuple[int, ...]:
        return tuple(range(self.n - self.k, self.n))

    def fig5_xyz(self) -> Tuple[int, int, int]:
        """(total, mandatory, half) CAS counts as annotated in Fig. 5."""
        return (self.source_size, self.num_units, self.num_half)


def prune_topk(sorter: Sequence[Tuple[int, int]], n: int, k: int,
               source_kind: str = "custom") -> TopKNetwork:
    """Algorithm 1: derive a unary top-k selector from a unary sorter."""
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k} n={n}")
    outputs = set(range(n - k, n))

    # --- mandatory-unit selection (paper lines 1-7) ---------------------
    needed = set(outputs)
    kept_rev = []
    for idx in range(len(sorter) - 1, -1, -1):
        i, j = sorter[idx]
        if i in needed or j in needed:
            kept_rev.append((i, j))
            needed.add(i)
            needed.add(j)
    units: Network = tuple(reversed(kept_rev))

    # --- half-unit detection (paper lines 8-13) -------------------------
    # A kept unit's output on wire w is *used* iff some LATER kept unit
    # reads wire w, or w is one of the final top-k output wires. If exactly
    # one output is unused, the unit degenerates to a single gate.
    half = set()
    dropped = []
    later_touch: list[set] = [set() for _ in range(len(units) + 1)]
    # later_touch[p] = wires read by units at positions >= p
    for p in range(len(units) - 1, -1, -1):
        i, j = units[p]
        later_touch[p] = later_touch[p + 1] | {i, j}
    for p, (i, j) in enumerate(units):
        used_i = (i in outputs) or (i in later_touch[p + 1])
        used_j = (j in outputs) or (j in later_touch[p + 1])
        if used_i and used_j:
            continue
        if not used_i and not used_j:  # cannot happen for a mandatory unit
            raise AssertionError("mandatory unit with both outputs dead")
        half.add(p)
        dropped.append((p, i if not used_i else j))

    return TopKNetwork(
        n=n, k=k, units=units, half=frozenset(half),
        dropped_output=tuple(dropped), source_size=len(sorter),
        source_kind=source_kind,
    )


@functools.lru_cache(maxsize=None)
def topk_network(kind: str, n: int, k: int) -> TopKNetwork:
    """Cached: prune the ``kind`` sorter of width ``n`` down to top-``k``.

    ``kind`` in {'bitonic', 'odd_even', 'optimal', 'selection', 'auto'}.
    ``k == n`` returns the unpruned sorter (unary sorting, no pruning
    possible — paper Fig. 6a). 'selection' builds the direct top-k
    selection network (paper's future-work direction; identical to pruned
    best-known sorters at n <= 16). 'auto' = 'optimal' where exact
    best-known lists exist (n <= 16), else 'selection' — this is what the
    silicon model uses for Catwalk (see DESIGN.md §3.6).
    """
    if kind == "auto":
        kind = "optimal" if (sn.optimal_is_exact(n) or k >= n) else "selection"
    if kind == "selection" and k < n:
        sorter = sn.selection_network(n, k)
        return prune_topk(sorter, n, k, source_kind="selection")
    if kind == "selection":
        kind = "optimal"
    sorter = sn.get_network(kind, n)
    return prune_topk(sorter, n, k, source_kind=kind)


def apply_topk(values, net: TopKNetwork):
    """Pure-Python reference: returns the bottom-k wires (ascending order),
    i.e. the k largest input values, sorted. Used as the oracle in tests."""
    out = list(values)
    for i, j in net.units:
        if out[i] > out[j]:
            out[i], out[j] = out[j], out[i]
    return out[net.n - net.k:]
