"""Generic slot-pool machinery for slot-based serving engines (DESIGN.md §5.1).

Both serving engines batch heterogeneous client requests into a fixed pool of
B *slots* — the batch rows of one compiled step function. A request waits in a
FIFO pending queue, is admitted into the lowest free slot, occupies that batch
row for as many engine steps as it needs, and is retired per-slot the moment it
completes; the freed row re-fills from the queue at the top of the next step.
No barrier on the slowest request: a long-running slot never blocks short
requests flowing through the other rows.

The pool is the repo's single abstraction for "batch row with memory": a
:class:`SlotEntry` carries not just the opaque payload (LM prompts, TNN volley
streams) but a typed per-request ``state`` field — the slot's persistent
memory across engine steps (a recurrent TNN stream's carry volleys, an LM
decode slot's cursor into its prompt). The lifecycle contract is explicit:

* ``submit`` enqueues (``state`` is ``None`` while pending; a full queue —
  ``max_pending`` — rejects with :class:`QueueFull`),
* ``admit`` places the entry and invokes the pool's ``on_admit(idx, entry)``
  hook, where the engine initialises ``entry.state`` for the slot,
* the engine reads/writes ``entry.state`` freely between steps, and
* ``retire(idx)`` frees the slot and returns the entry with its **final**
  state still attached — the stream's last carry, the decode slot's cursor.

Beyond state the pool only does bookkeeping — admission order, slot
assignment, and wall-clock timestamps for the per-request latency accounting
that :func:`latency_summary` aggregates.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import (
    Callable,
    Deque,
    Dict,
    Generic,
    Iterable,
    Iterator,
    List,
    Optional,
    Tuple,
    TypeVar,
)

T = TypeVar("T")
S = TypeVar("S")


class QueueFull(RuntimeError):
    """``submit`` rejected: the pending queue is at ``max_pending``."""


@dataclasses.dataclass
class SlotEntry(Generic[T, S]):
    """One request's bookkeeping: payload, per-slot state, timestamps.

    ``seq`` is the monotonically increasing submission index (FIFO ticket).
    ``state`` is the slot's persistent per-request memory: ``None`` while
    pending, initialised by the pool's ``on_admit`` hook at admission,
    mutated freely by the engine between steps, and carried out of the pool
    by ``retire`` as the request's final state. Timestamps are pool-clock
    seconds; ``admitted_at``/``retired_at`` stay at 0.0 until the
    corresponding transition happens.
    """

    item: T
    seq: int
    submitted_at: float
    admitted_at: float = 0.0
    retired_at: float = 0.0
    state: Optional[S] = None

    @property
    def wait_s(self) -> float:
        """Queue wait: submission -> admission."""
        return self.admitted_at - self.submitted_at

    @property
    def service_s(self) -> float:
        """In-slot service time: admission -> retirement."""
        return self.retired_at - self.admitted_at

    @property
    def latency_s(self) -> float:
        """End-to-end latency: submission -> retirement."""
        return self.retired_at - self.submitted_at


class SlotPool(Generic[T, S]):
    """Fixed pool of ``n_slots`` stateful slots fed by a FIFO pending queue.

    Deterministic scheduling contract (pinned by tests/test_slots.py and
    tests/test_serve_tnn.py):

    * ``submit`` appends to the pending queue and assigns the next ``seq``;
      with ``max_pending`` set, a full queue raises :class:`QueueFull`
      (counted in ``n_rejected``) instead of growing without bound.
    * ``admit`` drains the queue into free slots, earliest submission into
      the lowest free slot index, until slots or pending run out; each
      placement fires ``on_admit(idx, entry)`` so the owning engine can
      initialise ``entry.state`` before the slot's first step.
    * ``retire(idx)`` frees a slot and returns its entry (timestamped,
      final ``state`` attached).

    Engines call ``admit`` at the top of every step, so a slot freed in step
    ``s`` is re-filled in step ``s + 1`` — continuous batching.
    """

    def __init__(
        self,
        n_slots: int,
        clock: Callable[[], float] = time.perf_counter,
        *,
        on_admit: Optional[Callable[[int, SlotEntry[T, S]], None]] = None,
        max_pending: Optional[int] = None,
    ):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        if max_pending is not None and max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.n_slots = n_slots
        self._clock = clock
        self._on_admit = on_admit
        self.max_pending = max_pending
        self._slots: List[Optional[SlotEntry[T, S]]] = [None] * n_slots
        self._pending: Deque[SlotEntry[T, S]] = collections.deque()
        self._seq = 0
        self.n_submitted = 0
        self.n_retired = 0
        self.n_rejected = 0

    def submit(self, item: T) -> SlotEntry[T, S]:
        """Enqueue a request; returns its (shared, mutable) entry.

        Raises :class:`QueueFull` when the pending queue already holds
        ``max_pending`` entries — explicit admission control so a burst of
        clients cannot grow the queue (and its latency) without bound.
        """
        if self.max_pending is not None and len(self._pending) >= self.max_pending:
            self.n_rejected += 1
            raise QueueFull(
                f"pending queue full ({len(self._pending)} >= "
                f"max_pending={self.max_pending})"
            )
        entry: SlotEntry[T, S] = SlotEntry(
            item=item, seq=self._seq, submitted_at=self._clock()
        )
        self._seq += 1
        self.n_submitted += 1
        self._pending.append(entry)
        return entry

    def admit(self) -> List[Tuple[int, SlotEntry[T, S]]]:
        """Fill free slots from the pending queue; returns new placements.

        Each placement invokes the ``on_admit(idx, entry)`` hook (when
        configured) after the slot assignment and timestamp — the hook is
        where the engine initialises the slot's ``state``.
        """
        admitted: List[Tuple[int, SlotEntry[T, S]]] = []
        for idx in range(self.n_slots):
            if not self._pending:
                break
            if self._slots[idx] is None:
                entry = self._pending.popleft()
                entry.admitted_at = self._clock()
                self._slots[idx] = entry
                if self._on_admit is not None:
                    self._on_admit(idx, entry)
                admitted.append((idx, entry))
        return admitted

    def retire(self, idx: int) -> SlotEntry[T, S]:
        """Free slot ``idx``; returns the timestamped entry.

        The entry's ``state`` is the request's final per-slot state (the
        last recurrent carry, the decode cursor) — the caller owns it from
        here; the pool keeps no reference.
        """
        entry = self._slots[idx]
        if entry is None:
            raise ValueError(f"slot {idx} is empty")
        entry.retired_at = self._clock()
        self._slots[idx] = None
        self.n_retired += 1
        return entry

    def clear(self) -> List[SlotEntry[T, S]]:
        """Drop every live AND pending entry; returns the dropped entries.

        The crash-recovery primitive (DESIGN.md §5.5): after a restore the
        engine's weights have rolled back to the last snapshot, so every
        in-flight stream's partial progress is stale — the serve driver
        clears the pool and resubmits the uncommitted streams from their
        beginning (restore-and-replay). Dropped entries do NOT count as
        retired; counters other than the live/pending sets are untouched,
        so ``n_submitted``/``n_retired`` keep describing the pool's whole
        history.
        """
        dropped = [e for _, e in self.live()]
        dropped.extend(self._pending)
        self._slots = [None] * self.n_slots
        self._pending.clear()
        return dropped

    def live(self) -> Iterator[Tuple[int, SlotEntry[T, S]]]:
        """(slot index, entry) for every occupied slot, ascending index."""
        for idx, entry in enumerate(self._slots):
            if entry is not None:
                yield idx, entry

    @property
    def n_live(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def has_work(self) -> bool:
        """Anything admitted or still queued?"""
        return self.n_live > 0 or self.n_pending > 0

    @property
    def occupancy(self) -> float:
        """Fraction of slots currently occupied."""
        return self.n_live / self.n_slots

    @property
    def pending_occupancy(self) -> float:
        """Pending-queue depth as a fraction of ``max_pending`` (0.0 when
        the queue is unbounded or empty) — the admission-pressure signal
        the learn-while-serving backpressure rule watches (DESIGN.md
        §5.5)."""
        if not self.max_pending:
            return 0.0
        return len(self._pending) / self.max_pending


def latency_summary(entries: Iterable[SlotEntry]) -> Dict[str, float]:
    """Aggregate per-request latency stats over retired entries.

    Returns mean/p50/p95/max of end-to-end latency plus mean queue-wait and
    mean service time, all in milliseconds ({} for no entries).
    """
    done = [e for e in entries if e.retired_at > 0.0]
    if not done:
        return {}
    lat = sorted(e.latency_s for e in done)
    n = len(lat)
    return {
        "n": float(n),
        "latency_ms_mean": 1e3 * sum(lat) / n,
        "latency_ms_p50": 1e3 * lat[n // 2],
        "latency_ms_p95": 1e3 * lat[min(n - 1, (95 * n) // 100)],
        "latency_ms_max": 1e3 * lat[-1],
        "wait_ms_mean": 1e3 * sum(e.wait_s for e in done) / n,
        "service_ms_mean": 1e3 * sum(e.service_s for e in done) / n,
    }
