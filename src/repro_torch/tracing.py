"""Spans and counters inside the port's train step and forward.

A span (:func:`span`) brackets one phase of the work. It records its name,
the span it was opened inside (a stack per thread), the id of the
top-level span it belongs to (a count kept on the host: no device tensor
is read for it), its host start and end on ``time.perf_counter()`` (the
clock a benchmark's trace is placed on), and, once CUDA is in use, a pair
of timing events on the current stream at its edges. Device durations are
resolved only when the records are read (:func:`records`), after the
work: no span synchronises. A span opened on another thread while a
top-level span is open (the autograd engine's thread on the card, which
recomputes checkpointed blocks in the backward) takes that span's id and
no parent.

Spans record only while ``torch.profiler`` is collecting, or between
:func:`enable` and :func:`disable`. Otherwise :func:`span` returns one
shared object that records nothing. They are not profiler annotations
(``record_function``, NVTX): a trace that sums its device-typed events
would count those as busy time.

Counters, read at the edges of a span opened with ``counters=True`` (the
train step): Python's garbage collections (their count and host seconds,
from ``gc.callbacks``) and the CUDA caching allocator's ``cudaMalloc``
and ``cudaFree`` calls (the ``torch.cuda.memory_stats()`` counts in
:data:`ALLOC_KEYS`).

The records are module-level, as the kernels' ``LAUNCHES`` tables are:
at most :data:`MAX_SPANS` spans until :func:`reset`, the others counted
in ``COUNTS["dropped"]``. Call :func:`reset` with no span open.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

#: the spans kept until :func:`reset`
MAX_SPANS = 1 << 16
#: the caching allocator's counts a counted span reads
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")
#: ``dropped``: spans not kept since :func:`reset` (the records were full)
COUNTS: Dict[str, int] = {"dropped": 0}

_profiling = torch._C._autograd._profiler_enabled
_forced = False
_spans: List["_Span"] = []
_pool: List[Any] = []              # timing events, reused after a reset
_local = threading.local()         # .stack: this thread's open spans
_top: Optional[int] = None         # the id of the open top-level span
_next_id = 0
#: every collection's count and host seconds since the hook went in
_gc = {"collections": 0, "seconds": 0.0, "start": None, "hooked": False}
_pauses: List[Tuple[float, float, int]] = []


class _Off:
    """What :func:`span` returns while nothing records."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def _recording() -> bool:
    return _forced or _profiling()


def span(name: str, counters: bool = False):
    """A context manager that records the phase ``name`` while tracing is
    on (see the module docstring); ``counters``: read the garbage
    collector's and the allocator's counts at its edges."""
    if not _recording():
        return _OFF
    if len(_spans) >= MAX_SPANS:
        COUNTS["dropped"] += 1
        return _OFF
    return _Span(name, counters)


def enable() -> None:
    """Record spans without a profiler (tests)."""
    global _forced
    _forced = True


def disable() -> None:
    global _forced
    _forced = False


def _event():
    try:
        return _pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _gc_hook(phase: str, info: Dict[str, Any]) -> None:
    now = time.perf_counter()
    if phase == "start":
        _gc["start"] = now
    elif _gc["start"] is not None:
        _gc["collections"] += 1
        _gc["seconds"] += now - _gc["start"]
        if _recording() and len(_pauses) < MAX_SPANS:
            _pauses.append((_gc["start"], now, info["generation"]))
        _gc["start"] = None


def _counts() -> Dict[str, float]:
    out = {"gc_collections": _gc["collections"], "gc_s": _gc["seconds"]}
    if torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        out.update((k, stats.get(k, 0)) for k in ALLOC_KEYS)
    return out


class _Span:
    __slots__ = ("name", "counted", "index", "id", "parent", "main", "t0",
                 "t1", "ev0", "ev1", "device_s", "counters", "top")

    def __init__(self, name: str, counted: bool) -> None:
        self.name, self.counted = name, counted
        self.t1 = self.ev0 = self.ev1 = self.device_s = None
        self.counters: Optional[Dict[str, float]] = None
        self.top = False

    def __enter__(self) -> "_Span":
        global _top, _next_id
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent, self.id = stack[-1].index, stack[-1].id
        elif _top is not None:          # inside another thread's span
            self.parent, self.id = None, _top
        else:
            _next_id += 1
            self.parent, self.id, self.top = None, _next_id, True
            _top = self.id
        stack.append(self)
        self.index = len(_spans)
        _spans.append(self)
        self.main = threading.current_thread() is threading.main_thread()
        if self.counted:
            if not _gc["hooked"]:
                gc.callbacks.append(_gc_hook)
                _gc["hooked"] = True
            self.counters = _counts()
        # host start, then the device's: the device interval starts
        # inside the host one
        self.t0 = time.perf_counter()
        if torch.cuda.is_initialized():
            self.ev0 = _event()
            self.ev0.record()
        return self

    def __exit__(self, *exc) -> None:
        global _top
        if self.ev0 is not None:
            self.ev1 = _event()
            self.ev1.record()
        self.t1 = time.perf_counter()
        if self.counted:
            start = self.counters
            self.counters = {k: v - start[k] for k, v in _counts().items()}
        _local.stack.pop()
        if self.top:
            _top = None
        return None


def records() -> List[Dict[str, Any]]:
    """Every kept span in the order they opened: ``name``, ``id`` (of its
    top-level span), ``parent`` (the index of its parent in this list, or
    None), ``main`` (opened on the main thread), host ``t0`` and ``t1``
    (``time.perf_counter()`` seconds; ``t1`` None while open),
    ``device_s`` (seconds of the device timeline between its two events;
    None without CUDA or while open) and ``counters`` (a counted span's
    changes: ``gc_collections``, ``gc_s`` and, on CUDA,
    :data:`ALLOC_KEYS`; else None). Waits for the spans' end events."""
    out = []
    for s in _spans:
        if s.device_s is None and s.ev1 is not None:
            s.ev1.synchronize()
            s.device_s = s.ev0.elapsed_time(s.ev1) / 1e3
        out.append(dict(name=s.name, id=s.id, parent=s.parent, main=s.main,
                        t0=s.t0, t1=s.t1, device_s=s.device_s,
                        counters=s.counters))
    return out


def gc_pauses() -> List[Tuple[float, float, int]]:
    """(host start, host end, generation) of each garbage collection that
    ran while spans recorded, since :func:`reset`."""
    return list(_pauses)


def span_at(t: float) -> Optional[str]:
    """The name of the innermost span open on the main thread at host time
    ``t`` (``time.perf_counter()`` seconds), or None."""
    name = None
    for s in _spans:                    # in the order they opened
        if s.main and s.t0 <= t and (s.t1 is None or t < s.t1):
            name = s.name
    return name


def reset() -> None:
    """Forget every span, pause and drop; the events go back to the
    pool."""
    global _top
    for s in _spans:
        _pool.extend(e for e in (s.ev0, s.ev1) if e is not None)
    _spans.clear()
    _pauses.clear()
    COUNTS["dropped"] = 0
    _top = None
    _local.stack = []
