"""The card: its name and power limit, and what the profiler's trace of
a window says (device busy time, idle gaps, device time by op).

:func:`device_events` and :func:`device_share` are copies of
``chip_smoke.py``'s, proven on the card; the rest reads the same trace.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

#: cycles of the marker kernel launched at the traced window's start: its
#: device start, against the host clock read just before its launch, puts
#: the host's spans on the trace's clock
MARK_CYCLES = 1000
MARKS = 4
MARKER = "spin_kernel"


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[0] if lines else None


def device_events(prof):
    """The profile's CUDA activity (kernels and copies), one entry a name."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_share(dev_events, wall_ms):
    """Device busy time (the sum of the CUDA activity ``dev_events``), the
    idle share 1 - busy / wall, and the top device ops."""
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                device_ops=sum(e.count for e in dev_events),
                top=[dict(name=e.key[:80], count=e.count,
                          ms=e.self_device_time_total / 1e3) for e in top])


class Trace:
    """``torch.profiler`` over a window, device activity only (a host op
    record a launch would add to the host's time), and the benchmark's
    own host spans (:meth:`span`) to name the idle gaps by."""

    def __init__(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.spans: List[Tuple[str, float, float]] = []
        self.mark = 0.0

    def __enter__(self) -> "Trace":
        self.prof.__enter__()
        # the first launches under the profiler are slow to start: the
        # marker that sets the clock is the last of a few
        for _ in range(MARKS):
            torch.cuda.synchronize()
            self.mark = time.perf_counter()
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def summary(self, t0: float, t1: float) -> Dict[str, Any]:
        """Busy seconds, device time by op, and the longest idle gaps of
        the host window ``[t0, t1]`` (perf_counter seconds)."""
        evs = [e for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = [e for e in evs if MARKER in e.name]
        ops = [e for e in device_events(self.prof) if MARKER not in e.key]
        share = device_share(ops, 1e3 * (t1 - t0))
        by_name = {e.key: (e.count, e.self_device_time_total / 1e6)
                   for e in ops}
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        out = dict(busy_s=share["device_busy_ms"] / 1e3, window_s=t1 - t0,
                   ops=by_name, device_ops=[[k, v[1]] for k, v in top],
                   idle_gaps=[])
        if marks:
            # trace microseconds = host microseconds + offset
            offset = max(e.time_range.start for e in marks) - 1e6 * self.mark
            out["idle_gaps"] = self._gaps(
                [e for e in evs if MARKER not in e.name], offset, t0, t1)
        return out

    def _gaps(self, evs, offset: float, t0: float, t1: float
              ) -> List[List[Any]]:
        """The ten longest stretches of ``[t0, t1]`` with no device
        activity, each named by the host span it began in and the device
        op that ended it."""
        lo, hi = 1e6 * t0 + offset, 1e6 * t1 + offset
        ivs = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in evs if e.time_range.end > lo
                     and e.time_range.start < hi)
        gaps, edge = [], lo
        for start, end, name in ivs:
            if start > edge:
                gaps.append((start - edge, edge, name))
            edge = max(edge, end)
        if hi > edge:
            gaps.append((hi - edge, edge, "(window end)"))

        def host_span(at_us: float) -> str:
            at = (at_us - offset) / 1e6
            for name, s0, s1 in self.spans:
                if s0 <= at < s1:
                    return name
            return "between spans"
        gaps.sort(key=lambda g: -g[0])
        return [[f"{host_span(at)}: before {name[:60]}", length / 1e6]
                for length, at, name in gaps[:10]]
