"""One run of one cell:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
``correct`` compares, beside its limit (also the last lines of standard
error). Exits non-zero, printing no result, without a CUDA device, with
fewer devices than the cell asks for, or when JAX or the JAX package is
loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

from benchkit import guard


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="run one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def _layer_metrics(cell, out: Dict[str, Any]) -> Dict[str, Any]:
    """Each per-layer metric's reader over the traced window; a reader
    that finds nothing to read returns None and the metric is left out."""
    from benchkit import counts, spec
    tr = out["trace"]
    ctx = SimpleNamespace(
        cell=cell.name, kind=cell.mix["kind"], config=cell.config,
        mix=cell.mix, units=out["units"], window_s=tr["window_s"],
        busy_s=tr["busy_s"], ops=tr["ops"], counters=out["counters"],
        flops_per_unit=counts.model_flops(cell.reference, cell.config,
                                          cell.mix))
    got = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Whether every number compared is within its limit, and each number
    beside its limit."""
    checks = {k: {"value": readings[k], "limit": lim}
              for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float, **hooks) -> Tuple[Dict[str, Any], List[str]]:
    """The result line of one run of ``cell`` on ``dev``, and the lines
    that name each compared number beside its limit. ``hooks`` go to the
    mix's driver (a planted fault, in the tests)."""
    import torch
    from benchkit import device, program
    tracer = device.Trace() if trace else program.NoTrace()
    out = cell.driver.run(cell, seed, seconds, tracer, dev, **hooks)
    within, checks = judge(out["readings"], cell.limits)
    correct = bool(out["sound"]) and within
    if trace:
        metrics = _layer_metrics(cell, out)
    else:
        e2e = dict(out["e2e"], setup_s=out["t_window"] - t_start)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    cuda = dev.type == "cuda"
    dev_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": out["memory_peak_bytes"],
        "power_limit": device.power_limit() if cuda else None}
    result: Dict[str, Any] = {
        "correct": correct, "attempted": out["attempted"],
        "failed": out["failed"], "metrics": metrics, "device": dev_info,
        "readings": out["readings"], "counters": out["counters"]}
    if trace:
        tr = out["trace"]
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    return result, lines


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parser().parse_args(argv)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"bench: loaded at start: {bad}", file=sys.stderr)
        return 3
    import torch
    from benchkit import spec
    cell = spec.cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), t_start)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"bench: loaded once the window had closed: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
