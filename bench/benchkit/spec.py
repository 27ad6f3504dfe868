"""Finding a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names (``bench/configs/``),
  whose ``reference`` names its plain reference,
  ``bench/references/<reference>.py``;
- a traffic mix: ``bench/traffic/<traffic>.json``, whose ``kind`` names
  the driver that runs it, ``benchkit/<kind>.py``;
- a cell's limits on what ``correct`` compares:
  ``bench/limits/<cell>.json``;
- a per-layer metric: its reader, ``bench/metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Any, Callable, Dict, List

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """Everything one run of a cell reads."""
    name: str
    entry: Dict[str, Any]          # its ``workloads`` entry
    config: Dict[str, Any]         # the configuration file
    mix: Dict[str, Any]            # the traffic file
    limits: Dict[str, float]       # what ``correct`` compares, and limits
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(f"references.{self.config['reference']}")

    @property
    def driver(self) -> ModuleType:
        return importlib.import_module(f"benchkit.{self.mix['kind']}")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Dict[str, Any] | None = None,
         limits: Dict[str, float] | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (default ``BENCHMARK.json``), its
    limits from ``limits/<name>.json`` unless given; raises ``KeyError``
    for a name it does not hold."""
    bench = benchmark() if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in names
             and _applies(m, name)]
    return Cell(name=name, entry=entry, config=_json(ROOT / conf["file"]),
                mix=_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(BENCH / "limits" / f"{name}.json")
                if limits is None else limits,
                end_to_end=e2e, per_layer=layer)


def reader(metric: str) -> Callable[[Any], Any]:
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
