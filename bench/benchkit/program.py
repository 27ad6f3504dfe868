"""What the harness takes from the program under test (``repro_torch``):
its model configuration, held to the configuration file, and its
launch counters. Imported only once the run has passed the import guard
and found its device."""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Iterator

import torch


def model_config(config: Dict[str, Any]):
    """The program's ``ModelConfig`` for ``config["program_arch"]``, after
    every size the configuration file maps to it (``program_fields``) is
    found equal; raises ``ValueError`` where one differs: the program
    would run another model than the file states."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(config["program_arch"])
    check_fields(cfg, config)
    return cfg


def check_fields(cfg, config: Dict[str, Any]) -> None:
    wrong = {}
    for key, path in config["program_fields"].items():
        got = functools.reduce(getattr, path.split("."), cfg)
        if got != config[key]:
            wrong[key] = (config[key], got)
    if wrong:
        raise ValueError(f"the program's {cfg.name} differs from the "
                         f"configuration file: {wrong}")


def _launch_tables():
    from repro_torch.kernels import moe_gate, rnl_neuron, ssd_scan, unary_topk
    return (moe_gate.LAUNCHES, rnl_neuron.LAUNCHES, ssd_scan.LAUNCHES,
            unary_topk.LAUNCHES)


def reset_counters() -> None:
    for table in _launch_tables():
        for k in table:
            table[k] = 0


def counters() -> Dict[str, int]:
    """The port's kernel launch counts since :func:`reset_counters`."""
    return {k: v for table in _launch_tables() for k, v in table.items()}


# ------------------------------------------------------------ the device
def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def release(dev: torch.device) -> None:
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class NoTrace:
    """The window's spans when nothing is traced."""

    def __enter__(self) -> "NoTrace":
        return self

    def __exit__(self, *exc) -> None:
        return None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        yield
