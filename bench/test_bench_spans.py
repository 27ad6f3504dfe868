"""CPU tests of the per-layer metrics that read the program's spans and
counters (``repro_torch.tracing``): each reader's per-unit arithmetic on
hand-made records, and None where there is nothing to read (no module,
no records, dropped spans, another cell's kind, no device times)."""

from __future__ import annotations

import math
import pathlib
import sys
from types import SimpleNamespace

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import spec  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import tracing  # noqa: E402

#: each reader: its cell's kind, and the sum its records give per unit
#: over :func:`_records`
READERS = {
    "attention_s.prefill": ("prefill", 0.5 + 0.25 + 0.125),
    "forward_s.train": ("train", 2.0 + 2.5),
    "backward_s.train": ("train", 6.0 + 6.5),
    "optimizer_s.train": ("train", 0.25),
    "gc_s.train": ("train", 0.03 + 0.06),
    "cuda_mallocs.train": ("train", (4 + 3) + (0 + 1)),
}
UNITS = 2


def _rec(name, device_s=None, counters=None, parent=None):
    return dict(name=name, id=1, parent=parent, main=True, t0=0.0, t1=1.0,
                device_s=device_s, counters=counters)


def _records():
    """Two steps' and a forward's spans, as :func:`tracing.records` gives
    them on the card."""
    alloc = dict(num_device_alloc=0, num_device_free=0, num_alloc_retries=0)
    return [
        _rec("train_step", 9.0, dict(alloc, gc_collections=1, gc_s=0.03,
                                     num_device_alloc=4, num_device_free=3)),
        _rec("train_step.forward", 2.0, parent=0),
        _rec("train_step.backward", 6.0, parent=0),
        _rec("train_step.optimizer", 0.25, parent=0),
        _rec("train_step", 9.5, dict(alloc, gc_collections=2, gc_s=0.06,
                                     num_device_free=1, num_alloc_retries=5)),
        _rec("train_step.forward", 2.5, parent=4),
        _rec("train_step.backward", 6.5, parent=4),
        _rec("model.forward", 12.0),
        _rec("attention.scores", 0.5, parent=7),
        _rec("attention.scores", 0.25, parent=7),
        _rec("attention.scores", 0.125, parent=7),
    ]


def _ctx(kind, units=UNITS):
    return SimpleNamespace(kind=kind, units=units, window_s=20.0,
                           busy_s=19.0)


@pytest.fixture
def recs(monkeypatch):
    """The records the readers see; the test may edit the list."""
    got = _records()
    monkeypatch.setattr(tracing, "records", lambda: got)
    monkeypatch.setitem(tracing.COUNTS, "dropped", 0)
    return got


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_its_sum_per_unit(name, recs):
    kind, total = READERS[name]
    assert math.isclose(spec.reader(name)(_ctx(kind)), total / UNITS)
    assert math.isclose(spec.reader(name)(_ctx(kind, units=1)), total)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_only_its_kind_of_cell(name, recs):
    other = {"train": "prefill", "prefill": "train"}[READERS[name][0]]
    assert spec.reader(name)(_ctx(other)) is None
    assert spec.reader(name)(_ctx(READERS[name][0], units=0)) is None


@pytest.mark.parametrize("name", READERS)
def test_no_records_read_none(name, recs):
    recs.clear()
    assert spec.reader(name)(_ctx(READERS[name][0])) is None


@pytest.mark.parametrize("name", READERS)
def test_dropped_spans_read_none(name, recs):
    tracing.COUNTS["dropped"] = 1
    assert spec.reader(name)(_ctx(READERS[name][0])) is None


@pytest.mark.parametrize("name", READERS)
def test_without_the_module_a_reader_reads_none(name, monkeypatch):
    """As on a program that has no ``repro_torch.tracing``."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    assert spec.reader(name)(_ctx(READERS[name][0])) is None


@pytest.mark.parametrize("name", ["attention_s.prefill", "forward_s.train",
                                  "backward_s.train", "optimizer_s.train",
                                  "cuda_mallocs.train"])
def test_cpu_records_give_no_device_number(name, recs):
    """Spans recorded without CUDA carry no device seconds and no
    allocator counts: no device metric is read from them."""
    for r in recs:
        r["device_s"] = None
        if r["counters"]:
            r["counters"] = dict(gc_collections=0, gc_s=0.0)
    assert spec.reader(name)(_ctx(READERS[name][0])) is None


def test_a_cpu_step_gives_its_collections_and_nothing_else():
    """Real records of a smoke-size step on the CPU: the counters' GC
    seconds are read; the device metrics read None."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.optim import optimizers as O
    from repro_torch.train import train_loop as TL
    cfg = registry.get_config("internlm2-1.8b-smoke")
    tcfg = TL.TrainConfig(optimizer=O.AdamWConfig(warmup_steps=1),
                          grad_accum=2)
    state = TL.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                "cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 8))
             for k in ("tokens", "labels")}
    tracing.reset()
    tracing.enable()
    try:
        TL.make_train_step(cfg, tcfg)(state, batch)
    finally:
        tracing.disable()
    try:
        ctx = _ctx("train", units=1)
        assert spec.reader("gc_s.train")(ctx) >= 0.0
        for name in ("forward_s.train", "backward_s.train",
                     "optimizer_s.train", "cuda_mallocs.train"):
            assert spec.reader(name)(ctx) is None
    finally:
        tracing.reset()
