"""CPU tests of the ``attention_kernel.*`` readers: the share of the
``attention.scores`` spans that hold an ``attention.kernel`` span, on
hand-made records and on a real CPU forward's (which launches no kernel),
and None where there is nothing to read (another cell's kind, no
records, dropped spans, a program without the fused kernel or without
tracing)."""

from __future__ import annotations

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

READERS = {"attention_kernel.prefill": "prefill",
           "attention_kernel.train": "train"}


def _rec(name, parent=None):
    return dict(name=name, id=1, parent=parent, main=True, t0=0.0, t1=1.0,
                device_s=0.5, counters=None)


def _records(held):
    """A forward's span and one ``attention.scores`` span a layer, the
    first ``held`` of them around a kernel launch."""
    recs = [_rec("model.forward")]
    for i in range(4):
        recs.append(_rec("attention.scores", parent=0))
        if i < held:
            recs.append(_rec("attention.kernel", parent=len(recs) - 1))
    return recs


def _ctx(kind):
    return SimpleNamespace(kind=kind, units=2, window_s=20.0, busy_s=19.0)


@pytest.fixture
def recs(monkeypatch):
    got = []
    monkeypatch.setattr(tracing, "records", lambda: got)
    monkeypatch.setitem(tracing.COUNTS, "dropped", 0)
    return got


@pytest.mark.parametrize("held", [4, 2, 0])
@pytest.mark.parametrize("name", READERS)
def test_share_of_scores_spans_holding_a_kernel_span(name, recs, held):
    recs.extend(_records(held))
    assert spec.reader(name)(_ctx(READERS[name])) == 100.0 * held / 4


@pytest.mark.parametrize("name", READERS)
def test_reads_only_its_kind_of_cell(name, recs):
    recs.extend(_records(4))
    other = {"train": "prefill", "prefill": "train"}[READERS[name]]
    assert spec.reader(name)(_ctx(other)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_none(name, recs):
    assert spec.reader(name)(_ctx(READERS[name])) is None
    recs.append(_rec("model.forward"))
    assert spec.reader(name)(_ctx(READERS[name])) is None
    recs.extend(_records(4))
    tracing.COUNTS["dropped"] = 1
    assert spec.reader(name)(_ctx(READERS[name])) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_kernel_reads_none(name, recs, monkeypatch):
    """As on a program without ``repro_torch.kernels.gqa_attention`` (its
    ``attention.scores`` spans notwithstanding)."""
    recs.extend(_records(0))
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.gqa_attention",
                        None)
    assert spec.reader(name)(_ctx(READERS[name])) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_tracing_reads_none(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    assert spec.reader(name)(_ctx(READERS[name])) is None


def test_a_cpu_forward_reads_no_kernel():
    """Real records of a smoke-size forward on the CPU: one
    ``attention.scores`` span a layer, none with a kernel launch inside
    (the fused kernel runs on CUDA only)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    cfg = registry.get_config("internlm2-1.8b-smoke")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    tracing.reset()
    tracing.enable()
    try:
        with torch.no_grad():
            T.forward(params, cfg, tokens)
        n = sum(r["name"] == "attention.scores" for r in tracing.records())
        share = spec.reader("attention_kernel.prefill")(_ctx("prefill"))
    finally:
        tracing.disable()
        tracing.reset()
    assert n == cfg.n_layers and share == 0.0
