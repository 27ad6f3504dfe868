"""The port's spans and counters (``repro_torch.tracing``) on the CPU: off,
a train step and a forward record nothing; on (under ``torch.profiler``
or after ``tracing.enable()``), a step records its phases with their
parents and one id, every child inside its parent; a collection inside a
counted span is counted; tracing changes no value of the step; the
records are bounded; ``span_at`` names the innermost span of the main
thread. The ``cuda`` test holds each span's device time to its host
interval on the card."""

import gc
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.train import train_loop as TL  # noqa: E402

#: the train step's spans and the parent each is opened in
STEP_PARENTS = {
    "train_step": {None},
    "train_step.accumulators": {"train_step"},
    "train_step.forward": {"train_step"},
    "train_step.backward": {"train_step"},
    "train_step.accumulate": {"train_step"},
    "train_step.optimizer": {"train_step"},
    "model.forward": {"train_step.forward"},
    # the forward's, and the checkpointed blocks' recomputed in the
    # backward (on the CPU the engine runs on the calling thread)
    "attention.scores": {"model.forward", "train_step.backward"},
}


@pytest.fixture(autouse=True)
def _clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _case(device="cpu", ga=2):
    cfg = registry.get_config("internlm2-1.8b-smoke")
    tcfg = TL.TrainConfig(optimizer=O.AdamWConfig(lr=1e-2, warmup_steps=1),
                          grad_accum=ga)
    state = TL.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                device)
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                                device=device)
             for k in ("tokens", "labels")}
    return cfg, TL.make_train_step(cfg, tcfg), state, batch


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if t is not None]


def test_off_a_step_and_a_forward_record_nothing():
    cfg, step, state, batch = _case()
    assert tracing.span("a") is tracing.span("b")       # one shared no-op
    step(state, batch)
    with torch.no_grad():
        T.forward(state.params, cfg, batch["tokens"], logits_mode="last")
    assert tracing.records() == [] and tracing.gc_pauses() == []


def test_a_step_records_its_phases_under_the_profiler():
    _, step, state, batch = _case(ga=2)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
    recs = tracing.records()
    names = [r["name"] for r in recs]
    assert set(names) == set(STEP_PARENTS)
    for r in recs:
        parent = None if r["parent"] is None else recs[r["parent"]]
        assert (parent and parent["name"]) in STEP_PARENTS[r["name"]] \
            or (parent is None and None in STEP_PARENTS[r["name"]]), r
        if parent is not None:
            assert parent["t0"] <= r["t0"] <= r["t1"] <= parent["t1"]
        assert r["main"] and r["device_s"] is None       # no CUDA here
    (first,) = {r["id"] for r in recs}
    assert names.count("train_step.forward") == 2
    assert names.count("train_step.backward") == 2
    assert names.count("train_step") == 1
    # one accumulate a microbatch, and the division
    assert names.count("train_step.accumulate") == 3
    counted = recs[names.index("train_step")]["counters"]
    assert set(counted) == {"gc_collections", "gc_s"}
    assert all(r["counters"] is None for r in recs if r["name"] !=
               "train_step")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
    assert {r["id"] for r in tracing.records()} == {first + 1}


def test_a_forward_records_its_attention_under_its_span():
    cfg, _, state, batch = _case()
    tracing.enable()
    with torch.no_grad():
        T.forward(state.params, cfg, batch["tokens"], logits_mode="last")
    recs = tracing.records()
    assert [r["name"] for r in recs] == \
        ["model.forward"] + ["attention.scores"] * cfg.n_layers
    assert all(r["parent"] == 0 for r in recs[1:])
    assert len({r["id"] for r in recs}) == 1


def test_tracing_changes_no_value_of_the_step():
    outs = []
    for on in (False, True):
        _, step, state, batch = _case(ga=2)
        if on:
            tracing.enable()
        outs.append(step(state, batch))
        tracing.disable()
    (s0, m0), (s1, m1) = outs
    assert tracing.records()
    a, b = _leaves(s0), _leaves(s1)
    assert len(a) == len(b) > 10
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_a_collection_inside_a_counted_span_is_counted():
    tracing.enable()
    was = gc.isenabled()
    gc.disable()                      # no collection but the forced one
    try:
        with tracing.span("outer", counters=True):
            with tracing.span("inner"):
                gc.collect()
    finally:
        if was:
            gc.enable()
    outer, inner = tracing.records()
    assert outer["counters"]["gc_collections"] == 1
    assert outer["counters"]["gc_s"] > 0 and inner["counters"] is None
    (p0, p1, gen), = tracing.gc_pauses()
    assert inner["t0"] <= p0 <= p1 <= inner["t1"] and gen == 2


def test_span_at_names_the_innermost_span_of_the_main_thread():
    tracing.enable()
    seen = {}

    def other():
        with tracing.span("other"):
            seen["other"] = time.perf_counter()
    with tracing.span("outer"):
        seen["outer"] = time.perf_counter()
        with tracing.span("inner"):
            seen["inner"] = time.perf_counter()
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        seen["after_inner"] = time.perf_counter()
    seen["after"] = time.perf_counter()
    assert tracing.span_at(seen["outer"]) == "outer"
    assert tracing.span_at(seen["inner"]) == "inner"
    # a span of another thread is not the main thread's
    assert tracing.span_at(seen["other"]) == "inner"
    assert tracing.span_at(seen["after_inner"]) == "outer"
    assert tracing.span_at(seen["after"]) is None
    recs = {r["name"]: r for r in tracing.records()}
    # opened on another thread inside a top-level span: its id, no parent
    assert recs["other"]["parent"] is None and not recs["other"]["main"]
    assert recs["other"]["id"] == recs["outer"]["id"]
    assert recs["inner"]["parent"] == 0


def test_the_records_are_bounded_and_count_what_they_drop(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("x"):
            pass
    assert len(tracing.records()) == 3 and tracing.COUNTS["dropped"] == 2
    tracing.reset()
    assert tracing.records() == [] and tracing.COUNTS["dropped"] == 0


@pytest.mark.cuda
def test_cuda_device_times_lie_inside_the_host_intervals():
    """On the card, under a CUDA-only profiler as the benchmark's trace
    runs one: every span's device seconds are positive and no longer than
    the time from its host start to a final synchronise; the step's
    counters carry the allocator's counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    _, step, state, batch = _case("cuda", ga=2)
    step(state, batch)                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        step(state, batch)
        torch.cuda.synchronize()
        t_sync = time.perf_counter()
    recs = tracing.records()
    assert {r["name"] for r in recs} == set(STEP_PARENTS)
    for r in recs:
        assert 0 < r["device_s"] <= t_sync - r["t0"], r
    counted = [r["counters"] for r in recs if r["name"] == "train_step"]
    assert set(tracing.ALLOC_KEYS) <= set(counted[0])
