"""Durability of the port's serving engine: snapshots, ``resume=True``,
``restore()``, ``serve_resilient`` and ``AsyncTNNEngine``.

Mirrors ``tests/test_serve_learn.py``'s durability tests (snapshot cadence
and resume, step-consistent async snapshots, ``serve_resilient``
bit-exact with learning off, the learning trajectory replayed with and
without ``stdp_seed``, no snapshot restoring the initial weights, restarts
running out, restore clearing the pool) and ``tests/test_serve_tnn.py``'s
``AsyncTNNEngine`` tests (async equals sync, a failed pump rejects waiting
clients, transient ``QueueFull`` retried, the retry budget raised). The
reference's pump test overwrites its engine's jitted step; here
``network.forward`` is monkeypatched instead.

Against the reference (weights carried across as numpy): the same
``serve_resilient`` run reports the same restores and resubmissions and
returns the same outputs, and a snapshot written by either package
resumes in both, outputs bit for bit, weights within 1e-5 with the
rounded weights equal where learning is on (the reference's jitted
trainers divide by the reciprocal; ``torch.Generator`` cannot reproduce
``jax.random``, so only the expectation rule crosses). On one device
every comparison is exact. The ``cuda``-marked tests at the end hold the
same on the card and skip without one.
"""

import asyncio
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import coding, layer, network  # noqa: E402
from repro_torch.kernels import rnl_neuron  # noqa: E402
from repro_torch.serve import tnn_engine  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import fault_tolerance as FT  # noqa: E402

NO_SPIKE = coding.NO_SPIKE
STREAM_ATOL = 1e-5


def _kws(recurrent=True):
    # the reference test's layer 2 is its "rnl" dendrite, the full PC; the
    # port names it pc_compact
    return [dict(n_columns=2, rf_size=4, n_neurons=3, threshold=5,
                 t_steps=12, dendrite="catwalk", k=2),
            dict(n_columns=3, rf_size=2, n_neurons=2, threshold=4,
                 t_steps=12, dendrite="pc_compact", recurrent=recurrent)]


@pytest.fixture(scope="module")
def ref():
    """The reference package. Imported here, not at the top, so the
    ``cuda`` tests below also run on a GPU machine without JAX."""
    jax = pytest.importorskip("jax")
    from repro.core import layer as jlayer
    from repro.core import network as jnetwork
    from repro.serve import tnn_engine as jengine
    from repro.train import fault_tolerance as jft
    return types.SimpleNamespace(jax=jax, layer=jlayer, network=jnetwork,
                                 engine=jengine, FT=jft)


def _setup(ref, recurrent=True, seed=0, kws=None):
    """The same network in both packages and the reference's weights,
    also as numpy."""
    kws = kws or _kws(recurrent)
    jn = ref.network.make_network([ref.layer.TNNLayer(**kw) for kw in kws])
    tn = network.make_network([layer.TNNLayer(**kw) for kw in kws])
    pj = ref.network.init_network(ref.jax.random.PRNGKey(seed), jn)
    return jn, tn, pj, [np.asarray(p) for p in pj]


def _port_net(recurrent=True):
    """The port's network and its own seeded weights as numpy (no JAX)."""
    tn = network.make_network([layer.TNNLayer(**kw) for kw in _kws(recurrent)])
    return tn, [p.numpy() for p in network.init_network(
        torch.Generator().manual_seed(0), tn, "cpu")]


def _streams(n_inputs, n_req, max_cycles=4, min_cycles=1, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        n_cyc = int(rng.integers(min_cycles, max_cycles + 1))
        t = rng.integers(0, 20, size=(n_cyc, n_inputs))
        out.append(np.where(t >= 10, NO_SPIKE, t).astype(np.int32))
    return out


def _scfg(**kw):
    kw.setdefault("backend", "closed_form")
    return tnn_engine.TNNServeConfig(**kw)


def _engine(params_np, tn, device="cpu", resume=False, **kw):
    return tnn_engine.TNNEngine(convert.params_from_numpy(params_np, device),
                                tn, _scfg(**kw), device=device,
                                resume=resume)


def _template(params_np, device="cpu"):
    return {"params": convert.params_from_numpy(params_np, device),
            "counters": np.zeros(2, np.int32)}


def _weights_equal(ps_a, ps_b):
    return all(torch.equal(a, b) for a, b in zip(ps_a, ps_b))


def _close(want, got, atol=STREAM_ATOL):
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.cpu().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)
        np.testing.assert_array_equal(np.round(b), np.round(a))


def _one_shot_failure(at_step, host_id=1, ft=FT):
    fired = []

    def injector(step_id):
        if step_id >= at_step and not fired:
            fired.append(step_id)
            raise ft.WorkerFailure(host_id, "(injected)")

    return injector


# ------------------------------------------------------- validation
def test_durability_config_validation(ref):
    _, tn, _, pn = _setup(ref)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _engine(pn, tn, checkpoint_every=10)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _engine(pn, tn, checkpoint_every=-1)
    with pytest.raises(ValueError, match="resume"):
        _engine(pn, tn, resume=True)
    with pytest.raises(ValueError, match="restore"):
        _engine(pn, tn).restore()
    st = _engine(pn, tn).stats()
    assert st["n_snapshots"] == 0.0 and st["n_restores"] == 0.0


# ------------------------------------------------- snapshots + resume
def test_snapshot_cadence_and_resume(ref, tmp_path):
    jn, tn, pj, pn = _setup(ref)
    kw = dict(n_slots=2, learn=True, checkpoint_dir=str(tmp_path),
              checkpoint_every=2, checkpoint_keep=100,
              checkpoint_async=False)
    streams = [s[:3] for s in _streams(tn.n_inputs, 4, 3, 3)]
    eng = _engine(pn, tn, **kw)
    eng.serve(streams)
    eng.checkpoint_wait()
    assert eng.n_snapshots == eng.step_id // 2
    assert eng.stats()["n_snapshots"] == eng.n_snapshots
    assert CK.latest_step(tmp_path) == (eng.step_id // 2) * 2
    # a fresh engine resumes from the latest snapshot: weights + counters
    eng2 = _engine(pn, tn, resume=True, **kw)
    assert eng2.step_id == CK.latest_step(tmp_path)
    assert eng2.n_restores == 1 and eng2.stats()["n_restores"] == 1.0
    snap = CK.restore_checkpoint(tmp_path, _template(pn))
    assert _weights_equal(eng2.params, snap["params"])
    assert eng2.n_stdp_updates == int(snap["counters"][1])
    # drift is measured from the resumed weights
    assert eng2.stats()["weight_drift_l0"] == 0.0
    # resume with an empty dir is a clean cold start
    eng3 = _engine(pn, tn, resume=True, n_slots=2,
                   checkpoint_dir=str(tmp_path / "empty"),
                   checkpoint_every=2)
    assert eng3.step_id == 0 and eng3.n_restores == 0
    # the reference wrote the same snapshots at the same steps
    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        backend="closed_form", **dict(kw, checkpoint_dir=str(
            tmp_path / "ref"))))
    jeng.serve(streams)
    jeng.checkpoint_wait()
    assert jeng.n_snapshots == eng.n_snapshots
    assert sorted(p.name for p in (tmp_path / "ref").glob("step_*")) == \
        sorted(p.name for p in tmp_path.glob("step_*"))


def test_async_snapshot_is_step_consistent(ref, tmp_path):
    """The async writer saves the weights as of its step: they are copied
    to the host before the thread starts, so later STDP updates never
    reach an in-flight save."""
    _, tn, _, pn = _setup(ref, recurrent=False)
    eng = _engine(pn, tn, n_slots=2, learn=True,
                  checkpoint_dir=str(tmp_path), checkpoint_every=10,
                  checkpoint_keep=100, checkpoint_async=True)
    streams = [s[:25] for s in _streams(tn.n_inputs, 2, 25, 25)]
    for s in streams:
        eng.submit(s)
    while eng.pool.has_work and eng.n_snapshots == 0:
        eng.step()
    at_snap = tuple(p.clone() for p in eng.params)
    while eng.pool.has_work:
        eng.step()          # keep learning while the writer may still run
    eng.checkpoint_wait()
    assert eng.step_id == 25 and eng.n_snapshots == 2
    snap = CK.restore_checkpoint(tmp_path, _template(pn), step=10)
    assert _weights_equal(snap["params"], at_snap)
    assert not _weights_equal(eng.params, at_snap)


# ---------------------------------------------------- crash recovery
def test_serve_resilient_inference_bit_exact(ref, tmp_path):
    """Learning off: the interrupted and replayed run returns every
    stream's outputs bit-exact against the uninterrupted engine, each
    stream once; the reference's run restores to the same step, resubmits
    the same streams and returns the same outputs."""
    jn, tn, pj, pn = _setup(ref)
    streams = _streams(tn.n_inputs, 7, seed=11)
    want = _engine(pn, tn, n_slots=2).serve(streams)
    kw = dict(n_slots=2, checkpoint_every=2, checkpoint_keep=100,
              checkpoint_async=False)
    eng = _engine(pn, tn, checkpoint_dir=str(tmp_path / "port"), **kw)
    mon = FT.HeartbeatMonitor(1)
    results, report = tnn_engine.serve_resilient(
        eng, streams, failure_injector=_one_shot_failure(5), monitor=mon)
    assert report["restarts"] == 1 and report["failed_hosts"] == [1]
    assert len(report["restored_steps"]) == 1
    assert eng.n_restores == 1
    for a, b in zip(want, results):
        np.testing.assert_array_equal(a, b)
    assert report["resubmitted"][0]
    assert len(report["resubmitted"][0]) < len(streams)
    assert mon.hosts[0].step_times
    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        backend="closed_form", checkpoint_dir=str(tmp_path / "ref"), **kw))
    jres, jrep = ref.engine.serve_resilient(
        jeng, streams, failure_injector=_one_shot_failure(5, ft=ref.FT))
    assert jrep == report
    for a, b in zip(jres, results):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stdp_seed", [None, 123])
def test_serve_resilient_learning_replays_weight_trajectory(
        ref, tmp_path, stdp_seed):
    """Learning on: after restore-and-replay the engine's final weights,
    update count and replayed outputs equal a fresh engine's built from
    the snapshot (weights, ``step_id``, ``n_stdp_updates``) that serves
    the resubmitted streams, bit for bit: the restored counters reseed the
    stochastic rule identically. With the expectation rule the reference's
    run restores and resubmits the same, outputs bit for bit, weights
    within 1e-5."""
    jn, tn, pj, pn = _setup(ref)
    streams = _streams(tn.n_inputs, 7, seed=13)
    kw = dict(n_slots=2, learn=True, stdp_seed=stdp_seed,
              checkpoint_every=2, checkpoint_keep=100,
              checkpoint_async=False)
    eng = _engine(pn, tn, checkpoint_dir=str(tmp_path / "port"), **kw)
    results, report = tnn_engine.serve_resilient(
        eng, streams, failure_injector=_one_shot_failure(5, host_id=2))
    assert report["restarts"] == 1
    s = report["restored_steps"][0]
    replay_idx = report["resubmitted"][0]
    snap = CK.restore_checkpoint(tmp_path / "port", _template(pn), step=s)
    eng2 = tnn_engine.TNNEngine(snap["params"], tn, _scfg(
        n_slots=2, learn=True, stdp_seed=stdp_seed), device="cpu")
    eng2.step_id = s
    eng2.n_stdp_updates = int(snap["counters"][1])
    r2 = eng2.serve([streams[i] for i in replay_idx])
    assert _weights_equal(eng.params, eng2.params)
    assert eng.n_stdp_updates == eng2.n_stdp_updates
    for i, out in zip(replay_idx, r2):
        np.testing.assert_array_equal(results[i], out)
    if stdp_seed is not None:
        return
    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        backend="closed_form", checkpoint_dir=str(tmp_path / "ref"), **kw))
    jres, jrep = ref.engine.serve_resilient(
        jeng, streams,
        failure_injector=_one_shot_failure(5, host_id=2, ft=ref.FT))
    assert jrep == report
    for a, b in zip(jres, results):
        np.testing.assert_array_equal(a, b)
    _close(jeng.params, eng.params)
    assert jeng.n_stdp_updates == eng.n_stdp_updates


@pytest.mark.parametrize("learn", [False, True])
def test_serve_resilient_no_snapshot_restores_initial_weights(
        ref, tmp_path, learn):
    """A failure before the first snapshot rolls back to construction, the
    implicit step-0 commit point, with every stream replayed: outputs (and
    with learning on, the weights) equal an uninterrupted engine's."""
    _, tn, _, pn = _setup(ref)
    streams = _streams(tn.n_inputs, 4, seed=17)
    fresh = _engine(pn, tn, n_slots=2, learn=learn)
    want = fresh.serve(streams)
    eng = _engine(pn, tn, n_slots=2, learn=learn,
                  checkpoint_dir=str(tmp_path), checkpoint_every=1000)
    results, report = tnn_engine.serve_resilient(
        eng, streams, failure_injector=_one_shot_failure(1))
    assert report["restored_steps"] == [0]
    assert report["resubmitted"][0] == list(range(len(streams)))
    for a, b in zip(want, results):
        np.testing.assert_array_equal(a, b)
    assert _weights_equal(eng.params, fresh.params)
    assert eng.n_stdp_updates == fresh.n_stdp_updates


def test_serve_resilient_exhausts_restarts(ref, tmp_path):
    _, tn, _, pn = _setup(ref)
    eng = _engine(pn, tn, n_slots=2, checkpoint_dir=str(tmp_path),
                  checkpoint_every=2)

    def always(step_id):
        raise FT.WorkerFailure(0, "(always failing)")

    with pytest.raises(FT.WorkerFailure):
        tnn_engine.serve_resilient(
            eng, _streams(tn.n_inputs, 3), failure_injector=always,
            max_restarts=2)
    assert eng.n_restores == 2


def test_restore_clears_pool_and_counts(ref, tmp_path):
    _, tn, _, pn = _setup(ref)
    eng = _engine(pn, tn, n_slots=2, checkpoint_dir=str(tmp_path),
                  checkpoint_every=2, checkpoint_async=False)
    for s in _streams(tn.n_inputs, 5, seed=19):
        eng.submit(s)
    for _ in range(3):
        eng.step()
    assert eng.pool.has_work
    s = eng.restore()
    assert s == 2                       # latest snapshot
    assert eng.step_id == 2
    assert not eng.pool.has_work        # live + pending dropped
    assert eng.n_restores == 1
    out = eng.serve(_streams(tn.n_inputs, 2, seed=23))
    assert len(out) == 2


# ------------------------------------------- snapshots across packages
@pytest.mark.parametrize("learn", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_resumes_in_both_packages(ref, tmp_path, writer, learn):
    """One package serves the first streams with snapshots every 2 steps;
    each package then resumes (``resume=True``) from a copy of that
    directory and serves the rest. Both resume at the same step with the
    snapshot's weights and counters, and serve the rest with the same
    outputs; with learning on (the expectation rule) their weights agree
    within 1e-5, the rounded weights equal."""
    jn, tn, pj, pn = _setup(ref)
    first = [s[:3] for s in _streams(tn.n_inputs, 4, 3, 3, seed=29)]
    rest = _streams(tn.n_inputs, 5, seed=31)
    kw = dict(n_slots=2, learn=learn, checkpoint_every=2,
              checkpoint_keep=100, checkpoint_async=False)
    src = tmp_path / "src"
    if writer == "reference":
        w = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
            backend="closed_form", checkpoint_dir=str(src), **kw))
    else:
        w = _engine(pn, tn, checkpoint_dir=str(src), **kw)
    w.serve(first)
    w.checkpoint_wait()
    s = CK.latest_step(src)
    assert s == 6
    shutil.copytree(src, tmp_path / "port")
    shutil.copytree(src, tmp_path / "ref")
    peng = _engine(pn, tn, resume=True,
                   checkpoint_dir=str(tmp_path / "port"), **kw)
    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        backend="closed_form", checkpoint_dir=str(tmp_path / "ref"), **kw),
        resume=True)
    assert peng.step_id == jeng.step_id == s
    assert peng.n_stdp_updates == jeng.n_stdp_updates
    assert peng.n_stdp_updates == (s if learn else 0)
    assert peng.n_restores == jeng.n_restores == 1
    assert all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(peng.params, jeng.params))
    for a, b in zip(jeng.serve(rest), peng.serve(rest)):
        np.testing.assert_array_equal(a, b)
    _close(jeng.params, peng.params)
    assert peng.step_id == jeng.step_id
    assert peng.n_stdp_updates == jeng.n_stdp_updates


# ------------------------------------------------------ async front door
def test_async_engine_matches_sync(ref):
    jn, tn, pj, pn = _setup(ref, kws=_kws()[:1])
    streams = _streams(tn.n_inputs, 6, max_cycles=3, seed=7)
    expected = _engine(pn, tn, n_slots=3).serve(streams)
    aeng = tnn_engine.AsyncTNNEngine(_engine(pn, tn, n_slots=3))

    async def clients():
        return await asyncio.gather(*[aeng.submit(s) for s in streams])

    got = asyncio.run(clients())
    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        n_slots=3, backend="closed_form"))
    for e, g, j in zip(expected, got, jeng.serve(streams)):
        np.testing.assert_array_equal(e, g)
        np.testing.assert_array_equal(j, g)


def test_async_pump_failure_rejects_waiting_clients(monkeypatch):
    """A dying pump fails outstanding futures instead of stranding them."""
    tn, pn = _port_net()
    eng = _engine(pn, tn, n_slots=2)

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(network, "forward", boom)
    aeng = tnn_engine.AsyncTNNEngine(eng)

    async def client():
        return await aeng.submit(_streams(tn.n_inputs, 1)[0])

    with pytest.raises(RuntimeError, match="boom"):
        asyncio.run(client())


def test_async_submit_retries_transient_queue_full():
    """Concurrent submitters over a tiny pending queue: without retry the
    burst is rejected; with the bounded retry every client rides through
    (the pump drains the queue between backoffs) and the results stay
    bit-exact."""
    tn, pn = _port_net()
    streams = _streams(tn.n_inputs, 6, max_cycles=3, seed=21)
    expected = _engine(pn, tn, n_slots=2).serve(streams)

    def make(retries):
        return tnn_engine.AsyncTNNEngine(
            _engine(pn, tn, n_slots=2, max_pending=1),
            submit_retries=retries, submit_retry_delay_s=0.001)

    async def burst(aeng):
        return await asyncio.gather(*[aeng.submit(s) for s in streams])

    with pytest.raises(tnn_engine.slots.QueueFull):
        asyncio.run(burst(make(retries=0)))
    got = asyncio.run(burst(make(retries=50)))
    for e, g in zip(expected, got):
        np.testing.assert_array_equal(e, g)


def test_async_submit_raises_after_retry_budget():
    """A queue that never drains still surfaces ``QueueFull`` once the
    retry budget is spent."""
    tn, pn = _port_net()
    eng = _engine(pn, tn, n_slots=1, max_pending=1)
    eng.submit(_streams(tn.n_inputs, 1)[0])   # the queue is now full
    eng.step = lambda: []                     # the engine makes no progress
    aeng = tnn_engine.AsyncTNNEngine(
        eng, submit_retries=2, submit_retry_delay_s=0.001)

    async def client():
        return await aeng.submit(_streams(tn.n_inputs, 1, seed=8)[0])

    with pytest.raises(tnn_engine.slots.QueueFull):
        asyncio.run(client())
    # every attempt (initial + 2 retries) counted as a rejection
    assert eng.pool.n_rejected == 3
    with pytest.raises(ValueError):
        tnn_engine.AsyncTNNEngine(eng, submit_retries=-1)
    with pytest.raises(ValueError):
        tnn_engine.AsyncTNNEngine(eng, submit_retry_delay_s=-0.1)


# --------------------------------------------------------------- card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_serve_resilient_inference_matches_cpu(tmp_path):
    """Learning off on the card: every stream's outputs after a failure
    and replay equal the CPU's uninterrupted run exactly, and every step,
    replayed ones included, launches the layer kernel once a layer."""
    dev = _cuda()
    tn, pn = _port_net()
    streams = _streams(tn.n_inputs, 9, seed=11)
    want = _engine(pn, tn, n_slots=2).serve(streams)
    eng = _engine(pn, tn, device=dev, n_slots=2, backend="auto",
                  checkpoint_dir=str(tmp_path), checkpoint_every=2)
    rnl_neuron.reset_launches()
    results, report = tnn_engine.serve_resilient(
        eng, streams, failure_injector=_one_shot_failure(5))
    assert report["restarts"] == 1 and eng.n_restores == 1
    assert rnl_neuron.LAUNCHES["rnl_fire_times_layer"] == 2 * eng.n_steps
    for a, b in zip(want, results):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("stdp_seed", [None, 0])
def test_cuda_serve_resilient_learning_replays(tmp_path, stdp_seed):
    """Learning on the card: after restore-and-replay the weights, update
    count and replayed outputs equal a fresh card engine's built from the
    snapshot, exactly."""
    dev = _cuda()
    tn, pn = _port_net()
    streams = _streams(tn.n_inputs, 7, seed=13)
    kw = dict(n_slots=2, learn=True, stdp_seed=stdp_seed, backend="auto")
    eng = _engine(pn, tn, device=dev, checkpoint_dir=str(tmp_path),
                  checkpoint_every=2, checkpoint_keep=100, **kw)
    results, report = tnn_engine.serve_resilient(
        eng, streams, failure_injector=_one_shot_failure(5))
    s = report["restored_steps"][0]
    snap = CK.restore_checkpoint(tmp_path, _template(pn, dev), step=s)
    assert snap["params"][0].device.type == "cuda"
    eng2 = tnn_engine.TNNEngine(snap["params"], tn, _scfg(**kw), device=dev)
    eng2.step_id = s
    eng2.n_stdp_updates = int(snap["counters"][1])
    r2 = eng2.serve([streams[i] for i in report["resubmitted"][0]])
    assert _weights_equal(eng.params, eng2.params)
    assert eng.n_stdp_updates == eng2.n_stdp_updates
    for i, out in zip(report["resubmitted"][0], r2):
        np.testing.assert_array_equal(results[i], out)


@pytest.mark.cuda
def test_cuda_restore_and_resume_put_weights_on_the_card(tmp_path):
    dev = _cuda()
    tn, pn = _port_net()
    kw = dict(n_slots=2, learn=True, backend="auto",
              checkpoint_dir=str(tmp_path), checkpoint_every=2)
    eng = _engine(pn, tn, device=dev, **kw)
    eng.serve([s[:3] for s in _streams(tn.n_inputs, 4, 3, 3)])
    eng.checkpoint_wait()
    at = tuple(p.clone() for p in eng.params)
    assert eng.restore() == 6
    assert all(p.device.type == "cuda" and p.dtype == torch.float32
               for p in eng.params)
    assert _weights_equal(eng.params, at)
    eng2 = _engine(pn, tn, device=dev, resume=True, **kw)
    assert eng2.step_id == 6 and eng2.n_restores == 1
    assert all(p.device.type == "cuda" for p in eng2.params)
    assert _weights_equal(eng2.params, at)
