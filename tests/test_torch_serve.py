"""Port slot engine vs the reference engine, per request and bit for bit.

The same GRF client streams and the same weights (made by the reference
and carried across as numpy arrays) go through the reference
``TNNEngine`` / ``reference_outputs`` and the port's
``TNNEngine(device="cpu")``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import layer as jlayer  # noqa: E402
from repro.core import network as jnetwork  # noqa: E402
from repro.serve import tnn_engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import layer, network  # noqa: E402
from repro_torch.serve import slots, tnn_engine  # noqa: E402

from examples.serve_tnn import synth_clients  # noqa: E402

NO_SPIKE = 2**30


def _layers(recurrent=False):
    """The serving example's network (4 features x 8 GRF lines)."""
    return [dict(n_columns=4, rf_size=8, n_neurons=4, threshold=8,
                 t_steps=16, dendrite="catwalk", k=2, recurrent=recurrent),
            dict(n_columns=2, rf_size=8, n_neurons=4, threshold=6,
                 t_steps=16, dendrite="catwalk", k=2)]


def _setup(recurrent=False):
    kws = _layers(recurrent)
    jn = jnetwork.make_network([jlayer.TNNLayer(**kw) for kw in kws])
    tn = network.make_network([layer.TNNLayer(**kw) for kw in kws])
    pj = jnetwork.init_network(jax.random.PRNGKey(0), jn)
    pt = convert.params_from_numpy([np.asarray(p) for p in pj], "cpu")
    streams = synth_clients(10, n_features=4, n_fields=8, t_max=16, seed=1)
    return jn, tn, pj, pt, streams


@pytest.fixture(scope="module")
def feedforward():
    jn, tn, pj, pt, streams = _setup()
    refs = [np.asarray(jengine.reference_outputs(pj, jn, s))
            for s in streams]
    return jn, tn, pj, pt, streams, refs


@pytest.mark.parametrize("backend",
                         ["auto", "closed_form", "event", "fused",
                          "fused_compact"])
def test_engine_matches_reference_per_request(feedforward, backend):
    _, tn, _, pt, streams, refs = feedforward
    eng = tnn_engine.TNNEngine(
        pt, tn, tnn_engine.TNNServeConfig(n_slots=4, backend=backend),
        device="cpu")
    got = eng.serve(streams)
    for g, r, s in zip(got, refs, streams):
        assert g.dtype == np.int32 and g.shape == (s.shape[0], 2, 4)
        np.testing.assert_array_equal(g, r)
    port_ref = [tnn_engine.reference_outputs(pt, tn, s) for s in streams]
    for g, r in zip(got, port_ref):
        np.testing.assert_array_equal(g, r)
    st = eng.stats()
    assert st["n_retired"] == len(streams)
    assert st["n_volleys"] == sum(s.shape[0] for s in streams)
    if backend != "auto":
        assert st[f"steps_{backend}"] == st["n_steps"]


@pytest.mark.parametrize("backend", ["auto", "event"])
def test_engine_matches_reference_engine(feedforward, backend):
    """The reference engine and the port engine on the same streams give
    the same outputs and make the same engine choices off CUDA."""
    jn, tn, pj, pt, streams, _ = feedforward
    jeng = jengine.TNNEngine(
        pj, jn, jengine.TNNServeConfig(n_slots=4, backend=backend))
    teng = tnn_engine.TNNEngine(
        pt, tn, tnn_engine.TNNServeConfig(n_slots=4, backend=backend),
        device="cpu")
    for want, got in zip(jeng.serve(streams), teng.serve(streams)):
        np.testing.assert_array_equal(want, got)
    js, ts = jeng.stats(), teng.stats()
    for key in js:
        if key.startswith("steps_"):
            assert ts[key] == js[key], key
    assert ts["n_steps"] == js["n_steps"]


def test_recurrent_pipelined_engine_matches_reference():
    jn, tn, pj, pt, streams = _setup(recurrent=True)
    eng = tnn_engine.TNNEngine(
        pt, tn, tnn_engine.TNNServeConfig(n_slots=5, pipeline_microbatches=2),
        device="cpu")
    reqs = [eng.submit(s) for s in streams]
    eng.run()
    for r, s in zip(reqs, streams):
        np.testing.assert_array_equal(
            r.result(), np.asarray(jengine.reference_outputs(pj, jn, s)))
        assert r.final_state is not None and r.final_state[1] is None
    assert eng.stats()["pipeline_microbatches"] == 2.0
    # a continuation stream resumes from the retired carry
    first, rest = streams[0][:1], streams[0][1:]
    if rest.shape[0]:
        a = eng.submit(first)
        eng.run()
        b = eng.submit(rest, initial_state=a.final_state)
        eng.run()
        np.testing.assert_array_equal(
            np.concatenate([a.result(), b.result()]), reqs[0].result())


def test_config_and_submit_validation(feedforward):
    _, tn, _, pt, streams, _ = feedforward
    cfg = tnn_engine.TNNServeConfig
    bad = [
        (cfg(backend="pallas"), ValueError),
        (cfg(policy="fastest"), ValueError),
        (cfg(pipeline_microbatches=0), ValueError),
        (cfg(max_jit_variants=0), ValueError),
        (cfg(n_slots=0), ValueError),
    ]
    for scfg, exc in bad:
        with pytest.raises(exc):
            tnn_engine.TNNEngine(pt, tn, scfg, device="cpu")
    bad_layer = network.make_network(
        [dataclasses.replace(tn.layers[0], backend="nope"), tn.layers[1]])
    with pytest.raises(ValueError, match="layers\\[0\\]"):
        tnn_engine.TNNEngine(pt, bad_layer, device="cpu")
    eng = tnn_engine.TNNEngine(pt, tn, cfg(n_slots=2, max_pending=1),
                               device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.zeros((2, tn.n_inputs + 1), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0, tn.n_inputs), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.full((1, tn.n_inputs), -1, np.int32))
    with pytest.raises(ValueError):
        eng.submit(streams[0], initial_state=(None, None))
    eng.submit(streams[0])
    with pytest.raises(slots.QueueFull):
        eng.submit(streams[1])
    assert eng.stats()["n_rejected"] == 1.0


def test_pinned_network_cache_is_bounded():
    """Batches of 3, 12 and 24 active lines need widths 8, 16 and 32; with
    room for one pinned network the other two are evicted."""
    tn = network.make_network([layer.TNNLayer(
        n_columns=1, rf_size=24, n_neurons=2, threshold=4, t_steps=8)])
    pt = network.init_network(torch.Generator().manual_seed(0), tn, "cpu")
    eng = tnn_engine.TNNEngine(
        pt, tn, tnn_engine.TNNServeConfig(n_slots=1, backend="event",
                                          max_jit_variants=1),
        device="cpu")
    streams = []
    for active in (3, 12, 24):
        v = np.full((1, 24), NO_SPIKE, np.int32)
        v[0, :active] = 1
        streams.append(v)
    got = eng.serve(streams)
    want = [tnn_engine.reference_outputs(pt, tn, s) for s in streams]
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)
    st = eng.stats()
    assert st["jit_variants"] == 1.0 and st["jit_evictions"] == 2.0


def test_engine_defaults_to_cuda():
    """No device means CUDA: on a host without it the engine raises rather
    than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, tn, _, pt, _ = _setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        tnn_engine.TNNEngine(pt, tn)


@pytest.mark.parametrize("backend,counted",
                         [("auto", True), ("event", True),
                          ("fused_compact", True), ("closed_form", False),
                          ("fused", False)])
def test_active_count_only_where_used(feedforward, monkeypatch, backend,
                                      counted):
    """The engine counts layer 0's active lines only where the policy
    weighs them (``auto`` off CUDA) or a sparse engine sizes its width
    from them; the outputs stay the reference's either way."""
    _, tn, _, pt, streams, refs = feedforward
    calls = []
    real = tnn_engine.TNNEngine._layer0_active

    def spy(self, batch):
        calls.append(batch.shape)
        return real(self, batch)

    monkeypatch.setattr(tnn_engine.TNNEngine, "_layer0_active", spy)
    eng = tnn_engine.TNNEngine(
        pt, tn, tnn_engine.TNNServeConfig(n_slots=4, backend=backend),
        device="cpu")
    for got, want in zip(eng.serve(streams), refs):
        np.testing.assert_array_equal(got, want)
    assert bool(calls) == counted
