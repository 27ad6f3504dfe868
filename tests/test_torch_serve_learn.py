"""Learning while serving on the port: ``TNNEngine(learn=True)``.

Mirrors ``tests/test_serve_learn.py``'s learning tests (replay against a
manual ``network.step`` loop, outputs equal to inference, cadence and
drift stats, pauses under queue pressure and on slow steps, config
validation) on the port, and runs the reference engine on the same streams
and weights (carried across as numpy): outputs bit-exact, weights within
1e-5 and rounded weights equal. Where the reference test held that a
weight update never recompiles, the port holds that it builds no new
pinned network. The ``cuda``-marked test at the end holds the learning
engine on the card and skips without one.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import coding, column, layer, network  # noqa: E402
from repro_torch.kernels import rnl_neuron  # noqa: E402
from repro_torch.serve import tnn_engine  # noqa: E402

NO_SPIKE = coding.NO_SPIKE
STREAM_ATOL = 1e-5
ENGINES = ("closed_form", "event", "fused", "fused_compact", "auto")


def _kws(recurrent=True):
    # the reference test's layer 2 is its "rnl" dendrite, the full PC; the
    # port names it pc_compact (it refuses names it does not know)
    return [dict(n_columns=2, rf_size=4, n_neurons=3, threshold=5,
                 t_steps=12, dendrite="catwalk", k=2),
            dict(n_columns=3, rf_size=2, n_neurons=2, threshold=4,
                 t_steps=12, dendrite="pc_compact", recurrent=recurrent)]


@pytest.fixture(scope="module")
def ref():
    """The reference package. Imported here, not at the top, so the
    ``cuda`` test below also runs on a GPU machine without JAX."""
    jax = pytest.importorskip("jax")
    from repro.core import layer as jlayer
    from repro.core import network as jnetwork
    from repro.serve import tnn_engine as jengine
    return types.SimpleNamespace(jax=jax, layer=jlayer, network=jnetwork,
                                 engine=jengine)


def _setup(ref, recurrent=True, seed=0):
    """The same network in both packages and the reference's weights,
    also as numpy."""
    kws = _kws(recurrent)
    jn = ref.network.make_network([ref.layer.TNNLayer(**kw) for kw in kws])
    tn = network.make_network([layer.TNNLayer(**kw) for kw in kws])
    pj = ref.network.init_network(ref.jax.random.PRNGKey(seed), jn)
    return jn, tn, pj, [np.asarray(p) for p in pj]


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


def _engine(params_np, tn, **kw):
    return tnn_engine.TNNEngine(convert.params_from_numpy(params_np, "cpu"),
                                tn, _scfg(**kw), device="cpu")


def _close(want, got, atol=STREAM_ATOL):
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.cpu().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)
        np.testing.assert_array_equal(np.round(b), np.round(a))


# ---------------------------------------------------- learning semantics
@pytest.mark.parametrize("recurrent", [False, True])
def test_learning_engine_matches_manual_step_replay(ref, recurrent):
    """Same-length streams fill all slots at step 0 and retire together,
    so the engine's batch composition is known exactly: its outputs and
    final weights equal a manual ``network.step`` loop over those batches
    bit for bit, and the reference engine's outputs bit for bit and its
    weights to 1e-5."""
    jn, tn, pj, pn = _setup(ref, recurrent)
    B = 3
    streams = [s[:4] for s in _streams(tn.n_inputs, B, 4, 4)]
    eng = _engine(pn, tn, n_slots=B, learn=True)
    results = eng.serve(streams)

    pinned = network.make_network([
        dataclasses.replace(lc, backend="closed_form") for lc in tn.layers])
    p = convert.params_from_numpy(pn, "cpu")
    carry = network.init_carry(tn, B, "cpu")
    outs = [[] for _ in range(B)]
    for c in range(4):
        batch = torch.from_numpy(np.stack([s[c] for s in streams]))
        res = network.step(p, batch, pinned, carry=carry)
        p, carry = res.params, res.carry
        for i in range(B):
            outs[i].append(res.out[i].numpy())
    for i in range(B):
        np.testing.assert_array_equal(np.stack(outs[i]), results[i])
    assert all(torch.equal(a, b) for a, b in zip(eng.params, p))
    assert eng.n_stdp_updates == 4

    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        n_slots=B, backend="closed_form", learn=True))
    for want, got in zip(jeng.serve(streams), results):
        np.testing.assert_array_equal(got, want)
    _close(jeng.params, eng.params)


@pytest.mark.parametrize("backend", ENGINES)
def test_learning_runs_on_every_engine(ref, backend):
    """Every engine learns the same weights and serves the same outputs
    (``fused_compact`` included): all engines are bit-exact, and the STDP
    update does not depend on which one fired."""
    _, tn, _, pn = _setup(ref, recurrent=False)
    streams = _streams(tn.n_inputs, 6, seed=4)
    want = _engine(pn, tn, n_slots=3, learn=True)
    got = _engine(pn, tn, n_slots=3, learn=True, backend=backend)
    for a, b in zip(want.serve(streams), got.serve(streams)):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(want.params, got.params))
    assert got.n_stdp_updates == got.n_steps > 0


def test_learning_step_outputs_match_inference_step(ref):
    """Outputs are computed at the PRE-update weights: the first gamma
    cycle of a learning engine is bit-exact with learning off."""
    _, tn, _, pn = _setup(ref)
    streams = [s[:1] for s in _streams(tn.n_inputs, 4, seed=3)]
    r_off = _engine(pn, tn, n_slots=4).serve(streams)
    r_on = _engine(pn, tn, n_slots=4, learn=True).serve(streams)
    for a, b in zip(r_off, r_on):
        np.testing.assert_array_equal(a, b)


def test_stdp_cadence_and_drift_stats(ref):
    jn, tn, pj, pn = _setup(ref)
    streams = [s[:6] for s in _streams(tn.n_inputs, 2, 6, 6)]
    eng = _engine(pn, tn, n_slots=2, learn=True, stdp_every=3)
    eng.serve(streams)
    # 6 steps, updates on step_id 0 and 3
    assert eng.n_steps == 6 and eng.n_stdp_updates == 2
    st = eng.stats()
    assert st["n_stdp_updates"] == 2.0
    assert st["step_id"] == 6.0
    assert st["weight_drift_l0"] > 0.0
    assert "weight_drift_l1" in st
    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        n_slots=2, backend="closed_form", learn=True, stdp_every=3))
    jeng.serve(streams)
    jst = jeng.stats()
    for key in ("n_stdp_updates", "step_id", "learning_paused",
                "n_learn_pauses"):
        assert st[key] == jst[key], key
    for i in range(2):
        assert st[f"weight_drift_l{i}"] == pytest.approx(
            jst[f"weight_drift_l{i}"], abs=1e-4)
    # the persistent counter survives reset_stats
    eng.reset_stats()
    assert eng.stats()["step_id"] == 6.0 and eng.stats()["n_steps"] == 0.0
    # an inference engine reports the counters but no drift keys
    st0 = _engine(pn, tn, n_slots=2).stats()
    assert st0["n_stdp_updates"] == 0.0 and "weight_drift_l0" not in st0


def test_weight_update_builds_no_new_pinned_network(ref):
    """The weights are the engine's state, not part of a pinned network: a
    long learning run keeps serving the default network and builds no
    variant, on a sparse engine as on a dense one."""
    _, tn, _, pn = _setup(ref, recurrent=False)
    streams = [s[:5] for s in _streams(tn.n_inputs, 4, 5, 5)]
    eng = _engine(pn, tn, n_slots=2, learn=True)
    eng.serve(streams)
    assert eng.n_stdp_updates == eng.n_steps
    st = eng.stats()
    assert st["jit_variants"] == 0.0 and st["jit_evictions"] == 0.0
    inf = _engine(pn, tn, n_slots=2, backend="event")
    inf.serve(streams)
    learn = _engine(pn, tn, n_slots=2, backend="event", learn=True)
    learn.serve(streams)
    assert learn.stats()["jit_variants"] == inf.stats()["jit_variants"]
    assert learn.stats()["jit_evictions"] == 0.0


def test_seeded_stochastic_learning_replays(ref):
    """``stdp_seed`` seeds each step's generator from a hash of (seed,
    step_id): two
    engines with one seed learn the same weights, another seed learns
    others, and each differs from the expectation rule."""
    _, tn, _, pn = _setup(ref)
    streams = [s[:4] for s in _streams(tn.n_inputs, 6, 4, 4, seed=2)]

    def learned(**kw):
        eng = _engine(pn, tn, n_slots=3, learn=True, **kw)
        outs = eng.serve(streams)
        return eng, outs

    a, out_a = learned(stdp_seed=0)
    b, out_b = learned(stdp_seed=0)
    c, _ = learned(stdp_seed=1)
    e, _ = learned()
    assert all(torch.equal(x, y) for x, y in zip(a.params, b.params))
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(a.params, c.params))
    assert not all(torch.equal(x, y) for x, y in zip(a.params, e.params))
    # the rule the docstring states
    gen = a._stdp_key()
    want = torch.Generator().manual_seed(int(np.random.SeedSequence(
        (0, a.step_id)).generate_state(1)[0]))
    assert tnn_engine.stdp_step_seed(0, a.step_id) == want.initial_seed()
    assert torch.equal(torch.rand(8, generator=gen),
                       torch.rand(8, generator=want))
    assert e._stdp_key() is None


# ------------------------------------------------------- backpressure
def test_learning_pauses_under_queue_pressure_and_resumes(ref):
    jn, tn, pj, pn = _setup(ref)
    streams = [s[:1] for s in _streams(tn.n_inputs, 9, seed=5)]
    kw = dict(n_slots=1, learn=True, max_pending=16,
              learn_pause_queue_frac=0.25)
    eng = _engine(pn, tn, **kw)
    for s in streams:
        eng.submit(s)
    paused_steps = 0
    while eng.pool.has_work:
        eng.step()
        paused_steps += int(eng.learning_paused)
    # 9 single-cycle streams through 1 slot: the queue holds >= 4 (frac
    # 0.25) for the first steps -> learning paused; it resumes as the
    # queue drains, so some (not all) steps learned
    assert paused_steps > 0
    assert 0 < eng.n_stdp_updates < eng.n_steps
    st = eng.stats()
    assert st["n_learn_pauses"] >= 1.0
    assert st["learning_paused"] == 0.0
    assert eng.pool.n_retired == len(streams)
    # the reference pauses on the same steps
    jeng = ref.engine.TNNEngine(pj, jn, ref.engine.TNNServeConfig(
        backend="closed_form", **kw))
    for s in streams:
        jeng.submit(s)
    jeng.run()
    assert jeng.n_stdp_updates == eng.n_stdp_updates
    assert jeng.n_learn_pauses == eng.n_learn_pauses


def test_learning_pauses_on_slow_steps(ref):
    _, tn, _, pn = _setup(ref)
    eng = _engine(pn, tn, n_slots=2, learn=True, learn_pause_step_s=1e-9)
    eng.serve([_streams(tn.n_inputs, 1, 3, 3)[0]])
    # step 0 learns (no previous latency); every later step sees the
    # previous step's wall clock over the threshold and sheds
    assert eng.n_stdp_updates == 1
    assert eng.n_learn_pauses >= 1


def test_learn_config_validation(ref):
    _, tn, _, pn = _setup(ref)
    with pytest.raises(ValueError, match="stdp_every"):
        _engine(pn, tn, learn=True, stdp_every=0)
    with pytest.raises(ValueError, match="max_pending"):
        _engine(pn, tn, learn=True, learn_pause_queue_frac=0.5)
    with pytest.raises(ValueError, match="> 0"):
        _engine(pn, tn, learn=True, max_pending=4,
                learn_pause_queue_frac=0.0)


# --------------------------------------------------------------- card
@pytest.mark.cuda
def test_cuda_learning_matches_cpu():
    """On the card: a learning engine launches the layer kernel twice a
    step, its outputs and weights equal a manual ``network.step`` loop
    there bit for bit, one step's weights equal the CPU's within 2e-6
    (rounded equal), and a seeded run replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    tn = network.make_network([layer.TNNLayer(**kw) for kw in _kws()])
    pn = [p.numpy() for p in network.init_network(
        torch.Generator().manual_seed(0), tn, "cpu")]
    B = 3
    streams = [s[:4] for s in _streams(tn.n_inputs, B, 4, 4)]
    dev = torch.device("cuda")
    eng = tnn_engine.TNNEngine(convert.params_from_numpy(pn, dev), tn,
                               _scfg(n_slots=B, learn=True, backend="auto"),
                               device=dev)
    rnl_neuron.reset_launches()
    results = eng.serve(streams)
    assert rnl_neuron.LAUNCHES["rnl_fire_times_layer"] == 2 * eng.n_steps
    p = convert.params_from_numpy(pn, dev)
    carry = network.init_carry(tn, B, dev)
    for c in range(4):
        batch = torch.from_numpy(np.stack([s[c] for s in streams])).to(dev)
        res = network.step(p, batch, tn, carry=carry)
        if c == 0:
            cpu = network.step(convert.params_from_numpy(pn, "cpu"),
                               batch.cpu(), tn,
                               carry=network.init_carry(tn, B, "cpu"))
            assert torch.equal(res.out.cpu(), cpu.out)
            _close(cpu.params, res.params, atol=2e-6)
        p, carry = res.params, res.carry
        for i in range(B):
            np.testing.assert_array_equal(res.out[i].cpu().numpy(),
                                          results[i][c])
    assert all(torch.equal(a, b) for a, b in zip(eng.params, p))

    def seeded():
        e = tnn_engine.TNNEngine(convert.params_from_numpy(pn, dev), tn,
                                 _scfg(n_slots=B, learn=True, stdp_seed=0,
                                       backend="auto"), device=dev)
        e.serve(streams)
        return e.params
    assert all(torch.equal(a, b) for a, b in zip(seeded(), seeded()))


@pytest.mark.cuda
def test_cuda_train_column_matches_cpu():
    """``train_column`` on the card: one single-bank kernel launch a
    volley, and the CPU's weights and winners bit for bit (B = 1: no
    reduction to round differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    cfg = column.ColumnConfig(n_inputs=16, n_neurons=3, threshold=12,
                              t_steps=16, dendrite="catwalk", k=2)
    w0 = column.init_column(torch.Generator().manual_seed(0), cfg, "cpu")
    t = np.random.default_rng(1).integers(0, 24, (64, 16))
    x = torch.from_numpy(np.where(t >= 16, NO_SPIKE, t).astype(np.int32))
    rnl_neuron.reset_launches()
    w, win = column.train_column(w0.cuda(), x.cuda(), cfg)
    assert rnl_neuron.LAUNCHES["rnl_fire_times"] == 64
    want_w, want_win = column.train_column(
        w0, x, dataclasses.replace(cfg, backend="closed_form"))
    assert torch.equal(w.cpu(), want_w) and torch.equal(win.cpu(), want_win)
