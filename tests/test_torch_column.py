"""Port learning paths vs the reference: columns, ``layer_step`` /
``train_layer``, ``network.step`` / ``train_network``, and the silicon cost
model.

Mirrors ``tests/test_layer.py``'s learning tests (B = 1 layer vs column,
``train_layer`` vs ``train_column``, mean-step invariance, ragged streams,
network training) and ``tests/test_hwcost.py`` on the port, and runs the
same numpy inputs and reference weights (carried across as numpy) through
both packages. Fire times, winners and outputs are bit-exact; one step's
float weights agree within 2e-6 and a stream's within 1e-5, rounded weights
exactly. The stochastic rule gets the reference's own uniforms through
``draws=``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _stdp_draws as draws_of  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import column as jcolumn  # noqa: E402
from repro.core import hwcost as jhwcost  # noqa: E402
from repro.core import layer as jlayer  # noqa: E402
from repro.core import network as jnetwork  # noqa: E402
from repro.core import stdp as jstdp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import coding, column, hwcost, layer  # noqa: E402
from repro_torch.core import network, stdp  # noqa: E402
from repro_torch.core.topk_prune import topk_network  # noqa: E402

NO_SPIKE = coding.NO_SPIKE
ONE_STEP_ATOL = 2e-6
STREAM_ATOL = 1e-5
CLUSTER_STDP = dict(mu_capture=1.0, mu_backoff=1.0, mu_search=0.5)
BACKENDS = ("closed_form", "scan", "event", "fused", "fused_compact", "auto")


def _volleys(rng, shape, t_max, p_silent=0.3):
    t = rng.integers(0, t_max, shape)
    return np.where(rng.random(shape) < p_silent, NO_SPIKE,
                    t).astype(np.int32)


def _layer_kw(**kw):
    base = dict(n_columns=1, rf_size=16, n_neurons=3, threshold=12,
                t_steps=16, dendrite="catwalk", k=2)
    base.update(kw)
    return base


def _pair(**kw):
    """The same layer in both packages (the reference on its closed form:
    every reference engine is bit-exact with every other)."""
    lkw = _layer_kw(**kw)
    return (jlayer.TNNLayer(**lkw, stdp=jstdp.STDPConfig(**CLUSTER_STDP),
                            backend="closed_form"),
            layer.TNNLayer(**lkw, stdp=stdp.STDPConfig(**CLUSTER_STDP),
                           backend="closed_form"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(want, got):
    assert got.dtype == torch.int32, got.dtype
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def _close(want, got, atol):
    want, got = np.asarray(want), got.cpu().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_array_equal(np.round(got), np.round(want))


# ------------------------------------------------------------- column
@pytest.mark.parametrize("dendrite", ["pc_conventional", "pc_compact",
                                      "sorting_pc", "catwalk"])
def test_column_forward_matches_reference_on_every_engine(dendrite):
    jl, tl = _pair(dendrite=dendrite, n_neurons=5, threshold=9, t_steps=24)
    jc, tc = jl.column_config(), tl.column_config()
    rng = np.random.default_rng(len(dendrite))
    w = np.asarray(jcolumn.init_column(jax.random.PRNGKey(1), jc))
    for b in BACKENDS:
        cfg = dataclasses.replace(tc, backend=b)
        for _ in range(6):
            x = _volleys(rng, (16,), 30)
            out_j, win_j = jcolumn.column_forward(jnp.asarray(w),
                                                  jnp.asarray(x), jc)
            out_t, win_t = column.column_forward(
                convert.column_from_numpy(w, "cpu"), _t(x), cfg)
            _eq(out_j, out_t)
            _eq(win_j, win_t)


@pytest.mark.parametrize("stochastic", [False, True])
def test_train_column_matches_reference(stochastic):
    """``column_step`` and ``train_column`` over the reference test's
    40-volley stream: winners bit-exact, weights to 1e-5."""
    jl, tl = _pair()
    jc, tc = jl.column_config(), tl.column_config()
    w0 = np.asarray(jcolumn.init_column(jax.random.PRNGKey(0), jc))
    volleys = _volleys(np.random.default_rng(9), (40, 16), 20)
    key = jax.random.PRNGKey(4) if stochastic else None
    jw, jwin = jcolumn.train_column(jnp.asarray(w0), jnp.asarray(volleys),
                                    jc, key)
    d = (_t(draws_of.stream(key, 40, lambda k: draws_of.column(k, 3, 16)))
         if stochastic else None)
    tw, twin = column.train_column(convert.column_from_numpy(w0, "cpu"),
                                   _t(volleys), tc, draws=d)
    _eq(jwin, twin)
    _close(jw, tw, STREAM_ATOL)
    # one eager step: the one-step tolerance
    k1 = jax.random.PRNGKey(7) if stochastic else None
    jw1, jo1, jwin1 = jcolumn.column_step(jnp.asarray(w0),
                                          jnp.asarray(volleys[0]), jc, k1)
    d1 = _t(draws_of.column(k1, 3, 16)) if stochastic else None
    tw1, to1, twin1 = column.column_step(convert.column_from_numpy(w0, "cpu"),
                                         _t(volleys[0]), tc, draws=d1)
    _eq(jo1, to1)
    _eq(jwin1, twin1)
    _close(jw1, tw1, ONE_STEP_ATOL)


def test_init_column_is_seeded_and_defaults_to_cuda(monkeypatch):
    cfg = _pair()[1].column_config()
    a = column.init_column(torch.Generator().manual_seed(3), cfg, "cpu")
    b = column.init_column(torch.Generator().manual_seed(3), cfg, "cpu")
    assert a.shape == (3, 16) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 7.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        column.init_column(torch.Generator().manual_seed(3), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.column_from_numpy(a.numpy())


def test_column_from_numpy_takes_one_column_only():
    w = convert.column_from_numpy(np.ones((3, 4), np.float64), "cpu")
    assert w.dtype == torch.float32 and w.shape == (3, 4)
    with pytest.raises(ValueError, match=r"\(q, n\)"):
        convert.column_from_numpy(np.ones((1, 3, 4)), "cpu")
    with pytest.raises(ValueError, match="C, Q, rf_total"):
        convert.params_from_numpy([np.ones((3, 4))], "cpu")


# -------------------------------------------------------------- layer
def test_layer_b1_bit_identical_to_column_step_loop():
    """Batched layer forward + minibatch STDP at B=1 == per-volley
    column_step loop, weights and winners, bit for bit."""
    _, lcfg = _pair()
    ccfg = lcfg.column_config()
    wl = layer.init_layer(torch.Generator().manual_seed(0), lcfg, "cpu")
    wc = column.init_column(torch.Generator().manual_seed(0), ccfg, "cpu")
    assert torch.equal(wl[0], wc)
    volleys = _t(_volleys(np.random.default_rng(3), (25, 16), 20))
    for i in range(volleys.shape[0]):
        wl, out_l, win_l = layer.layer_step(wl, volleys[i][None, :], lcfg)
        wc, out_c, win_c = column.column_step(wc, volleys[i], ccfg)
        assert torch.equal(out_l[0, 0], out_c)
        assert int(win_l[0, 0]) == int(win_c)
        assert torch.equal(wl[0], wc)


@pytest.mark.parametrize("stochastic", [False, True])
def test_train_layer_b1_matches_train_column(stochastic):
    """``train_layer`` at C=1, B=1 equals the port's ``train_column``
    bit for bit, and the reference's to 1e-5 (its scan-compiled step)."""
    jl, tl = _pair()
    w0 = np.asarray(jlayer.init_layer(jax.random.PRNGKey(0), jl))
    volleys = _volleys(np.random.default_rng(9), (40, 16), 20)
    key = jax.random.PRNGKey(11) if stochastic else None
    jw, jwin = jlayer.train_layer(jnp.asarray(w0), jnp.asarray(volleys), jl,
                                  batch_size=1, key=key)
    d = (_t(draws_of.stream(key, 40, lambda k: draws_of.layer(k, jl, 1)))
         if stochastic else None)
    tw, twin = layer.train_layer(convert.params_from_numpy([w0], "cpu")[0],
                                 _t(volleys), tl, batch_size=1, draws=d)
    assert twin.shape == (40, 1)
    _eq(jwin, twin)
    _close(jw, tw, STREAM_ATOL)
    cw, cwin = column.train_column(
        convert.column_from_numpy(w0[0], "cpu"), _t(volleys),
        tl.column_config(), draws=None if d is None else d[:, 0, 0])
    assert torch.equal(tw[0], cw) and torch.equal(twin[:, 0], cwin)


LAYER_CASES = {
    "multi_column": dict(n_columns=3, rf_size=8, n_neurons=4, threshold=8),
    "overlap": dict(n_columns=3, rf_size=8, rf_stride=4, threshold=8),
    "recurrent": dict(n_columns=2, rf_size=6, n_neurons=3, threshold=6,
                      recurrent=True, dendrite="pc_compact"),
    "sum": dict(n_columns=2, rf_size=8, n_neurons=4, threshold=7,
                stdp_reduction="sum"),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
@pytest.mark.parametrize("stochastic", [False, True])
def test_layer_step_matches_reference(case, stochastic):
    """One ``layer_step`` on a batch of 5 (a carry for the recurrent
    layer), on every port engine: outputs and winners bit-exact, weights
    within 2e-6."""
    jl, tl = _pair(**LAYER_CASES[case])
    rng = np.random.default_rng(len(case))
    w0 = np.asarray(jlayer.init_layer(jax.random.PRNGKey(2), jl))
    x = _volleys(rng, (5, jl.n_inputs), 20)
    carry = (_volleys(rng, (5, jl.n_outputs), 20, p_silent=0.8)
             if jl.recurrent else None)
    key = jax.random.PRNGKey(6) if stochastic else None
    jw, jout, jwin = jlayer.layer_step(
        jnp.asarray(w0), jnp.asarray(x), jl, key,
        None if carry is None else jnp.asarray(carry))
    d = _t(draws_of.layer(key, jl, 5)) if stochastic else None
    for b in BACKENDS:
        tw, tout, twin = layer.layer_step(
            _t(w0), _t(x), dataclasses.replace(tl, backend=b),
            carry=None if carry is None else _t(carry), draws=d)
        _eq(jout, tout)
        _eq(jwin, twin)
        _close(jw, tw, ONE_STEP_ATOL)


def test_layer_step_single_volley_and_generator():
    """A 1-D volley keeps its promoted batch dim (the reference's
    contract); a generator draws (C, B, Q, rf_total) in one ``torch.rand``,
    so the same seed's draws handed in give the same step."""
    jl, tl = _pair(n_columns=2, rf_size=8, n_neurons=4, threshold=7)
    w0 = np.asarray(jlayer.init_layer(jax.random.PRNGKey(5), jl))
    x = _volleys(np.random.default_rng(1), (3, jl.n_inputs), 16)
    jw, jout, jwin = jlayer.layer_step(jnp.asarray(w0), jnp.asarray(x[0]), jl)
    tw, tout, twin = layer.layer_step(_t(w0), _t(x[0]), tl)
    assert tout.shape == (1, 2, 4) and twin.shape == (1, 2)
    _eq(jout, tout)
    _eq(jwin, twin)
    _close(jw, tw, ONE_STEP_ATOL)
    a = layer.layer_step(_t(w0), _t(x), tl,
                         torch.Generator().manual_seed(1))[0]
    u = torch.rand((2, 3, 4, 8), generator=torch.Generator().manual_seed(1))
    b = layer.layer_step(_t(w0), _t(x), tl, draws=u)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        layer.layer_step(_t(w0), _t(x), tl, draws=u[:, :1])
    with pytest.raises(ValueError, match="non-recurrent"):
        layer.layer_step(_t(w0), _t(x), tl,
                         carry=torch.zeros((3, 8), dtype=torch.int32))


def test_minibatch_stdp_mean_step_invariance():
    """Mean reduction: a minibatch of B identical volleys takes the
    single-volley step (deltas average to the per-volley delta)."""
    _, lcfg = _pair()
    w0 = layer.init_layer(torch.Generator().manual_seed(1), lcfg, "cpu")
    v = _t(_volleys(np.random.default_rng(2), (16,), 14))[None, :]
    w1, _, _ = layer.layer_step(w0, v, lcfg)
    w8, _, _ = layer.layer_step(w0, v.repeat(8, 1), lcfg)
    torch.testing.assert_close(w8, w1, rtol=0, atol=1e-6)


def test_train_layer_rejects_ragged_stream():
    _, lcfg = _pair()
    volleys = _t(_volleys(np.random.default_rng(0), (10, 16), 12))
    w = layer.init_layer(torch.Generator().manual_seed(1), lcfg, "cpu")
    with pytest.raises(ValueError, match="divisible"):
        layer.train_layer(w, volleys, lcfg, batch_size=3)
    with pytest.raises(ValueError, match="draws"):
        layer.train_layer(w, volleys, lcfg, batch_size=5,
                          draws=torch.zeros((3, 1, 5, 3, 16)))


def test_train_layer_minibatches_match_reference():
    """``train_layer`` at B=4 over 24 volleys, two columns: the B-way
    reduction agrees with the reference's to 1e-5."""
    jl, tl = _pair(n_columns=2, rf_size=8, n_neurons=3, threshold=7)
    w0 = np.asarray(jlayer.init_layer(jax.random.PRNGKey(8), jl))
    volleys = _volleys(np.random.default_rng(4), (24, jl.n_inputs), 16)
    jw, jwin = jlayer.train_layer(jnp.asarray(w0), jnp.asarray(volleys), jl,
                                  batch_size=4)
    tw, twin = layer.train_layer(_t(w0), _t(volleys), tl, batch_size=4)
    _eq(jwin, twin)
    _close(jw, tw, STREAM_ATOL)


# ------------------------------------------------------------ network
def _nets(recurrent=False):
    kws = [_layer_kw(n_columns=2, rf_size=8, n_neurons=4, threshold=6),
           _layer_kw(n_columns=1, rf_size=8, n_neurons=3, threshold=3,
                     recurrent=recurrent, dendrite="pc_compact")]
    jn = jnetwork.make_network([
        jlayer.TNNLayer(**kw, stdp=jstdp.STDPConfig(**CLUSTER_STDP),
                        backend="closed_form") for kw in kws])
    tn = network.make_network([
        layer.TNNLayer(**kw, stdp=stdp.STDPConfig(**CLUSTER_STDP))
        for kw in kws])
    pj = [np.asarray(p) for p in
          jnetwork.init_network(jax.random.PRNGKey(0), jn)]
    return jn, tn, pj


@pytest.mark.parametrize("recurrent", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_network_step_matches_reference(recurrent, stochastic):
    """``network.step``: layer 2 learns from layer 1's pre-update output,
    the carry is threaded, a 1-D volley drops the batch dim everywhere but
    ``params``."""
    jn, tn, pj = _nets(recurrent)
    rng = np.random.default_rng(recurrent + 2 * stochastic)
    x = _volleys(rng, (6, jn.n_inputs), 12)
    carry = [None] * 2
    if recurrent:
        carry[1] = _volleys(rng, (6, 3), 12, p_silent=0.7)
    key = jax.random.PRNGKey(3) if stochastic else None
    jres = jnetwork.step([jnp.asarray(p) for p in pj], jnp.asarray(x), jn,
                         key=key, carry=[None if c is None else
                                         jnp.asarray(c) for c in carry])
    d = ([_t(a) for a in draws_of.network(key, jn, 6)] if stochastic
         else None)
    tres = network.step(convert.params_from_numpy(pj, "cpu"), _t(x), tn,
                        carry=[None if c is None else _t(c) for c in carry],
                        draws=d)
    _eq(jres.out, tres.out)
    for a, b in zip(jres.winners, tres.winners):
        _eq(a, b)
    for a, b in zip(jres.carry, tres.carry):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a, b)
    for a, b in zip(jres.params, tres.params):
        _close(a, b, ONE_STEP_ATOL)
    # the forward part is network.forward's, bit for bit
    fwd = network.forward(convert.params_from_numpy(pj, "cpu"), _t(x), tn,
                          carry=[None if c is None else _t(c)
                                 for c in carry])
    assert torch.equal(fwd.out, tres.out)
    # a single volley
    j1 = jnetwork.step([jnp.asarray(p) for p in pj], jnp.asarray(x[0]), jn)
    t1 = network.step(convert.params_from_numpy(pj, "cpu"), _t(x[0]), tn)
    assert t1.out.shape == (1, 3) and t1.winners[0].shape == (2,)
    _eq(j1.out, t1.out)
    for a, b in zip(j1.params, t1.params):
        _close(a, b, ONE_STEP_ATOL)
    with pytest.raises(ValueError, match="entries"):
        network.step(convert.params_from_numpy(pj, "cpu"), _t(x), tn,
                     draws=[None])


@pytest.mark.parametrize("stochastic", [False, True])
def test_train_network_matches_reference(stochastic):
    """``train_network`` at B=4 over 24 volleys (the reference test's
    training smoke): winners bit-exact, weights to 1e-5 and in range."""
    jn, tn, pj = _nets()
    volleys = _volleys(np.random.default_rng(1), (24, jn.n_inputs), 14)
    key = jax.random.PRNGKey(12) if stochastic else None
    jp, jwin = jnetwork.train_network([jnp.asarray(p) for p in pj],
                                      jnp.asarray(volleys), jn,
                                      batch_size=4, key=key)
    d = ([_t(a) for a in draws_of.stream(
        key, 6, lambda k: draws_of.network(k, jn, 4))]
         if stochastic else None)
    tp, twin = network.train_network(convert.params_from_numpy(pj, "cpu"),
                                     _t(volleys), tn, batch_size=4, draws=d)
    assert twin[0].shape == (24, 2) and twin[1].shape == (24, 1)
    for a, b in zip(jwin, twin):
        _eq(a, b)
    for a, b, lc in zip(jp, tp, tn.layers):
        _close(a, b, STREAM_ATOL)
        assert float(b.min()) >= 0.0 and float(b.max()) <= lc.w_max
    res = network.network_step(convert.params_from_numpy(pj, "cpu"),
                               _t(volleys[0]), tn)
    assert res[1].shape == (1, 1, 3)


# ------------------------------------------------------------- hwcost
@pytest.fixture(scope="module")
def model():
    return hwcost.calibrate()


def test_gate_count_pc_compact():
    # paper [7]: n-1 full adders
    assert hwcost.pc_compact_counts(16)["FA"] == 15
    assert hwcost.pc_compact_counts(64)["FA"] == 63


def test_fig6_topk_gate_savings():
    """Fig. 6a: pruning + half-unit removal reduce CAS-stage gates, and
    k=2 dendrites undercut the full PC (Fig. 6b) for all studied n."""
    for n in [16, 32, 64]:
        full_sorter_gates = 2 * topk_network("auto", n, n).num_units
        topk = topk_network("auto", n, 2)
        assert topk.gate_count < full_sorter_gates
        pc_gates = (n - 1) * 4.5
        assert topk.gate_count + 1 * 4.5 < pc_gates


def test_fig6_large_k_loses():
    """At k = n/2 the CAS stage alone exceeds the PC it replaces."""
    n = 16
    big_k = topk_network("auto", n, 8).gate_count + 7 * 4.5
    assert big_k > (n - 1) * 4.5


def test_table1_reproduction_error(model):
    """Mean abs error across all 24 Table I cells stays under 5 %."""
    errs = []
    for n, rows in hwcost.TABLE1.items():
        for d, (_, _, tot, area) in rows.items():
            r = model.neuron_report(d, n, 2)
            errs.append(abs(r["area_um2"] / area - 1))
            errs.append(abs(r["total_uw"] / tot - 1))
    assert sum(errs) / len(errs) < 0.05


def test_headline_ratios(model):
    """Catwalk is 1.39x / 1.86x better in area / power than compact-PC
    neurons at n=64, improving monotonically with n."""
    ratios = {}
    for n in [16, 32, 64]:
        rc = model.neuron_report("pc_compact", n, 2)
        rk = model.neuron_report("catwalk", n, 2)
        ratios[n] = (rc["area_um2"] / rk["area_um2"],
                     rc["total_uw"] / rk["total_uw"])
    assert ratios[64][0] == pytest.approx(1.39, abs=0.05)
    assert ratios[64][1] == pytest.approx(1.86, abs=0.07)
    assert ratios[16][0] < ratios[32][0] < ratios[64][0]
    assert ratios[16][1] < ratios[32][1] < ratios[64][1]


def test_catwalk_beats_sorting(model):
    for n in [16, 32, 64]:
        rs = model.neuron_report("sorting_pc", n, 2)
        rk = model.neuron_report("catwalk", n, 2)
        assert rk["area_um2"] < rs["area_um2"]
        assert rk["total_uw"] < rs["total_uw"]


def test_leakage_tracks_area(model):
    for n in [16, 64]:
        for d in ["pc_compact", "catwalk"]:
            r = model.neuron_report(d, n, 2)
            assert r["leakage_uw"] == pytest.approx(
                r["area_um2"] * model.leakage_nw_per_um2 * 1e-3)


def test_cost_model_equals_reference():
    """The copy computes what the reference computes: every calibrated
    constant, gate count and neuron report, exactly."""
    ours, ref = hwcost.calibrated(), jhwcost.calibrated()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for design in ("pc_conventional", "pc_compact", "sorting_pc", "catwalk"):
        for n in (8, 16, 32, 64):
            for k in (1, 2):
                assert hwcost.neuron_counts(design, n, k) == \
                    jhwcost.neuron_counts(design, n, k)
                assert ours.neuron_report(design, n, k) == \
                    ref.neuron_report(design, n, k)
