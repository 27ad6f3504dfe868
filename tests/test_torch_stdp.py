"""Port STDP rules and TNN column vs the reference.

Mirrors ``tests/test_column_stdp.py`` (WTA semantics, the STDP cases, the
clustering dynamics) on the port, and holds every STDP function of the
port against the reference's on the same numpy inputs: the expectation
rule, and the stochastic rule with the reference's own uniforms (rebuilt
from its key tree) handed in through ``draws=``. Float weights agree
within 2e-6 for one step, rounded weights and spike times bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _stdp_draws as draws_of  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import column as jcolumn  # noqa: E402
from repro.core import stdp as jstdp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import coding, column, stdp  # noqa: E402

NO_SPIKE = coding.NO_SPIKE
ONE_STEP_ATOL = 2e-6
STREAM_ATOL = 1e-5


def _cfg(dendrite="pc_compact", k=2, n=8, q=3, thr=8, T=24, **kw):
    return column.ColumnConfig(n_inputs=n, n_neurons=q, threshold=thr,
                               t_steps=T, dendrite=dendrite, k=k, **kw)


def _jcfg(cfg: column.ColumnConfig) -> jcolumn.ColumnConfig:
    """The same column in the reference (closed form: every reference
    engine is bit-exact with every other)."""
    return jcolumn.ColumnConfig(
        n_inputs=cfg.n_inputs, n_neurons=cfg.n_neurons,
        threshold=cfg.threshold, t_steps=cfg.t_steps, dendrite=cfg.dendrite,
        k=cfg.k, w_max=cfg.w_max,
        stdp=jstdp.STDPConfig(**vars(cfg.stdp)), backend="closed_form")


def _times(rng, shape, t_max=20, silent=0.4):
    t = rng.integers(0, t_max, shape)
    return np.where(rng.random(shape) < silent, NO_SPIKE,
                    t).astype(np.int32)


def _weights_close(want, got, atol):
    want, got = np.asarray(want), got.cpu().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_array_equal(np.round(got), np.round(want))


# ------------------------------------------------------------ mirrors
def test_wta_single_winner():
    cfg = _cfg(backend="closed_form")
    w = column.init_column(torch.Generator().manual_seed(0), cfg, "cpu")
    times = torch.from_numpy(np.random.default_rng(1).integers(
        0, 12, 8).astype(np.int32))
    out, winner = column.column_forward(w, times, cfg)
    assert out.dtype == torch.int32 and winner.dtype == torch.int32
    if int(winner) >= 0:
        assert int((out < NO_SPIKE).sum()) == 1
        assert int(out[int(winner)]) < NO_SPIKE
    else:
        assert bool((out == NO_SPIKE).all())


def test_wta_tie_breaks_to_lowest_index():
    cfg = _cfg(q=2, thr=2, T=16, backend="closed_form")
    w = torch.full((2, 8), 7.0)                   # identical neurons
    _, winner = column.column_forward(w, torch.zeros(8, dtype=torch.int32),
                                      cfg)
    assert int(winner) == 0


def test_stdp_capture_increases_causal_weights():
    cfg = stdp.STDPConfig()
    w = torch.full((4,), 3.0)
    in_times = torch.tensor([0, 1, NO_SPIKE, 9], dtype=torch.int32)
    new = stdp.stdp_update(w, in_times, torch.tensor(5, dtype=torch.int32),
                           cfg)
    assert float(new[0]) > 3.0          # causal -> capture
    assert float(new[1]) > 3.0
    assert float(new[2]) < 3.0          # silent input, output fired -> backoff
    assert float(new[3]) < 3.0          # anti-causal -> backoff
    want = jstdp.stdp_update(jnp.full((4,), 3.0), jnp.asarray(in_times),
                             jnp.int32(5), jstdp.STDPConfig())
    np.testing.assert_array_equal(new.numpy(), np.asarray(want))


def test_stdp_search_when_no_output():
    cfg = stdp.STDPConfig()
    w = torch.full((2,), 3.0)
    in_times = torch.tensor([2, NO_SPIKE], dtype=torch.int32)
    new = stdp.stdp_update(w, in_times, NO_SPIKE, cfg)
    assert float(new[0]) > 3.0          # search raises spiking synapse
    assert float(new[1]) == 3.0         # nothing happened on this line


def test_stdp_weights_stay_in_range():
    cfg = stdp.STDPConfig(w_max=7)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    w = torch.tensor([0.0, 7.0, 3.5, 6.9])
    for _ in range(20):
        in_times = torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32))
        w = stdp.stdp_update(w, in_times, 5, cfg, key=gen)
        assert float(w.min()) >= 0.0 and float(w.max()) <= 7.0
        assert bool(((w * 4) == torch.round(w * 4)).all())  # B is 0 or 1


def _two_cluster_volleys(rng, m, n=16, t_max=16, active=4):
    """Sparse synthetic patterns (25 % line activity): class 0 lights lines
    [0, active) early, class 1 lights [n/2, n/2 + active). Returns
    (volleys, labels) as numpy."""
    labels = (rng.random(m) < 0.5).astype(np.int64)
    jit = rng.integers(0, 3, (m, n))
    t = np.full((m, n), 40)
    t[:, :active] = np.where(labels[:, None] == 0, jit[:, :active], 40)
    t[:, n // 2:n // 2 + active] = np.where(labels[:, None] == 1,
                                            jit[:, active:2 * active], 40)
    return np.where(t >= t_max, NO_SPIKE, t).astype(np.int32), labels


@pytest.mark.parametrize("dendrite,thr", [("pc_compact", 18),
                                          ("catwalk", 12)])
def test_column_learns_two_clusters(dendrite, thr):
    """Online STDP reaches full clustering purity with either dendrite, and
    the port's run is the reference's: the same stream and weights give
    the same winners and, to 1e-5, the same final weights."""
    scfg = stdp.STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=0.5)
    cfg = column.ColumnConfig(n_inputs=16, n_neurons=2, threshold=thr,
                              t_steps=16, dendrite=dendrite, k=2, stdp=scfg)
    volleys, labels = _two_cluster_volleys(np.random.default_rng(7), 400)
    w0 = np.asarray(jcolumn.init_column(jax.random.PRNGKey(42), _jcfg(cfg)))
    w, winners = column.train_column(convert.column_from_numpy(w0, "cpu"),
                                     torch.from_numpy(volleys), cfg)
    purity = column.cluster_purity(winners[200:],
                                   torch.from_numpy(labels[200:]), 2, 2)
    assert float(purity) > 0.95, f"{dendrite} purity {float(purity)}"
    wn = w.numpy()
    assert {int(np.argmax(wn[0]) // 8), int(np.argmax(wn[1]) // 8)} == {0, 1}
    jw, jwin = jcolumn.train_column(jnp.asarray(w0), jnp.asarray(volleys),
                                    _jcfg(cfg))
    np.testing.assert_array_equal(winners.numpy(), np.asarray(jwin))
    _weights_close(jw, w, STREAM_ATOL)


def test_cluster_purity_bounds():
    winners = torch.tensor([0, 0, 1, 1, -1])
    labels = torch.tensor([0, 0, 1, 1, 0])
    p = column.cluster_purity(winners, labels, 2, 2)
    assert 0.0 <= float(p) <= 1.0
    assert float(p) == pytest.approx(0.8)
    want = jcolumn.cluster_purity(jnp.asarray(winners.numpy()),
                                  jnp.asarray(labels.numpy()), 2, 2)
    assert float(p) == float(want)


# ----------------------------------------------------- cross-package
STDP_CONFIGS = {
    "default": dict(),
    "clustering": dict(mu_capture=1.0, mu_backoff=1.0, mu_search=0.5),
    "unstabilized": dict(stabilize=False, mu_search=0.75),
}


@pytest.mark.parametrize("name", sorted(STDP_CONFIGS))
@pytest.mark.parametrize("stochastic", [False, True])
def test_stdp_rules_match_reference(name, stochastic):
    """``stdp_delta``, ``stdp_update`` and ``stdp_update_column`` on random
    weights, volleys and WTA outcomes (silent columns included) against the
    reference, expectation rule and stochastic rule with its draws."""
    jcfg = jstdp.STDPConfig(**STDP_CONFIGS[name])
    cfg = stdp.STDPConfig(**STDP_CONFIGS[name])
    rng = np.random.default_rng(len(name) + 10 * stochastic)
    q, n = 4, 12
    for trial in range(6):
        w = (rng.random((q, n)) * 7).astype(np.float32)
        w[0, :3] = [0.0, 7.0, 3.5]                     # the rails
        x = _times(rng, (n,))
        out_t = _times(rng, (q,), silent=0.5)
        winner = int(rng.integers(-1, q))
        key = jax.random.PRNGKey(trial) if stochastic else None

        d_draws = (torch.from_numpy(draws_of.delta(key, (n,)))
                   if stochastic else None)
        want = jstdp.stdp_delta(jnp.asarray(w[1]), jnp.asarray(x),
                                jnp.int32(out_t[1]), jcfg, key)
        got = stdp.stdp_delta(torch.from_numpy(w[1]), torch.from_numpy(x),
                              int(out_t[1]), cfg, draws=d_draws)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = jstdp.stdp_update(jnp.asarray(w[1]), jnp.asarray(x),
                                 jnp.int32(out_t[1]), jcfg, key)
        got = stdp.stdp_update(torch.from_numpy(w[1]), torch.from_numpy(x),
                               int(out_t[1]), cfg, draws=d_draws)
        _weights_close(want, got, ONE_STEP_ATOL)

        c_draws = (torch.from_numpy(draws_of.column(key, q, n))
                   if stochastic else None)
        want = jstdp.stdp_update_column(
            jnp.asarray(w), jnp.asarray(x), jnp.asarray(out_t),
            jnp.int32(winner), jcfg, key)
        got = stdp.stdp_update_column(
            torch.from_numpy(w), torch.from_numpy(x),
            torch.from_numpy(out_t), winner, cfg, draws=c_draws)
        _weights_close(want, got, ONE_STEP_ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_minibatch_rule_matches_reference_over_columns(reduction,
                                                       stochastic):
    """``stdp_update_column_minibatch`` on C columns at once (the layer's
    call) against the reference column by column."""
    cfg, jcfg = stdp.STDPConfig(), jstdp.STDPConfig()
    rng = np.random.default_rng(3 + stochastic)
    c, bsz, q, n = 3, 6, 4, 10
    w = (rng.random((c, q, n)) * 7).astype(np.float32)
    x = _times(rng, (c, bsz, n))
    out_t = _times(rng, (c, bsz, q), silent=0.5)
    win = rng.integers(-1, q, (c, bsz)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    want = np.stack([np.asarray(jstdp.stdp_update_column_minibatch(
        jnp.asarray(w[i]), jnp.asarray(x[i]), jnp.asarray(out_t[i]),
        jnp.asarray(win[i]), jcfg, keys[i] if stochastic else None,
        reduction=reduction)) for i in range(c)])
    draws = (torch.from_numpy(np.stack([
        draws_of.minibatch(keys[i], bsz, q, n) for i in range(c)]))
        if stochastic else None)
    got = stdp.stdp_update_column_minibatch(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(out_t),
        torch.from_numpy(win), cfg, reduction=reduction, draws=draws)
    _weights_close(want, got, ONE_STEP_ATOL)


def test_minibatch_b1_equals_column_rule():
    """At B=1 the minibatch rule is the per-volley column rule, bit for bit
    (the reference's stated invariant)."""
    cfg = stdp.STDPConfig()
    rng = np.random.default_rng(8)
    for winner in (-1, 0, 2):
        w = torch.from_numpy((rng.random((3, 9)) * 7).astype(np.float32))
        x = torch.from_numpy(_times(rng, (9,)))
        out_t = torch.from_numpy(_times(rng, (3,), silent=0.3))
        mb = stdp.stdp_update_column_minibatch(
            w, x[None], out_t[None], torch.tensor([winner]), cfg)
        one = stdp.stdp_update_column(w, x, out_t, winner, cfg)
        assert torch.equal(mb, one)


def test_rule_arguments_are_checked():
    cfg = stdp.STDPConfig()
    w = torch.full((2, 4), 3.0)
    x = torch.zeros((3, 4), dtype=torch.int32)
    out_t = torch.zeros((3, 2), dtype=torch.int32)
    win = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="reduction"):
        stdp.stdp_update_column_minibatch(w, x, out_t, win, cfg,
                                          reduction="max")
    with pytest.raises(ValueError, match="not both"):
        stdp.stdp_update_column_minibatch(
            w, x, out_t, win, cfg, torch.Generator(),
            draws=torch.zeros((3, 2, 4)))
    with pytest.raises(ValueError, match="shape"):
        stdp.stdp_update_column_minibatch(w, x, out_t, win, cfg,
                                          draws=torch.zeros((2, 4)))


def test_generator_rule_is_seeded_and_draws_replay_it():
    """A seeded generator gives the same update every time, and its own
    uniforms handed in as ``draws`` give that update too."""
    cfg = stdp.STDPConfig()
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.random((2, 3, 8)) * 7).astype(np.float32))
    x = torch.from_numpy(_times(rng, (2, 5, 8)))
    out_t = torch.from_numpy(_times(rng, (2, 5, 3), silent=0.5))
    win = torch.from_numpy(rng.integers(-1, 3, (2, 5)).astype(np.int32))
    a = stdp.stdp_update_column_minibatch(
        w, x, out_t, win, cfg, torch.Generator().manual_seed(9))
    b = stdp.stdp_update_column_minibatch(
        w, x, out_t, win, cfg, torch.Generator().manual_seed(9))
    u = torch.rand((2, 5, 3, 8), generator=torch.Generator().manual_seed(9))
    c = stdp.stdp_update_column_minibatch(w, x, out_t, win, cfg, draws=u)
    assert torch.equal(a, b) and torch.equal(a, c)
    expect = stdp.stdp_update_column_minibatch(w, x, out_t, win, cfg)
    assert not torch.equal(a, expect)
