"""Port layers and networks vs the reference: receptive-field gathers with
overlapping strides, recurrent layers, 1-WTA ties, and ``network.forward``
barriered, pipelined (M = 1..4, ragged batches) and with carry — all bit
for bit on the spike times and winners."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import layer as jlayer  # noqa: E402
from repro.core import network as jnetwork  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import layer, network  # noqa: E402

NO_SPIKE = 2**30
BACKENDS = ("closed_form", "fused", "event", "fused_compact", "auto")


def _eq(jax_value, torch_value):
    assert torch_value.dtype == torch.int32, torch_value.dtype
    np.testing.assert_array_equal(np.asarray(jax_value), torch_value.numpy())


def _volleys(rng, shape, t_max, silent):
    t = rng.integers(0, t_max, shape)
    return np.where(rng.random(shape) < silent, NO_SPIKE, t).astype(np.int32)


def _pair(cls_kw, backend="auto"):
    """The same layer config in both packages; the reference side runs its
    closed form (every reference engine is bit-exact with every other)."""
    return (jlayer.TNNLayer(**cls_kw, backend="closed_form"),
            layer.TNNLayer(**cls_kw, backend=backend))


def _port_layers(tcfg):
    """The port layer pinned to each of its engines."""
    return [dataclasses.replace(tcfg, backend=b) for b in BACKENDS]


def _weights(cfg_kw, seed):
    j = jlayer.TNNLayer(**cfg_kw)
    return np.array(jlayer.init_layer(jax.random.PRNGKey(seed), j))


@pytest.mark.parametrize("stride", [None, 3, 1])
def test_layer_forward_overlapping_strides(stride):
    kw = dict(n_columns=4, rf_size=6, n_neurons=3, threshold=6, t_steps=16,
              dendrite="catwalk", k=2, rf_stride=stride)
    jcfg, tcfg = _pair(kw)
    assert tcfg.n_inputs == jcfg.n_inputs and tcfg.stride == jcfg.stride
    _eq(jcfg.rf_index(), tcfg.rf_index(device="cpu"))
    rng = np.random.default_rng(0 if stride is None else stride)
    x = _volleys(rng, (7, tcfg.n_inputs), 18, 0.4)
    w = _weights(kw, 1)
    out_j, win_j = jlayer.layer_forward(jnp.asarray(w), jnp.asarray(x), jcfg)
    o1_j, w1_j = jlayer.layer_forward(jnp.asarray(w), jnp.asarray(x[0]), jcfg)
    for cfg in _port_layers(tcfg):
        out_t, win_t = layer.layer_forward(torch.from_numpy(w),
                                           torch.from_numpy(x), cfg)
        _eq(out_j, out_t)
        _eq(win_j, win_t)
        # single volley drops the batch dim
        o1_t, w1_t = layer.layer_forward(torch.from_numpy(w),
                                         torch.from_numpy(x[0]), cfg)
        _eq(o1_j, o1_t)
        _eq(w1_j, w1_t)
    assert abs(layer.layer_input_density(torch.from_numpy(x), tcfg)
               - jlayer.layer_input_density(jnp.asarray(x), jcfg)) < 1e-6


def test_recurrent_layer_with_carry():
    kw = dict(n_columns=3, rf_size=5, n_neurons=4, threshold=5, t_steps=12,
              dendrite="pc_compact", recurrent=True)
    jcfg, tcfg = _pair(kw)
    assert tcfg.rf_total == jcfg.rf_total == 9
    rng = np.random.default_rng(11)
    x = _volleys(rng, (5, tcfg.n_inputs), 14, 0.3)
    carry = _volleys(rng, (5, tcfg.n_outputs), 12, 0.7)
    w = _weights(kw, 2)
    for c in (None, carry):
        out_j, win_j = jlayer.layer_forward(
            jnp.asarray(w), jnp.asarray(x), jcfg,
            None if c is None else jnp.asarray(c))
        for cfg in _port_layers(tcfg):
            out_t, win_t = layer.layer_forward(
                torch.from_numpy(w), torch.from_numpy(x), cfg,
                None if c is None else torch.from_numpy(c))
            _eq(out_j, out_t)
            _eq(win_j, win_t)
    with pytest.raises(ValueError):
        layer.layer_forward(torch.from_numpy(w), torch.from_numpy(x),
                            dataclasses.replace(tcfg, recurrent=False),
                            torch.from_numpy(carry))


def test_wta_ties_go_to_the_lowest_index():
    """Identical neurons fire at the same tick; the lowest index wins."""
    kw = dict(n_columns=2, rf_size=4, n_neurons=5, threshold=3, t_steps=10,
              dendrite="pc_compact")
    jcfg, tcfg = _pair(kw)
    w = np.full((2, 5, 4), 3.0, np.float32)
    w[1, :2] = 1.0            # column 1: neurons 2..4 tie, 0..1 fire later
    x = np.array([[0, 0, 1, 2, 0, 1, NO_SPIKE, NO_SPIKE],
                  [NO_SPIKE] * 8], np.int32)
    out_j, win_j = jlayer.layer_forward(jnp.asarray(w), jnp.asarray(x), jcfg)
    for cfg in _port_layers(tcfg):
        out_t, win_t = layer.layer_forward(torch.from_numpy(w),
                                           torch.from_numpy(x), cfg)
        _eq(out_j, out_t)
        _eq(win_j, win_t)
        assert win_t.tolist() == [[0, 2], [-1, -1]]


def test_weights_round_half_to_even():
    kw = dict(n_columns=1, rf_size=4, n_neurons=2, threshold=4, t_steps=12,
              dendrite="pc_compact")
    jcfg, tcfg = _pair(kw, "closed_form")
    w = np.array([[[0.5, 1.5, 2.5, 3.5], [2.5, 2.5, 0.5, 1.5]]], np.float32)
    x = np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.int32)
    out_j, _ = jlayer.layer_forward(jnp.asarray(w), jnp.asarray(x), jcfg)
    out_t, _ = layer.layer_forward(torch.from_numpy(w), torch.from_numpy(x),
                                   tcfg)
    _eq(out_j, out_t)


def _nets(recurrent=False, backend="auto"):
    l1 = dict(n_columns=4, rf_size=6, n_neurons=3, threshold=6, t_steps=16,
              dendrite="catwalk", k=2, rf_stride=4, recurrent=recurrent)
    l2 = dict(n_columns=2, rf_size=6, n_neurons=3, threshold=4, t_steps=16,
              dendrite="catwalk", k=2)
    jl, tl = zip(*(_pair(kw, backend) for kw in (l1, l2)))
    jn, tn = jnetwork.make_network(jl), network.make_network(tl)
    params_j = jnetwork.init_network(jax.random.PRNGKey(3), jn)
    params_t = convert.params_from_numpy([np.asarray(p) for p in params_j],
                                         "cpu")
    return jn, tn, params_j, params_t


def _check_result(res_j, res_t):
    _eq(res_j.out, res_t.out)
    assert len(res_j.winners) == len(res_t.winners)
    for a, b in zip(res_j.winners, res_t.winners):
        _eq(a, b)
    for a, b in zip(res_j.carry, res_t.carry):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a, b)


@pytest.mark.parametrize("recurrent", [False, True])
def test_forward_barriered_and_pipelined(recurrent):
    jn, tn, pj, pt = _nets(recurrent)
    port_nets = [network.make_network(_port_layers(lc)[i]
                                      for lc in tn.layers)
                 for i in range(len(BACKENDS))]
    rng = np.random.default_rng(5)
    x = _volleys(rng, (7, tn.n_inputs), 18, 0.4)       # ragged for M=2..4
    carry_np = tuple(_volleys(rng, (7, lc.n_outputs), 16, 0.6)
                     if lc.recurrent else None for lc in tn.layers)
    for carry in (None, carry_np):
        cj = None if carry is None else tuple(
            None if c is None else jnp.asarray(c) for c in carry)
        ct = None if carry is None else tuple(
            None if c is None else torch.from_numpy(c) for c in carry)
        for m in (1, 2, 3, 4):
            res_j = jnetwork.forward(pj, jnp.asarray(x), jn, microbatches=m,
                                     carry=cj)
            for net in port_nets:
                res_t = network.forward(pt, torch.from_numpy(x), net,
                                        microbatches=m, carry=ct)
                _check_result(res_j, res_t)


def test_forward_single_volley_and_densities():
    jn, tn, pj, pt = _nets(recurrent=True)
    rng = np.random.default_rng(8)
    x = _volleys(rng, (4, tn.n_inputs), 18, 0.5)
    res_j = jnetwork.forward(pj, jnp.asarray(x[0]), jn)
    res_t = network.forward(pt, torch.from_numpy(x[0]), tn)
    _check_result(res_j, res_t)
    # stream of single volleys threading the carry
    cj = ct = None
    for row in x:
        rj = jnetwork.forward(pj, jnp.asarray(row), jn, carry=cj)
        rt = network.forward(pt, torch.from_numpy(row), tn, carry=ct)
        _check_result(rj, rt)
        cj, ct = rj.carry, rt.carry
    dj = jnetwork.measured_densities(pj, jnp.asarray(x), jn)
    dt = network.measured_densities(pt, torch.from_numpy(x), tn)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        network.forward(pt, torch.from_numpy(x), tn, microbatches=2,
                        with_densities=True)
    with pytest.raises(ValueError):
        network.forward(pt, torch.from_numpy(x), tn, carry=(None,))


def test_network_helpers_match_reference():
    jn, tn, _, _ = _nets(recurrent=True)
    for first in (1, 3, 8, 40):
        assert network.sparse_widths(tn, first) == \
            jnetwork.sparse_widths(jn, first)
    for b in (0, 1, 5, 7, 64):
        for m in (1, 2, 3, 4, 100):
            assert network.microbatch_split(b, m) == \
                jnetwork.microbatch_split(b, m)
    assert tn.column_counts == jn.column_counts
    for a, b in zip(jnetwork.init_carry(jn, 3),
                    network.init_carry(tn, 3, device="cpu")):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a, b)
    _eq(jlayer.stage_init(jn.layers[1], 2),
        layer.stage_init(tn.layers[1], 2, device="cpu"))
    with pytest.raises(ValueError):
        network.make_network([tn.layers[1], tn.layers[1]])


def test_state_inits_default_to_cuda(monkeypatch):
    """``init_carry``, ``carry_init`` and ``stage_init`` run on the card
    unless the caller asks for the CPU: without CUDA, no device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tn, _, _ = _nets(recurrent=True)
    for init in (lambda: network.init_carry(tn, 3),
                 lambda: layer.carry_init(tn.layers[0], 3),
                 lambda: layer.stage_init(tn.layers[1], 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init()
    assert layer.carry_init(tn.layers[0], 3, "cpu").device.type == "cpu"


def test_rf_index_defaults_to_cuda(monkeypatch):
    """``TNNLayer.rf_index`` runs on the card unless the caller asks for
    the CPU, as every other entry point: without CUDA, no device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tn, _, _ = _nets(recurrent=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tn.layers[0].rf_index()
    idx = tn.layers[0].rf_index("cpu")
    assert idx.device.type == "cpu" and idx.dtype == torch.int32


def test_init_network_is_seeded_and_shaped():
    _, tn, pj, _ = _nets(recurrent=True)
    a = network.init_network(torch.Generator().manual_seed(0), tn, "cpu")
    b = network.init_network(torch.Generator().manual_seed(0), tn, "cpu")
    for x, y, ref in zip(a, b, pj):
        assert x.shape == ref.shape and x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert float(x.min()) >= 0.0 and float(x.max()) <= 7.0


def test_entry_points_default_to_cuda():
    """No device given means CUDA: on a host without it they raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, tn, pj, _ = _nets()
    with pytest.raises(RuntimeError, match="CUDA"):
        network.init_network(torch.Generator().manual_seed(0), tn)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_numpy([np.asarray(p) for p in pj])
