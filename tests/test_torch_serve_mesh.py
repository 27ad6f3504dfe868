"""``TNNEngine(mesh=)``: the port's serving engine across ranks.

Mirrors ``tests/test_sharding_tnn.py``'s engine tests
(``test_sharded_engine_serve_bit_exact``,
``test_pallas_mesh_capability_model``'s engine half,
``test_sharded_pipelined_forward_bit_exact``'s and
``test_sharded_recurrent_carry_bit_exact``'s engines and
``test_sharded_learn_while_serving_and_crash_recovery``) on four CPU
ranks joined by gloo (``tests/_torch_dist.py``), a (2, 2) and a (1, 4)
``("data", "column")`` mesh, with the reference's single-device engine
and ``reference_outputs`` as the oracle:

* serving at n_slots = 3 (the data axis does not divide it: the slot
  batch stays whole on every rank), every request bit-exact, the same
  ``stats()`` on every rank;
* the capability model's ``stats()`` rows: ``fused`` runs where the
  columns tile the mesh (8, 4) and, on these CPU ranks, degrades to
  ``closed_form`` for C = 5;
* the pipelined and recurrent engines;
* learning while serving: outputs bit-exact, weights equal to the
  single-device port engine's bit for bit (expectation and seeded rules)
  and within 1e-6 of the reference's, rounded ints equal;
* ``serve_resilient`` through a failure injected at the same step on every
  rank: equal to the uninterrupted run with learning off, and with
  learning on equal to a replay from the restored snapshot, which one rank
  wrote.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402

MESHES = [(2, 2), (1, 4)]
#: learned weights against the reference's (its sharded test's tolerance)
W_ATOL = 1e-6
#: stats() fields that time the run, and so differ between ranks
TIMED = ("run_s", "volleys_per_s", "wait_ms", "service_ms", "latency")


@pytest.fixture(scope="module")
def ref():
    """The reference's single-device engine on the SETUP. Imported here,
    not at the top, so the file imports without JAX."""
    jax = pytest.importorskip("jax")
    from repro.core import layer as jlayer
    from repro.core import network as jnetwork
    from repro.serve import tnn_engine as jengine

    def nets(recurrent=False):
        kw = dict(recurrent=recurrent)
        return (jnetwork.make_network([jlayer.TNNLayer(**TD.L1, **kw),
                                       jlayer.TNNLayer(**TD.L2, **kw)]),
                jnetwork.make_network([jlayer.TNNLayer(**TD.ODD, **kw)]))

    net, odd = nets()
    rnet, _ = nets(recurrent=True)
    params = jnetwork.init_network(jax.random.PRNGKey(0), net)
    podd = jnetwork.init_network(jax.random.PRNGKey(1), odd)
    rparams = jnetwork.init_network(jax.random.PRNGKey(0), rnet)
    v = TD.sparse_volleys(np.random.default_rng(0), 8, net.n_inputs)
    streams = [v[:3], v[3:6], v[6:], v[1:2], v[4:6]]
    odd_in = TD.draws_for(odd.n_inputs)[0][:2]
    learn = jengine.TNNEngine(params, net, jengine.TNNServeConfig(
        n_slots=2, backend="closed_form", learn=True))
    return dict(
        params=tuple(np.asarray(p) for p in params),
        podd=tuple(np.asarray(p) for p in podd),
        rparams=tuple(np.asarray(p) for p in rparams),
        streams=streams,
        outputs=[jengine.reference_outputs(params, net, s)
                 for s in streams],
        odd_outputs=jengine.reference_outputs(podd, odd, odd_in),
        rec_outputs=[jengine.reference_outputs(rparams, rnet, s)
                     for s in streams],
        learn_outputs=learn.serve(streams),
        learn_w=[np.asarray(p) for p in learn.params])


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"mesh{s}")
def ranks(request, ref, tmp_path_factory):
    """Every rank's outputs of ``_torch_dist.engine_suite`` on one mesh."""
    snap = str(tmp_path_factory.mktemp("snapshots"))
    return TD.run("engine_suite", request.param,
                  (ref["params"], ref["podd"], ref["rparams"],
                   ref["streams"], snap),
                  str(tmp_path_factory.mktemp("ranks")))


def _same(a, b, key):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=key)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            _same(x, y, key)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), key
        for k in a:
            if not k.startswith(TIMED):
                _same(a[k], b[k], f"{key}/{k}")
    else:
        assert a == b, key


def _one(ranks):
    for other in ranks[1:]:
        for key, val in ranks[0].items():
            _same(val, other[key], key)
    return ranks[0]


def _equal_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_every_rank_returns_the_same(ranks):
    got = _one(ranks)
    assert got["serve/auto/stats"]["n_retired"] == 5.0


def test_mesh_engine_serves_the_reference_outputs(ranks, ref):
    got = _one(ranks)
    _equal_outputs(got["serve/auto"], ref["outputs"])
    st = got["serve/auto/stats"]
    assert st["n_steps"] > 0 and st["n_volleys"] == 11.0
    assert any(k.startswith("steps_") for k in st)
    n_column = got["mesh"][1]
    assert got["serve/auto/block"] == [[8 // n_column, 3, 4],
                                       [4 // n_column, 4, 6]]
    assert got["serve/init_whole_equal"]
    assert got["serve/init_whole_blocks_kept"]
    assert got["serve/blocks_refused"] == "raised"


def test_capability_rows_record_what_ran(ranks, ref):
    got = _one(ranks)
    _equal_outputs(got["cap/net"], [ref["outputs"][0][:2]])
    assert got["cap/net/stats"] == {"steps_fused": 2.0}
    _equal_outputs(got["cap/odd"], [ref["odd_outputs"]])
    assert got["cap/odd/stats"] == {"steps_closed_form": 2.0}


def test_pipelined_and_recurrent_engines(ranks, ref):
    got = _one(ranks)
    _equal_outputs(got["serve/pipelined"], ref["outputs"][:3])
    assert got["serve/pipelined/stages"] == 3.0
    _equal_outputs(got["serve/recurrent"], ref["rec_outputs"])


@pytest.mark.parametrize("rule", ["mean", "seeded"])
def test_learning_while_serving_gives_the_single_device_weights(
        ranks, rule):
    got = _one(ranks)
    assert got[f"learn/{rule}/outputs_equal_one"]
    for a, b in zip(got[f"learn/{rule}/w"], got[f"learn/{rule}/w_one"]):
        np.testing.assert_array_equal(a, b)
    steps = got[f"learn/{rule}/updates"]
    assert steps[0] == steps[1] > 0
    assert all(d > 0 for d in got[f"learn/{rule}/drift"])


def test_learning_while_serving_matches_the_reference(ranks, ref):
    got = _one(ranks)
    _equal_outputs(got["learn/mean"], ref["learn_outputs"])
    for a, b in zip(got["learn/mean/w"], ref["learn_w"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=W_ATOL)
        np.testing.assert_array_equal(np.round(a), np.round(b))


def test_serve_resilient_equals_the_uninterrupted_run(ranks, ref):
    got = _one(ranks)
    _equal_outputs(got["resilient/off"], ref["outputs"])
    report = got["resilient/off/report"]
    assert report["restarts"] == 1 and report["failed_hosts"] == [5]
    assert got["resilient/off/restores"] == 1
    assert got["snapshot_hosts"] == ["host_0", "manifest.json"]


def test_resilient_learning_replays_from_its_snapshot(ranks):
    got = _one(ranks)
    report = got["resilient/learn/report"]
    assert report["restarts"] == 1 and report["restored_steps"][0] > 0
    for a, b in zip(got["resilient/learn/w"],
                    got["resilient/learn/w_replay"]):
        np.testing.assert_array_equal(a, b)
    assert got["resilient/learn/block"] == got["learn/mean/block"]


def test_device_disagreeing_with_the_mesh_raises(ranks):
    assert _one(ranks)["device_disagrees"] == "raised"
