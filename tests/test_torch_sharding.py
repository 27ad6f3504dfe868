"""The port's TNN sharding rules, the sharded RNL wrappers and the mesh
path through ``fire_times_bank``, ``layer_forward``, ``layer_step``,
``network.forward`` / ``step`` / ``init_network`` and the policy.

Mirrors ``tests/test_sharding_tnn.py`` and ``tests/test_sharding_specs.py``:

* The rules (``specs.tnn_*``, ``batch_pspec``, ``_fit``) against the
  reference's over a grid of meshes, column counts, batches and line
  counts. Both packages' rules read only a mesh's axis names and sizes,
  so stand-ins serve in this process.
* Four CPU ranks joined by gloo (``tests/_torch_dist.py``) on a (2, 2)
  and a (1, 4) ``("data", "column")`` mesh, on the reference SETUP's
  networks (C = 8 then 4, which tile the column axis, and C = 5, which
  takes the replication fallback), held against the reference's
  single-device outputs: the forwards on every engine, with the
  all-silent and fully-dense draws, pipelined and recurrent; ``layer_step``
  (weights equal to the port's on one device, within 1e-6 of the
  reference's with the rounded ints equal; ``test_sharding_tnn.py``
  accepts the same 1e-6); ``init_network(mesh=)``; the eager sharded bank,
  where the reference raises ``TypeError`` outside ``jit``
  (``test_sharding_pallas.py::test_lane_bucket_boundary_widths``); the
  policy's capability model (``test_pallas_mesh_capability_model``, pallas
  read as fused); the wrappers' raises; and ``tnn_mesh``'s validation at
  world size 4.
* The tiles: every rank's block of a stack launched one after another
  through the wrappers equals the whole launch (in this process on the
  plain versions; on the card, in the ``cuda`` test at the end).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
from repro_torch.core import neuron, policy  # noqa: E402
from repro_torch.kernels import rnl_neuron, rnl_shard  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

MESHES = [(2, 2), (1, 4)]
#: STDP weights against the reference (its sharded test's tolerance)
W_ATOL = 1e-6


@dataclasses.dataclass
class _RefMesh:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    dims: dict

    @property
    def axis_names(self):
        return tuple(self.dims)

    @property
    def shape(self):
        return dict(self.dims)


@pytest.fixture(scope="module")
def ref():
    """The reference package and its single-device outputs on the SETUP.
    Imported here, not at the top, so the ``cuda`` test below also runs on
    a GPU machine without JAX."""
    jax = pytest.importorskip("jax")
    from repro.core import layer as jlayer
    from repro.core import network as jnetwork
    from repro.core import neuron as jneuron

    def nets(backend="closed_form", recurrent=False):
        kw = dict(backend=backend, recurrent=recurrent)
        return (jnetwork.make_network([jlayer.TNNLayer(**TD.L1, **kw),
                                       jlayer.TNNLayer(**TD.L2, **kw)]),
                jnetwork.make_network([jlayer.TNNLayer(**TD.ODD, **kw)]))

    net, odd = nets()
    rnet, rodd = nets(recurrent=True)
    host = lambda ps: tuple(np.asarray(p) for p in ps)  # noqa: E731
    out = dict(
        params=host(jnetwork.init_network(jax.random.PRNGKey(0), net)),
        podd=host(jnetwork.init_network(jax.random.PRNGKey(1), odd)),
        rparams=host(jnetwork.init_network(jax.random.PRNGKey(0), rnet)),
        rpodd=host(jnetwork.init_network(jax.random.PRNGKey(1), rodd)))
    for tag, cfg, ps in (("net", net, out["params"]),
                         ("odd", odd, out["podd"])):
        for i, vol in enumerate(TD.draws_for(cfg.n_inputs)):
            res = jnetwork.forward(ps, vol, cfg)
            out[f"fwd/{tag}/{i}/out"] = np.asarray(res.out)
            out[f"fwd/{tag}/{i}/win"] = [np.asarray(w) for w in res.winners]
            lo, lw = jlayer.layer_forward(ps[0], vol, cfg.layers[0])
            out[f"layer/{tag}/{i}/out"] = np.asarray(lo)
            out[f"layer/{tag}/{i}/win"] = np.asarray(lw)
        vol = TD.draws_for(cfg.n_inputs)[0]
        lc = cfg.layers[0]
        w = np.round(ps[0]).astype(np.float32)
        new_w, o, win = jlayer.layer_step(w, vol, lc)
        out[f"step/{tag}/w"] = np.asarray(new_w)
        out[f"step/{tag}/out"] = np.asarray(o)
        out[f"step/{tag}/win"] = np.asarray(win)
        rf = np.swapaxes(vol[:, np.asarray(lc.rf_index())], 0, 1)
        out[f"bank/{tag}"] = np.asarray(jneuron.fire_times_bank(
            rf, np.round(ps[0]).astype(np.int32), lc.neuron_config(),
            backend="closed_form"))
    vol = TD.draws_for(net.n_inputs)[0]
    out["densities"] = np.asarray(jnetwork.forward(
        out["params"], vol, net, with_densities=True).densities)
    for tag, cfg, ps in (("net", rnet, out["rparams"]),
                         ("odd", rodd, out["rpodd"])):
        seq = TD.draws_for(cfg.n_inputs)[:4]
        carry = None
        for t, vol in enumerate(seq):
            res = jnetwork.forward(ps, vol, cfg, carry=carry)
            out[f"rec/{tag}/{t}"] = np.asarray(res.out)
            carry = res.carry
        out[f"rec/{tag}/carry"] = [np.asarray(c) for c in carry]
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"mesh{s}")
def ranks(request, ref, tmp_path_factory):
    """Every rank's outputs of ``_torch_dist.core_suite`` on one mesh."""
    return TD.run("core_suite", request.param,
                  (ref["params"], ref["podd"], ref["rparams"],
                   ref["rpodd"]),
                  str(tmp_path_factory.mktemp("ranks")))


# ------------------------------------------------------------ the rules

def _grid_meshes():
    return [(d, c) for d in (1, 2, 3) for c in (1, 2, 4, 8)]


@pytest.mark.parametrize("n_data,n_column", _grid_meshes())
def test_tnn_rules_match_reference(n_data, n_column):
    from repro.sharding import specs as jspecs
    port = TD.MeshShape({"data": n_data, "column": n_column})
    jref = _RefMesh({"data": n_data, "column": n_column})
    for c in (1, 3, 5, 8, 12, 24, 32):
        assert specs.tnn_param_pspec(port, c) == \
            tuple(jspecs.tnn_param_pspec(jref, c))
        assert specs.tnn_column_size(port) == n_column
        for b in (1, 2, 3, 6, 8, 64):
            assert specs.tnn_data_pspec(port, c, b) == \
                tuple(jspecs.tnn_data_pspec(jref, c, b))
            assert specs.tnn_batch_pspec(port, b) == \
                tuple(jspecs.tnn_batch_pspec(jref, b))
            assert specs.batch_pspec(port, b, 2) == \
                tuple(jspecs.batch_pspec(jref, b, 2))
            for n in (4, 24, 96, 384, 512):
                assert specs.tnn_stage_pspec(port, b, n) == \
                    tuple(jspecs.tnn_stage_pspec(jref, b, n))
                assert specs.tnn_carry_pspec(port, b, n) == \
                    tuple(jspecs.tnn_carry_pspec(jref, b, n))
    for dim in (1, 2, 6, 7, 16):
        for axis in (None, "data", "column", ("data", "column"),
                     ("column", "data")):
            assert specs._fit(port, dim, axis) == jspecs._fit(jref, dim,
                                                              axis)
            assert specs.axis_size(port, axis) == \
                jspecs.axis_size(jref, axis)
    assert specs.dp_axes(port) == jspecs.dp_axes(jref)


def test_axis_entries_match_reference():
    from repro.sharding import specs as jspecs
    assert specs.TNN_COLUMN_AXIS == jspecs.TNN_COLUMN_AXIS
    assert specs.dp_spec_names() == jspecs.dp_spec_names()
    for name in ("tnn_param_axes", "tnn_volley_axes", "tnn_stage_axes",
                 "tnn_carry_axes"):
        assert getattr(specs, name)() == getattr(jspecs, name)(), name
    # no mesh: the single-device path
    assert specs.tnn_column_size() == 1
    x = torch.zeros(3, 2)
    assert specs.maybe_wsc(x, "data", None) is x
    assert specs.shard_of(x, ("data", None), None) is x
    assert specs.gather(x, ("data", None), None) is x


def test_ambient_fit_and_block_checks():
    mesh = TD.MeshShape({"data": 2, "column": 4})
    assert specs.ambient_fit(8, "column", mesh) == "column"
    assert specs.ambient_fit(6, "column", mesh) is None
    assert specs.ambient_fit(6, specs.dp_spec_names(), mesh) == "data"
    assert specs.ambient_fit(6, ("model",), mesh) is None
    assert specs.ambient_fit(8, "column") is None
    # a rank's block passes, the whole stack and other blocks raise
    assert specs.maybe_wsc(torch.zeros(2, 3, 4), "column", ("pod", "data"),
                           None, mesh=mesh, shape=(8, 6, 4)) is not None
    specs.maybe_wsc(torch.zeros(5, 3, 4), "column", "data", None,
                    mesh=mesh, shape=(5, 6, 4))      # C = 5: whole
    for bad in ((8, 6, 4), (2, 6, 4), (4, 3, 4)):
        with pytest.raises(ValueError):
            specs.maybe_wsc(torch.zeros(bad), "column", "data", None,
                            mesh=mesh, shape=(8, 6, 4))
    with pytest.raises(ValueError):
        specs.maybe_wsc(torch.zeros(2, 3, 4), "column", mesh=mesh)


# ------------------------------------------------------- the tiles, here

def _tiles(times, weights, n_data, n_column, fn, compact=False):
    """Every rank's block launched one after another through ``fn``, the
    blocks put back together; a stand-in mesh (no rank needs another)."""
    mesh = TD.MeshShape({"data": n_data, "column": n_column})
    c, b = times.shape[:2]
    col, dp = rnl_shard._mesh_specs(c, b, mesh)
    nc, nd = c // n_column, (b // n_data if dp else b)
    rows = []
    for j in range(n_data if dp else 1):
        cols = []
        for i in range(n_column):
            t = times[i * nc:(i + 1) * nc, j * nd:(j + 1) * nd]
            w = (weights[i * nc:(i + 1) * nc, j * nd:(j + 1) * nd]
                 if compact else weights[i * nc:(i + 1) * nc])
            cols.append(fn(t.contiguous(), w.contiguous(), t_steps=12,
                           threshold=5, k=2, mesh=mesh,
                           shape=tuple(times.shape)))
        rows.append(torch.cat(cols, dim=0))
    return torch.cat(rows, dim=1)


def _stack(seed, c=8, b=6, n=8, q=3, t_steps=12):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 20, (c, b, n))
    t = np.where(t >= t_steps, TD.NO_SPIKE, t).astype(np.int32)
    w = rng.integers(0, 8, (c, q, n)).astype(np.int32)
    return torch.from_numpy(t), torch.from_numpy(w)


@pytest.mark.parametrize("n_data,n_column", [(1, 1), (1, 2), (2, 2),
                                             (2, 4), (3, 8), (4, 8)])
def test_tiles_equal_the_whole_launch(n_data, n_column):
    from repro_torch.core import compaction
    times, weights = _stack(n_data * 10 + n_column)
    whole = rnl_neuron.rnl_fire_times_layer(times, weights, t_steps=12,
                                            threshold=5, k=2)
    for fn in (rnl_shard.rnl_fire_times_layer_sharded,
               rnl_shard.rnl_fire_times_layer_sharded_plain):
        assert torch.equal(_tiles(times, weights, n_data, n_column, fn),
                           whole)
    comp = compaction.compact_volleys(times, 12)
    w_c = compaction.gather_weights(weights, comp.line_index)
    for fn in (rnl_shard.rnl_fire_times_compact_sharded,
               rnl_shard.rnl_fire_times_compact_sharded_plain):
        assert torch.equal(_tiles(comp.times, w_c, n_data, n_column, fn,
                                  compact=True), whole)


def test_wrappers_raise_the_references_errors():
    times, weights = _stack(0, c=5)
    kw = dict(t_steps=12, threshold=5, k=2)
    for fn in (rnl_shard.rnl_fire_times_layer_sharded,
               rnl_shard.rnl_fire_times_layer_sharded_plain):
        with pytest.raises(ValueError, match="no mesh"):
            fn(times, weights, **kw)
        with pytest.raises(ValueError, match="no 'column' axis"):
            fn(times, weights, mesh=TD.MeshShape({"data": 2}), **kw)
        with pytest.raises(ValueError, match="do not divide"):
            fn(times, weights, mesh=TD.MeshShape({"data": 1, "column": 2}),
               **kw)
        # the whole stack where a block is due: the block check raises
        t8, w8 = _stack(0)
        with pytest.raises(ValueError, match="block"):
            fn(t8, w8, mesh=TD.MeshShape({"data": 1, "column": 2}), **kw)


def test_policy_capability_model():
    """``test_pallas_mesh_capability_model``'s assertions, pallas read as
    fused and the TPU check read as a CUDA device, on a stand-in (2, 4)
    mesh; the bank itself tile by tile, every engine equal to the
    closed form."""
    mesh = TD.MeshShape({"data": 2, "column": 4})
    pol = policy.default_policy()
    assert neuron.mesh_active(mesh) and not neuron.mesh_active(None)
    assert pol.resolve("fused", column_counts=8, mesh=mesh).engine == "fused"
    assert pol.resolve("fused_compact", column_counts=(8, 4),
                       mesh=mesh).engine == "fused_compact"
    assert pol.resolve("fused", mesh=mesh).engine == "closed_form"
    assert pol.resolve("fused", column_counts=5,
                       mesh=mesh).engine == "closed_form"
    assert pol.resolve("fused_compact", column_counts=5,
                       mesh=mesh).engine == "event"
    assert pol.resolve("fused", column_counts=5,
                       mesh=mesh).requested == "fused"
    assert pol.resolve("auto", column_counts=8,
                       mesh=mesh).requested != "fused"
    assert pol.resolve("auto", column_counts=8, mesh=mesh,
                       device="cuda").engine == "fused"
    # on a CUDA device a stack that does not tile runs the kernel on its
    # replicated block: no degradation, and auto stays fused
    assert pol.resolve("fused", column_counts=5, mesh=mesh,
                       device="cuda").engine == "fused"
    assert pol.resolve("fused_compact", column_counts=5, mesh=mesh,
                       device="cuda").engine == "fused_compact"
    assert not pol.wants_density("auto", "cuda")
    assert pol.wants_density("auto", "cpu")
    assert policy.density_policy().resolve(
        "auto", column_counts=5, density=0.1, mesh=mesh,
        device="cuda").engine == "fused"
    # a mesh without a column axis degrades the fused engines
    assert pol.resolve("fused", column_counts=8, mesh=TD.MeshShape(
        {"data": 2})).engine == "closed_form"
    assert pol.resolve("fused").engine == "fused"
    times, weights = _stack(3, c=8, b=8)
    cfg = neuron.NeuronConfig(n_inputs=8, threshold=5, t_steps=12, k=2)
    want = neuron.fire_times_bank(times, weights, cfg,
                                  backend="closed_form")
    for backend in ("fused", "fused_compact", "auto"):
        got = _tiles(times, weights, 2, 4, lambda t, w, mesh, shape, **_:
                     neuron.fire_times_bank(t, w, cfg, backend=backend,
                                            mesh=mesh, shape=shape))
        assert torch.equal(got, want), backend


# ------------------------------------------------------ gloo ranks, here

def _one(ranks):
    """Rank 0's outputs, after checking every rank returned the same."""
    first = ranks[0]
    for other in ranks[1:]:
        for key, val in first.items():
            if key == "coordinate":
                continue
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(val, other[key], err_msg=key)
            else:
                assert val == other[key], key
    return first


def test_ranks_agree_and_cover_the_mesh(ranks):
    got = _one(ranks)
    # gathers order the pieces by mesh coordinate, not by rank
    assert all(got[f"gather/{tag}{part}"] for tag in ("mesh", "reversed")
               for part in ("", "/both_axes"))
    coords = sorted(tuple(r["coordinate"]) for r in ranks)
    shape = (max(c[0] for c in coords) + 1, max(c[1] for c in coords) + 1)
    assert coords == [(d, c) for d in range(shape[0])
                      for c in range(shape[1])]
    assert "fwd/fused/net/0/out" in got


def test_forward_bit_exact_every_engine(ranks, ref):
    got = _one(ranks)
    for backend in TD.BACKENDS:
        for tag in ("net", "odd"):
            for i in range(5):
                key = f"{backend}/{tag}/{i}"
                np.testing.assert_array_equal(
                    got[f"fwd/{key}/out"], ref[f"fwd/{tag}/{i}/out"], key)
                for li, w in enumerate(ref[f"fwd/{tag}/{i}/win"]):
                    np.testing.assert_array_equal(
                        got[f"fwd/{key}/win{li}"], w, key)
                np.testing.assert_array_equal(
                    got[f"layer/{key}/out"], ref[f"layer/{tag}/{i}/out"],
                    key)
                np.testing.assert_array_equal(
                    got[f"layer/{key}/win"], ref[f"layer/{tag}/{i}/win"],
                    key)


def test_densities_measured_on_the_whole_batch(ranks, ref):
    np.testing.assert_allclose(_one(ranks)["densities"], ref["densities"],
                               rtol=0, atol=1e-7)


def test_pipelined_forward_bit_exact(ranks, ref):
    got = _one(ranks)
    for backend in ("closed_form", "fused", "fused_compact"):
        for m in (2, 3, 8, 20):
            np.testing.assert_array_equal(got[f"pipe/{backend}/{m}/out"],
                                          ref["fwd/net/0/out"])
            for li, w in enumerate(ref["fwd/net/0/win"]):
                np.testing.assert_array_equal(
                    got[f"pipe/{backend}/{m}/win{li}"], w)


def test_recurrent_carry_bit_exact(ranks, ref):
    got = _one(ranks)
    for tag in ("net", "odd"):
        for m in (1, 3):
            for t in range(4):
                np.testing.assert_array_equal(got[f"rec/{tag}/{m}/{t}"],
                                              ref[f"rec/{tag}/{t}"])
            for li, c in enumerate(ref[f"rec/{tag}/carry"]):
                np.testing.assert_array_equal(
                    got[f"rec/{tag}/{m}/carry{li}"], c)


def test_layer_step_gives_the_single_device_weights(ranks, ref):
    got = _one(ranks)
    for tag in ("net", "odd"):
        for rule in ("mean", "seeded"):
            key = f"step/{tag}/{rule}"
            np.testing.assert_array_equal(got[f"{key}/w"],
                                          got[f"{key}/w_one"])
            np.testing.assert_array_equal(got[f"{key}/out"],
                                          ref[f"step/{tag}/out"])
            np.testing.assert_array_equal(got[f"{key}/win"],
                                          ref[f"step/{tag}/win"])
        # the expectation rule against the reference
        w = got[f"step/{tag}/mean/w"]
        np.testing.assert_allclose(w, ref[f"step/{tag}/w"], rtol=0,
                                   atol=W_ATOL)
        np.testing.assert_array_equal(np.round(w),
                                      np.round(ref[f"step/{tag}/w"]))
    mesh_cols = 8 // max(c[1] + 1 for c in (r["coordinate"] for r in ranks))
    assert got["step/net/mean/block"] == [mesh_cols, 3, 4]
    assert got["step/odd/mean/block"] == [5, 3, 4]


def test_network_step_equals_one_device(ranks):
    got = _one(ranks)
    for li in range(2):
        np.testing.assert_array_equal(got[f"nstep/w{li}"],
                                      got[f"nstep/w{li}_one"])
    np.testing.assert_array_equal(got["nstep/out"], got["nstep/out_one"])


def test_init_network_keeps_each_ranks_block(ranks):
    got = _one(ranks)
    n_column = max(r["coordinate"][1] for r in ranks) + 1
    assert got["init/net/equal"] and got["init/odd/equal"]
    assert got["init/net/specs"] == (("column", None, None),) * 2
    assert got["init/net/blocks"] == [[8 // n_column, 3, 4],
                                      [4 // n_column, 4, 6]]
    assert got["init/odd/specs"] == ((None, None, None),)
    assert got["init/odd/blocks"] == [[5, 3, 4]]


def test_eager_sharded_bank_equals_reference_single_device(ranks, ref):
    """The reference raises ``TypeError`` for an eager bank call under its
    mesh; the port computes, equal to the reference's single-device
    answer, and refuses a block that is not the rank's."""
    got = _one(ranks)
    for tag in ("net", "odd"):
        for backend in ("fused", "fused_compact", "auto"):
            np.testing.assert_array_equal(got[f"bank/{tag}/{backend}"],
                                          ref[f"bank/{tag}"])
    assert got["bank/net/wrong_block"] == "raised"


def test_policy_capability_on_the_mesh(ranks):
    assert _one(ranks)["policy"] == dict(
        active=True, fused8="fused", compact84="fused_compact",
        unknown="closed_form", fused5="closed_form", compact5="event",
        requested5="fused", auto8_cpu="closed_form", auto8_cuda="fused",
        auto5_cuda_density="fused", fused5_cuda="fused")


def test_wrappers_raise_on_the_mesh(ranks):
    raises = _one(ranks)["raises"]
    assert raises["no_mesh"].startswith("no mesh")
    assert "do not divide" in raises["not_tiling"]


def test_tnn_mesh_validation_at_world_size_4(ranks):
    got = _one(ranks)
    errors = got["tnn_mesh_errors"]
    assert len(errors) == 5 and all(errors.values()), errors
    assert got["tnn_mesh_default"] == (1, 4)
    assert got["tnn_mesh_2_2"] == (2, 2)


def test_tnn_mesh_validates_before_any_process_group():
    for bad in (dict(n_data=3), dict(n_column=16), dict(n_column=0),
                dict(n_column=4, n_data=0), dict(n_column=-2)):
        with pytest.raises(ValueError):
            specs.tnn_mesh(**bad, devices=range(4), device_type="cpu")


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_cuda_tiles_equal_the_whole_launch():
    """Every rank's tile of an m-way column, d-way data mesh launched on
    the card through the wrappers, one after another, equals the whole
    launch and the plain version bit for bit; the wrappers count their
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    from repro_torch.core import compaction
    dev = torch.device("cuda")
    times, weights = (x.to(dev) for x in _stack(5, c=16, b=8, n=16, q=4))
    whole = rnl_neuron.rnl_fire_times_layer(times, weights, t_steps=12,
                                            threshold=5, k=2)
    plain = rnl_neuron.rnl_fire_times_layer_plain(times, weights,
                                                  t_steps=12, threshold=5,
                                                  k=2)
    assert torch.equal(whole, plain)
    comp = compaction.compact_volleys(times, 12)
    w_c = compaction.gather_weights(weights, comp.line_index)
    for n_data in (1, 2):
        for n_column in (2, 4, 8):
            rnl_shard.reset_launches()
            got = _tiles(times, weights, n_data, n_column,
                         rnl_shard.rnl_fire_times_layer_sharded)
            got_c = _tiles(comp.times, w_c, n_data, n_column,
                           rnl_shard.rnl_fire_times_compact_sharded,
                           compact=True)
            torch.cuda.synchronize()
            assert torch.equal(got, whole) and torch.equal(got_c, whole)
            assert rnl_shard.LAUNCHES == {
                "rnl_fire_times_layer_sharded": n_data * n_column,
                "rnl_fire_times_compact_sharded": n_data * n_column}


def _replicated_bank(dev):
    """C = 5 on a 4-way column axis (whole on every rank), the batch split
    over a 2-way data axis: this rank's (5, 3, n) block through the bank
    on each fused engine, against the whole bank's first rows."""
    cfg = neuron.NeuronConfig(n_inputs=8, threshold=5, t_steps=12,
                              dendrite="catwalk", k=2)
    times, weights = (x.to(dev) for x in _stack(9, c=5, b=6))
    mesh = TD.MeshShape({"data": 2, "column": 4})
    out = {}
    for backend in ("fused", "fused_compact"):
        want = neuron.fire_times_bank(times, weights, cfg,
                                      backend="closed_form")[:, :3]
        rnl_neuron.reset_launches()
        rnl_shard.reset_launches()
        got = neuron.fire_times_bank(times[:, :3].contiguous(), weights,
                                     cfg, backend=backend, mesh=mesh,
                                     shape=tuple(times.shape))
        out[backend] = (torch.equal(got, want),
                        {k: v for k, v in {**rnl_neuron.LAUNCHES,
                                           **rnl_shard.LAUNCHES}.items()
                         if v})
    return out


def test_replicated_bank_degrades_on_the_cpu():
    """On CPU blocks a stack that does not tile degrades to the closed
    form and the event engine, as the reference's engines do."""
    pol = policy.default_policy()
    mesh = TD.MeshShape({"data": 2, "column": 4})
    assert pol.resolve("fused", column_counts=5, mesh=mesh,
                       device="cpu").engine == "closed_form"
    assert _replicated_bank("cpu") == {"fused": (True, {}),
                                       "fused_compact": (True, {})}


@pytest.mark.cuda
def test_cuda_replicated_bank_launches_the_unsharded_kernel():
    """On the card a stack that does not tile stays on the fused engine:
    one launch of the unsharded kernel on the rank's replicated block,
    none of the sharded wrappers, equal to the whole bank's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    assert _replicated_bank(torch.device("cuda")) == {
        "fused": (True, {"rnl_fire_times_layer": 1}),
        "fused_compact": (True, {"rnl_fire_times_compact": 1})}
