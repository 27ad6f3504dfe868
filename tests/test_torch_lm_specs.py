"""The port's LM sharding rules and ``policy.fit_coefficients`` against the
reference's.

* Every leaf of every architecture's smoke ``TrainState`` (with the
  error-feedback buffer) and ``ServeState``: the port's spec
  (``specs.param_pspecs`` / ``serve_shardings``, over a state built on the
  ``meta`` device) equals the reference's ``param_pspec`` / ``cache_pspec``
  (over ``jax.eval_shape`` of its state), leaf by leaf by the reference's
  own leaf names, on ``(1, 4)``, ``(2, 2)``, ``(4, 1)`` and ``(2, 8)``
  ``("data", "model")`` meshes and a ``(2, 2, 4)`` ``("pod", "data",
  "model")`` one, with and without ``replicate_embed``. Both packages'
  rules read only a mesh's axis names and sizes, so stand-ins serve on
  both sides. Exact.
* ``batch_pspec`` and ``data_shardings`` with and without ``over_model``;
  ``shard_tree`` / ``gather_tree`` on a mesh of one rank. Exact.
* ``fit_coefficients`` on synthetic sweep rows against the reference's:
  relative 1e-12 (the same float64 arithmetic).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import grad_compression as tGC  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.train import train_loop as tTL  # noqa: E402

MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
          {"data": 4, "model": 1}, {"data": 2, "model": 8},
          {"pod": 2, "data": 2, "model": 4}]


class _RefMesh:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, dims):
        self.shape = dict(dims)
        self.axis_names = tuple(dims)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.registry as jreg
    import repro.core.policy as jpolicy
    import repro.models.transformer as jT
    import repro.optim.grad_compression as jGC
    import repro.sharding.specs as jSH
    import repro.train.train_loop as jTL
    return dict(jax=jax, reg=jreg, policy=jpolicy, T=jT, GC=jGC, SH=jSH,
                TL=jTL)


def _ref_table(ref, tree, rule):
    """Reference leaf name -> spec of every leaf of ``tree``."""
    jax, SH = ref["jax"], ref["SH"]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {SH._leaf_name(path): tuple(rule(path, leaf))
            for path, leaf in flat}


def _port_table(tree):
    """Reference leaf name -> spec of every leaf of a port spec tree."""
    return {specs._leaf_name(key): spec
            for key, spec in specs._spec_table(tree).items()}


def _states(ref, arch):
    """Both packages' smoke config, whole TrainState (with error feedback;
    reference: abstract, port: on ``meta``) and ServeState."""
    jax = ref["jax"]
    jcfg = ref["reg"].get_config(arch + "-smoke")
    tcfg = treg.get_config(arch + "-smoke")
    jt = ref["TL"].TrainConfig(compression=ref["GC"].CompressionConfig())
    tt = tTL.TrainConfig(compression=tGC.CompressionConfig())
    jstate = jax.eval_shape(lambda: ref["TL"].init_train_state(
        jax.random.PRNGKey(0), jcfg, jt))
    tstate = tTL.init_train_state(torch.Generator(), tcfg, tt,
                                  device="meta")
    kw, tkw = {}, {}
    if tcfg.family == "audio":
        shape = (2, tcfg.encdec.encoder_seq, tcfg.frontend.d_embed)
        kw["frames"] = jax.ShapeDtypeStruct(shape, np.float32)
        tkw["frames"] = torch.empty(shape, device="meta")
    jserve = jax.eval_shape(lambda p, **k: ref["T"].init_serve_state(
        p, jcfg, 2, 32, **k), jstate.params, **kw)
    tserve = tT.init_serve_state(tstate.params, tcfg, 2, 32, **tkw)
    return jstate, tstate, jserve, tserve


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_every_state_leaf_has_the_reference_spec(ref, arch):
    jstate, tstate, jserve, tserve = _states(ref, arch)
    SH = ref["SH"]
    for dims in MESHES:
        jm, tm = _RefMesh(dims), TD.MeshShape(dict(dims))
        for rep in (False, True):
            want = _ref_table(ref, jstate, lambda p, l: SH.param_pspec(
                p, l, jm, replicate_embed=rep))
            got = _port_table(specs.param_pspecs(
                tstate, tm, replicate_embed=rep))
            assert got == want, (arch, dims, rep)
        want = _ref_table(ref, jserve,
                          lambda p, l: SH.cache_pspec(p, l, jm))
        assert _port_table(specs.serve_shardings(tserve, tm)) == want, (
            arch, dims)
    # the names the rules key on are the reference's
    names = set(_port_table(specs.param_pspecs(tstate, TD.MeshShape(
        dict(MESHES[0])))))
    assert "step" in names and any(n.startswith("opt/m/layers/")
                                   for n in names)
    assert any(n.startswith("ef/error/") for n in names)


def test_expert_and_embedding_rules(ref):
    """The leaves whose layout decides the expert-parallel path, on a
    (2, 2) mesh: experts over model with d_ff over data, the shared
    experts' d_ff over model, the router whole, the optimizer moments as
    their parameters."""
    _, tstate, _, _ = _states(ref, "deepseek-v2-lite-16b")
    table = _port_table(specs.param_pspecs(
        tstate, TD.MeshShape({"data": 2, "model": 2})))
    assert table["params/layers/moe/w_gate"] == (None, "model", None,
                                                 "data")
    assert table["params/layers/moe/w_down"] == (None, "model", "data",
                                                 None)
    assert table["params/layers/moe/shared/w_up"] == (None, None, "model")
    assert table["params/layers/moe/router"] == (None, None, None)
    assert table["opt/v/layers/moe/w_up"] == table["params/layers/moe/w_up"]
    assert table["params/embed"] == ("model", None)
    rep = _port_table(specs.param_pspecs(
        tstate, TD.MeshShape({"data": 2, "model": 2}), replicate_embed=True))
    assert rep["params/embed"] == (None, None)


@pytest.mark.parametrize("over_model", [False, True])
def test_batch_rules_match_the_reference(ref, over_model):
    SH = ref["SH"]
    for dims in MESHES:
        jm, tm = _RefMesh(dims), TD.MeshShape(dict(dims))
        for batch in (1, 2, 4, 6, 8, 32, 256):
            for extra in (0, 1, 2):
                assert specs.batch_pspec(tm, batch, extra, over_model) == \
                    tuple(SH.batch_pspec(jm, batch, extra, over_model))
        shapes = {"tokens": np.zeros((8, 16)), "labels": np.zeros((8, 16)),
                  "frames": np.zeros((8, 4, 3))}
        got = specs.data_shardings(tm, shapes, over_model)
        assert got == {k: tuple(SH.batch_pspec(jm, v.shape[0],
                                               v.ndim - 1, over_model))
                       for k, v in shapes.items()}
        axes = specs.lm_batch_axes(tm, over_model)
        assert axes == tuple(a for a in ("pod", "data") if a in dims) + (
            ("model",) if over_model else ())


def test_state_blocks_round_trip_on_one_rank():
    """``shard_tree`` / ``gather_tree`` over a whole TrainState on a mesh
    of one rank: every leaf back as it was (a mesh needs a process group:
    a gloo group of one process)."""
    import tempfile

    import torch.distributed as dist
    cfg = treg.get_config("deepseek-v2-lite-16b-smoke")
    tt = tTL.TrainConfig(compression=tGC.CompressionConfig())
    state = tTL.init_train_state(torch.Generator().manual_seed(0), cfg, tt,
                                 device="cpu")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = specs.lm_mesh(device_type="cpu")
            st = tTL.state_pspecs(cfg, tt, mesh)
            back = specs.gather_tree(specs.shard_tree(state, st, mesh), st,
                                     mesh)
        finally:
            dist.destroy_process_group()
    from repro_torch.train import checkpoint as tCK
    a, b = tCK._flatten(state), tCK._flatten(back)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _sweep_rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for density in (0.02, 0.05, 0.1, 0.2, 0.4, 0.8):
        rows.append(dict(backend="closed_form", density=density,
                         us_per_call=float(rng.uniform(900, 1100))))
        for backend in ("event", "event_nc"):
            rows.append(dict(backend=backend, density=density,
                             us_per_call=float(rng.uniform(50, 4000))))
    rows.append(dict(backend="pallas", density=0.1, us_per_call=3.0))
    rows.append(dict(backend="event", density=None, us_per_call=1.0))
    rows.append(dict(backend="event", density=0.1, us_per_call="n/a"))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_coefficients_match_the_reference(ref, seed):
    rows = _sweep_rows(seed)
    kw = dict(pairs=4096, n_lines=64, t_steps=64)
    want = ref["policy"].fit_coefficients(rows, **kw)
    got = tpolicy.fit_coefficients(rows, **kw)
    for field in ("closed_form_unit_us", "event_pair_us",
                  "event_breakpoint_us", "scan_unit_us"):
        w, g = getattr(want, field), getattr(got, field)
        assert abs(g - w) <= 1e-12 * max(abs(w), 1e-30), field
    base = dataclasses.replace(tpolicy.CostCoefficients(), scan_unit_us=1.5)
    assert tpolicy.fit_coefficients(rows, **kw, base=base).scan_unit_us \
        == 1.5
    with pytest.raises(ValueError):
        tpolicy.fit_coefficients(rows[:1], **kw)
    with pytest.raises(ValueError):
        ref["policy"].fit_coefficients(rows[:1], **kw)
