"""Checkpoints and fault tolerance on the port: ``repro_torch.train``.

Mirrors every test of ``tests/test_fault_tolerance.py`` (heartbeat revival,
the two-host merge, the same-host re-save, the interrupted save, dtype
round trips, ``run_resilient``'s replay accounting, the elastic planner)
and the checkpoint, heartbeat and elastic-planner tests of
``tests/test_runtime.py`` (round trip, rotation, async save, dead hosts
and stragglers, shrinking the data axis), with torch tensors for leaves.
The round trip saves the port's mamba2-780m smoke parameters in place of
the reference's LM training state (the port trains no LM yet).

Against the reference: a manifest written by each package has the other's
keys, shapes and dtypes for the same tree; each package restores the
other's checkpoint; and ``run_resilient`` over the port's TNN trainer
(``network.network_step``) with a failure lands on the uninterrupted
loop's weights bit for bit.
"""

import collections
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import layer, network  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import fault_tolerance as FT  # noqa: E402

Pair = collections.namedtuple("Pair", "w extra")


@pytest.fixture(scope="module")
def ref():
    """The reference package's checkpoint module and ``jax.numpy``."""
    jax = pytest.importorskip("jax")
    from repro.train import checkpoint as jck
    return types.SimpleNamespace(jnp=jax.numpy, CK=jck)


# ------------------------------------------------- heartbeat revival
def test_beat_revives_dead_host():
    """A host declared dead that resumes beating comes back alive, and so
    can be declared dead again."""
    mon = FT.HeartbeatMonitor(2, timeout_s=10)
    now = 1000.0
    mon.beat(0, 1.0, now=now)
    mon.beat(1, 1.0, now=now)
    assert mon.dead_hosts(now=now + 100) == [0, 1]
    assert not mon.hosts[0].alive
    mon.beat(0, 1.0, now=now + 101)
    assert mon.hosts[0].alive
    assert mon.dead_hosts(now=now + 300) == [0]


def test_revived_host_rejoins_straggler_accounting():
    mon = FT.HeartbeatMonitor(3, timeout_s=10, straggler_factor=1.5,
                              window=8)
    now = 0.0
    for i in range(8):
        for h in range(3):
            mon.beat(h, 1.0, now=now + i)
    assert mon.dead_hosts(now=now + 100) == [0, 1, 2]
    for i in range(8):
        mon.beat(0, 1.0, now=now + 101 + i)
        mon.beat(1, 1.0, now=now + 101 + i)
        mon.beat(2, 5.0, now=now + 101 + i)
    assert mon.stragglers() == [2]


def test_heartbeat_detects_dead_and_stragglers():
    mon = FT.HeartbeatMonitor(4, timeout_s=10, straggler_factor=1.5)
    now = 1000.0
    for h in range(4):
        for i in range(8):
            mon.beat(h, 1.0 if h != 2 else 2.5, now=now + i)
    assert mon.stragglers() == [2]
    for h in range(3):
        mon.beat(h, 1.0, now=now + 100)
    assert mon.dead_hosts(now=now + 100) == [3]


# --------------------------------------- multi-host checkpoint publish
def test_two_host_save_merges_instead_of_clobbering(tmp_path):
    """The second host publishing the same step merges its ``host_<i>/``
    shard dir into the published step instead of deleting the first
    host's shards."""
    s0 = {"w": torch.arange(4.0)}
    s1 = {"w": torch.arange(4.0, 8.0)}
    CK.save_checkpoint(tmp_path, 3, s0, host_id=0)
    CK.save_checkpoint(tmp_path, 3, s1, host_id=1)
    step_dir = tmp_path / "step_00000003"
    assert (step_dir / "host_0" / "arrays.npz").exists()
    assert (step_dir / "host_1" / "arrays.npz").exists()
    r0 = CK.restore_checkpoint(tmp_path, s0, 3, host_id=0)
    r1 = CK.restore_checkpoint(tmp_path, s1, 3, host_id=1)
    assert torch.equal(r0["w"], s0["w"]) and torch.equal(r1["w"], s1["w"])
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["step"] == 3
    assert "w" in manifest["keys"]
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_same_host_resave_replaces_own_shards(tmp_path):
    CK.save_checkpoint(tmp_path, 1, {"w": torch.zeros(2)}, host_id=0)
    CK.save_checkpoint(tmp_path, 1, {"w": torch.ones(2)}, host_id=0)
    r = CK.restore_checkpoint(tmp_path, {"w": torch.zeros(2)}, 1)
    assert torch.equal(r["w"], torch.ones(2))


# ------------------------------------------------- atomic rotation
def test_interrupted_save_never_corrupts_latest(tmp_path, monkeypatch):
    """A save that dies mid-serialization leaves only a tmp dir; the
    previous checkpoint stays the restorable latest."""
    state = {"w": torch.arange(6.0)}
    CK.save_checkpoint(tmp_path, 1, state)
    assert CK.latest_step(tmp_path) == 1

    real_savez = np.savez

    def dying_savez(path, **kw):
        real_savez(path, **kw)
        raise OSError("simulated crash mid-save")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(OSError):
        CK.save_checkpoint(tmp_path, 2, {"w": state["w"] + 1})
    monkeypatch.undo()
    assert CK.latest_step(tmp_path) == 1
    r = CK.restore_checkpoint(tmp_path, state)
    assert torch.equal(r["w"], state["w"])


def test_checkpoint_rotation(tmp_path):
    mgr = CK.CheckpointManager(tmp_path, keep=2, every=1)
    for s in range(1, 5):
        mgr.maybe_save(s, {"x": torch.full((2,), s)})
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]


def test_async_checkpoint(tmp_path):
    mgr = CK.CheckpointManager(tmp_path, keep=3, every=1, async_save=True)
    mgr.maybe_save(1, {"x": torch.ones(4)})
    mgr.wait()
    assert CK.latest_step(tmp_path) == 1


def test_async_save_owns_its_copy(tmp_path):
    """``maybe_save`` copies a CPU tensor before its writer thread starts:
    an in-place write right after the call never reaches the file."""
    mgr = CK.CheckpointManager(tmp_path, keep=3, every=1, async_save=True)
    x = torch.zeros(1 << 16)
    mgr.maybe_save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    r = CK.restore_checkpoint(tmp_path, {"x": torch.empty(1 << 16)})
    assert torch.equal(r["x"], torch.zeros(1 << 16))


# ------------------------------------------------- dtype round-trips
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_checkpoint_dtype_roundtrip(tmp_path, dtype):
    """bfloat16 can't live in an npz: it's stored widened to float32 and
    restored back through the template's dtype."""
    x = torch.linspace(-2.0, 2.0, 8).to(getattr(torch, dtype))
    CK.save_checkpoint(tmp_path, 1, {"x": x})
    manifest = json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())
    want = "float32" if dtype == "bfloat16" else dtype
    assert manifest["keys"]["x"]["dtype"] == want
    r = CK.restore_checkpoint(tmp_path, {"x": x})
    assert r["x"].dtype == x.dtype
    assert torch.equal(r["x"], x)


def test_checkpoint_roundtrip(tmp_path):
    """A whole model's tree (mamba2-780m smoke: nested dicts, bfloat16 and
    float32 leaves) comes back leaf for leaf, in each leaf's dtype."""
    cfg = registry.get_config("mamba2-780m").smoke()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    state = {"params": params, "step": np.asarray(7, np.int32)}
    CK.save_checkpoint(tmp_path, 7, state)
    assert CK.latest_step(tmp_path) == 7
    restored = CK.restore_checkpoint(tmp_path, state)
    leaves, got = [], []
    CK._map_with_path(state, lambda k, v: leaves.append((k, v)))
    CK._map_with_path(restored, lambda k, v: got.append((k, v)))
    assert [k for k, _ in leaves] == [k for k, _ in got]
    assert len(leaves) > 10
    assert {v.dtype for _, v in leaves if isinstance(v, torch.Tensor)} == \
        {torch.bfloat16, torch.float32}
    for (_, a), (_, b) in zip(leaves, got):
        if isinstance(a, torch.Tensor):
            assert b.dtype == a.dtype and torch.equal(a, b)
        else:
            assert b.dtype == a.dtype and np.array_equal(a, b)


# --------------------------------------------- resilient-loop replay
def test_run_resilient_skips_committed_steps(tmp_path):
    """After a failure the loop resumes from the last checkpoint: steps at
    or before it never re-execute, steps after it replay."""
    mgr = CK.CheckpointManager(tmp_path, keep=10, every=2)
    executed = []

    def step(state, batch):
        executed.append(batch)
        return {"x": state["x"] + batch}, {}

    def injector(i, fired=[False]):
        if i == 5 and not fired[0]:
            fired[0] = True
            raise FT.WorkerFailure(1, "(injected)")

    state0 = {"x": torch.zeros((), dtype=torch.float32)}
    final, report = FT.run_resilient(
        step, state0, list(range(8)), ckpt_mgr=mgr,
        failure_injector=injector)
    assert report["restarts"] == 1 and report["failed_hosts"] == [1]
    assert report["completed_steps"] == 8
    assert executed == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert float(final["x"]) == float(sum(range(8)))


def test_run_resilient_exhausts_restarts(tmp_path):
    mgr = CK.CheckpointManager(tmp_path, keep=3, every=2)

    def injector(i):
        raise FT.WorkerFailure(0, "(always failing)")

    with pytest.raises(FT.WorkerFailure):
        FT.run_resilient(
            lambda s, b: (s, {}), {"x": torch.zeros(1)}, list(range(4)),
            ckpt_mgr=mgr, failure_injector=injector, max_restarts=2)


def test_run_resilient_tnn_trainer_replays_bit_exact(tmp_path):
    """``run_resilient`` over the port's TNN trainer, checkpoints every 2
    steps and a failure before step 5: the final weights equal the
    uninterrupted loop's bit for bit."""
    net = network.make_network([
        layer.TNNLayer(n_columns=2, rf_size=4, n_neurons=3, threshold=5,
                       t_steps=12, dendrite="catwalk", k=2,
                       backend="closed_form"),
        layer.TNNLayer(n_columns=3, rf_size=2, n_neurons=2, threshold=4,
                       t_steps=12, dendrite="pc_compact",
                       backend="closed_form")])
    params = network.init_network(torch.Generator().manual_seed(0), net,
                                  "cpu")
    t = np.random.default_rng(3).integers(0, 20, (8, 3, net.n_inputs))
    batches = [torch.from_numpy(b) for b in
               np.where(t >= 10, 2**31 - 1, t).astype(np.int32)]

    def step(state, batch):
        return network.network_step(state, batch, net)[0], {}

    want = params
    for b in batches:
        want, _ = step(want, b)
    fail_at = {5}

    def injector(i):
        if i in fail_at:
            fail_at.remove(i)
            raise FT.WorkerFailure(3, "(simulated preemption)")

    mgr = CK.CheckpointManager(tmp_path, keep=3, every=2)
    final, report = FT.run_resilient(step, params, batches, ckpt_mgr=mgr,
                                     failure_injector=injector)
    assert report["restarts"] == 1 and report["failed_hosts"] == [3]
    assert report["completed_steps"] == 8
    assert isinstance(final, tuple)
    assert all(torch.equal(a, b) for a, b in zip(final, want))
    assert not all(torch.equal(a, b) for a, b in zip(final, params))


# ------------------------------------------------- elastic planner
def test_elastic_planner_plan_shapes():
    pl = FT.ElasticPlanner(chips_per_host=4, model_parallel=8)
    full = pl.plan(surviving_hosts=16)
    assert (full.pod, full.data, full.model) == (1, 8, 8)
    assert full.chips == 64
    degraded = pl.plan(surviving_hosts=13)
    assert degraded.model == 8
    assert degraded.data == 4
    assert degraded.chips <= 52
    pods = pl.plan(surviving_hosts=16, pods=2)
    assert pods.pod == 2 and pods.model == 8
    assert pods.data == 4
    tiny = pl.plan(surviving_hosts=1)
    assert tiny.data == 1 and tiny.model == 8


def test_elastic_planner_shrinks_data_axis():
    pl = FT.ElasticPlanner(chips_per_host=4, model_parallel=16)
    full = pl.plan(surviving_hosts=64)
    assert (full.data, full.model) == (16, 16)
    degraded = pl.plan(surviving_hosts=60)
    assert degraded.model == 16
    assert degraded.data == 8
    assert degraded.chips <= 240


# ----------------------------------------------- against the reference
def _trees(ref):
    """The same tree in both packages: a dict (keys out of order) holding
    a tuple, a NamedTuple with a ``None`` field, a list, numpy and
    bfloat16 leaves and a scalar."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((5,)).astype(np.float32)
    ids = rng.integers(0, 9, (2, 3)).astype(np.int32)
    port = {"z": (torch.from_numpy(w), [torch.from_numpy(ids), 5]),
            "a": Pair(torch.from_numpy(h).to(torch.bfloat16), None),
            "m": np.arange(4, dtype=np.int32)}
    jnp = ref.jnp
    jax_tree = {"z": (jnp.asarray(w), [jnp.asarray(ids), 5]),
                "a": Pair(jnp.asarray(h).astype(jnp.bfloat16), None),
                "m": np.arange(4, dtype=np.int32)}
    return port, jax_tree


def _manifest(path, step):
    return json.loads((path / f"step_{step:08d}" / "manifest.json")
                      .read_text())


def test_manifest_keys_match_the_reference(ref, tmp_path):
    port, jax_tree = _trees(ref)
    CK.save_checkpoint(tmp_path / "port", 1, port)
    ref.CK.save_checkpoint(tmp_path / "ref", 1, jax_tree)
    mine, theirs = _manifest(tmp_path / "port", 1), _manifest(
        tmp_path / "ref", 1)
    assert mine["keys"] == theirs["keys"]
    assert sorted(mine["keys"]) == ["a/.w", "m", "z/0", "z/1/0", "z/1/1"]
    a = np.load(tmp_path / "port" / "step_00000001" / "host_0"
                / "arrays.npz")
    b = np.load(tmp_path / "ref" / "step_00000001" / "host_0"
                / "arrays.npz")
    for key in mine["keys"]:
        np.testing.assert_array_equal(a[key], b[key])


def test_port_restores_a_reference_checkpoint(ref, tmp_path):
    port, jax_tree = _trees(ref)
    ref.CK.save_checkpoint(tmp_path, 4, jax_tree)
    template = _map_zero(port)
    got = CK.restore_checkpoint(tmp_path, template)
    # dict keys come back sorted, as the reference's restore returns them
    assert list(got) == ["a", "m", "z"]
    assert list(got) == list(ref.CK.restore_checkpoint(tmp_path,
                                                       _ref_template(ref)))
    assert isinstance(got["a"], Pair) and got["a"].extra is None
    assert got["a"].w.dtype == torch.bfloat16
    assert torch.equal(got["a"].w, port["a"].w)
    assert torch.equal(got["z"][0], port["z"][0])
    assert torch.equal(got["z"][1][0], port["z"][1][0])
    assert got["z"][1][1] == 5 and type(got["z"][1][1]) is int
    assert isinstance(got["m"], np.ndarray)
    np.testing.assert_array_equal(got["m"], port["m"])


def test_reference_restores_a_port_checkpoint(ref, tmp_path):
    port, jax_tree = _trees(ref)
    CK.save_checkpoint(tmp_path, 4, port)
    got = ref.CK.restore_checkpoint(tmp_path, _ref_template(ref))
    assert got["a"].w.dtype == ref.jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["a"].w, np.float32),
                                  port["a"].w.float().numpy())
    np.testing.assert_array_equal(np.asarray(got["z"][0]),
                                  port["z"][0].numpy())
    np.testing.assert_array_equal(np.asarray(got["z"][1][0]),
                                  port["z"][1][0].numpy())
    assert int(got["z"][1][1]) == 5
    np.testing.assert_array_equal(np.asarray(got["m"]), port["m"])


def _ref_template(ref):
    """The reference's template of :func:`_trees`' structure. Its restore
    reads each template leaf's dtype, so the scalar's template is a 0-d
    array."""
    jnp = ref.jnp
    return {"z": (jnp.zeros((3, 4)), [jnp.zeros((2, 3), jnp.int32),
                                      jnp.zeros((), jnp.int32)]),
            "a": Pair(jnp.zeros((5,), jnp.bfloat16), None),
            "m": np.zeros(4, np.int32)}


def _map_zero(tree):
    """A template of ``tree``'s structure and dtypes, filled with zeros."""
    def zero(_, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.zeros_like(leaf)
        if isinstance(leaf, np.ndarray):
            return np.zeros_like(leaf)
        return type(leaf)(0)
    return CK._map_with_path(tree, zero)
