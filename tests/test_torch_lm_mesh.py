"""The port's LM path across GPUs, on four CPU ranks joined by gloo
(``tests/_torch_dist.py`` spawns them; the rank bodies are in
``tests/_torch_lm_dist.py``), on ``("data", "model")`` meshes of
``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ranks, against the reference.

* The expert-parallel layer ``moe_apply_ep`` (deepseek-v2-lite's smoke
  MoE, float32, 8 x 16 rows): at capacity factor 8 (no drops) against the
  reference's single-device ``moe_apply``, and at capacity 1.0 (local
  capacities, drops) with ``fsdp`` on and off against the reference's own
  ``moe_apply_ep`` on a mesh of 4 forced host devices, run in a
  subprocess as ``tests/test_distribution.py`` runs it: outputs within
  the reference test's 2e-4 (absolute and relative), aux within 1e-4.
  The three fallbacks (no ``model`` axis, 3 experts on a model axis that
  does not divide them, a shared d_ff of 33) equal the reference's
  single-device ``moe_apply`` within 2e-4 / 1e-4, and the port's bit for
  bit. Rows not split over a data axis of more than one rank raise.
* Its gradients at capacity 8, gathered whole (and summed over the ranks
  that hold the same block): each within 1e-5 of its largest |value| of
  the port's single-device ``moe_apply`` gradients (plus the aux loss
  where the data axis has one rank, so the two are the same function).
* The mesh train step (float32) on internlm2 (grad_accum 2, a mask,
  compression rho 0.1), mamba2 ``--opt`` (``batch_over_model``, grad_accum
  2, and grad_accum 4, whose 2-row microbatches do not divide over the
  four ranks: split over ``data`` on ``(2, 2)``, replicated elsewhere, as
  the reference's ``batch_pspec`` lays them out), deepseek (catwalk at capacity 1.0, so assignments drop: the
  layer's rows are gathered, so the capacity and the drops are the whole
  batch's), deepseek ``--opt``
  (``catwalk_ep``), mamba2 without ``--opt`` (``mamba2_tp``: its SSM
  blocks tensor-parallel over ``model``) and internlm2 under ``act_sp``
  (``internlm2_sp``: the residual stream the rank's sequence block),
  zamba2 (``zamba2_tp``: its SSM layers and shared attention block
  tensor-parallel), 3
  steps each, against the reference's single-device
  step under ``tests/test_torch_train.py``'s float32 tolerances:
  the first step's loss and grad norm within relative 1e-5 and its
  parameters by that file's one-step rule (at least one element of a leaf may
  sit at the near-zero gradients AdamW's first step moves by up to 2 lr);
  the next steps, whose inputs those elements change, loss within 1e-4,
  grad norm 1e-3, the parameters after step 3 within 4 lr; kept fraction
  1e-3 every step. Every step also against the port's single-device step
  (loss 1e-5, grad norm 1e-5 then 1e-4, 1e-3 where a layer is split over
  ``model``, whose partial sums add in another order); where no rank
  splits the rows
  (``ROW_AXES`` empty; not the expert-parallel layer) and no layer is
  split over a model axis of more than one rank (``TP_CASES``) the two
  are equal bit for bit. ``init_train_state(mesh=)`` makes the blocks of the whole
  state exactly. deepseek ``--opt`` on a data axis
  of more than one rank is another function, as in the reference (the
  capacity from the local token count, the aux the mean of the per-rank
  aux): there, at capacity 8, the first step's cross-entropy is held
  within relative 1e-5, its aux within 1e-5 of the mean of the
  reference's aux over the data blocks, its loss within relative 1e-5 of
  their sum, and on ``(2, 2)`` within relative 1e-4 of the reference's
  single-device loss.
* The launcher on 4 ranks (a ``(1, 4)`` mesh, ``--device cpu``), bfloat16,
  whose layers are split over ``model`` (the ranks' partial outputs are
  summed in bfloat16, in another order than one GEMM's): a checkpoint
  crosses exactly, the state a mesh restores from a single-process
  checkpoint and the state one process restores from a mesh checkpoint
  each equal the checkpoint they read, every leaf bit for bit (params,
  AdamW moments, steps); internlm2 smoke's trajectory, from scratch and
  continued across either crossing, keeps the single-process losses
  within relative 2e-3 and the state within the drift the split adds
  (:func:`_assert_close_state`: each leaf's update from the initial
  parameters within 0.25 in relative norm and each AdamW moment within
  0.05, about twice what :func:`_state_drift` reads between these runs,
  0.114 and 0.019; the steps equal); deepseek smoke ``--opt`` (the expert-parallel layer) keeps the
  single-process losses within relative 2e-3 and restarts after a
  failure into the state of the run that did not fail, bit for bit.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
import _torch_lm_dist as LD  # noqa: E402
import test_torch_train as TT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.data import pipeline as tDP  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.train import checkpoint as tCK  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(2, 2), (1, 4), (4, 1)]
LR = TT.LR
ADAMW = dict(lr=LR, warmup_steps=2, total_steps=50)
D_MODEL = 64
MOE = dict(n_experts=4, top_k=2, d_expert=32, n_shared=2,
           dispatch="catwalk_ep")
EP_CASES = {
    "cap8": dict(MOE, capacity_factor=8.0),
    "cap1": dict(MOE, capacity_factor=1.0),
    "no_model": dict(MOE, capacity_factor=1.0),
    "e3": dict(MOE, n_experts=3, capacity_factor=1.0),
    "shared33": dict(MOE, n_shared=1, d_expert=33, capacity_factor=1.0),
}


# ----------------------------------------------------------------- inputs

def _moe_params(seed, cfg):
    rng = np.random.default_rng(seed)
    e, f, d = cfg["n_experts"], cfg["d_expert"], D_MODEL

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": w(d, e), "w_gate": w(e, d, f), "w_up": w(e, d, f),
         "w_down": w(e, f, d)}
    if cfg["n_shared"]:
        fs = cfg["n_shared"] * f
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs),
                       "w_down": w(fs, d)}
    return p


def _ep_inputs():
    out = {}
    for i, (name, cfg) in enumerate(EP_CASES.items()):
        rng = np.random.default_rng(100 + i)
        out[name] = dict(cfg=cfg, p=_moe_params(i, cfg),
                         x=rng.standard_normal((8, 16, D_MODEL)).astype(
                             np.float32),
                         w=rng.standard_normal((8, 16, D_MODEL)).astype(
                             np.float32))
    return out


def _rank_ep_cases(inputs):
    cases = {}
    for name, c in inputs.items():
        base = dict(cfg=c["cfg"], p=c["p"], x=c["x"], w=c["w"])
        if name in ("cap8", "cap1"):
            cases[name] = dict(base, fsdp=False, grad=name == "cap8")
            cases[name + "_fsdp"] = dict(base, fsdp=True,
                                         grad=name == "cap8")
        else:
            cases[name] = dict(base, fsdp=False, tnn=name == "no_model")
    return cases


_REF_EP = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.models import moe as M
from repro.sharding import compat

data = np.load(sys.argv[1], allow_pickle=True)["cases"].item()
out = {}
for name, c in data.items():
    cfg = MoEConfig(**c["cfg"])
    p = jax.tree.map(jnp.asarray, c["p"])
    x = jnp.asarray(c["x"])
    y, aux = jax.jit(lambda p, x: M.moe_apply(p, x, cfg))(p, x)
    out[name + "/single"] = (np.asarray(y), float(aux["aux_loss"]))
    if name == "cap1":
        for shape in ((2, 2), (1, 4)):
            mesh = jax.make_mesh(shape, ("data", "model"))
            for fsdp in (False, True):
                with compat.set_mesh(mesh):
                    y, aux = jax.jit(lambda p, x: M.moe_apply_ep(
                        p, x, cfg, fsdp=fsdp))(p, x)
                out[f"{name}/{shape[0]}x{shape[1]}/{fsdp}"] = (
                    np.asarray(y), float(aux["aux_loss"]))
np.save(sys.argv[2], out, allow_pickle=True)
print("REF_EP_OK")
"""


class _Pending:
    """A subprocess's result, read once it is wanted."""

    def __init__(self, proc, inputs, out):
        self.proc, self.inputs, self.out, self.value = proc, inputs, out, None

    def result(self):
        if self.value is None:
            _, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            self.value = (self.inputs,
                          np.load(self.out, allow_pickle=True).item())
        return self.value


@pytest.fixture(scope="module")
def ep_ref(tmp_path_factory):
    """The reference's outputs on the EP inputs: single-device
    ``moe_apply`` for every case and ``moe_apply_ep`` at capacity 1.0 on
    (2, 2) and (1, 4) meshes of 4 forced host devices (a subprocess: the
    test process keeps one device). It starts here and runs while the
    other fixtures compute."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("ep_ref")
    inputs = _ep_inputs()
    np.savez(d / "in.npz", cases=np.array(inputs, dtype=object))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_KERNEL_IMPL="ref",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_EP, str(d / "in.npz"),
         str(d / "out.npy")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    pending = _Pending(proc, inputs, d / "out.npy")
    yield pending
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# -------------------------------------------------------------- the steps

def _step_cases(data):
    """The train-step cases of a mesh whose data axis has ``data`` ranks:
    arch, the port's config edits and the train config."""
    base = dict(adamw=ADAMW, rho=None)
    return {
        "internlm2": dict(base, arch="internlm2-1.8b", ga=2, rho=0.1,
                          mask=True),
        "mamba2": dict(base, arch="mamba2-780m", opt=True, ga=2),
        # microbatches of 2 rows: split over data on (2, 2), replicated
        # over the axes that do not divide them
        "mamba2_ragged": dict(base, arch="mamba2-780m", opt=True, ga=4),
        "deepseek": dict(base, arch="deepseek-v2-lite-16b", ga=1,
                         dispatch="catwalk", capacity=1.0),
        "deepseek_ep": dict(base, arch="deepseek-v2-lite-16b", opt=True,
                            ga=1, capacity=1.0 if data == 1 else 8.0),
        # tensor-parallel SSM blocks (no batch_over_model), and sequence
        # parallelism between the layers
        "mamba2_tp": dict(base, arch="mamba2-780m", ga=2),
        "internlm2_sp": dict(base, arch="internlm2-1.8b", ga=1,
                             act_sp=True),
        # the hybrid family: tensor-parallel SSM layers and the shared
        # attention block after each
        "zamba2_tp": dict(base, arch="zamba2-1.2b", ga=2),
    }


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.registry as jreg
    import repro.optim.grad_compression as jGC
    import repro.optim.optimizers as jO
    import repro.train.train_loop as jTL
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, reg=jreg, GC=jGC,
                                 O=jO, TL=jTL)


def _ref_run(ref, c):
    """The reference's smoke config of case ``c``, its initial state (as
    the port's checkpoint keys -> numpy), its batches, and its
    single-device trajectory (metrics and states after each step, and the
    gradient of the first step, the microbatches' mean)."""
    tcfg, tt = LD._configs(c)
    jcfg = dataclasses.replace(ref.reg.get_config(c["arch"] + "-smoke"),
                               dtype="float32")
    jcfg = TT._reference_opt(jcfg, tcfg)
    jt = ref.TL.TrainConfig(
        optimizer=ref.O.AdamWConfig(**c["adamw"]), grad_accum=c["ga"],
        compression=None if c["rho"] is None
        else ref.GC.CompressionConfig(rho=c["rho"]))
    js = ref.TL.init_train_state(ref.jax.random.PRNGKey(0), jcfg, jt)
    flat = tCK._flatten(convert.train_state_from_numpy(
        ref.jax.tree.map(np.asarray, js), tcfg, device="cpu"))
    data = tDP.SyntheticLM(tDP.DataConfig(seq_len=16, global_batch=8,
                                          vocab_size=tcfg.vocab_size))
    batches = []
    for i in range(3):
        b = data.batch(i)
        if c.get("mask"):
            b["mask"] = np.random.default_rng(i).random(
                b["labels"].shape) < 0.7
        batches.append(b)
    jstep = ref.jax.jit(ref.TL.make_train_step(jcfg, jt))
    if c.get("capacity") == 8.0:
        # the expert-parallel step over a split data axis is another
        # function: only its first step's metrics are compared
        js, m = jstep(js, batches[0])
        return types.SimpleNamespace(
            jcfg=jcfg, state=flat, batches=batches,
            metrics=[{k: float(v) for k, v in m.items()}])
    grad = ref.jax.jit(ref.jax.grad(
        lambda p, b: ref.TL.loss_fn(p, jcfg, b)[0]))
    mb = 8 // c["ga"]
    g0 = [grad(js.params, {k: v[i * mb:(i + 1) * mb]
                           for k, v in batches[0].items()})
          for i in range(c["ga"])]
    g0 = ref.jax.tree.map(lambda *g: sum(g) / len(g), *g0)
    states, metrics = [], []
    for b in batches:
        js, m = jstep(js, b)
        states.append(js)
        metrics.append({k: float(v) for k, v in m.items()})
    return types.SimpleNamespace(jcfg=jcfg, state=flat, batches=batches,
                                 metrics=metrics, states=states, grad=g0)


@pytest.fixture(scope="module")
def ref_runs(ref):
    runs = {}
    for data in (1, 2):
        for name, c in _step_cases(data).items():
            key = (name, c.get("capacity"))
            if key not in runs:
                runs[key] = _ref_run(ref, c)
    return runs


def _key(name, c):
    return (name, c.get("capacity"))


@pytest.fixture(scope="module")
def ranks(ep_ref, ref_runs, tmp_path_factory):
    """Each mesh's ranks (spawned once per mesh), run lazily."""
    inputs = ep_ref.inputs
    cache = {}

    def get(shape):
        if shape not in cache:
            steps = {}
            for name, c in _step_cases(shape[0]).items():
                run = ref_runs[_key(name, c)]
                steps[name] = dict(c, state=run.state, batches=run.batches)
            cache[shape] = TD.run(
                "_torch_lm_dist:mesh_suite", shape,
                args=(_rank_ep_cases(inputs), steps),
                tmp_dir=tmp_path_factory.mktemp("lm_mesh"), kind="lm")
        return cache[shape]
    return get


# ------------------------------------------------------------ the EP layer

def _single(inputs, name):
    """The port's single-device ``moe_apply`` of case ``name`` (whole)."""
    c = inputs[name]
    p = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else torch.from_numpy(v))
         for k, v in c["p"].items()}
    return p, torch.from_numpy(c["x"]), MoEConfig(**c["cfg"])


@pytest.mark.parametrize("shape", MESHES[:2])
def test_ep_forward_matches_the_reference(ranks, ep_ref, shape):
    inputs, want = ep_ref.result()
    got = ranks(shape)[0]["ep"]
    for name in ("cap8", "cap8_fsdp"):
        assert got[name]["ep"]
        y, aux = want["cap8/single"]
        np.testing.assert_allclose(got[name]["y"], y, atol=2e-4, rtol=2e-4)
        assert abs(got[name]["aux"] - aux) <= 1e-4
    for fsdp in (False, True):
        name = "cap1_fsdp" if fsdp else "cap1"
        y, aux = want[f"cap1/{shape[0]}x{shape[1]}/{fsdp}"]
        assert got[name]["ep"]
        np.testing.assert_allclose(got[name]["y"], y, atol=2e-4, rtol=2e-4)
        assert abs(got[name]["aux"] - aux) <= 1e-4
    # capacity 1.0 drops assignments: over a data axis of more than one
    # rank the capacities are the local ones, as the reference's, not the
    # single-device layer's
    if shape[0] > 1:
        single = want["cap1/single"][0]
        assert np.abs(got["cap1"]["y"] - single).max() > 1e-3


@pytest.mark.parametrize("shape", MESHES[:2])
def test_ep_fallbacks_run_moe_apply(ranks, ep_ref, shape):
    inputs, want = ep_ref.result()
    got = ranks(shape)[0]["ep"]
    for name in ("no_model", "e3", "shared33"):
        assert not got[name]["ep"], name
        y, aux = want[f"{name}/single"]
        np.testing.assert_allclose(got[name]["y"], y, atol=2e-4, rtol=2e-4)
        assert abs(got[name]["aux"] - aux) <= 1e-4
        p, x, cfg = _single(inputs, name)
        mine, stats = tM.moe_apply(p, x, cfg)
        assert np.array_equal(got[name]["y"], mine.numpy())
        assert got[name]["aux"] == float(stats["aux_loss"])


@pytest.mark.parametrize("shape", MESHES)
def test_ep_gradients_match_single_device(ranks, ep_ref, shape):
    inputs = ep_ref.inputs
    got = ranks(shape)[0]["ep"]
    p, x, cfg = _single(inputs, "cap8")
    leaves = []

    def track(t):
        t = t.clone().requires_grad_()
        leaves.append(t)
        return t
    p = {k: ({kk: track(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else track(v)) for k, v in p.items()}
    x = track(x)
    y, stats = tM.moe_apply(p, x, cfg)
    loss = torch.sum(y * torch.from_numpy(inputs["cap8"]["w"]))
    if shape[0] == 1:
        loss = loss + stats["aux_loss"]
    loss.backward()
    for name in ("cap8", "cap8_fsdp"):
        g = got[name]["grads"]
        pairs = [(g[k], p[k].grad) for k in ("router", "w_gate", "w_up",
                                              "w_down")]
        pairs += [(g["shared"][k], p["shared"][k].grad)
                  for k in ("w_gate", "w_up", "w_down")]
        pairs.append((got[name]["x_grad"], x.grad))
        for mine, want in pairs:
            want = want.numpy()
            scale = float(np.abs(want).max())
            assert scale > 0
            assert float(np.abs(mine - want).max()) <= 1e-5 * scale, name


# ------------------------------------------------------------ the mesh step

STEP_CASES = ["internlm2", "mamba2", "mamba2_ragged", "deepseek",
              "deepseek_ep", "mamba2_tp", "internlm2_sp", "zamba2_tp"]
#: the axes each case's microbatch rows split over, per mesh
ROW_AXES = {
    (2, 2): {"internlm2": ("data",), "mamba2": ("data", "model"),
             "mamba2_ragged": ("data",), "deepseek": ("data",),
             "deepseek_ep": ("data",), "mamba2_tp": ("data",),
             "internlm2_sp": ("data",), "zamba2_tp": ("data",)},
    (1, 4): {"internlm2": (), "mamba2": ("model",), "mamba2_ragged": (),
             "deepseek": (), "deepseek_ep": (), "mamba2_tp": (),
             "internlm2_sp": (), "zamba2_tp": ()},
    (4, 1): {"internlm2": ("data",), "mamba2": ("data",),
             "mamba2_ragged": (), "deepseek": ("data",),
             "deepseek_ep": ("data",), "mamba2_tp": ("data",),
             "internlm2_sp": ("data",), "zamba2_tp": ("data",)},
}
#: the cases whose layers the model axis splits (tensor parallelism: not
#: under batch_over_model), on a mesh whose model axis has more ranks
#: than one
TP_CASES = {"internlm2", "deepseek", "deepseek_ep", "mamba2_tp",
            "internlm2_sp", "zamba2_tp"}


def _check_first_update(want_params, got, grads):
    """The one-step float32 rule of ``test_torch_train._check_update``:
    each updated leaf within 1e-6 (1 + |p|) except elements at a gradient
    within 1e-4 of the leaf's largest, which AdamW's first step moves by
    up to 2 lr and which differ by at most 2 lr; at most 0.2 % of a leaf's
    elements, and at least one (a 128-element norm may hold one)."""
    for want, mine, g in zip(TT._leaves(want_params), TT._leaves(got),
                             TT._leaves(grads)):
        want, mine, g = TT._np(want), TT._np(mine), np.abs(TT._np(g))
        diff = np.abs(mine - want)
        off = diff > 1e-6 * (1 + np.abs(want))
        assert off.sum() <= max(1, 0.002 * off.size)
        if off.any():
            assert g[off].max() <= 1e-4 * g.max()
            assert (diff[off] <= 2 * LR * (1 + 1e-3)).all()


@pytest.mark.parametrize("name", STEP_CASES)
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_matches_the_reference(ranks, ref_runs, ref, shape, name):
    """Step 1 against the reference under the one-step tolerances of
    ``tests/test_torch_train.py``;
    every step against the port's single-device step (loss relative 1e-5,
    grad norm 1e-5 at step 1 and 1e-4 after; bit for bit where the rows
    are whole); steps 2-3 against the reference within relative 1e-4
    (loss) and 1e-3 (grad norm), and the parameters after step 3 within 4
    lr: from step 2 on, the elements AdamW's first step moved by up to 2
    lr change the function, in the port's single-device step as well.
    Where a layer is split over a model axis of more than one rank
    (``TP_CASES``), a row-parallel projection's partial sums add in
    another order than the single-device step's, as they do in the
    reference's: its steps 2-3 are held to the port's single-device step
    within the reference's grad-norm tolerance (1e-3), and bit for bit
    only where the step splits nothing over ranks."""
    c = _step_cases(shape[0])[name]
    run = ref_runs[_key(name, c)]
    got = ranks(shape)[0]["steps"][name]
    tp = name in TP_CASES and shape[1] > 1
    for m in got["metrics"]:
        assert set(m) == set(run.metrics[0])
        assert all(np.isfinite(v) for v in m.values())
    if name == "deepseek_ep" and shape[0] > 1:
        m, want = got["metrics"][0], run.metrics[0]
        assert TT._rel(m["ce"], want["ce"]) <= 1e-5
        b = run.batches[0]
        rows = 8 // shape[0]
        params = ref.jax.tree.map(ref.jnp.asarray, _initial(run))
        auxes = [float(ref.TL.loss_fn(params, run.jcfg, {
            k: v[d * rows:(d + 1) * rows] for k, v in b.items()})[1]["aux"])
            for d in range(shape[0])]
        assert abs(m["aux"] - np.mean(auxes)) <= 1e-5
        assert TT._rel(m["loss"], want["ce"] + np.mean(auxes)) <= 1e-5
        if shape == (2, 2):
            assert TT._rel(m["loss"], want["loss"]) <= 1e-4
        return
    for i, (m, want, single) in enumerate(zip(
            got["metrics"], run.metrics, got["single_metrics"])):
        tol = (1e-5, 1e-5) if i == 0 else (1e-4, 1e-3)
        assert TT._rel(m["loss"], want["loss"]) <= tol[0], (i, m, want)
        assert TT._rel(m["grad_norm"], want["grad_norm"]) <= tol[1]
        assert TT._rel(m["lr"], want["lr"]) <= 1e-6
        if "kept_fraction" in m:
            assert TT._rel(m["kept_fraction"], want["kept_fraction"]) \
                <= 1e-3
        assert TT._rel(m["loss"], single["loss"]) <= 1e-5
        assert TT._rel(m["grad_norm"], single["grad_norm"]) \
            <= (1e-5 if i == 0 else 1e-3 if tp else 1e-4)
    first, last = got["params"]
    _check_first_update(run.states[0].params, _nested(first), run.grad)
    for want, mine in zip(TT._leaves(run.states[-1].params),
                          TT._leaves(_nested(last))):
        assert float(np.abs(TT._np(mine) - TT._np(want)).max()) <= 4 * LR
    if name != "deepseek_ep" and not ROW_AXES[shape][name] and not tp:
        assert got["metrics"] == got["single_metrics"]
        assert all(np.array_equal(last[k], got["single_params"][k])
                   for k in last)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_rows_split_over_the_axes_that_divide_them(ranks, shape):
    """Each microbatch's rows over as many of the batch axes as divide
    them (the reference's ``batch_pspec``), replicated over the rest."""
    steps = ranks(shape)[0]["steps"]
    assert {k: tuple(v["row_axes"]) for k, v in steps.items()} \
        == ROW_AXES[shape]


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_init_draws_the_single_device_blocks(ranks, shape):
    """``init_train_state(mesh=)``, which cuts each parameter as it is
    drawn and makes the moments and the error buffer as blocks, equals
    the blocks of the whole state the same generator draws, on every
    rank."""
    for rank in ranks(shape):
        assert all(v["init_blocks"] for v in rank["steps"].values())


@pytest.mark.parametrize("shape", MESHES[:2])
def test_ep_refuses_rows_not_split_over_data(ranks, shape):
    """The expert-parallel layer raises where the rows are not split over
    a data axis of more than one rank; over a data axis of one rank it
    runs."""
    refused = ranks(shape)[0]["ep_rows_refused"]
    if shape[0] > 1:
        assert refused is not None and "every DP axis" in refused
    else:
        assert refused is None


def _initial(run):
    """The initial parameters (the state the ranks started from), rebuilt
    from the keys the ranks were given."""
    return _nested({k[len(".params/"):]: v for k, v in run.state.items()
                    if k.startswith(".params/")})


def _nested(flat):
    """Checkpoint keys -> a nested dict of numpy leaves (NamedTuple field
    keys keep the port's ``.field`` form at the top only)."""
    out = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return out


# ------------------------------------------------------------ the launcher

class _Crash(RuntimeError):
    pass


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The single-process launcher runs the mesh runs are held against,
    and the mesh runs (4 ranks, one spawn; see
    ``_torch_lm_dist.launcher_suite``). Every run goes to ``--steps 4``
    (the schedule depends on it), with checkpoints every 2 steps."""
    root = tmp_path_factory.mktemp("launch")

    def argv(arch, ckpt, *extra, steps=4):
        return ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len",
                "32", "--steps", str(steps), "--ckpt-every", "2",
                "--ckpt-dir", str(ckpt), *extra]

    def crash(i, state, metrics):
        if i == 1:
            raise _Crash
    # --steps 0: the initial state; --steps 2 on a checkpoint at step 2:
    # the state as restored, before any step
    single = {"init": tlaunch.main(argv("internlm2-1.8b", root / "i",
                                        steps=0)),
              "intern": tlaunch.main(argv("internlm2-1.8b", root / "s"))}
    with pytest.raises(_Crash):
        tlaunch.main(argv("internlm2-1.8b", root / "resume"), hooks=[crash])
    single["deepseek"] = tlaunch.main(argv("deepseek-v2-lite-16b",
                                           root / "sd", "--opt"))
    mesh = TD.run("_torch_lm_dist:launcher_suite", (1, 4),
                  args=(str(root / "mesh"), str(root / "resume")),
                  tmp_dir=root, kind="lm")[0]
    # the mesh's checkpoint at step 2, restored and resumed by one process
    single["from_mesh0"] = tlaunch.main(argv("internlm2-1.8b",
                                             root / "mesh" / "a2", steps=2))
    single["from_mesh"] = tlaunch.main(argv("internlm2-1.8b",
                                            root / "mesh" / "a2"))
    ckpt = {"single": _checkpoint(root / "resume", 2),
            "mesh": _checkpoint(root / "mesh" / "a2", 2)}
    return single, mesh, ckpt


def _checkpoint(ckpt_dir, step):
    """The leaves a checkpoint holds (checkpoint keys -> numpy)."""
    path = ckpt_dir / f"step_{step:08d}" / "host_0" / "arrays.npz"
    with np.load(path) as data:
        return dict(data)


def _same_state(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _state_drift(a, b, init):
    """How far launcher state ``a`` (checkpoint keys -> numpy) lies from
    ``b``, a state of the same run: the largest relative norm of the
    difference over the parameters' updates from ``init`` (``params``)
    and over the AdamW moments (``moments``), and whether the keys, the
    shapes and the steps agree (``layout``)."""
    layout = a.keys() == b.keys() and all(
        a[k].shape == b[k].shape for k in a) and all(
        np.array_equal(a[k], b[k]) for k in a if k.endswith(".step"))
    out = dict(layout=layout, params=0.0, moments=0.0)
    if not layout:
        return out
    for k in a:
        if k.endswith(".step"):
            continue
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        group = "params" if k.startswith(".params/") else "moments"
        if group == "params":
            x, y = x - init[k], y - init[k]
        out[group] = max(out[group],
                         float(np.linalg.norm(x - y) / np.linalg.norm(y)))
    return out


def _assert_close_state(a, b, init):
    """A mesh run's state against one process's of the same run: the
    parameters' updates within 0.25 and the AdamW moments within 0.05 in
    relative norm (:func:`_state_drift`), about twice what it reads
    between these runs (0.114 and 0.019: the mesh's bfloat16 partial sums
    over 4 steps); updates of unrelated gradients differ by about 1.4."""
    drift = _state_drift(a, b, init)
    assert drift["layout"] and drift["params"] <= 0.25 \
        and drift["moments"] <= 0.05, drift


def _close_losses(got, want):
    return len(got) == len(want) and all(
        TT._rel(g, w) <= 2e-3 for g, w in zip(got, want))


def test_launcher_on_a_mesh_equals_one_process(launched):
    single, mesh, _ = launched
    init = tCK._flatten(single["init"]["state"])
    a = mesh["a"]
    assert a["mesh"] == (1, 4) and a["start"] == 0
    assert _close_losses(a["losses"], single["intern"]["losses"])
    _assert_close_state(a["state"], tCK._flatten(single["intern"]["state"]),
                        init)
    c = mesh["c"]
    want = single["deepseek"]["losses"]
    assert len(c["losses"]) == len(want) == 4
    assert all(TT._rel(g, w) <= 2e-3 for g, w in zip(c["losses"], want))


def test_launcher_checkpoints_cross_between_one_process_and_a_mesh(
        launched):
    single, mesh, ckpt = launched
    init = tCK._flatten(single["init"]["state"])
    whole = tCK._flatten(single["intern"]["state"])
    # the restores: every leaf of the checkpoint read, bit for bit
    b0 = mesh["b0"]
    assert b0["start"] == 2 and b0["losses"] == []
    assert _same_state(b0["state"], ckpt["single"])
    assert mesh["a2_failed_at"] == 2
    back0 = single["from_mesh0"]
    assert back0["start"] == 2 and back0["losses"] == []
    assert _same_state(tCK._flatten(back0["state"]), ckpt["mesh"])
    # the runs continued from them
    b = mesh["b"]
    assert b["start"] == 2
    assert _close_losses(b["losses"], single["intern"]["losses"][2:])
    _assert_close_state(b["state"], whole, init)
    back = single["from_mesh"]
    assert back["start"] == 2
    assert _close_losses(back["losses"], single["intern"]["losses"][2:])
    _assert_close_state(tCK._flatten(back["state"]), whole, init)


def test_launcher_restart_on_a_mesh_equals_the_uninterrupted_run(launched):
    _, mesh, _ = launched
    assert mesh["d_failed_at"] == 2
    d, c = mesh["d"], mesh["c"]
    assert d["start"] == 2 and d["losses"] == c["losses"][2:]
    assert _same_state(d["state"], c["state"])
