"""The port's LM training path against the reference: cross-entropy,
AdamW, top-k gradient compression, the SSD scan's and the MoE gate's
gradients, one train step of the dense, ssm and moe families, gradient
accumulation, compressed steps, training states crossing checkpoints both
ways, and the launcher.

States cross as numpy (``convert.train_state_from_numpy`` of the
reference's ``TrainState``); batches come from both packages' synthetic
pipelines (equal, tests/test_torch_data.py). The reference runs compiled
(``jax.jit``), its Pallas SSD scan in interpret mode; the port runs on CPU
tensors (the kernels' plain versions). Tolerances, stated per check:

* cross-entropy, the schedule, the clip: relative 1e-6; AdamW with f32
  moments 1e-6 (relative, with atol 1e-7) after 3 steps, with bf16 moments
  one bf16 rounding (2^-8 relative); compression: masks, sparse gradients
  and errors exact, ``kept_fraction`` 1e-6;
* the SSD scan's and the gate's gradients: relative 1e-5 (atol 1e-6 of
  the scale) against the reference's VJPs; the autograd functions equal
  plain autograd exactly;
* one float32 train step: loss and grad norm relative 1e-5; each
  gradient within 2e-5 of its leaf's largest |value|; each updated leaf
  within 1e-6 (1 + |p|) except at most 0.2 % of its elements, each at a
  gradient within 1e-4 of the leaf's largest (AdamW's first step turns a
  near-zero gradient into +-lr, so a rounding-sized gradient difference
  moves it by up to 2 lr), and those differ by at most 2 lr;
* one bfloat16 step: loss relative 1e-4, grad norm 5e-3, gradients 3e-2
  of the leaf's scale, updated leaves within 2^-8 |p| + 1e-6 except at
  most 1.5 % of a leaf, each at a gradient within 2e-2 of the leaf's
  largest, differing by at most 2 lr + 2^-7 |p|.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import pipeline as tDP  # noqa: E402
from repro_torch.kernels import moe_gate as tmg  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import grad_compression as tGC  # noqa: E402
from repro_torch.optim import optimizers as tO  # noqa: E402
from repro_torch.optim.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.train import checkpoint as tCK  # noqa: E402
from repro_torch.train import train_loop as tTL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("internlm2-1.8b", "mamba2-780m", "deepseek-v2-lite-16b")
LR = 1e-2


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.registry as jreg
    import repro.data.pipeline as jDP
    import repro.kernels.ops as jops
    import repro.kernels.ref as jref
    import repro.models.layers as jL
    import repro.optim.grad_compression as jGC
    import repro.optim.optimizers as jO
    import repro.train.checkpoint as jCK
    import repro.train.train_loop as jTL
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, reg=jreg, DP=jDP,
                                 ops=jops, ref=jref, L=jL, GC=jGC, O=jO,
                                 CK=jCK, TL=jTL)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _leaves(tree):
    """The leaves of a reference pytree (or of a port tree as numpy), in
    the order ``tree_leaves`` walks a port tree."""
    import jax
    return jax.tree.leaves(tree)


def _numpy_tree(tree):
    """A port tree as a tree of numpy arrays (for :func:`_leaves`)."""
    return {k: _numpy_tree(v) if isinstance(v, dict) else _np(v)
            for k, v in tree.items()}


# ------------------------------------------------------------ cross-entropy

def test_cross_entropy_matches_the_reference(ref):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = rng.random((2, 7)) < 0.6
    for m in (None, mask, np.zeros((2, 7), bool)):
        want = ref.L.cross_entropy(
            ref.jnp.asarray(logits), ref.jnp.asarray(labels),
            None if m is None else ref.jnp.asarray(m))
        got = tL.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32
        assert _rel(got, want) <= 1e-6 or float(want) == float(got) == 0.0
    bf = tL.cross_entropy(_t(logits, torch.bfloat16), torch.from_numpy(labels))
    assert bf.dtype == torch.float32


# ------------------------------------------------------------------ AdamW

def test_schedule_and_clip_match_the_reference(ref):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    jc, tc = ref.O.AdamWConfig(**cfg), tO.AdamWConfig(**cfg)
    for s in (0, 1, 5, 10, 11, 60, 109, 110, 500):
        want = ref.O.schedule(jc, ref.jnp.int32(s))
        got = tO.schedule(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _rel(got, want) <= 1e-6 or float(want) == float(got)
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        jg, jn = ref.O.clip_by_global_norm(
            ref.jax.tree.map(ref.jnp.asarray, tree), max_norm)
        tg, tn = tO.clip_by_global_norm(
            {"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}}, max_norm)
        assert _rel(tn, jn) <= 1e-6
        np.testing.assert_allclose(_np(tg["a"]), _np(jg["a"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tg["b"]["c"]), _np(jg["b"]["c"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(ref, moments):
    """Three updates of a bf16 and an f32 leaf, with clipping on."""
    rng = np.random.default_rng(2)
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=0.5,
              moments_dtype=moments)
    jc, tc = ref.O.AdamWConfig(**kw), tO.AdamWConfig(**kw)
    p = {"w": rng.standard_normal((4, 9)).astype(np.float32),
         "n": rng.standard_normal(9).astype(np.float32)}
    jp = {"w": ref.jnp.asarray(p["w"]).astype(ref.jnp.bfloat16),
          "n": ref.jnp.asarray(p["n"])}
    tp = {"w": _t(p["w"], torch.bfloat16), "n": _t(p["n"])}
    js, ts = ref.O.init_adamw(jp, jc), tO.init_adamw(tp, tc)
    want_dt = torch.bfloat16 if moments == "bfloat16" else torch.float32
    assert ts.m["w"].dtype == ts.v["n"].dtype == want_dt
    upd = ref.jax.jit(lambda p_, g_, s_: ref.O.adamw_update(jc, p_, g_, s_))
    tol = dict(rtol=2.0 ** -8, atol=1e-7) if moments == "bfloat16" \
        else dict(rtol=1e-6, atol=1e-7)
    for _ in range(3):
        g = {"w": rng.standard_normal((4, 9)).astype(np.float32),
             "n": rng.standard_normal(9).astype(np.float32)}
        jp, js, jm = upd(jp, {"w": ref.jnp.asarray(g["w"]).astype(
            ref.jnp.bfloat16), "n": ref.jnp.asarray(g["n"])}, js)
        tp, ts, tm = tO.adamw_update(tc, tp, {
            "w": _t(g["w"], torch.bfloat16), "n": _t(g["n"])}, ts)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
        assert int(ts.step) == int(js.step)
        assert tp["w"].dtype == torch.bfloat16
        for k in ("w", "n"):
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                       rtol=2.0 ** -8 if k == "w" else 1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(_np(ts.m[k]), _np(js.m[k]), **tol)
            np.testing.assert_allclose(_np(ts.v[k]), _np(js.v[k]), **tol)


# ---------------------------------------------------- gradient compression

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_matches_the_reference(ref, dtype):
    """Three steps of error feedback on leaves of one chunk, several
    chunks with a ragged last one, and a short leaf (fewer entries than
    k): masks, sparse gradients and errors exact."""
    rng = np.random.default_rng(3)
    shapes = {"a": (2048,), "b": (5, 1000), "c": (7,)}
    jdt = getattr(ref.jnp, dtype)
    jc, tc = ref.GC.CompressionConfig(rho=0.05), \
        tGC.CompressionConfig(rho=0.05)
    like = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jef = ref.GC.init_ef(ref.jax.tree.map(ref.jnp.asarray, like))
    tef = tGC.init_ef({k: _t(v) for k, v in like.items()})
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        g["b"][0, :40] = 1.0                       # ties at the threshold
        jg = {k: ref.jnp.asarray(v).astype(jdt) for k, v in g.items()}
        tg = {k: _t(v, getattr(torch, dtype)) for k, v in g.items()}
        js, jef, jst = ref.GC.compress_grads(jg, jef, jc)
        ts, tef, tst = tGC.compress_grads(tg, tef, tc)
        for k in shapes:
            assert ts[k].dtype == getattr(torch, dtype)
            assert tef.error[k].dtype == torch.float32
            np.testing.assert_array_equal(_np(ts[k]), _np(js[k]))
            np.testing.assert_array_equal(_np(tef.error[k]),
                                          _np(jef.error[k]))
            acc = _t(_np(tef.error[k]) + _np(ts[k]))
            np.testing.assert_array_equal(
                _np(tGC._topk_mask_chunked(acc, 0.05)),
                _np(ref.GC._topk_mask_chunked(ref.jnp.asarray(_np(acc)),
                                              0.05)))
        assert _rel(tst["kept_fraction"], jst["kept_fraction"]) <= 1e-6
    off = tGC.compress_grads(tg, tef, tGC.CompressionConfig(enabled=False))
    assert off[0] is tg and float(off[2]["kept_fraction"]) == 1.0


# ------------------------------------------------ the kernels' gradients

def _ssd_inputs(seed, bsz=2, h=3, L=50, p=8, n=5):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((bsz, h, L, p)).astype(np.float32)
    ld = -np.logaddexp(rng.standard_normal((bsz, h, L)), 0).astype(
        np.float32)
    b, c = (0.5 * rng.standard_normal((bsz, L, n)).astype(np.float32)
            for _ in range(2))
    gy = rng.standard_normal((bsz, h, L, p)).astype(np.float32)
    return u, ld, b, c, gy


def test_ssd_scan_gradients_match_the_reference(ref):
    """The SSD scan's autograd function (its backward the plain chunked
    form's VJP, B and C summed over the heads) against the reference's
    custom VJP through ``ops.ssd_scan_mh`` (Pallas, interpret mode), and
    equal to plain autograd through the chunked form."""
    u, ld, b, c, gy = _ssd_inputs(0)
    chunk = 16

    def jloss(u_, ld_, b_, c_):
        y = ref.ops.ssd_scan_mh(u_, ld_, b_, c_, chunk=chunk)
        return ref.jnp.sum(y * gy)
    want = ref.jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(ref.jnp.asarray, (u, ld, b, c)))
    bsz, h, L, p = u.shape

    def run(fn):
        ins = [_t(x).requires_grad_() for x in (u, ld, b, c)]
        y = fn(ins[0].reshape(bsz * h, L, p), ins[1].reshape(bsz * h, L),
               ins[2], ins[3], chunk, h)
        torch.autograd.backward(y, _t(gy).reshape(bsz * h, L, p))
        return [x.grad for x in ins]
    got = run(tss._SSDScan.apply)
    plain = run(tss._ssd_scan_plain)
    for g, pg, w in zip(got, plain, want):
        assert torch.equal(g, pg)
        scale = float(np.abs(_np(w)).max())
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5,
                                   atol=1e-6 * scale)
    # the public entries differentiate on the CPU too
    ins = [_t(x).requires_grad_() for x in (u, ld, b, c)]
    from repro_torch.kernels import ops as tops
    torch.autograd.backward(tops.ssd_scan_mh(*ins, chunk=chunk), _t(gy))
    for g, pg in zip([x.grad for x in ins], plain):
        assert torch.equal(g, pg)


@pytest.mark.parametrize("renorm", [True, False])
def test_moe_gate_gradient_matches_the_reference(ref, renorm):
    """The gate's autograd function (backward ``moe_gate_vjp``) against
    ``jax.grad`` of the reference's oracle ``ref.moe_gate_topk`` (the gate
    its model differentiates), and against autograd through the plain
    version; no gradient reaches the ids."""
    rng = np.random.default_rng(1)
    x = (2 * rng.standard_normal((40, 16))).astype(np.float32)
    g = rng.standard_normal((40, 6)).astype(np.float32)
    want = ref.jax.grad(lambda z: ref.jnp.sum(
        ref.ref.moe_gate_topk(z, 6, renorm)[0] * g))(ref.jnp.asarray(x))
    lx = _t(x).requires_grad_()
    probs, ids = tmg._MoEGate.apply(lx, 6, renorm)
    assert not ids.requires_grad
    torch.autograd.backward(probs, _t(g))
    px = _t(x).requires_grad_()
    torch.autograd.backward(tmg.moe_gate_topk(px, 6, renorm)[0], _t(g))
    scale = float(np.abs(_np(want)).max())
    for got in (lx.grad, px.grad):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6 * scale)
    if renorm:           # only the chosen logits get a gradient
        chosen = np.zeros(x.shape, bool)
        np.put_along_axis(chosen, ids.long().numpy(), True, axis=1)
        assert not _np(lx.grad)[~chosen].any()


# ------------------------------------------------------------ train steps

def _configs(ref, arch, dtype, *, opt=False, **over):
    """Both packages' smoke config of ``arch``; with ``opt``, after each
    package's ``apply_opt`` (:func:`test_apply_opt_equals_the_reference`
    holds the two transforms equal; the reference's is rebuilt here from
    the port's fields, see :func:`_reference_opt`)."""
    jcfg = dataclasses.replace(ref.reg.get_config(arch + "-smoke"),
                               dtype=dtype, **over)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"),
                               dtype=dtype, **over)
    if opt:
        tcfg = tdry.apply_opt(tcfg)
        jcfg = _reference_opt(jcfg, tcfg)
    return jcfg, tcfg


def _reference_opt(jcfg, tcfg):
    """The reference config ``jcfg`` with the fields ``apply_opt`` sets,
    taken from the port's transformed ``tcfg``. Importing the reference's
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` and ``REPRO_KERNEL_IMPL``
    for the whole process, so it is imported only in a subprocess."""
    repl = dict(act_sp=tcfg.act_sp, batch_over_model=tcfg.batch_over_model)
    if jcfg.moe is not None:
        repl["moe"] = dataclasses.replace(
            jcfg.moe, capacity_factor=tcfg.moe.capacity_factor,
            dispatch=tcfg.moe.dispatch, ep_fsdp=tcfg.moe.ep_fsdp)
    return dataclasses.replace(jcfg, **repl)


def _setup(ref, arch, dtype, *, grad_accum=1, rho=None, batch=4, opt=False):
    """Both packages' train configs and steps, the reference's initial
    state and the port's copy of it, and a batch of both pipelines."""
    jcfg, tcfg = _configs(ref, arch, dtype, opt=opt)
    opt = dict(lr=LR, warmup_steps=2, total_steps=50)
    jt = ref.TL.TrainConfig(
        optimizer=ref.O.AdamWConfig(**opt), grad_accum=grad_accum,
        compression=None if rho is None else ref.GC.CompressionConfig(
            rho=rho))
    tt = tTL.TrainConfig(
        optimizer=tO.AdamWConfig(**opt), grad_accum=grad_accum,
        compression=None if rho is None else tGC.CompressionConfig(rho=rho))
    js = ref.TL.init_train_state(ref.jax.random.PRNGKey(0), jcfg, jt)
    ts = convert.train_state_from_numpy(ref.jax.tree.map(np.asarray, js),
                                        tcfg, device="cpu")
    kw = dict(seq_len=16, global_batch=batch, vocab_size=tcfg.vocab_size)
    data = types.SimpleNamespace(
        j=ref.DP.SyntheticLM(ref.DP.DataConfig(**kw)),
        t=tDP.SyntheticLM(tDP.DataConfig(**kw)))
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, js=js, ts=ts, data=data,
        jstep=ref.jax.jit(ref.TL.make_train_step(jcfg, jt)),
        tstep=tTL.make_train_step(tcfg, tt))


def _check_update(jparams, tparams, jgrads, lr, dtype):
    """Updated leaves: close except near-zero-gradient elements, which
    AdamW's first step may move by up to 2 lr (module docstring)."""
    f32 = dtype == "float32"
    for want, got, g in zip(_leaves(jparams), tree_leaves(tparams),
                            _leaves(jgrads)):
        want, got, g = _np(want), _np(got), np.abs(_np(g))
        diff = np.abs(got - want)
        tol = 1e-6 * (1 + np.abs(want)) if f32 \
            else 2.0 ** -8 * np.abs(want) + 1e-6
        off = diff > tol
        assert off.sum() <= (0.002 if f32 else 0.015) * off.size
        if off.any():
            assert g[off].max() <= (1e-4 if f32 else 2e-2) * g.max()
            assert (diff[off] <= 2 * lr * (1 + 1e-3)
                    + (0 if f32 else 2.0 ** -7 * np.abs(want[off]))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(ref, arch, dtype):
    s = _setup(ref, arch, dtype)
    batch = s.data.t.batch(0)
    jbatch = s.data.j.batch(0)
    jgrads = ref.jax.jit(ref.jax.grad(
        lambda p: ref.TL.loss_fn(p, s.jcfg, jbatch)[0]))(s.js.params)
    _, _, tgrads = tTL.grads_of(s.ts.params, s.tcfg, batch)
    f32 = dtype == "float32"
    for want, got in zip(_leaves(jgrads), tree_leaves(tgrads)):
        assert got.dtype == tL._dtype(dtype) or got.dtype == torch.float32
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(_np(got) - _np(want)).max()) \
            <= (2e-5 if f32 else 3e-2) * scale
    js2, jm = s.jstep(s.js, jbatch)
    ts2, tm = s.tstep(s.ts, batch)
    assert set(tm) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert _rel(tm["loss"], jm["loss"]) <= (1e-5 if f32 else 1e-4)
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= (1e-5 if f32 else 5e-3)
    assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    if arch.startswith("deepseek"):
        assert float(tm["aux"]) > 0 and _rel(tm["aux"], jm["aux"]) <= 1e-4
    assert int(ts2.step) == int(ts2.opt.step) == 1
    _check_update(js2.params, ts2.params, jgrads, float(jm["lr"]), dtype)
    # the input state is left as it was
    for a, b in zip(tree_leaves(s.ts.params),
                    tree_leaves(convert.train_state_from_numpy(
                        ref.jax.tree.map(np.asarray, s.js), s.tcfg,
                        device="cpu").params)):
        assert torch.equal(a, b)


def test_grad_accum_matches_the_reference_and_the_full_batch(ref):
    """grad_accum 2 against the reference's, and against grad_accum 1 on
    the same batch (the same loss to 1e-6, the same update but for the
    near-zero-gradient elements)."""
    two = _setup(ref, "internlm2-1.8b", "float32", grad_accum=2)
    one = _setup(ref, "internlm2-1.8b", "float32")
    batch = two.data.t.batch(0)
    js2, jm = two.jstep(two.js, two.data.j.batch(0))
    ts2, tm = two.tstep(two.ts, batch)
    ts1, tm1 = one.tstep(one.ts, batch)
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    assert float(tm["ce"]) == float(tm["loss"]) and float(tm["aux"]) == 0.0
    assert _rel(tm["loss"], tm1["loss"]) <= 1e-6
    assert _rel(tm["grad_norm"], tm1["grad_norm"]) <= 1e-5
    # the full batch's gradient marks the near-zero elements for both
    g1 = _numpy_tree(tTL.grads_of(one.ts.params, one.tcfg, batch)[2])
    _check_update(js2.params, ts2.params, g1, float(jm["lr"]), "float32")
    _check_update(_numpy_tree(ts1.params), ts2.params, g1, float(jm["lr"]),
                  "float32")
    with pytest.raises(ValueError):
        two.tstep(two.ts, tDP.SyntheticLM(tDP.DataConfig(
            seq_len=16, global_batch=3, vocab_size=256)).batch(0))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m"])
def test_compressed_steps_match_the_reference(ref, arch):
    """Three compressed steps (rho 0.1) in float32: loss, grad norm and
    kept fraction each step, the error buffers and the parameters."""
    s = _setup(ref, arch, "float32", rho=0.1)
    js, ts = s.js, s.ts
    for i in range(3):
        js, jm = s.jstep(js, s.data.j.batch(i))
        ts, tm = s.tstep(ts, s.data.t.batch(i))
        assert set(tm) == set(jm)
        assert _rel(tm["loss"], jm["loss"]) <= 1e-5
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
        assert _rel(tm["kept_fraction"], jm["kept_fraction"]) <= 1e-3
        assert 0.09 <= float(tm["kept_fraction"]) <= 0.15
    for want, got in zip(_leaves(js.ef.error), tree_leaves(ts.ef.error)):
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(_np(got) - _np(want)).max()) <= 1e-3 * scale
    for want, got in zip(_leaves(js.params), tree_leaves(ts.params)):
        assert float(np.abs(_np(got) - _np(want)).max()) <= 4 * LR


@pytest.mark.parametrize("rho", [None, 0.1])
def test_loss_descends_over_20_steps(ref, rho):
    """As the reference's ``test_train_loss_descends_over_steps`` and
    ``test_compressed_training_still_descends``: the same data, config,
    initial state (the reference's, carried across: the thresholds were
    set for that draw, and the port's losses follow the reference's step
    by step) and thresholds, on the port through ``train_loop``."""
    s = _setup(ref, "internlm2-1.8b", "bfloat16", rho=rho)
    seen = []
    state, hist = tTL.train_loop(
        s.ts, s.tstep, (s.data.t.batch(i) for i in range(20)),
        hooks=[lambda i, st, m: seen.append(int(st.step))])
    losses = [h["loss"] for h in hist]
    assert seen == list(range(1, 21))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - (0.2 if rho is None
                                                         else 0.1)
    if rho is not None:
        assert 0.05 <= hist[-1]["kept_fraction"] <= 0.2


def test_remat_on_equals_off_and_every_leaf_learns():
    """Block remat (``torch.utils.checkpoint``) gives the same loss and
    gradients, bit for bit, as keeping the activations; every leaf of a
    mamba2 layer and the MoE router gets a non-zero gradient from the
    cross-entropy alone."""
    for arch in ("mamba2-780m", "deepseek-v2-lite-16b", "internlm2-1.8b"):
        base = dataclasses.replace(treg.get_config(arch + "-smoke"),
                                   dtype="float32")
        params = tT.init_params(torch.Generator().manual_seed(1), base,
                                device="cpu")
        batch = tDP.SyntheticLM(tDP.DataConfig(
            seq_len=40, global_batch=2, vocab_size=base.vocab_size)).batch(3)
        out = {}
        for remat in ("block", "none"):
            cfg = dataclasses.replace(base, remat=remat)
            out[remat] = tTL.grads_of(params, cfg, batch)
        assert torch.equal(out["block"][0], out["none"][0])
        for a, b in zip(tree_leaves(out["block"][2]),
                        tree_leaves(out["none"][2])):
            assert torch.equal(a, b)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        logits, _ = tT.forward(tree_unflatten(params, leaves), base,
                               batch["tokens"])
        ce = tL.cross_entropy(logits, torch.from_numpy(batch["labels"]))
        grads = torch.autograd.grad(ce, leaves, allow_unused=True)
        named = dict(zip(_paths(params), grads))
        wanted = [k for k in named if k[0] == "layers" and (
            not arch.startswith("deepseek") or k[-1] == "router")]
        assert wanted
        for k in wanted:
            g = named[k]
            assert g is not None and bool((g != 0).any()), k
            for layer in range(base.n_layers):
                assert bool((g[layer] != 0).any()), (k, layer)


def _paths(tree, prefix=()):
    return [p for k in sorted(tree) for p in (
        _paths(tree[k], prefix + (k,)) if isinstance(tree[k], dict)
        else [prefix + (k,)])]


# --------------------------------------------------------- checkpoints

def test_train_state_checkpoint_crosses_both_ways(ref, tmp_path):
    """A bf16 compressed TrainState after one step (moments, error buffer
    and steps all non-trivial): the reference's checkpoint restores into
    the port's state exactly, the port's into the reference's, and both
    manifests hold the same keys."""
    s = _setup(ref, "mamba2-780m", "bfloat16", rho=0.1)
    js2, _ = s.jstep(s.js, s.data.j.batch(0))
    ts2, _ = s.tstep(s.ts, s.data.t.batch(0))
    ref.CK.save_checkpoint(tmp_path / "j", 1, js2)
    tCK.save_checkpoint(tmp_path / "t", 1, ts2)
    jkeys = tCK._flatten(ts2).keys()
    assert any(k.startswith(".ef/.error/") for k in jkeys)
    assert {".step", ".opt/.step", ".params/embed", ".opt/.m/embed",
            ".opt/.v/embed"} <= set(jkeys)
    assert set(jkeys) == set(ref.CK._flatten(js2).keys())
    got = tCK.restore_checkpoint(tmp_path / "j", s.ts)
    want = convert.train_state_from_numpy(
        ref.jax.tree.map(np.asarray, js2), s.tcfg, device="cpu")
    for a, b in zip(tCK._flatten(got).values(), tCK._flatten(want).values()):
        np.testing.assert_array_equal(a, b)
    assert tree_leaves(got.params)[0].dtype == torch.bfloat16
    back = ref.CK.restore_checkpoint(tmp_path / "t", s.js)
    for a, b in zip(ref.CK._flatten(back).values(),
                    tCK._flatten(ts2).values()):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    assert str(_leaves(back.params)[0].dtype) == "bfloat16"


# ------------------------------------------------------------ launcher

def test_launcher_runs_and_resumes_from_the_command_line(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "internlm2-1.8b", "--smoke", "--device", "cpu", "--seq-len",
           "32", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    first = subprocess.run(cmd + ["--steps", "4"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "4 steps in" in first.stdout
    assert tCK.latest_step(tmp_path) == 4
    second = subprocess.run(cmd + ["--steps", "6"], cwd=ROOT, env=env,
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4" in second.stdout
    assert "2 steps in" in second.stdout
    assert tCK.latest_step(tmp_path) == 6


class _Crash(RuntimeError):
    pass


def test_launcher_restart_equals_the_uninterrupted_run(tmp_path):
    """A run that fails after step 4 and is started again with the same
    flags resumes from its step-3 checkpoint and ends in the state, and
    with the losses, of the run that did not fail (compression on, grad
    accumulation 2)."""
    argv = ["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
            "--steps", "6", "--seq-len", "32", "--grad-accum", "2",
            "--compress", "--ckpt-every", "3"]
    whole = tlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "a")])

    def crash(i, state, metrics):
        if i == 3:
            raise _Crash
    with pytest.raises(_Crash):
        tlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "b")],
                     hooks=[crash])
    assert tCK.latest_step(tmp_path / "b") == 3
    resumed = tlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start"] == 3 and whole["start"] == 0
    assert resumed["losses"] == whole["losses"][3:]
    for a, b in zip(tCK._flatten(resumed["state"]).values(),
                    tCK._flatten(whole["state"]).values()):
        np.testing.assert_array_equal(a, b)
    assert int(whole["state"].step) == 6


def test_apply_opt_equals_the_reference():
    """``apply_opt`` gives the reference's config for every architecture,
    full and smoke. The reference's runs in a subprocess: importing its
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` and ``REPRO_KERNEL_IMPL``
    for the whole process."""
    code = ("import dataclasses, json\n"
            "from repro.configs.registry import ARCH_IDS, get_config\n"
            "from repro.launch.dryrun import apply_opt\n"
            "print(json.dumps({a + s: dataclasses.asdict(apply_opt(\n"
            "    get_config(a + s))) for a in ARCH_IDS\n"
            "    for s in ('', '-smoke')}))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = {a + s: json.loads(json.dumps(dataclasses.asdict(
        tdry.apply_opt(treg.get_config(a + s)))))
        for a in treg.ARCH_IDS for s in ("", "-smoke")}
    assert got == want
    moe = tdry.apply_opt(treg.get_config("deepseek-v2-lite-16b-smoke")).moe
    assert (moe.capacity_factor, moe.dispatch) == (1.0, "catwalk_ep")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opt_step_matches_the_reference(ref, dtype):
    """deepseek-v2-lite's smoke step under ``--opt`` (capacity factor 1.0,
    so assignments drop; ``catwalk_ep``, which runs ``moe_apply`` on one
    device in both packages) against the reference's, within the
    tolerances of :func:`test_train_step_matches_the_reference`."""
    s = _setup(ref, "deepseek-v2-lite-16b", dtype, opt=True)
    assert s.tcfg.moe.capacity_factor == 1.0
    js2, jm = s.jstep(s.js, s.data.j.batch(0))
    ts2, tm = s.tstep(s.ts, s.data.t.batch(0))
    f32 = dtype == "float32"
    assert _rel(tm["loss"], jm["loss"]) <= (1e-5 if f32 else 1e-4)
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= (1e-5 if f32 else 5e-3)
    assert float(tm["aux"]) > 0 and _rel(tm["aux"], jm["aux"]) <= 1e-4
    jgrads = ref.jax.jit(ref.jax.grad(lambda p: ref.TL.loss_fn(
        p, s.jcfg, s.data.j.batch(0))[0]))(s.js.params)
    _check_update(js2.params, ts2.params, jgrads, float(jm["lr"]), dtype)


def test_launcher_opt_runs_and_steps_as_the_reference(ref, tmp_path):
    """``--smoke --opt`` through the launcher: its config is the smoke
    config after ``apply_opt``, it runs a step, and its step (the
    launcher's train config and first batch) from the reference's state
    equals the reference's, as in :func:`test_opt_step_matches_the_reference`
    (bfloat16, the smoke config's dtype)."""
    arch = "deepseek-v2-lite-16b"
    argv = ["--arch", arch, "--smoke", "--opt", "--device", "cpu",
            "--steps", "1", "--ckpt-dir", str(tmp_path)]
    out = tlaunch.main(argv)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    cfg, tcfg, data = tlaunch.setup(tlaunch.parser().parse_args(argv))
    assert cfg == tdry.apply_opt(treg.get_config(arch + "-smoke"))
    jcfg = _reference_opt(ref.reg.get_config(arch + "-smoke"), cfg)
    jt = ref.TL.TrainConfig(optimizer=ref.O.AdamWConfig(
        **dataclasses.asdict(tcfg.optimizer)))
    js = ref.TL.init_train_state(ref.jax.random.PRNGKey(0), jcfg, jt)
    ts = convert.train_state_from_numpy(ref.jax.tree.map(np.asarray, js),
                                        cfg, device="cpu")
    jbatch = ref.DP.SyntheticLM(ref.DP.DataConfig(
        **dataclasses.asdict(data.cfg))).batch(0)
    js2, jm = ref.jax.jit(ref.TL.make_train_step(jcfg, jt))(js, jbatch)
    ts2, tm = tTL.make_train_step(cfg, tcfg)(ts, data.batch(0))
    assert _rel(tm["loss"], jm["loss"]) <= 1e-4
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 5e-3
    jgrads = ref.jax.jit(ref.jax.grad(lambda p: ref.TL.loss_fn(
        p, jcfg, jbatch)[0]))(js.params)
    _check_update(js2.params, ts2.params, jgrads, float(jm["lr"]),
                  "bfloat16")


# ---------------------------------------------------------------- card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
def test_cuda_autograd_kernels_match_plain_versions():
    """On the card: the SSD scan's autograd function (one launch forward)
    against plain autograd through the chunked form, in float32 and
    bfloat16, and the gate's against autograd through its plain
    version."""
    _cuda()
    dev = torch.device("cuda")
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        u, ld, b, c, gy = _ssd_inputs(5, bsz=2, h=4, L=300, p=64, n=128)
        bsz, h, L, p = u.shape
        grads = {}
        for name, fn in (("kernel", tss._SSDScan.apply),
                         ("plain", tss._ssd_scan_plain)):
            ins = [_t(x).to(dev, dtype if i != 1 else torch.float32)
                   .requires_grad_() for i, x in enumerate((u, ld, b, c))]
            tss.reset_launches()
            y = fn(ins[0].reshape(bsz * h, L, p).contiguous(),
                   ins[1].reshape(bsz * h, L).contiguous(), ins[2], ins[3],
                   128, h)
            assert tss.LAUNCHES["ssd_scan"] == (name == "kernel")
            torch.autograd.backward(y, _t(gy).to(dev, dtype)
                                    .reshape(bsz * h, L, p))
            grads[name] = [x.grad.float().cpu() for x in ins]
        for a, b_ in zip(grads["kernel"], grads["plain"]):
            scale = float(b_.abs().max())
            assert float((a - b_).abs().max()) <= tol * scale
    x = torch.randn(8192, 64, device=dev)
    g = torch.randn(8192, 6, device=dev)
    for renorm in (True, False):
        out = []
        for fn in (tmg.moe_gate_topk, tmg.moe_gate_topk_plain):
            lx = x.clone().requires_grad_()
            torch.autograd.backward(fn(lx, 6, renorm)[0], g)
            out.append(lx.grad)
        assert float((out[0] - out[1]).abs().max()) <= 1e-6


def _card_vs_cpu_step(arch, remat="block"):
    cfg = dataclasses.replace(treg.get_config(arch + "-smoke"),
                              dtype="float32", remat=remat)
    tcfg = tTL.TrainConfig(optimizer=tO.AdamWConfig(lr=LR, warmup_steps=2,
                                                    total_steps=50),
                           compression=tGC.CompressionConfig(rho=0.1))
    host = tTL.init_train_state(torch.Generator().manual_seed(2), cfg, tcfg,
                                device="cpu")
    card = tTL.TrainState(*(tCK._map_with_path(
        x, lambda _, t: t.cuda()) for x in host))
    batch = tDP.SyntheticLM(tDP.DataConfig(
        seq_len=70, global_batch=2, vocab_size=cfg.vocab_size)).batch(0)
    step = tTL.make_train_step(cfg, tcfg)
    return step(host, batch), step(card, batch)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """One float32 compressed step of each family on the card against the
    CPU's (f32 matmuls without TF32): loss and grad norm within 1e-4."""
    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ARCHS:
        (h2, hm), (c2, cm) = _card_vs_cpu_step(arch)
        assert _rel(cm["loss"].cpu(), hm["loss"]) <= 1e-4
        assert _rel(cm["grad_norm"].cpu(), hm["grad_norm"]) <= 1e-4
        for a, b in zip(tree_leaves(c2.params), tree_leaves(h2.params)):
            assert float((a.cpu() - b).abs().max()) <= 2 * LR * (1 + 1e-3)


@pytest.mark.cuda
def test_cuda_remat_on_equals_remat_off():
    _cuda()
    for arch in ARCHS:
        (_, _), (on, mon) = _card_vs_cpu_step(arch, "block")
        (_, _), (off, moff) = _card_vs_cpu_step(arch, "none")
        assert float(mon["loss"]) == float(moff["loss"])
        for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
            assert torch.equal(a, b)
