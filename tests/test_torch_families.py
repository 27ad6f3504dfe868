"""The port's vlm (phi-3-vision-4.2b), audio (seamless-m4t-medium) and
hybrid (zamba2-1.2b) families against the reference: parameter layouts
and conversion, the forward with and without patches or frames, the serve
state (the encoder output, the shared block's per-site caches), cached
decode token by token, greedy ``Engine.generate``, ``loss_fn`` and one
train step with patches or frames, hybrid remat, and the raises.

Weights come from the reference's ``init_params`` and cross through
``convert.lm_params_from_numpy`` (train states through
``convert.train_state_from_numpy``); token ids, patch and frame
embeddings are made with numpy from fixed seeds, shaped as
``tests/test_models_smoke.py`` shapes them. The hybrid runs at the smoke
config (period 1: a site after every layer, no tail) and at 8 layers with
period 3 (two sites and a tail of two layers), built the same way in both
packages. The reference runs compiled (``jax.jit``; its SSD scan in Pallas
interpret mode), the port on CPU tensors (the SSD scan's plain version).

Tolerances: logits, decode steps and the serve state in float32 atol =
rtol = 1e-4; in bfloat16 those of
``tests/test_models_smoke.py::test_decode_matches_forward`` (atol 0.06,
rtol 0.05), the gates of the dense family (``tests/test_torch_lm.py``);
greedy tokens and engine steps equal. One train step as
``tests/test_torch_train.py`` states: float32 loss and grad norm relative
1e-5, each gradient within 2e-5 of its leaf's largest |value|, updated
leaves within 1e-6 (1 + |p|) but for near-zero-gradient elements, moved by
at most 2 lr; bfloat16 loss relative 1e-4, grad norm 5e-3, gradients 3e-2
of the leaf's scale, updated leaves within one bf16 ulp of |p| + 1e-6 but
for near-zero-gradient elements. A near-zero gradient is one within 1e-4
(bfloat16: 2e-2) of its leaf's largest, as there, or one that the clip
brings within 100 AdamW eps of zero, where AdamW's first step turns a
rounding-sized gradient difference into an update difference; the
hybrid's grad norms (37 and 135) put many elements there, so their share
of a leaf is not bounded (``_check_update``). The 8-layer tail case's gradient gates are 2.5 times
the smoke models' (``GRAD_TOL``). Remat on and off: bit for bit.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import pipeline as tDP  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import optimizers as tO  # noqa: E402
from repro_torch.optim.tree import tree_leaves  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.train import train_loop as tTL  # noqa: E402

from test_torch_train import _leaves, _rel  # noqa: E402

VLM, AUDIO, HYBRID = "phi-3-vision-4.2b", "seamless-m4t-medium", "zamba2-1.2b"
#: the family cases: (arch, config overrides); "hybrid_tail" is 8 layers
#: with period 3
CASES = {"vlm": (VLM, {}), "audio": (AUDIO, {}), "hybrid": (HYBRID, {}),
         "hybrid_tail": (HYBRID, {"n_layers": 8, "period": 3})}
#: leaves of the reference trees: embed, final_norm, lm_head; vlm: the
#: dense block's 9 and patch_proj; audio: the decoder block's 14 (norm_x
#: and 4 xattn weights added), the encoder block's 9 and frame_proj;
#: hybrid: norm1 and 6 ssm leaves, and the shared dense block's 9
LEAVES = {"vlm": 13, "audio": 27, "hybrid": 19, "hybrid_tail": 19}
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.06, rtol=0.05)}
DTYPES = ("float32", "bfloat16")
B, S = 2, 24
LR = 1e-2


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.base as jbase
    import repro.configs.registry as jreg
    import repro.data.pipeline as jDP
    import repro.models.transformer as jT
    import repro.optim.optimizers as jO
    import repro.serve.engine as jeng
    import repro.train.train_loop as jTL
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, base=jbase,
                                 reg=jreg, DP=jDP, T=jT, O=jO, eng=jeng,
                                 TL=jTL)


def _configs(ref, case, dtype, **extra):
    arch, over = CASES[case]
    over = dict(over, **extra)
    period = over.pop("period", None)
    jcfg = dataclasses.replace(ref.reg.get_config(arch + "-smoke"),
                               dtype=dtype, **over)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"),
                               dtype=dtype, **over)
    if period is not None:
        jcfg = dataclasses.replace(jcfg, hybrid=ref.base.HybridConfig(period))
        tcfg = dataclasses.replace(tcfg, hybrid=tbase.HybridConfig(period))
    return jcfg, tcfg


def _extras(cfg, b, seed):
    """The frontend inputs of ``cfg``'s family as numpy float32 arrays:
    patches (b, n_tokens, d_embed) for vlm, frames (b, encoder_seq,
    d_embed) for audio, none for the others."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (b, cfg.frontend.n_tokens, cfg.frontend.d_embed),
            dtype=np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (b, cfg.encdec.encoder_seq, cfg.frontend.d_embed),
            dtype=np.float32)}
    return {}


_BUILT = {}


def _build(ref, case, dtype):
    """Both packages' model with the same weights, token ids and frontend
    inputs (built once per module)."""
    if (case, dtype) not in _BUILT:
        jcfg, tcfg = _configs(ref, case, dtype)
        jp = ref.T.init_params(ref.jax.random.PRNGKey(0), jcfg)
        tree = ref.jax.tree.map(np.asarray, jp)
        _BUILT[case, dtype] = types.SimpleNamespace(
            case=case, dtype=dtype, jcfg=jcfg, tcfg=tcfg, jp=jp, tree=tree,
            tp=convert.lm_params_from_numpy(tree, tcfg, device="cpu"),
            toks=np.random.default_rng(1).integers(
                0, tcfg.vocab_size, (B, S)).astype(np.int32),
            extra=_extras(tcfg, B, 2))
    return _BUILT[case, dtype]


@pytest.fixture(scope="module", params=[(c, d) for c in CASES for d in DTYPES],
                ids=[f"{c}-{d}" for c in CASES for d in DTYPES])
def model(request, ref):
    return _build(ref, *request.param)


@pytest.fixture(scope="module",
                params=[(c, d) for c in ("audio", "hybrid", "hybrid_tail")
                        for d in DTYPES],
                ids=[f"{c}-{d}" for c in ("audio", "hybrid", "hybrid_tail")
                     for d in DTYPES])
def stateful(request, ref):
    """The families with serve state of their own (the encoder output, the
    shared block's caches)."""
    return _build(ref, *request.param)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _jnp(ref, extra):
    return {k: ref.jnp.asarray(v) for k, v in extra.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ----------------------------------------------------------- parameters

def test_init_params_matches_reference_layout(ref, model):
    """Same tree, shapes and dtypes as the reference's ``init_params`` (the
    draws differ: another generator); the stacked layers hold independent
    draws; every norm, ``norm_x`` included, is float32 ones."""
    tp = tT.init_params(torch.Generator().manual_seed(0), model.tcfg,
                        device="cpu")
    shapes = ref.jax.eval_shape(lambda k: ref.T.init_params(k, model.jcfg),
                                ref.jax.random.PRNGKey(0))
    flat_t = dict(_flatten(tp))
    flat_j = {tuple(k.key for k in path): leaf for path, leaf in
              ref.jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert set(flat_t) == set(flat_j) and len(flat_j) == LEAVES[model.case]
    for k, leaf in flat_j.items():
        assert tuple(flat_t[k].shape) == leaf.shape, k
        assert str(flat_t[k].dtype).split(".")[-1] == str(leaf.dtype), k
        if k[-1].startswith("norm"):
            assert torch.equal(flat_t[k], torch.ones_like(flat_t[k])), k
    stacked = tp["layers"]["ssm"]["in_proj"] if "ssm" in tp["layers"] \
        else tp["layers"]["mlp"]["w_up"]
    assert not torch.equal(stacked[0], stacked[1])
    if model.case == "audio":
        enc = tp["encoder"]["attn"]["wq"]
        assert not torch.equal(enc[0], enc[1])
        assert tp["layers"]["norm_x"].dtype == torch.float32


def test_lm_params_from_numpy_round_trips_every_leaf(ref, model):
    """Every leaf (patch_proj, frame_proj, the encoder, shared and xattn
    included) arrives exactly, in the dtype the reference keeps it in."""
    leaves = ref.jax.tree_util.tree_flatten_with_path(model.jp)[0]
    for path, leaf in leaves:
        node = model.tp
        for key in path:
            node = node[key.key]
        want = torch.bfloat16 if str(leaf.dtype) == "bfloat16" \
            else torch.float32
        assert node.dtype == want, path
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert len(dict(_flatten(model.tp))) == len(leaves) == LEAVES[model.case]


# -------------------------------------------------------------- forward

def test_forward_matches_reference(ref, model):
    """``"all"`` and ``"last"`` against the reference's, with the family's
    frontend input, and for vlm also without patches (text only)."""
    runs = [model.extra]
    if model.case == "vlm":
        runs.append({})
    for extra in runs:
        for mode in ("all", "last"):
            want = ref.jax.jit(lambda p, t, e: ref.T.forward(
                p, model.jcfg, t, logits_mode=mode, **e)[0])(
                    model.jp, ref.jnp.asarray(model.toks), _jnp(ref, extra))
            got, aux = tT.forward(model.tp, model.tcfg, model.toks,
                                  logits_mode=mode, **extra)
            assert tuple(got.shape) == (B, S if mode == "all" else 1,
                                        model.tcfg.vocab_size)
            assert got.dtype == getattr(torch, model.dtype)
            assert float(aux) == 0.0
            _close(got, want, model.dtype)


def test_patch_prefix_changes_the_text_logits(ref):
    """The prefix is attended to (the text logits move) and left out of
    the logits; other families ignore patches and frames, as the
    reference does."""
    m = _build(ref, "vlm", "float32")
    with_patches, _ = tT.forward(m.tp, m.tcfg, m.toks, **m.extra)
    text_only, _ = tT.forward(m.tp, m.tcfg, m.toks)
    assert with_patches.shape == text_only.shape
    assert float((with_patches - text_only).abs().max()) > 1e-3
    h = _build(ref, "hybrid", "float32")
    plain, _ = tT.forward(h.tp, h.tcfg, h.toks)
    ignored, _ = tT.forward(h.tp, h.tcfg, h.toks, **m.extra,
                            frames=np.zeros((B, 4, 32), np.float32))
    assert torch.equal(plain, ignored)


# ---------------------------------------------------------------- serving

def test_init_serve_state_matches_reference(ref, stateful):
    """audio: the encoder output; hybrid: one GQA cache per site stacked
    on a leading site axis (and the SSM caches per layer)."""
    m = stateful
    jstate = ref.T.init_serve_state(m.jp, m.jcfg, B, 32, **_jnp(ref, m.extra))
    state = tT.init_serve_state(m.tp, m.tcfg, B, 32, **m.extra)
    for got, want in zip(state.layer_caches, jstate.layer_caches):
        assert tuple(got.shape) == tuple(want.shape)
    if m.case == "audio":
        assert state.shared_cache is None and jstate.shared_cache is None
        assert tuple(state.enc_out.shape) == tuple(jstate.enc_out.shape)
        _close(state.enc_out, jstate.enc_out, m.dtype)
        want_enc = tT._encode(m.tp, m.tcfg, m.extra["frames"])
        assert torch.equal(state.enc_out, want_enc)
    else:
        n_sites = m.tcfg.n_layers // m.tcfg.hybrid.period
        assert state.enc_out is None and jstate.enc_out is None
        for got, want in zip(state.shared_cache, jstate.shared_cache):
            assert tuple(got.shape) == tuple(want.shape)
            assert got.shape[0] == n_sites
            assert not bool(got.float().abs().sum())
    with pytest.raises(ValueError):
        tT.per_slot_state(state, B)


def test_decode_step_matches_reference_and_forward(ref, stateful):
    """Token by token against the reference's ``decode_step`` (the
    cross-attention over the encoder output; the shared block with each
    site's cache, then the tail) and against the port's own forward;
    every cache against the reference's after the last step."""
    m = stateful
    jstate = ref.T.init_serve_state(m.jp, m.jcfg, B, 32, **_jnp(ref, m.extra))
    jstep = ref.jax.jit(lambda p, s, t: ref.T.decode_step(p, m.jcfg, s, t))
    state = tT.init_serve_state(m.tp, m.tcfg, B, 32, **m.extra)
    fwd, _ = tT.forward(m.tp, m.tcfg, m.toks, **m.extra)
    for i in range(S):
        want, jstate = jstep(m.jp, jstate, ref.jnp.asarray(m.toks[:, i:i + 1]))
        got, state = tT.decode_step(m.tp, m.tcfg, state, m.toks[:, i:i + 1])
        _close(got, want, m.dtype)
        _close(got, fwd[:, i], m.dtype)
    assert int(state.pos) == S
    caches = list(state.layer_caches) + list(state.shared_cache or [])
    jcaches = list(jstate.layer_caches) + list(jstate.shared_cache or [])
    assert len(caches) == len(jcaches)
    for got, want in zip(caches, jcaches):
        assert tuple(got.shape) == tuple(want.shape)
        if got.is_floating_point():
            _close(got, want, m.dtype)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _prompts(vocab, lengths=(5, 9, 1, 13), seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("case", list(CASES))
def test_engine_greedy_matches_reference(ref, case):
    """Greedy ``Engine.generate`` in float32, token for token and step for
    step: vlm per slot (no patches, as the reference's engine takes none),
    audio on the static path with frames (one row a prompt), hybrid on the
    static path."""
    m = _build(ref, case, "float32")
    prompts = _prompts(m.tcfg.vocab_size)
    extra = _extras(m.tcfg, len(prompts), 5).get("frames")
    jeng = ref.eng.Engine(m.jp, m.jcfg, ref.eng.ServeConfig(max_len=64))
    want = jeng.generate(prompts, max_new_tokens=10, frames=extra)
    eng = Engine(m.tp, m.tcfg, ServeConfig(max_len=64), device="cpu")
    got = eng.generate(prompts, max_new_tokens=10, frames=extra)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.n_steps == jeng.n_steps
    if case == "vlm":              # per slot: the same as serve()
        again = eng.serve(prompts, max_new_tokens=10)
        for g, w in zip(again, want):
            np.testing.assert_array_equal(g, w)
    else:
        with pytest.raises(ValueError):
            eng.serve(prompts, max_new_tokens=10)


# --------------------------------------------------------------- training

#: AdamW's first step turns a clipped gradient g into lr g / (|g| + eps):
#: where |g| is within this many eps of zero, a rounding-sized gradient
#: difference moves the update by more than the leaf tolerance
EPS_BAND = 100


def _ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits): 2^-8 to 2^-7 of |x|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _check_update(jparams, tparams, jgrads, lr, grad_norm, dtype):
    """Updated leaves within 1e-6 (1 + |p|) in float32, one bf16 ulp of
    |p| + 1e-6 in bfloat16, but for elements at a near-zero gradient:
    within 1e-4 (2e-2) of the leaf's largest or, once clipped, within
    EPS_BAND eps of zero; those moved by at most 2 lr (+ 2^-7 |p|)."""
    f32 = dtype == "float32"
    opt = tO.AdamWConfig()
    clip = min(1.0, opt.grad_clip / grad_norm)
    for want, got, g in zip(_leaves(jparams), tree_leaves(tparams),
                            _leaves(jgrads)):
        want, got, g = _np(want), _np(got), np.abs(_np(g))
        diff = np.abs(got - want)
        tol = 1e-6 * (1 + np.abs(want)) if f32 else _ulp(want) + 1e-6
        off = diff > tol
        near = (g <= (1e-4 if f32 else 2e-2) * g.max()) \
            | (clip * g <= EPS_BAND * opt.eps)
        assert near[off].all()
        assert (diff[off] <= 2 * lr * (1 + 1e-3)
                + (0 if f32 else 2.0 ** -7 * np.abs(want[off]))).all()


#: gradient gates, of each leaf's largest |value|: the smoke models'
#: (tests/test_torch_train.py), and for the 8-layer tail case 2.5 times
#: those: the port's SSD scan sums in another order than the reference's,
#: and the difference grows with the SSM depth, as it does in the
#: attention-free mamba2 stack (the forward logits drift the same way)
GRAD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DEPTH_FACTOR = {"hybrid_tail": 2.5}


def _setup(ref, case, dtype):
    """Both packages' train configs and the same initial state (the
    module's weights, zero moments), a batch of both pipelines with the
    family's patches or frames, and the port's step."""
    m = _build(ref, case, dtype)
    opt = dict(lr=LR, warmup_steps=2, total_steps=50)
    jopt = ref.O.AdamWConfig(**opt)
    js = ref.TL.TrainState(m.jp, ref.O.init_adamw(m.jp, jopt), None,
                           ref.jnp.zeros((), ref.jnp.int32))
    ts = convert.train_state_from_numpy(ref.jax.tree.map(np.asarray, js),
                                        m.tcfg, device="cpu")
    kw = dict(seq_len=16, global_batch=4, vocab_size=m.tcfg.vocab_size)
    batch = {**tDP.SyntheticLM(tDP.DataConfig(**kw)).batch(0),
             **_extras(m.tcfg, 4, 3)}
    jbatch = {**ref.DP.SyntheticLM(ref.DP.DataConfig(**kw)).batch(0),
              **_jnp(ref, _extras(m.tcfg, 4, 3))}
    tt = tTL.TrainConfig(optimizer=tO.AdamWConfig(**opt))
    return types.SimpleNamespace(
        m=m, jopt=jopt, js=js, ts=ts, batch=batch, jbatch=jbatch,
        tstep=tTL.make_train_step(m.tcfg, tt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_train_step_match_reference(ref, case, dtype):
    """``loss_fn`` with the batch's patches or frames, its gradients (the
    shared block's summed over every site), and one step against the
    reference's as its ``make_train_step`` composes it at ``grad_accum``
    1: ``value_and_grad`` of ``loss_fn``, then ``adamw_update``."""
    s = _setup(ref, case, dtype)
    f32 = dtype == "float32"
    (jloss, jparts), jgrads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p: ref.TL.loss_fn(p, s.m.jcfg, s.jbatch), has_aux=True))(
            s.js.params)
    jparams, _, jm = ref.jax.jit(
        lambda p, g, o: ref.O.adamw_update(s.jopt, p, g, o))(
            s.js.params, jgrads, s.js.opt)
    ts2, tm = s.tstep(s.ts, s.batch)
    loss, parts = tTL.loss_fn(s.ts.params, s.m.tcfg, s.batch)
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]),
                      (tm["loss"], jloss)):
        assert _rel(got, want) <= (1e-5 if f32 else 1e-4)
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= (1e-5 if f32 else 5e-3)
    assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    _, _, tgrads = tTL.grads_of(s.ts.params, s.m.tcfg, s.batch)
    tol = GRAD_TOL[dtype] * DEPTH_FACTOR.get(case, 1.0)
    for want, got in zip(_leaves(jgrads), tree_leaves(tgrads)):
        scale = float(np.abs(_np(want)).max())
        assert scale > 0
        assert float(np.abs(_np(got) - _np(want)).max()) <= tol * scale
    _check_update(jparams, ts2.params, jgrads, float(jm["lr"]),
                  float(jm["grad_norm"]), dtype)
    assert int(ts2.step) == 1


@pytest.mark.parametrize("case", ["hybrid", "hybrid_tail", "audio"])
def test_remat_on_equals_off(ref, case):
    """Block remat (a hybrid layer and its shared block under one
    checkpoint; the audio encoder's and decoder's blocks) gives the same
    loss and gradients, bit for bit, as keeping the activations."""
    m = _build(ref, case, "float32")
    batch = {**tDP.SyntheticLM(tDP.DataConfig(
        seq_len=16, global_batch=2, vocab_size=m.tcfg.vocab_size)).batch(1),
             **_extras(m.tcfg, 2, 6)}
    out = {remat: tTL.grads_of(m.tp, dataclasses.replace(m.tcfg, remat=remat),
                               batch) for remat in ("block", "none")}
    assert torch.equal(out["block"][0], out["none"][0])
    for a, b in zip(tree_leaves(out["block"][2]), tree_leaves(out["none"][2])):
        assert torch.equal(a, b)
    shared = out["block"][2].get("shared")
    if shared is not None:
        assert all(bool((g != 0).any()) for g in tree_leaves(shared))


# ------------------------------------------------------------------ raises

def test_audio_needs_frames(ref):
    """Where the reference fails on ``None.astype``, the port raises
    ``ValueError`` naming the frames: the forward, the serve state, the
    engine and the loss."""
    m = _build(ref, "audio", "float32")
    with pytest.raises(AttributeError):
        ref.T.forward(m.jp, m.jcfg, ref.jnp.asarray(m.toks))
    with pytest.raises(ValueError, match="frames"):
        tT.forward(m.tp, m.tcfg, m.toks)
    with pytest.raises(ValueError, match="frames"):
        tT.init_serve_state(m.tp, m.tcfg, B, 32)
    with pytest.raises(ValueError, match="frames"):
        Engine(m.tp, m.tcfg, ServeConfig(), device="cpu").generate(
            _prompts(m.tcfg.vocab_size))
    with pytest.raises(ValueError, match="frames"):
        tTL.loss_fn(m.tp, m.tcfg, tDP.SyntheticLM(tDP.DataConfig(
            seq_len=8, global_batch=2, vocab_size=256)).batch(0))


def test_launcher_trains_vlm_and_hybrid_and_refuses_audio(tmp_path):
    """The launcher's data gives tokens only: phi-3-vision trains text
    only, zamba2 trains; seamless raises (the reference's launcher fails
    in its loss on the missing frames)."""
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2"]
    for arch in (VLM, HYBRID):
        out = tlaunch.main(["--arch", arch, *base,
                            "--ckpt-dir", str(tmp_path / arch)])
        assert len(out["losses"]) == 2 and all(map(np.isfinite,
                                                   out["losses"]))
        assert int(out["state"].step) == 2
    with pytest.raises(ValueError, match="frames"):
        tlaunch.main(["--arch", AUDIO, *base,
                      "--ckpt-dir", str(tmp_path / AUDIO)])


@pytest.mark.parametrize("family", ["tnn", "mystery"])
def test_unknown_family_raises(family):
    cfg = dataclasses.replace(treg.get_config(VLM + "-smoke"), family=family)
    with pytest.raises(ValueError, match=family):
        tT.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(ValueError, match=family):
        tT.forward({"embed": torch.zeros(4, 4)}, cfg, np.zeros((1, 2)))
    with pytest.raises(ValueError, match=family):
        tT.init_serve_state({"embed": torch.zeros(4, 4)}, cfg, 1, 4)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    for arch in (VLM, AUDIO, HYBRID):
        cfg = treg.get_config(arch + "-smoke")
        with pytest.raises(RuntimeError, match="CUDA"):
            tT.init_params(torch.Generator(), cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine({}, cfg, ServeConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.lm_params_from_numpy({}, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tTL.init_train_state(torch.Generator(), cfg, tTL.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--arch", HYBRID, "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--opt",
                      "--steps", "1"])


# ------------------------------------------------------------------- card

def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [VLM, AUDIO, HYBRID])
def test_cuda_family_matches_cpu(arch):
    """Each family's float32 smoke model on the card (the SSD kernel in
    every hybrid layer; 7 hybrid layers with period 6: a site and a tail):
    the forward against the CPU's float64 forward and the card's own cached
    decode (1e-4 of the scale), and the loss against the CPU's (1e-4, TF32
    off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from repro_torch.kernels import ssd_scan as tss
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(treg.get_config(arch + "-smoke"),
                              dtype="float32")
    if arch == HYBRID:
        cfg = dataclasses.replace(cfg, n_layers=7,
                                  hybrid=tbase.HybridConfig(period=6))
    params = tT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cuda")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    extra = _extras(cfg, B, 1)
    tss.reset_launches()
    got, _ = tT.forward(params, cfg, toks, **extra)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["ssd_scan"] == (cfg.n_layers if arch == HYBRID
                                        else 0)
    host, _ = tT.forward(_map(params, lambda t: t.cpu().double()), cfg, toks,
                         **{k: v.astype(np.float64) for k, v in extra.items()})
    scale = float(host.abs().max())
    assert float((got.cpu().double() - host).abs().max()) <= 1e-4 * scale
    # decode takes no patches: the vlm's decode against its text forward
    fwd = tT.forward(params, cfg, toks)[0] if arch == VLM else got
    state = tT.init_serve_state(params, cfg, B, S, frames=extra.get("frames"))
    for i in range(S):
        lg, state = tT.decode_step(params, cfg, state, toks[:, i:i + 1])
        assert float((lg - fwd[:, i]).abs().max()) <= 1e-4 * scale
    batch = {**tDP.SyntheticLM(tDP.DataConfig(
        seq_len=S, global_batch=B, vocab_size=cfg.vocab_size)).batch(0),
             **extra}
    card = tTL.loss_fn(params, cfg, batch)[0]
    cpu = tTL.loss_fn(_map(params, lambda t: t.cpu()), cfg, batch)[0]
    assert _rel(card.cpu(), cpu) <= 1e-4
