"""The port's moe family vs the reference: RoPE and the gated MLP, GQA and
MLA attention (full sequence, a scalar-position cache, per-slot caches
with a write past the end), the MoE layer (catwalk dispatch with and
without capacity drops, dense dispatch, the aux loss), the forward and
token-by-token decode of deepseek-v2-lite-16b-smoke (MLA, shared experts)
and arctic-480b-smoke (GQA, dense residual), per-slot serve states and the
continuous-batching engine.

Weights come from the reference's ``init_params`` and cross through
``convert.lm_params_from_numpy``; inputs and token ids are made with numpy
from fixed seeds. The reference runs compiled (``jax.jit``, as its own
tests run it), the port on CPU tensors (the router gate's plain version).
Tolerances: float32 atol = rtol = 1e-4; bfloat16 atol 0.06, rtol 0.05
(``tests/test_models_smoke.py::test_decode_matches_forward``). The port
keeps the reference's compiled bf16 rounding points;
``test_bf16_rounding_points`` shows each one.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "arctic-480b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.06, rtol=0.05)}
L_SEQ = 24


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.registry as jreg
    import repro.models.attention as jA
    import repro.models.layers as jL
    import repro.models.moe as jM
    import repro.models.transformer as jT
    import repro.serve.engine as jeng
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, reg=jreg, A=jA,
                                 L=jL, M=jM, T=jT, eng=jeng)


_MODELS = {}


def _model(ref, arch, dtype):
    """Both packages' smoke model with the same weights and token ids, and
    the reference's forward logits (made once per arch and dtype)."""
    if (arch, dtype) not in _MODELS:
        _MODELS[arch, dtype] = _make_model(ref, arch, dtype)
    return _MODELS[arch, dtype]


def _make_model(ref, arch, dtype):
    jcfg = dataclasses.replace(ref.reg.get_config(arch + "-smoke"),
                               dtype=dtype)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"), dtype=dtype)
    jp = ref.T.init_params(ref.jax.random.PRNGKey(0), jcfg)
    tree = ref.jax.tree.map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, L_SEQ)).astype(np.int32)
    want, aux = ref.jax.jit(lambda p, t: ref.T.forward(p, jcfg, t))(
        jp, ref.jnp.asarray(toks))
    return types.SimpleNamespace(
        arch=arch, dtype=dtype, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
        toks=toks, want=np.asarray(want, np.float32), aux=float(aux),
        jdt=jp["embed"].dtype)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request, ref):
    return _model(ref, *request.param)


@pytest.fixture(scope="module", params=ARCHS)
def model32(request, ref):
    return _model(ref, request.param, "float32")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _input(model, shape, seed):
    """Random normal values in the model dtype (the reference gets the same
    values through :func:`_jx`)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(getattr(torch, model.dtype))


def _jx(ref, model, t):
    return ref.jnp.asarray(t.float().numpy()).astype(model.jdt)


def _layer(ref, model, i):
    return (ref.jax.tree.map(lambda a: a[i], model.jp["layers"]),
            tT._layer(model.tp["layers"], i))


def _attn_ref(ref, model):
    return ref.A.mla_apply if model.jcfg.mla is not None \
        else ref.A.gqa_apply


def _attn_port(model):
    return tA.mla_apply if model.tcfg.mla is not None else tA.gqa_apply


def _cache_init(ref, model, batch, max_len):
    if model.jcfg.mla is not None:
        return (ref.A.mla_cache_init(model.jcfg, batch, max_len, model.jdt),
                tA.mla_cache_init(model.tcfg, batch, max_len,
                                  getattr(torch, model.dtype),
                                  torch.device("cpu")))
    return (ref.A.gqa_cache_init(model.jcfg, batch, max_len, model.jdt),
            tA.gqa_cache_init(model.tcfg, batch, max_len,
                              getattr(torch, model.dtype),
                              torch.device("cpu")))


def _close_cache(got, want, dtype):
    _close(got.k, want.k, dtype)
    _close(got.v, want.v, dtype)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))


# ---------------------------------------------------------- layers ------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_reference(ref, dtype, per_row):
    """Interleaved pairs, float32 angles: equal to the reference bit for
    bit (rounding point: one cast of the f32 rotation to x's dtype)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 10, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 500, (3, 10)) if per_row
           else np.arange(7, 17)[None]).astype(np.int32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = ref.jnp.asarray(x).astype(ref.jnp.bfloat16 if dtype == "bfloat16"
                                   else ref.jnp.float32)
    want = ref.jax.jit(lambda h, p: ref.L.apply_rope(h, p, 1e4))(
        jx, ref.jnp.asarray(pos))
    got = tL.apply_rope(t, torch.from_numpy(pos), 1e4)
    assert got.dtype == t.dtype
    np.testing.assert_array_equal(tL.rope_freqs(16, 1e4),
                                  ref.L.rope_freqs(16, 1e4))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=0)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))


def test_mlp_apply_matches_reference(ref, model):
    """SwiGLU, the shared experts (deepseek) or the dense residual branch
    (arctic)."""
    jl, tl = _layer(ref, model, 0)
    jp, tp = ((jl["mlp"], tl["mlp"]) if "mlp" in tl
              else (jl["moe"]["shared"], tl["moe"]["shared"]))
    t = _input(model, (2, 9, model.tcfg.d_model), 3)
    want = ref.jax.jit(ref.L.mlp_apply)(jp, _jx(ref, model, t))
    got = tL.mlp_apply(tp, t)
    assert got.dtype == t.dtype
    _close(got, want, model.dtype)


# -------------------------------------------------------- attention -----

def test_attention_full_sequence(ref, model):
    """GQA (arctic) or MLA (deepseek), causal, over the whole sequence;
    GQA cross-attention too."""
    jl, tl = _layer(ref, model, 1)
    t = _input(model, (2, 13, model.tcfg.d_model), 4)
    fn = _attn_ref(ref, model)
    want, _ = ref.jax.jit(lambda p, h: fn(p, h, model.jcfg))(
        jl["attn"], _jx(ref, model, t))
    got, cache = _attn_port(model)(tl["attn"], t, model.tcfg)
    assert cache is None and got.dtype == t.dtype
    _close(got, want, model.dtype)
    if model.jcfg.mla is None:
        # GQA cross-attention over another sequence (no rope, no mask)
        src = _input(model, (2, 7, model.tcfg.d_model), 21)
        want, _ = ref.jax.jit(lambda p, h, e: ref.A.gqa_apply(
            p, h, model.jcfg, kv_input=e, causal=False))(
                jl["attn"], _jx(ref, model, t), _jx(ref, model, src))
        got, _ = tA.gqa_apply(tl["attn"], t, model.tcfg, kv_input=src,
                              causal=False)
        _close(got, want, model.dtype)


def test_attention_scalar_position_cache(ref, model):
    """A 3-token chunk then token by token through a cache with one shared
    position: outputs and every cache part against the reference."""
    jl, tl = _layer(ref, model, 0)
    t = _input(model, (2, 9, model.tcfg.d_model), 5)
    jx = _jx(ref, model, t)
    jc, tc = _cache_init(ref, model, 2, 16)
    fn = _attn_ref(ref, model)
    step = ref.jax.jit(lambda p, h, c: fn(p, h, model.jcfg, cache=c))
    for lo, hi in [(0, 3)] + [(i, i + 1) for i in range(3, 9)]:
        want, jc = step(jl["attn"], jx[:, lo:hi], jc)
        got, tc = _attn_port(model)(tl["attn"], t[:, lo:hi], model.tcfg,
                                    cache=tc)
        _close(got, want, model.dtype)
    assert tc.pos.dim() == 0 and int(tc.pos) == 9
    _close_cache(tc, jc, model.dtype)


def test_attention_per_slot_cache(ref, model):
    """Per-slot positions (0, 5, 7) in a cache of 8: row 2's second write
    lands past the end and is dropped, as in the reference."""
    jl, tl = _layer(ref, model, 1)
    t = _input(model, (3, 3, model.tcfg.d_model), 6)
    jx = _jx(ref, model, t)
    jc, tc = _cache_init(ref, model, 3, 8)
    fill = _input(model, tuple(tc.k.shape), 7)
    fill_v = _input(model, tuple(tc.v.shape), 8)
    pos = np.array([0, 5, 7], np.int32)
    jc = jc._replace(k=_jx(ref, model, fill), v=_jx(ref, model, fill_v),
                     pos=ref.jnp.asarray(pos))
    tc = tc._replace(k=fill.clone(), v=fill_v.clone(),
                     pos=torch.from_numpy(pos))
    fn = _attn_ref(ref, model)
    step = ref.jax.jit(lambda p, h, c: fn(p, h, model.jcfg, cache=c))
    for lo, hi in [(0, 2), (2, 3)]:
        want, jc = step(jl["attn"], jx[:, lo:hi], jc)
        before = tc.k.clone()
        got, tc2 = _attn_port(model)(tl["attn"], t[:, lo:hi], model.tcfg,
                                     cache=tc)
        _close(got, want, model.dtype)
        _close_cache(tc2, jc, model.dtype)
        assert torch.equal(tc.k, before)        # the old cache is kept
        tc = tc2
    assert tc.pos.tolist() == [3, 8, 10]
    # row 2 kept its first write at 7 and nothing else moved
    assert torch.equal(tc.k[2, :7], fill[2, :7])


def test_cache_update_drops_and_clamps():
    buf = torch.zeros((2, 4, 1))
    new = torch.ones((2, 2, 1))
    per_slot = tA._cache_update(buf, new, torch.tensor([1, 3]))
    assert per_slot[:, :, 0].tolist() == [[0, 1, 1, 0], [0, 0, 0, 1]]
    scalar = tA._cache_update(buf, new, torch.tensor(3))   # start clamped
    assert scalar[:, :, 0].tolist() == [[0, 0, 1, 1], [0, 0, 1, 1]]
    assert float(buf.sum()) == 0.0


# -------------------------------------------------------------- moe -----

MOE_CASES = {
    # smoke capacity_factor 8: no assignment can drop
    "catwalk": dict(),
    # capacity_factor 1 at T = 64: cap 32 of 128 assignments over 4
    # experts, so the busiest expert drops some
    "catwalk_drops": dict(capacity_factor=1.0),
    "dense": dict(dispatch="dense"),
    # without a mesh the reference's expert-parallel dispatch is catwalk
    "catwalk_ep": dict(dispatch="catwalk_ep"),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(ref, model, case):
    """The MoE layer and its aux loss, each dispatch."""
    jcfg = dataclasses.replace(model.jcfg.moe, **MOE_CASES[case])
    tcfg = dataclasses.replace(model.tcfg.moe, **MOE_CASES[case])
    jl, tl = _layer(ref, model, 1)
    t = _input(model, (2, 32, model.tcfg.d_model), 9)
    jx = _jx(ref, model, t)
    apply = ref.M.moe_apply_ep if case == "catwalk_ep" else ref.M.moe_apply
    want, wst = ref.jax.jit(lambda p, h: apply(p, h, jcfg))(jl["moe"], jx)
    got, st = tM.moe_apply(tl["moe"], t, tcfg)
    assert got.dtype == t.dtype
    _close(got, want, model.dtype)
    np.testing.assert_allclose(float(st["aux_loss"]),
                               float(wst["aux_loss"]), rtol=1e-5)
    if case == "catwalk_drops":
        logits = t.float().reshape(64, -1) @ tl["moe"]["router"]
        _, idx = tM.ops.moe_gate_topk(logits, tcfg.top_k)
        load = np.bincount(idx.numpy().ravel(), minlength=tcfg.n_experts)
        assert load.max() > tM._capacity(64, tcfg)       # something drops


def test_aux_loss_matches_reference(ref):
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((50, 8)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(logits), -1)
    idx = rng.integers(0, 8, (50, 3)).astype(np.int32)
    want = ref.M._aux_loss(ref.jnp.asarray(probs.numpy()),
                           ref.jnp.asarray(idx), 8)
    got = tM._aux_loss(probs, torch.from_numpy(idx), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _bf16(shape, seed, scale=1.0):
    x = scale * np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _rounding_point(ref, point):
    """(reference output, port output, the port with this rounding point
    moved) on the same bf16 inputs, all as float32 numpy arrays."""
    jnp = ref.jnp
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    if point == "gate_probs_and_combine":
        # moe.py:82 probs.astype(x.dtype) and :126 the combine
        c, p32 = _bf16((40, 6, 64), 12), torch.softmax(
            _bf16((40, 6), 13, 3.0).float(), -1)
        want = ref.jax.jit(lambda c, p: jnp.sum(
            c * p.astype(jnp.bfloat16)[..., None], axis=1))(
                j(c), jnp.asarray(p32.numpy()))
        got = tM._combine(c, p32.to(torch.bfloat16))
        moved = torch.sum(c * p32.to(torch.bfloat16)[..., None], dim=1)
    elif point == "swiglu_product":
        # layers.py mlp_apply and moe.py:59: g * u rounded before w_down
        x, wg, wu, wd = (_bf16((30, 64), 14), _bf16((64, 96), 15, 0.125),
                         _bf16((64, 96), 16, 0.125), _bf16((96, 64), 17, 0.1))
        p = {"w_gate": wg, "w_up": wu, "w_down": wd}
        want = ref.jax.jit(ref.L.mlp_apply)(
            {k: j(v) for k, v in p.items()}, j(x))
        got = tL.mlp_apply(p, x)
        g = tL.silu(x @ wg)
        moved = ((g.float() * (x @ wu).float()) @ wd.float()).to(x.dtype)
    elif point == "residual_into_norm":
        # transformer.py:_block_apply: x + a reaches norm2 unrounded
        x, a = _bf16((30, 64), 18), _bf16((30, 64), 19)
        scale = torch.from_numpy(np.random.default_rng(20).uniform(
            0.5, 1.5, 64).astype(np.float32))
        want = ref.jax.jit(lambda x, a, s: ref.L.rmsnorm(s, x + a))(
            j(x), j(a), jnp.asarray(scale.numpy()))
        got = tL.rmsnorm(scale, tL._f32(x) + tL._f32(a)).to(x.dtype)
        moved = tL.rmsnorm(scale, x + a)
    return _np(want), _np(got), _np(moved)


@pytest.mark.parametrize("point", ["gate_probs_and_combine",
                                   "swiglu_product", "residual_into_norm"])
def test_bf16_rounding_points(ref, point):
    """Each place where the reference's compiled bf16 code rounds, or
    does not: the port agrees with it on (almost) every element; moving
    the rounding point breaks that agreement."""
    want, got, moved = _rounding_point(ref, point)
    same = np.mean(got == want)
    same_moved = np.mean(moved == want)
    assert same >= 0.99, same
    assert same_moved < 0.95 * same, (same, same_moved)


# ------------------------------------------------- forward and decode ---

def test_forward_all_and_last(ref, model):
    got, aux = tT.forward(model.tp, model.tcfg, torch.from_numpy(model.toks))
    assert tuple(got.shape) == (2, L_SEQ, model.tcfg.vocab_size)
    _close(got, model.want, model.dtype)
    np.testing.assert_allclose(float(aux), model.aux, rtol=1e-4)
    last, aux_last = tT.forward(model.tp, model.tcfg, model.toks,
                                logits_mode="last")
    want_last = ref.jax.jit(lambda p, t: ref.T.forward(
        p, model.jcfg, t, logits_mode="last")[0])(
            model.jp, ref.jnp.asarray(model.toks))
    assert tuple(last.shape) == (2, 1, model.tcfg.vocab_size)
    _close(last, want_last, model.dtype)
    assert float(aux_last) == float(aux)


def test_decode_step_matches_reference_and_forward(ref, model):
    """Token by token against the reference's ``decode_step`` and against
    the port's own forward (drop-free at the smoke capacity factor)."""
    jstate = ref.T.init_serve_state(model.jp, model.jcfg, 2, 32)
    jstep = ref.jax.jit(lambda p, s, t: ref.T.decode_step(
        p, model.jcfg, s, t))
    state = tT.init_serve_state(model.tp, model.tcfg, 2, 32)
    fwd, _ = tT.forward(model.tp, model.tcfg, model.toks)
    for i in range(L_SEQ):
        want, jstate = jstep(model.jp, jstate,
                             ref.jnp.asarray(model.toks[:, i:i + 1]))
        got, state = tT.decode_step(model.tp, model.tcfg, state,
                                    model.toks[:, i:i + 1])
        _close(got, want, model.dtype)
        _close(got, fwd[:, i], model.dtype)
    assert int(state.pos) == L_SEQ
    assert state.layer_caches.pos.tolist() == [L_SEQ] * model.tcfg.n_layers
    _close_cache(state.layer_caches, jstate.layer_caches, model.dtype)


def test_per_slot_state_and_reset_slots(ref, model):
    """Per-slot decode with an admission reset midway: logits, positions
    and caches against the reference's per-slot state."""
    b = 3
    jstate = ref.T.per_slot_state(
        ref.T.init_serve_state(model.jp, model.jcfg, b, 16), b)
    state = tT.per_slot_state(tT.init_serve_state(model.tp, model.tcfg, b,
                                                  16), b)
    assert tuple(state.pos.shape) == (b,)
    assert tuple(state.layer_caches.pos.shape) == (model.tcfg.n_layers, b)
    jstep = ref.jax.jit(lambda p, s, t: ref.T.decode_step(
        p, model.jcfg, s, t))
    toks = np.random.default_rng(11).integers(
        0, model.tcfg.vocab_size, (b, 10)).astype(np.int32)
    for i in range(10):
        if i == 4:
            free = np.array([False, True, False])
            jstate = ref.T.reset_slots(jstate, ref.jnp.asarray(free))
            state = tT.reset_slots(state, free)
            assert state.pos.tolist() == [4, 0, 4]
        want, jstate = jstep(model.jp, jstate,
                             ref.jnp.asarray(toks[:, i:i + 1]))
        got, state = tT.decode_step(model.tp, model.tcfg, state,
                                    toks[:, i:i + 1])
        _close(got, want, model.dtype)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    _close_cache(state.layer_caches, jstate.layer_caches, model.dtype)


def test_serve_state_refusals(model):
    state = tT.init_serve_state(model.tp, model.tcfg, 2, 8)
    with pytest.raises(ValueError):            # scalar positions
        tT.reset_slots(state, np.array([True, False]))
    ssm = treg.get_config("mamba2-780m-smoke")
    sp = tT.init_params(torch.Generator().manual_seed(0), ssm, device="cpu")
    with pytest.raises(ValueError):            # not a KV cache
        tT.per_slot_state(tT.init_serve_state(sp, ssm, 2, 8), 2)


# ------------------------------------------------------------ engine ----

def _prompts(vocab, lengths=(2, 7, 3, 9, 4), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, (n,)).astype(np.int32) for n in lengths]


def test_engine_serve_matches_reference(ref, model32):
    """Continuous, wave and per-request serving and ``generate``: greedy
    tokens equal to the JAX ``Engine``'s, continuous tokens equal to the
    per-request ones, and no more steps than the wave baseline."""
    m = model32
    prompts = _prompts(m.tcfg.vocab_size)
    jeng = ref.eng.Engine(m.jp, m.jcfg, ref.eng.ServeConfig(max_len=48))
    eng = Engine(m.tp, m.tcfg, ServeConfig(max_len=48), device="cpu")
    runs = {}
    for name, kw in [("continuous", dict(n_slots=2, continuous=True)),
                     ("wave", dict(n_slots=2, continuous=False))]:
        want = jeng.serve(prompts, max_new_tokens=6, **kw)
        got = eng.serve(prompts, max_new_tokens=6, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert eng.n_steps == jeng.n_steps, name
        runs[name] = (got, eng.n_steps)
    per_req = [eng.serve([p], max_new_tokens=6)[0] for p in prompts]
    want_req = [jeng.serve([p], max_new_tokens=6)[0] for p in prompts]
    for c, w, r, jr in zip(runs["continuous"][0], runs["wave"][0], per_req,
                           want_req):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(c, r)
        np.testing.assert_array_equal(w, r)
    assert runs["continuous"][1] <= runs["wave"][1]
    gen = eng.generate(prompts[:3], max_new_tokens=5)
    want_gen = jeng.generate(prompts[:3], max_new_tokens=5)
    for g, w in zip(gen, want_gen):
        np.testing.assert_array_equal(g, w)
    assert eng.n_steps == jeng.n_steps


def test_engine_serve_budget_and_temperature(ref, model32):
    """Requests retire when they have been fed ``max_len`` tokens (a 9-token
    prompt with max_len 10 gets 2 new tokens, a 3-token one 8 of its 8),
    as in the reference; a seeded temperature run is deterministic and in
    range."""
    m = model32
    prompts = _prompts(m.tcfg.vocab_size, (9, 3))
    eng = Engine(m.tp, m.tcfg, ServeConfig(max_len=10), device="cpu")
    out = eng.serve(prompts, max_new_tokens=8, n_slots=1)
    want = ref.eng.Engine(m.jp, m.jcfg, ref.eng.ServeConfig(
        max_len=10)).serve(prompts, max_new_tokens=8, n_slots=1)
    assert [len(o) for o in out] == [2, 8]
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w)

    def run(seed):
        e = Engine(m.tp, m.tcfg, ServeConfig(temperature=0.8, seed=seed),
                   device="cpu")
        return e.serve(_prompts(m.tcfg.vocab_size), max_new_tokens=5,
                       n_slots=2)

    a, b = run(3), run(3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert all(len(x) == 5 and x.min() >= 0
               and x.max() < m.tcfg.vocab_size for x in a)


def test_engine_serve_refusals(model32):
    eng = Engine(model32.tp, model32.tcfg, ServeConfig(), device="cpu")
    with pytest.raises(ValueError):
        eng.serve(_prompts(model32.tcfg.vocab_size), n_slots=0)
    with pytest.raises(ValueError):
        eng.serve([np.zeros((0,), np.int32)])
    with pytest.raises(ValueError):
        eng.generate([np.array([1, 2], np.int32), np.zeros((0,), np.int32)])


@pytest.mark.cuda
def test_cuda_forward_matches_plain_gate_and_decode(monkeypatch):
    """deepseek-v2-lite-16b-smoke on the card in float32: the forward
    launches the gate kernel once per layer and equals the same forward
    with the gate's plain version; each decode step launches it once per
    layer and matches the forward (drop-free at the smoke capacity)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from repro_torch.kernels import moe_gate as tmg
    cfg = dataclasses.replace(treg.get_config(ARCHS[0] + "-smoke"),
                              dtype="float32")
    params = tT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cuda")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, L_SEQ))
    tmg.reset_launches()
    got, _ = tT.forward(params, cfg, toks)
    torch.cuda.synchronize()
    assert tmg.LAUNCHES["moe_gate_topk"] == cfg.n_layers
    with monkeypatch.context() as m:
        m.setattr(tmg, "_moe_gate", lambda x, k, r:
                  tmg.moe_gate_topk_plain(x, k, r))
        want, _ = tT.forward(params, cfg, toks)
    assert tmg.LAUNCHES["moe_gate_topk"] == cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    state = tT.init_serve_state(params, cfg, 2, 32)
    for i in range(L_SEQ):
        lg, state = tT.decode_step(params, cfg, state, toks[:, i:i + 1])
        np.testing.assert_allclose(lg.cpu().numpy(), got[:, i].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
    assert tmg.LAUNCHES["moe_gate_topk"] == cfg.n_layers * (1 + L_SEQ)
