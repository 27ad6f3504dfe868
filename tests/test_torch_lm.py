"""The port's LM path (mamba2-780m, ssm family; internlm2-1.8b, dense
family; phi-3-vision-4.2b, vlm family, text only here: its patches are in
tests/test_torch_families.py) vs the reference: configs, tokenizer, weight conversion, the Mamba2
block, the full-sequence forward, token-by-token decode and the serving
engine.

Weights come from the reference's ``init_params`` and cross through
``convert.lm_params_from_numpy``; token ids are made with numpy from fixed
seeds. The reference runs compiled (``jax.jit``, as its own tests run it;
its SSD scan in Pallas interpret mode), the port on CPU tensors (the SSD
scan's plain version). Tolerances: float32 atol = rtol = 1e-4; bfloat16
those of ``tests/test_models_smoke.py::test_decode_matches_forward``
(atol 0.06, rtol 0.05) — the port keeps the reference's bf16 rounding
points, so the two differ by about one bf16 ulp per layer.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import tokenizer as ttok  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "mamba2-780m"
DENSE = "internlm2-1.8b"
VLM = "phi-3-vision-4.2b"
#: (arch, dtype) of the ``model`` fixture, and the ids its tests keep
MODELS = [(ARCH, "float32"), (ARCH, "bfloat16"), (DENSE, "float32"),
          (DENSE, "bfloat16"), (VLM, "float32"), (VLM, "bfloat16")]
MODEL_IDS = ["float32", "bfloat16", "dense-float32", "dense-bfloat16",
             "vlm-float32", "vlm-bfloat16"]
#: leaves of the reference trees: embed, final_norm, lm_head, norm1 and 6
#: ssm leaves; or norm1, norm2, 4 GQA and 3 MLP weights (and the vlm's
#: patch_proj)
LEAVES = {ARCH: 10, DENSE: 12, VLM: 13}
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.06, rtol=0.05)}
L_SEQ = 70          # two chunks of 32 and a ragged third at the smoke size


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.base as jbase
    import repro.configs.registry as jreg
    import repro.data.tokenizer as jtok
    import repro.models.ssm as jssm
    import repro.models.transformer as jT
    import repro.serve.engine as jeng
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, base=jbase,
                                 reg=jreg, tok=jtok, ssm=jssm, T=jT,
                                 eng=jeng)


_BUILT = {}


def _build(ref, arch, dtype):
    """Both packages' smoke model with the same weights and token ids, and
    the reference's forward logits (built once per module)."""
    if (arch, dtype) in _BUILT:
        return _BUILT[arch, dtype]
    jcfg = dataclasses.replace(ref.reg.get_config(arch + "-smoke"),
                               dtype=dtype)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"), dtype=dtype)
    jp = ref.T.init_params(ref.jax.random.PRNGKey(0), jcfg)
    tree = ref.jax.tree.map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, L_SEQ)).astype(np.int32)
    fwd = ref.jax.jit(lambda p, t: ref.T.forward(p, jcfg, t)[0])
    want = np.asarray(fwd(jp, ref.jnp.asarray(toks)), np.float32)
    _BUILT[arch, dtype] = types.SimpleNamespace(
        arch=arch, dtype=dtype, jcfg=jcfg, tcfg=tcfg, jp=jp, tree=tree,
        tp=tp, toks=toks, want=want)
    return _BUILT[arch, dtype]


@pytest.fixture(scope="module", params=MODELS, ids=MODEL_IDS)
def model(request, ref):
    """mamba2-780m's, internlm2-1.8b's and phi-3-vision-4.2b's smoke
    models in both dtypes."""
    return _build(ref, *request.param)


@pytest.fixture(scope="module", params=MODELS[:2], ids=MODEL_IDS[:2])
def ssm_model(request, ref):
    """mamba2-780m's smoke model in both dtypes."""
    return _build(ref, *request.param)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# ------------------------------------------------------------ configs, data

@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_configs_equal_the_reference(ref, arch):
    for suffix in ("", "-smoke"):
        t, j = treg.get_config(arch + suffix), ref.reg.get_config(arch + suffix)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_registry_and_shapes_equal_the_reference(ref):
    assert treg.ARCH_IDS == ref.reg.ARCH_IDS
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == \
        [dataclasses.asdict(s) for s in ref.base.SHAPES]
    assert set(tbase.SHAPES_BY_NAME) == set(ref.base.SHAPES_BY_NAME)
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


def test_tokenizer_equals_the_reference(ref):
    assert (ttok.PAD, ttok.BOS, ttok.EOS, ttok.VOCAB_SIZE) == \
        (ref.tok.PAD, ref.tok.BOS, ref.tok.EOS, ref.tok.VOCAB_SIZE)
    texts = ["", "hello", "temporal neural networks, é"]
    for text in texts:
        for bos in (True, False):
            np.testing.assert_array_equal(ttok.encode(text, bos),
                                          ref.tok.encode(text, bos))
        assert ttok.decode(ttok.encode(text)) == ref.tok.decode(
            ref.tok.encode(text))
    np.testing.assert_array_equal(ttok.batch_encode(texts, 8),
                                  ref.tok.batch_encode(texts, 8))


# ---------------------------------------------------------- weights, init

#: the moe family's configs: leaf counts of their reference trees
#: (embed, final_norm, lm_head; norm1, norm2; 5 MLA or 4 GQA weights;
#: router and 3 expert stacks; 3 shared-expert or dense-residual weights)
MOE_LEAVES = {"deepseek-v2-lite-16b": 17, "arctic-480b": 16}


def _round_trip(ref, jp, tp):
    """Every leaf of the reference tree ``jp`` arrives in ``tp`` exactly, in
    the dtype the reference keeps it in; returns the number of leaves."""
    leaves_j = ref.jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in leaves_j:
        node = tp
        for key in path:
            node = node[key.key]
        want_dtype = torch.bfloat16 if str(leaf.dtype) == "bfloat16" \
            else torch.float32
        assert node.dtype == want_dtype, path
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert len(dict(_flatten(tp))) == len(leaves_j)
    return len(leaves_j)


def _moe_configs(ref, dtype):
    for arch, n in MOE_LEAVES.items():
        yield (n, dataclasses.replace(ref.reg.get_config(arch + "-smoke"),
                                      dtype=dtype),
               dataclasses.replace(treg.get_config(arch + "-smoke"),
                                   dtype=dtype))


def test_lm_params_from_numpy_round_trips_every_leaf(ref, model):
    """Every leaf, bf16 ones included, arrives exactly, in the dtype the
    reference keeps it in: mamba2's and internlm2's trees, and the moe
    family's (the router and the norms stay float32)."""
    assert _round_trip(ref, model.jp, model.tp) == LEAVES[model.arch]
    if model.arch != ARCH:
        return
    for n, jcfg, tcfg in _moe_configs(ref, model.dtype):
        jp = ref.T.init_params(ref.jax.random.PRNGKey(1), jcfg)
        tp = convert.lm_params_from_numpy(ref.jax.tree.map(np.asarray, jp),
                                          tcfg, device="cpu")
        assert _round_trip(ref, jp, tp) == n
        assert tp["layers"]["moe"]["router"].dtype == torch.float32
        assert tp["layers"]["norm2"].dtype == torch.float32


def _same_layout(ref, jcfg, tcfg):
    tp = tT.init_params(torch.Generator().manual_seed(0), tcfg,
                        device="cpu")
    shapes = ref.jax.eval_shape(lambda k: ref.T.init_params(k, jcfg),
                                ref.jax.random.PRNGKey(0))
    flat_t = dict(_flatten(tp))
    flat_j = {tuple(k.key for k in path): leaf for path, leaf in
              ref.jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert set(flat_t) == set(flat_j)
    for k, leaf in flat_j.items():
        assert tuple(flat_t[k].shape) == leaf.shape, k
        assert str(flat_t[k].dtype).split(".")[-1] == str(leaf.dtype), k
    assert float(tp["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    return tp


def test_init_params_matches_reference_layout(ref, model):
    """Same tree, shapes and dtypes as the reference's ``init_params``
    (the draws differ: another generator), for mamba2 and the moe family;
    the stacked layers hold independent draws."""
    tp = _same_layout(ref, model.jcfg, model.tcfg)
    w = next(iter(tp["layers"]["ssm" if model.arch == ARCH
                               else "mlp"].values())).float()
    assert not torch.equal(w[0], w[1])
    if model.arch != ARCH:
        return
    for _, jcfg, tcfg in _moe_configs(ref, model.dtype):
        tp = _same_layout(ref, jcfg, tcfg)
        w = tp["layers"]["moe"]["w_up"].float()
        assert not torch.equal(w[0], w[1])
        assert float(w.std()) == pytest.approx(
            1 / np.sqrt(tcfg.d_model), rel=0.1)


def _map(tree, fn):
    """The parameter tree with ``fn`` applied to every leaf."""
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# --------------------------------------------------------------- the block

def _block_input(model, seed):
    x = np.random.default_rng(seed).standard_normal(
        (2, L_SEQ, model.tcfg.d_model)).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, model.dtype))
    return t, t.float().numpy()


def test_ssm_apply_full_sequence(ref, ssm_model):
    model = ssm_model
    jlp = ref.jax.tree.map(lambda a: a[1], model.jp["layers"])["ssm"]
    tlp = tT._layer(model.tp["layers"], 1)["ssm"]
    t, x = _block_input(model, 2)
    jx = ref.jnp.asarray(x).astype(model.jp["embed"].dtype)
    want, _ = ref.jax.jit(lambda p, h: ref.ssm.ssm_apply(p, h, model.jcfg))(
        jlp, jx)
    got, cache = tssm.ssm_apply(tlp, t, model.tcfg)
    assert cache is None and got.dtype == t.dtype
    _close(got, want, model.dtype)


def test_ssm_apply_one_token_cache(ref, ssm_model):
    """The decode branch, token by token from empty caches: outputs and
    both cache parts against the reference."""
    model = ssm_model
    jlp = ref.jax.tree.map(lambda a: a[0], model.jp["layers"])["ssm"]
    tlp = tT._layer(model.tp["layers"], 0)["ssm"]
    t, x = _block_input(model, 3)
    jdt = model.jp["embed"].dtype
    jx = ref.jnp.asarray(x).astype(jdt)
    jc = ref.ssm.ssm_cache_init(model.jcfg, 2, jdt)
    tc = tssm.ssm_cache_init(model.tcfg, 2, t.dtype, torch.device("cpu"))
    step = ref.jax.jit(lambda p, h, c: ref.ssm.ssm_apply(
        p, h, model.jcfg, cache=c))
    for i in range(12):
        want, jc = step(jlp, jx[:, i:i + 1], jc)
        got, tc = tssm.ssm_apply(tlp, t[:, i:i + 1], model.tcfg, cache=tc)
        _close(got, want, model.dtype)
    _close(tc.conv, jc.conv, model.dtype)
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state),
                               **TOL[model.dtype])
    with pytest.raises(ValueError):
        tssm.ssm_apply(tlp, t[:, :2], model.tcfg, cache=tc)


# ----------------------------------------------------- forward and decode

def test_forward_all_and_last(ref, model):
    got, aux = tT.forward(model.tp, model.tcfg, torch.from_numpy(model.toks))
    assert tuple(got.shape) == (2, L_SEQ, model.tcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, model.want, model.dtype)
    last, _ = tT.forward(model.tp, model.tcfg, model.toks,
                         logits_mode="last")
    want_last = ref.jax.jit(lambda p, t: ref.T.forward(
        p, model.jcfg, t, logits_mode="last")[0])(
            model.jp, ref.jnp.asarray(model.toks))
    assert tuple(last.shape) == (2, 1, model.tcfg.vocab_size)
    _close(last, want_last, model.dtype)
    with pytest.raises(ValueError):
        tT.forward(model.tp, model.tcfg, model.toks, logits_mode="first")


def test_float32_forward_matches_its_float64_form():
    """The port's float32 forward on the CPU against the same forward in
    float64 (the model's f32 steps widen with it; the SSD scan's plain
    version computes in float64): three runs in one process, the first
    counting like the others, each within 1e-4 of the logits' scale and
    all three identical."""
    cfg = dataclasses.replace(treg.get_config(ARCH + "-smoke"),
                              dtype="float32")
    params = tT.init_params(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    p64 = _map(params, torch.Tensor.double)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, L_SEQ))
    want, _ = tT.forward(p64, cfg, toks)
    assert want.dtype == torch.float64
    runs = [tT.forward(params, cfg, toks)[0] for _ in range(3)]
    scale = float(want.abs().max())
    for got in runs:
        assert got.dtype == torch.float32
        assert float((got.double() - want).abs().max()) <= 1e-4 * scale
        assert torch.equal(got, runs[0])


def test_decode_step_matches_reference_and_forward(ref, model):
    """Token by token against the reference's ``decode_step`` and against
    the port's own forward (the chunked scan vs the recurrence)."""
    jstate = ref.T.init_serve_state(model.jp, model.jcfg, 2, 128)
    jstep = ref.jax.jit(lambda p, s, t: ref.T.decode_step(
        p, model.jcfg, s, t))
    state = tT.init_serve_state(model.tp, model.tcfg, 2, 128)
    fwd, _ = tT.forward(model.tp, model.tcfg, model.toks)
    for i in range(L_SEQ):
        want, jstate = jstep(model.jp, jstate,
                             ref.jnp.asarray(model.toks[:, i:i + 1]))
        got, state = tT.decode_step(model.tp, model.tcfg, state,
                                    model.toks[:, i:i + 1])
        _close(got, want, model.dtype)
        _close(got, fwd[:, i], model.dtype)
    assert int(state.pos) == L_SEQ
    for got, want in zip(state.layer_caches, jstate.layer_caches):
        assert tuple(got.shape) == tuple(want.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["glm4-9b", "llama3.2-3b", "stablelm-3b"])
def test_other_dense_configs_match_reference(ref, arch, dtype):
    """The rest of the dense family at the smoke size: the forward and 12
    decode steps against the reference's (internlm2 is the ``model``
    fixture's)."""
    m = _build(ref, arch, dtype)
    got, aux = tT.forward(m.tp, m.tcfg, m.toks)
    assert float(aux) == 0.0
    _close(got, m.want, dtype)
    jstate = ref.T.init_serve_state(m.jp, m.jcfg, 2, 16)
    jstep = ref.jax.jit(lambda p, s, t: ref.T.decode_step(p, m.jcfg, s, t))
    state = tT.init_serve_state(m.tp, m.tcfg, 2, 16)
    for i in range(12):
        want, jstate = jstep(m.jp, jstate, ref.jnp.asarray(m.toks[:, i:i + 1]))
        logits, state = tT.decode_step(m.tp, m.tcfg, state, m.toks[:, i:i + 1])
        _close(logits, want, dtype)


# ------------------------------------------------------------------ engine

def _prompts(vocab, lengths=(5, 9, 1, 13), seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


def test_engine_greedy_matches_reference(ref, model):
    if model.dtype != "float32":
        pytest.skip("greedy token identity is held in float32")
    prompts = _prompts(model.tcfg.vocab_size)
    jeng = ref.eng.Engine(model.jp, model.jcfg,
                          ref.eng.ServeConfig(max_len=64))
    want = jeng.generate(prompts, max_new_tokens=10)
    eng = Engine(model.tp, model.tcfg, ServeConfig(max_len=64),
                 device="cpu")
    got = eng.generate(prompts, max_new_tokens=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.n_steps == jeng.n_steps


def test_engine_temperature_is_deterministic_and_valid(model):
    if model.dtype != "float32":
        pytest.skip("sampling plumbing does not depend on the dtype")
    prompts = _prompts(model.tcfg.vocab_size)

    def run(seed):
        eng = Engine(model.tp, model.tcfg,
                     ServeConfig(temperature=0.8, seed=seed), device="cpu")
        return eng.generate(prompts, max_new_tokens=8)

    a, b, other = run(3), run(3), run(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert all(len(x) == 8 and x.min() >= 0
               and x.max() < model.tcfg.vocab_size for x in a)
    assert any(not np.array_equal(x, y) for x, y in zip(a, other))


def test_engine_refusals(ssm_model):
    model = ssm_model
    eng = Engine(model.tp, model.tcfg, ServeConfig(), device="cpu")
    with pytest.raises(ValueError):         # ssm caches are served statically
        eng.serve(_prompts(model.tcfg.vocab_size))
    with pytest.raises(ValueError):
        eng.generate([np.zeros((0,), np.int32)])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    cfg = treg.get_config(ARCH + "-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        tT.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine({}, cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params_from_numpy({}, cfg)
    # the training entry points
    from repro_torch.launch import train as tlaunch
    from repro_torch.train import train_loop as tTL
    dense = treg.get_config(DENSE + "-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        tT.init_params(torch.Generator(), dense)
    with pytest.raises(RuntimeError, match="CUDA"):
        tTL.init_train_state(torch.Generator(), dense, tTL.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.train_state_from_numpy(types.SimpleNamespace(), dense)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--arch", DENSE, "--smoke", "--steps", "1"])


@pytest.mark.cuda
def test_cuda_forward_matches_plain_and_decode(monkeypatch):
    """The smoke model on the card in float32: the forward with the SSD
    kernel (one launch per layer) against the same forward with the
    kernel's plain version, against the card's own decode (the
    recurrence), and against the CPU's forward in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from repro_torch.kernels import ssd_scan as tss
    cfg = dataclasses.replace(treg.get_config(ARCH + "-smoke"),
                              dtype="float32")
    params = tT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cuda")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, L_SEQ))
    tss.reset_launches()
    got, _ = tT.forward(params, cfg, toks)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["ssd_scan"] == cfg.n_layers
    with monkeypatch.context() as m:
        m.setattr(tss, "_ssd_scan", tss._ssd_scan_plain)
        want, _ = tT.forward(params, cfg, toks)
    assert tss.LAUNCHES["ssd_scan"] == cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    host, _ = tT.forward(_map(params, lambda t: t.cpu().double()), cfg, toks)
    assert host.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().double().numpy(), host.numpy(),
                               atol=1e-4, rtol=1e-4)
    state = tT.init_serve_state(params, cfg, 2, 128)
    for i in range(L_SEQ):
        lg, state = tT.decode_step(params, cfg, state, toks[:, i:i + 1])
        np.testing.assert_allclose(lg.cpu().numpy(), got[:, i].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
