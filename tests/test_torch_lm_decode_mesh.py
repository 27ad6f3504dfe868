"""The port's LM decode step on a mesh, ``decode_step(..., mesh=)`` with
``init_serve_state(..., mesh=)``, on four CPU ranks joined by gloo
(``tests/_torch_dist.py`` spawns them; the rank body is
``tests/_torch_lm_dist.py:decode_suite``), on ``("data", "model")`` meshes
of ``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` ranks, and zamba2 and the two
plain MoE families on ``("pod", "data", "model")`` meshes of ``(2, 1,
2)`` and ``(2, 2, 1)`` over the same ranks (zamba2's two site caches
rest split over ``pod``: a site's is gathered only when its block runs),
against the reference's single-device ``decode_step``. Float32, smoke
sizes, 4 rows.

The reference prefills its serve state with :data:`PREFILL` tokens and
decodes :data:`STEPS` more; each rank takes its blocks of the weights
(``transformer.serve_pspecs``) and of the prefilled state
(``specs.serve_shardings``: the shapes ``init_serve_state(mesh=)`` makes)
and decodes the same tokens. Every step's logits, whole on every rank,
are within 1e-5 of their largest |value| of the reference's; every rank's
block of every state leaf after the steps is within 1e-5 of the leaf's
largest |value| of its block of the reference's state; audio's encoder
output from ``init_serve_state(mesh=)`` is the rank's rows of the
reference's, to the same tolerance.

Cases: every family (dense, vlm, audio with frames, moe with MLA and
arctic's GQA with a dense residual, ssm, hybrid with one KV cache per
shared site); internlm2's 4 query heads in 2 KV groups, whose KV heads do
not divide a ``model`` axis of 4 (every head cached on every rank, each
rank's queries reading its group); 6 heads in KV groups of 2, which do
not split over 4 ranks (the layer whole on every rank); deepseek and
mamba2 under ``--opt`` (the expert-parallel MoE layer; ``batch_over_model``
does not apply to a decode step). The expert-parallel layer computes its
capacity from each rank's tokens, as the reference's ``shard_map`` body
does, so the ``--opt`` MoE case runs at the smoke size's drop-free
capacity factor.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
import _torch_lm_dist as LD  # noqa: E402
import test_torch_train as TT  # noqa: E402

MESHES = [(1, 4), (2, 2), (4, 1)]
#: ``("pod", "data", "model")`` meshes over the same four ranks, and the
#: cases decoded there: zamba2's site caches rest split over ``pod``
#: (each pod holds one of the two sites), the plain MoE layers' experts
#: over ``model``
POD_MESHES = [(2, 1, 2), (2, 2, 1)]
POD_CASES = ("hybrid", "moe", "arctic")
B, PREFILL, STEPS, MAX_LEN = 4, 3, 4, 12
TOL = 1e-5

CASES = {
    "dense": dict(arch="internlm2-1.8b"),
    "dense_h6": dict(arch="internlm2-1.8b",
                     edit=dict(n_heads=6, n_kv_heads=3)),
    "vlm": dict(arch="phi-3-vision-4.2b"),
    "audio": dict(arch="seamless-m4t-medium"),
    "moe": dict(arch="deepseek-v2-lite-16b"),
    "moe_opt": dict(arch="deepseek-v2-lite-16b", opt=True, capacity=8.0),
    "arctic": dict(arch="arctic-480b"),
    "ssm": dict(arch="mamba2-780m"),
    "ssm_opt": dict(arch="mamba2-780m", opt=True),
    "hybrid": dict(arch="zamba2-1.2b"),
}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.registry as jreg
    import repro.models.transformer as jT
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, reg=jreg, T=jT)


def _flat(ref, tree):
    """A reference serve state as numpy arrays by leaf key
    (``"layer_caches/k"``)."""
    out = {}
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "name", getattr(k, "key", k)))
                       for k in path)
        out[key] = np.asarray(leaf)
    return out


def _case(ref, i, c):
    """The reference's run of case ``c``: weights, prefilled state, the
    tokens and logits of each step and the final state."""
    cfg = LD._decode_cfg(c)
    jcfg = dataclasses.replace(ref.reg.get_config(c["arch"] + "-smoke"),
                               dtype="float32", **c.get("edit", {}))
    jcfg = TT._reference_opt(jcfg, cfg)
    params = ref.T.init_params(ref.jax.random.PRNGKey(i), jcfg)
    rng = np.random.default_rng(300 + i)
    toks = rng.integers(0, jcfg.vocab_size, (B, PREFILL + STEPS)).astype(
        np.int32)
    kw, out = {}, {}
    if jcfg.family == "audio":
        frames = rng.standard_normal(
            (B, jcfg.encdec.encoder_seq, jcfg.frontend.d_embed)).astype(
            np.float32)
        kw["frames"] = ref.jnp.asarray(frames)
        out["frames"] = frames
    state = ref.T.init_serve_state(params, jcfg, B, MAX_LEN, **kw)
    step = ref.jax.jit(lambda p, s, t: ref.T.decode_step(p, jcfg, s, t))
    for t in range(PREFILL):
        _, state = step(params, state, toks[:, t:t + 1])
    if jcfg.family == "audio":
        out["enc_out"] = np.asarray(state.enc_out)
    out.update(c, p=ref.jax.tree.map(np.asarray, params),
               state=_flat(ref, state), tokens=toks[:, PREFILL:],
               max_len=MAX_LEN)
    logits = []
    for t in range(PREFILL, PREFILL + STEPS):
        lg, state = step(params, state, toks[:, t:t + 1])
        logits.append(np.asarray(lg))
    out["final"] = _flat(ref, state)
    return out, logits


@pytest.fixture(scope="module")
def cases(ref):
    made = {name: _case(ref, i, c) for i, (name, c) in enumerate(
        CASES.items())}
    return ({k: v[0] for k, v in made.items()},
            {k: v[1] for k, v in made.items()})


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            args = (cases[0],) if len(shape) == 2 else (
                {k: cases[0][k] for k in POD_CASES}, shape)
            cache[shape] = TD.run(
                "_torch_lm_dist:decode_suite", shape if len(shape) == 2
                else (2, 2), args=args,
                tmp_dir=tmp_path_factory.mktemp("lm_decode"), kind="lm")
        return cache[shape]
    return get


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_decode_matches_the_reference(ranks, cases, shape, name):
    _check_logits(ranks, cases, shape, name)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_decode_state_blocks_match_the_reference(ranks, cases, shape,
                                                      name):
    _check_state(ranks, cases, shape, name)


@pytest.mark.parametrize("name", POD_CASES)
@pytest.mark.parametrize("shape", POD_MESHES)
def test_pod_mesh_decode_matches_the_reference(ranks, cases, shape, name):
    _check_logits(ranks, cases, shape, name)


@pytest.mark.parametrize("name", POD_CASES)
@pytest.mark.parametrize("shape", POD_MESHES)
def test_pod_mesh_decode_state_blocks_match_the_reference(ranks, cases,
                                                          shape, name):
    _check_state(ranks, cases, shape, name)


def _check_logits(ranks, cases, shape, name):
    want = cases[1][name]
    for rank in ranks(shape):
        got = rank[name]
        assert len(got["logits"]) == STEPS
        for g, w in zip(got["logits"], want):
            assert g.shape == w.shape
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= TOL * scale
        if "enc_err" in got:
            err, scale = got["enc_err"]
            assert err <= TOL * scale


def _check_state(ranks, cases, shape, name):
    for rank in ranks(shape):
        errs = rank[name]["state_err"]
        assert set(errs) == set(cases[0][name]["final"])
        for key, (err, scale) in errs.items():
            assert err <= TOL * max(scale, 1e-30), (key, err, scale)
