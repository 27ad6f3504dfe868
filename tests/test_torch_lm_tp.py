"""Tensor and sequence parallelism over ``model`` in the port's LM forward
and mesh train step, on four CPU ranks joined by gloo
(``tests/_torch_dist.py`` spawns them; the rank bodies are in
``tests/_torch_lm_dist.py``), on ``("data", "model")`` meshes of
``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` ranks, against the reference. All
float32, at the smoke sizes.

* Each module as ``forward(..., mesh=)`` runs it, its weights the rank's
  blocks under ``transformer.tp_plan``: the MLP, GQA self-attention with
  KV heads that divide ``model`` and KV heads that do not (the rank's
  query heads use their group's KV heads, ``wk``/``wv`` whole), GQA with
  heads that do not split head-aligned (the layer whole on every rank),
  cross-attention, MLA, the Mamba2 block (the SSD scan's plain version),
  the vocabulary-parallel embedding, head and cross-entropy; the MLP,
  GQA, MLA and Mamba2 also under sequence parallelism (the input and the
  output the rank's sequence block). Each output, gathered whole, within
  1e-5 of its largest |value| of the reference's single-device function
  on the same seeded numpy inputs and weights.
* Each rank's gradient of the mesh step without compression (internlm2,
  internlm2 under ``act_sp``, mamba2 without ``--opt``, zamba2's SSM
  layers and the shared block after each, deepseek's MLA
  and catwalk MoE; under ``act_sp`` also 6 query heads in KV groups of 2
  and deepseek, whose attention and MoE layer run whole on the gathered
  sequence; arctic's dense residual MLP beside its MoE layer,
  phi-3-vision with patches, seamless-m4t's encoder and cross-attention
  with frames) is its block of the reference's single-device gradient,
  within 1e-5 of the leaf's largest |value|.
* The leaves the step gathers: a hook on ``specs.gather`` outside the
  activations' collectives sees exactly the parameter blocks the plan
  leaves out (KV heads that do not divide ``model``, Mamba2's
  ``in_proj``, the MoE layer's shared experts, and its expert stacks
  where ``model`` has one rank), and without compression
  no other gather (no rank builds a whole gradient of a split leaf).
* Under ``act_sp`` every block's input is the rank's block of the
  sequence (its length over the ``model`` ranks).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
import _torch_lm_dist as LD  # noqa: E402
import test_torch_train as TT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import pipeline as tDP  # noqa: E402
from repro_torch.train import checkpoint as tCK  # noqa: E402

MESHES = [(1, 4), (2, 2), (4, 1)]
B, S, D = 2, 48, 64
INTERN, MAMBA, DEEP = "internlm2-1.8b", "mamba2-780m", "deepseek-v2-lite-16b"
ARCTIC, VLM, AUDIO = "arctic-480b", "phi-3-vision-4.2b", "seamless-m4t-medium"
ZAMBA = "zamba2-1.2b"
ADAMW = dict(lr=TT.LR, warmup_steps=2, total_steps=50)

#: module cases: kind, arch, config edits, sequence parallel
MODULES = {
    "mlp": dict(kind="mlp", arch=INTERN),
    "mlp_seq": dict(kind="mlp", arch=INTERN, seq=True),
    "gqa_kv2": dict(kind="gqa", arch=INTERN),
    "gqa_kv4": dict(kind="gqa", arch=INTERN, edit=dict(n_kv_heads=4)),
    "gqa_h6": dict(kind="gqa", arch=INTERN,
                   edit=dict(n_heads=6, n_kv_heads=3)),
    "gqa_kv2_seq": dict(kind="gqa", arch=INTERN, seq=True),
    "xattn": dict(kind="xattn", arch=INTERN),
    "mla": dict(kind="mla", arch=DEEP),
    "mla_seq": dict(kind="mla", arch=DEEP, seq=True),
    "ssm": dict(kind="ssm", arch=MAMBA),
    "ssm_seq": dict(kind="ssm", arch=MAMBA, seq=True),
    "embed": dict(kind="embed", arch=INTERN),
    "head": dict(kind="head", arch=INTERN),
    "ce": dict(kind="ce", arch=INTERN),
}
#: the modules the plan leaves whole at every model size here: 6 query
#: heads over 2 ranks (3 a rank, in KV groups of 2) or 4
WHOLE = {"gqa_h6"}

#: train-step cases of the gradient and layout checks
STEPS = {
    "internlm2": dict(arch=INTERN),
    "internlm2_sp": dict(arch=INTERN, act_sp=True),
    "mamba2": dict(arch=MAMBA),
    # the hybrid family: the shared block after each SSM layer
    "zamba2": dict(arch=ZAMBA),
    "deepseek": dict(arch=DEEP, dispatch="catwalk", capacity=1.0),
    # under act_sp, a layer computed whole on every rank: attention whose
    # heads do not split head-aligned, the catwalk MoE layer
    "internlm2_sp_h6": dict(arch=INTERN, act_sp=True,
                            edit=dict(n_heads=6, n_kv_heads=3)),
    "deepseek_sp": dict(arch=DEEP, dispatch="catwalk", capacity=1.0,
                        act_sp=True),
    # the dense residual MLP beside the MoE layer; the vlm prefix; the
    # audio encoder and the decoder's cross-attention
    "arctic": dict(arch=ARCTIC),
    "phi3v": dict(arch=VLM, extra="patches"),
    "seamless": dict(arch=AUDIO, extra="frames"),
}
#: the parameter blocks the mesh step gathers, per mesh and case: the
#: plain MoE layer keeps its expert blocks where ``model`` has more than
#: one rank (it gathers only the shared experts' d_ff)
MOE = ["layers/moe/shared/w_down", "layers/moe/shared/w_gate",
       "layers/moe/shared/w_up", "layers/moe/w_down", "layers/moe/w_gate",
       "layers/moe/w_up"]
GQA = ["layers/attn/wk", "layers/attn/wo", "layers/attn/wq",
       "layers/attn/wv"]
KV = ["layers/attn/wk", "layers/attn/wv"]
KV_AUDIO = ["encoder/attn/wk", "encoder/attn/wv", "layers/attn/wk",
            "layers/attn/wv", "layers/xattn/wk", "layers/xattn/wv"]
GATHERED = {
    (1, 4): {"internlm2": ["layers/attn/wk", "layers/attn/wv"],
             "internlm2_sp": ["layers/attn/wk", "layers/attn/wv"],
             "mamba2": ["layers/ssm/in_proj"], "deepseek": MOE[:3],
             "zamba2": ["layers/ssm/in_proj", "shared/attn/wk",
                        "shared/attn/wv"],
             "internlm2_sp_h6": GQA, "deepseek_sp": MOE[:3],
             "arctic": KV, "phi3v": KV, "seamless": KV_AUDIO},
    (2, 2): {"internlm2": [], "internlm2_sp": [],
             "mamba2": ["layers/ssm/in_proj"], "deepseek": MOE[:3],
             "zamba2": ["layers/ssm/in_proj"],
             "internlm2_sp_h6": GQA, "deepseek_sp": MOE[:3],
             "arctic": [], "phi3v": [], "seamless": []},
    (4, 1): {"internlm2": [], "internlm2_sp": [], "mamba2": [],
             "zamba2": [], "deepseek": MOE[3:], "internlm2_sp_h6": [],
             "deepseek_sp": MOE[3:], "arctic": MOE[3:], "phi3v": [],
             "seamless": []},
}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.configs.registry as jreg
    import repro.models.attention as jA
    import repro.models.layers as jL
    import repro.models.ssm as jS
    import repro.optim.optimizers as jO
    import repro.train.train_loop as jTL
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, reg=jreg, A=jA,
                                 L=jL, S=jS, O=jO, TL=jTL)


# ----------------------------------------------------------------- modules

def _w(rng, *shape, scale=None):
    scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _module_inputs(i, c, cfg):
    """Seeded numpy weights and inputs of module case ``c``."""
    rng = np.random.default_rng(200 + i)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    kind = c["kind"]
    out = dict(c, x=x)
    if kind == "mlp":
        out["p"] = {"w_gate": _w(rng, D, cfg.d_ff),
                    "w_up": _w(rng, D, cfg.d_ff),
                    "w_down": _w(rng, cfg.d_ff, D)}
    elif kind in ("gqa", "xattn"):
        hd = cfg.resolved_head_dim
        out["p"] = {"wq": _w(rng, D, cfg.n_heads * hd),
                    "wk": _w(rng, D, cfg.n_kv_heads * hd),
                    "wv": _w(rng, D, cfg.n_kv_heads * hd),
                    "wo": _w(rng, cfg.n_heads * hd, D)}
        if kind == "xattn":
            out["kv"] = rng.standard_normal((B, 24, D)).astype(np.float32)
    elif kind == "mla":
        m, h = cfg.mla, cfg.n_heads
        out["p"] = {"wq": _w(rng, D, h * (m.d_nope + m.d_rope)),
                    "w_dkv": _w(rng, D, m.kv_lora_rank),
                    "w_ukv": _w(rng, m.kv_lora_rank, h * (m.d_nope + m.d_v)),
                    "w_kr": _w(rng, D, m.d_rope),
                    "wo": _w(rng, h * m.d_v, D)}
    elif kind == "ssm":
        s = cfg.ssm
        di, n, h = s.d_inner(D), s.d_state, s.n_heads(D)
        out["p"] = {"in_proj": _w(rng, D, 2 * di + 2 * n + h),
                    "conv_w": _w(rng, s.conv_kernel, di + 2 * n, scale=0.1),
                    "dt_bias": _w(rng, h, scale=0.5),
                    "a_log": _w(rng, h, scale=0.5),
                    "norm": 1 + _w(rng, di, scale=0.1),
                    "out_proj": _w(rng, di, D)}
    elif kind == "embed":
        out["x"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
        out["p"] = {"w": _w(rng, cfg.vocab_size, D, scale=0.02)}
    elif kind == "head":
        out["p"] = {"w": _w(rng, D, cfg.vocab_size)}
    else:
        out["x"] = 3 * rng.standard_normal(
            (B, S, cfg.vocab_size)).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int64)
        out["mask"] = rng.random((B, S)) < 0.7
        out["p"] = {"w": _w(rng, D, cfg.vocab_size)}
    return out


def _reference_module(ref, c):
    """The reference's single-device function of module case ``c``."""
    jcfg = dataclasses.replace(ref.reg.get_config(c["arch"] + "-smoke"),
                               dtype="float32", **c.get("edit", {}))
    p = ref.jax.tree.map(ref.jnp.asarray, c["p"])
    x = ref.jnp.asarray(c["x"])
    kind = c["kind"]
    if kind == "mlp":
        y = ref.L.mlp_apply(p, x)
    elif kind == "gqa":
        y = ref.A.gqa_apply(p, x, jcfg)[0]
    elif kind == "xattn":
        y = ref.A.gqa_apply(p, x, jcfg, kv_input=ref.jnp.asarray(c["kv"]),
                            causal=False)[0]
    elif kind == "mla":
        y = ref.A.mla_apply(p, x, jcfg)[0]
    elif kind == "ssm":
        y = ref.jax.jit(lambda p, x: ref.S.ssm_apply(p, x, jcfg)[0])(p, x)
    elif kind == "embed":
        y = ref.L.embed_lookup(p["w"], x)
    elif kind == "head":
        y = x @ p["w"]
    else:
        y = ref.L.cross_entropy(x, ref.jnp.asarray(c["labels"]),
                                ref.jnp.asarray(c["mask"]))
    return np.asarray(y, dtype=np.float32)


@pytest.fixture(scope="module")
def modules(ref):
    cases, want = {}, {}
    for i, (name, c) in enumerate(MODULES.items()):
        cfg = LD._module_cfg(c)
        cases[name] = _module_inputs(i, c, cfg)
        want[name] = _reference_module(ref, cases[name])
    return cases, want


# ------------------------------------------------------------ train steps

def _step_case(c):
    return dict(c, adamw=ADAMW, ga=1, rho=None)


def _batch(data, cfg, c):
    """The synthetic batch, with seeded patches (vlm) or frames (audio)
    for case ``c``."""
    batch = data.batch(0)
    if c.get("extra"):
        n = cfg.frontend.n_tokens if c["extra"] == "patches" \
            else cfg.encdec.encoder_seq
        batch[c["extra"]] = np.random.default_rng(7).standard_normal(
            (8, n, cfg.frontend.d_embed)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def grad_cases(ref):
    """Each step case with the reference's initial state (as the port's
    checkpoint keys), a batch and the reference's single-device gradient
    of it (as the port's parameter keys)."""
    out = {}
    data = tDP.SyntheticLM(tDP.DataConfig(seq_len=16, global_batch=8,
                                          vocab_size=256))
    for name, c in STEPS.items():
        c = _step_case(c)
        tcfg, _ = LD._configs(c)
        batch = _batch(data, tcfg, c)
        jcfg = dataclasses.replace(ref.reg.get_config(c["arch"] + "-smoke"),
                                   dtype="float32", **c.get("edit", {}))
        jcfg = TT._reference_opt(jcfg, tcfg)
        jt = ref.TL.TrainConfig(optimizer=ref.O.AdamWConfig(**ADAMW))
        js = ref.TL.init_train_state(ref.jax.random.PRNGKey(0), jcfg, jt)
        tree = ref.jax.tree.map(np.asarray, js)
        state = tCK._flatten(convert.train_state_from_numpy(tree, tcfg,
                                                            device="cpu"))
        grad = ref.jax.jit(ref.jax.grad(
            lambda p, b: ref.TL.loss_fn(p, jcfg, b)[0]))(js.params, batch)
        grad = tCK._flatten(convert.lm_params_from_numpy(
            ref.jax.tree.map(np.asarray, grad), tcfg, device="cpu"))
        out[name] = dict(c, state=state, batch=batch,
                         grad={k: np.asarray(v) for k, v in grad.items()})
    return out


@pytest.fixture(scope="module")
def ranks(modules, grad_cases, tmp_path_factory):
    """Each mesh's ranks (spawned once per mesh), run lazily."""
    cache = {}
    layout = {name: dict(_step_case(c), batch=grad_cases[name]["batch"])
              for name, c in STEPS.items()}

    def get(shape):
        if shape not in cache:
            cache[shape] = TD.run(
                "_torch_lm_dist:tp_suite", shape,
                args=(modules[0], grad_cases, layout),
                tmp_dir=tmp_path_factory.mktemp("lm_tp"), kind="lm")
        return cache[shape]
    return get


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("name", list(MODULES))
@pytest.mark.parametrize("shape", MESHES)
def test_tp_module_matches_the_reference(ranks, modules, shape, name):
    got = ranks(shape)[0]["modules"][name]
    want = modules[1][name]
    assert got["split"] == (shape[1] > 1 and name not in WHOLE)
    assert got["y"].shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got["y"] - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("shape", MESHES)
def test_tp_gradient_blocks_match_the_reference(ranks, grad_cases, shape,
                                                name):
    """Every rank's gradient of every leaf is its block (of the state's
    layout at rest) of the reference's single-device gradient."""
    for rank in ranks(shape):
        res = rank["grads"][name]
        assert set(res) == set(grad_cases[name]["grad"])
        for key, (err, _) in res.items():
            assert err <= 1e-5, (key, err)


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("shape", MESHES)
def test_tp_step_gathers_only_what_the_plan_leaves_out(ranks, shape, name):
    for rank in ranks(shape):
        got = rank["layout"][name]
        assert got["plain"]["params"] == GATHERED[shape][name]
        assert got["plain"]["other"] == 0
        assert got["compress"]["params"] == GATHERED[shape][name]
        if shape[1] > 1:
            # the chunked top-k gathers the gradients whole
            assert got["compress"]["other"] > 0


@pytest.mark.parametrize("shape", MESHES)
def test_sp_residual_stream_is_the_sequence_block(ranks, shape):
    for rank in ranks(shape):
        layout = rank["layout"]
        assert set(layout["internlm2_sp"]["plain"]["seq"]) \
            == {16 // shape[1]}
        for name in ("internlm2_sp_h6", "deepseek_sp"):
            assert set(layout[name]["plain"]["seq"]) == {16 // shape[1]}
        assert set(layout["internlm2"]["plain"]["seq"]) == {16}
