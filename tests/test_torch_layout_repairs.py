"""The port's layout repairs against the reference, on the CPU at small
widths (float32; inputs from numpy seeds, the reference under
``JAX_PLATFORMS=cpu``):

* Attention scored a block of queries at a time
  (``attention._by_query_blocks``): GQA's ``_sdpa`` (causal, groups of
  rep > 1, bidirectional over another key length, a cached decode with a
  shared and a per-row validity mask, several queries into a cache) and
  MLA's score pass (``mla_apply``: the full sequence, a cached decode, a
  chunk of tokens into a cache) at block sizes that do not divide the
  queries, and with one query. Each blocked forward is within 1e-6 of
  the output's largest |value| of the port's form in one block (the
  same float32 steps; the BLAS picks its kernel by the product's shape,
  so a block's rows may round otherwise, as cuBLAS's may on the card),
  and the reference's ``_sdpa`` (``src/repro/models/attention.py:91``)
  and ``mla_apply`` within 1e-5 (XLA orders its float32 sums otherwise);
  the gradients (each block recomputed under
  ``torch.utils.checkpoint``) within 1e-6 of their largest |value| of
  the one-block form's.
* The cross-entropy over token chunks (``layers.head_cross_entropy``)
  with and without a mask, with ``total=``, at chunks that do not divide
  the tokens: within 1e-6 (relative) of ``cross_entropy(x @ head,
  ...)`` (a chunk's product may take another BLAS kernel) and of the
  reference's ``cross_entropy``
  (``src/repro/models/layers.py:80``; with ``total=``, its mean scaled by
  the token count over the total), and its gradients with respect to the
  hidden state and the head within 1e-6 of their largest |value| of the
  unchunked form's. In bfloat16, over 96 and 20 chunks, both gradients
  within one bfloat16 step of the unchunked form's (the head's summed in
  float32, rounded once); the FLOP counter sees each chunk's four head
  products.
* The plain MoE layer under a mesh (``moe_apply(..., mesh=)`` with its
  expert blocks, ``moe._plain_part``) on four gloo ranks
  (``tests/_torch_lm_dist.py:plain_moe_suite``) over ``(2, 2)`` and
  ``(1, 4)`` meshes, at capacity factors 1.0 and 0.5 (which drop
  assignments), 8 (none) and with shared experts: the output within
  1e-5 of its largest |value| of the reference's single-device
  ``moe_apply`` on the whole batch, the aux loss within 1e-6 (relative),
  every rank holding ``E / model`` experts, the ranks' drops over one
  data row equal to the whole layer's (the reference's gate ids past each
  expert's capacity), and every gradient of ``sum(out * w) + aux``
  (summed over the ranks that hold the same block) within 1e-5 of its
  largest |value| of the port's single-device layer's. Its rank stages
  (``_route``, ``_relocation``, ``_fill_slots``, ``_expert_ffn``,
  ``_rows_combine``), driven part after part and summed where its
  collectives sum, over (2, 2), (1, 4) and (4, 1) tilings: within 1e-5
  of the single-device layer, the drops its own; ``_plain_part`` on a
  one-rank mesh with every expert: bit for bit.
* AdamW's update a piece of each leaf at a time
  (``optimizers.UPDATE_CHUNK``): the new parameters and moments equal,
  bit for bit, the update of each leaf whole.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
from repro_torch.configs.base import MLAConfig, MoEConfig  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.optim import optimizers as tO  # noqa: E402

#: the reference against the port (XLA's float32 sums in another order)
REF_TOL = 1e-5
#: blocked or chunked forms and their gradients against the one-block
#: form's
GRAD_TOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.kernels.ops as jops
    import repro.models.attention as jA
    import repro.models.layers as jL
    import repro.models.moe as jM
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, A=jA, L=jL, M=jM,
                                 ops=jops)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * max(scale, 1e-30)


def _grads(fn, *inputs):
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(out.shape)).astype(np.float32)) if out.dim() else 1.0
    return out.detach(), torch.autograd.grad(torch.sum(out * w), leaves)


# ------------------------------------------------------------- GQA blocks

#: (B, Sq, Sk, H, G, D, causal, validity mask)
SDPA_CASES = {
    "causal_gqa": (2, 19, 19, 6, 2, 16, True, None),
    "causal_mha": (2, 13, 13, 4, 4, 8, True, None),
    "bidirectional": (2, 11, 17, 4, 2, 16, False, None),
    "decode": (3, 1, 12, 6, 3, 16, False, "shared"),
    "decode_per_row": (2, 1, 12, 4, 2, 16, False, "rows"),
    "chunk_into_cache": (2, 5, 12, 4, 2, 16, False, "shared"),
}
BLOCKS = (1, 3, 4)


def _sdpa_inputs(case):
    b, sq, sk, h, g, d, causal, valid = SDPA_CASES[case]
    rng = np.random.default_rng(sorted(SDPA_CASES).index(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, g, d), (b, sk, g, d)))
    kv = None
    if valid == "shared":
        kv = np.arange(sk) < sk - 3
    elif valid == "rows":
        kv = np.arange(sk)[None] < rng.integers(1, sk, (b, 1))
    return q, k, v, causal, kv


def _blocks(monkeypatch, n, row):
    """Blocks of ``n`` queries at ``row`` score bytes a query (``n``
    None: every query in one block)."""
    budget = (1 << 62) if n is None else n * row
    monkeypatch.setattr(tA, "SCORE_BLOCK_BYTES", budget)


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_blocked_sdpa_matches_the_reference(ref, monkeypatch, case):
    q, k, v, causal, kv = _sdpa_inputs(case)
    want = ref.A._sdpa(ref.jnp.asarray(q), ref.jnp.asarray(k),
                       ref.jnp.asarray(v), causal=causal,
                       kv_valid=None if kv is None else ref.jnp.asarray(kv))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tkv = None if kv is None else torch.from_numpy(kv)

    def run(a, b_, c):
        return tA._sdpa(a, b_, c, causal=causal, kv_valid=tkv)
    row = 4 * q.shape[0] * q.shape[2] * k.shape[1]
    _blocks(monkeypatch, None, row)
    whole, whole_g = _grads(run, tq, tk, tv)
    _close(whole.numpy(), np.asarray(want), REF_TOL)
    for block in BLOCKS:
        _blocks(monkeypatch, block, row)
        got, got_g = _grads(run, tq, tk, tv)
        _close(got.numpy(), whole.numpy(), GRAD_TOL)
        for g, w in zip(got_g, whole_g):
            _close(g.numpy(), w.numpy(), GRAD_TOL)


def test_sdpa_block_size_comes_from_the_score_bytes(monkeypatch):
    """A block holds as many queries as fit ``SCORE_BLOCK_BYTES`` of f32
    scores, with a gradient and without, at least one."""
    q, k, v, causal, _ = _sdpa_inputs("causal_gqa")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    row = 4 * q.shape[0] * q.shape[2] * k.shape[1]
    seen = []
    block = tA._sdpa_block

    def spy(qb, *args):
        seen.append(qb.shape[1])
        return block(qb, *args)
    monkeypatch.setattr(tA, "_sdpa_block", spy)
    monkeypatch.setattr(tA, "SCORE_BLOCK_BYTES", 5 * row)
    with torch.no_grad():
        tA._sdpa(tq, tk, tv, causal=causal)
    assert seen == [5, 5, 5, 4]
    seen.clear()
    monkeypatch.setattr(tA, "SCORE_BLOCK_BYTES", 2 * row)
    tA._sdpa(tq.requires_grad_(), tk, tv, causal=causal).sum().backward()
    # ten blocks forward, each recomputed in the backward
    assert seen[:10] == [2] * 9 + [1]
    assert sorted(seen[10:]) == [1] + [2] * 9
    seen.clear()
    monkeypatch.setattr(tA, "SCORE_BLOCK_BYTES", 1)
    with torch.no_grad():
        tA._sdpa(tq, tk, tv, causal=causal)
    assert seen == [1] * q.shape[1]


# ------------------------------------------------------------- MLA blocks

MLA_CFG = dict(kv_lora_rank=16, d_nope=8, d_rope=8, d_v=8)
#: (B, S, cache positions before the call or None)
MLA_CASES = {"full": (2, 13, None), "decode": (2, 1, 5),
             "chunk_into_cache": (2, 3, 4), "one_query": (2, 1, None)}


def _mla(case):
    cfg = treg.get_config("deepseek-v2-lite-16b-smoke")
    b, s, pos = MLA_CASES[case]
    m, d, h = MLAConfig(**MLA_CFG), cfg.d_model, cfg.n_heads
    rng = np.random.default_rng(40 + sorted(MLA_CASES).index(case))

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    p = {"wq": w(d, h * (m.d_nope + m.d_rope)), "w_dkv": w(d, m.kv_lora_rank),
         "w_ukv": w(m.kv_lora_rank, h * (m.d_nope + m.d_v)),
         "w_kr": w(d, m.d_rope), "wo": w(h * m.d_v, d)}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cache = None
    if pos is not None:
        cache = (rng.standard_normal((b, 12, m.kv_lora_rank)).astype(
            np.float32), rng.standard_normal((b, 12, m.d_rope)).astype(
            np.float32), np.int32(pos))
    import dataclasses
    return dataclasses.replace(cfg, dtype="float32", mla=m), p, x, cache


@pytest.mark.parametrize("case", list(MLA_CASES))
def test_blocked_mla_matches_the_reference(ref, monkeypatch, case):
    cfg, p, x, cache = _mla(case)
    jcache = None if cache is None else ref.A.KVCache(
        *(ref.jnp.asarray(t) for t in cache))
    want, _ = ref.A.mla_apply({k: ref.jnp.asarray(v) for k, v in p.items()},
                              ref.jnp.asarray(x), cfg, cache=jcache)
    names = list(p)
    sk = x.shape[1] if cache is None else cache[0].shape[1]
    row = 4 * x.shape[0] * cfg.n_heads * sk

    def run(*leaves):
        tc = None if cache is None else tA.KVCache(
            *(torch.as_tensor(t) for t in cache))
        return tA.mla_apply(dict(zip(names, leaves[:-1])), leaves[-1], cfg,
                            cache=tc)[0]
    inputs = [torch.from_numpy(p[k]) for k in names] + [torch.from_numpy(x)]
    _blocks(monkeypatch, None, row)
    whole, whole_g = _grads(run, *inputs)
    _close(whole.numpy(), np.asarray(want), REF_TOL)
    for block in BLOCKS:
        _blocks(monkeypatch, block, row)
        got, got_g = _grads(run, *inputs)
        with torch.no_grad():
            _close(run(*inputs).numpy(), whole.numpy(), GRAD_TOL)
        _close(got.numpy(), whole.numpy(), GRAD_TOL)
        for g, w in zip(got_g, whole_g):
            _close(g.numpy(), w.numpy(), GRAD_TOL)


# ------------------------------------------------------ the chunked loss

#: (B, S, D, V, mask, total)
CE_CASES = {"plain": (2, 7, 16, 37, False, False),
            "masked": (2, 7, 16, 37, True, False),
            "total": (3, 5, 8, 29, False, True),
            "masked_total": (3, 5, 8, 29, True, True)}
CHUNKS = (1, 3, 4, 100)


@pytest.mark.parametrize("case", list(CE_CASES))
def test_chunked_cross_entropy_matches_the_reference(ref, monkeypatch,
                                                     case):
    b, s, d, v, masked, with_total = CE_CASES[case]
    rng = np.random.default_rng(60 + sorted(CE_CASES).index(case))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.6 if masked else None
    jmask = None if mask is None else ref.jnp.asarray(mask)
    want = float(ref.L.cross_entropy(ref.jnp.asarray(x @ head),
                                     ref.jnp.asarray(labels), jmask))
    tl = torch.from_numpy(labels)
    tm = None if mask is None else torch.from_numpy(mask)
    total = None
    if with_total:
        count = float(mask.sum()) if masked else float(labels.size)
        total = torch.tensor(3.0 * count)
        want = want * count / (3.0 * count)

    def whole(xx, hh):
        return tL.cross_entropy(xx @ hh, tl, tm, total=total)
    base, base_g = _grads(whole, torch.from_numpy(x), torch.from_numpy(head))
    assert abs(float(base) - want) <= 1e-6 * abs(want)
    for chunk in CHUNKS:
        monkeypatch.setattr(tL, "CE_CHUNK_BYTES", chunk * 4 * v)
        got, got_g = _grads(lambda xx, hh: tL.head_cross_entropy(
            xx, hh, tl, tm, total=total),
            torch.from_numpy(x), torch.from_numpy(head))
        assert abs(float(got) - float(base)) <= GRAD_TOL * abs(float(base))
        for g, w in zip(got_g, base_g):
            _close(g.numpy(), w.numpy(), GRAD_TOL)


@pytest.mark.parametrize("chunk", [1, 5])
def test_chunked_head_gradient_keeps_bfloat16_rounding(monkeypatch, chunk):
    """In bfloat16, the head's gradient over many chunks adds them in
    float32 and rounds once: each element within one bfloat16 step
    (2^-7 of its |value|, plus 1e-6 of the largest) of the one-piece
    product's, as the hidden state's gradient is."""
    n, d, v = 96, 32, 53
    rng = np.random.default_rng(71)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(torch.bfloat16)
    head = torch.from_numpy((rng.standard_normal((d, v)) / np.sqrt(d))
                            .astype(np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, v, (n,)))
    base, base_g = _grads(lambda xx, hh: tL.cross_entropy(xx @ hh, labels),
                          x, head)
    monkeypatch.setattr(tL, "CE_CHUNK_BYTES", chunk * 4 * v)
    got, got_g = _grads(lambda xx, hh: tL.head_cross_entropy(xx, hh, labels),
                        x, head)
    assert float(got) == float(base)
    for g, w in zip(got_g, base_g):
        assert g.dtype == torch.bfloat16
        g, w = g.double(), w.double()
        bound = 2.0 ** -7 * w.abs() + 1e-6 * float(w.abs().max())
        assert bool(((g - w).abs() <= bound).all())


def test_chunked_loss_counts_every_product(monkeypatch):
    """Under ``FlopCounterMode`` (the dry run's FLOP count) a step of the
    chunked loss counts four head products: the forward, its recompute,
    and the gradients of the hidden state and of the head."""
    from torch.utils.flop_counter import FlopCounterMode
    n, d, v = 24, 8, 29
    x = torch.ones(n, d, requires_grad=True)
    head = torch.ones(d, v, requires_grad=True)
    monkeypatch.setattr(tL, "CE_CHUNK_BYTES", 5 * 4 * v)
    with FlopCounterMode(display=False) as count:
        tL.head_cross_entropy(x, head, torch.zeros(n, dtype=torch.long)
                              ).backward()
    assert count.get_total_flops() == 4 * 2 * n * d * v


def test_chunk_size_comes_from_the_logit_bytes(monkeypatch):
    """A chunk holds as many tokens as fit ``CE_CHUNK_BYTES`` of f32
    logits, at least one."""
    v = 10
    x, head = torch.ones(2, 5, 4), torch.ones(4, v)
    labels = torch.zeros(2, 5, dtype=torch.long)
    seen = []
    nll = tL._head_nll

    def spy(xs, hh, ls):
        seen.append(xs.shape[0])
        return nll(xs, hh, ls)
    monkeypatch.setattr(tL, "_head_nll", spy)
    monkeypatch.setattr(tL, "CE_CHUNK_BYTES", 4 * 4 * v)
    tL.head_cross_entropy(x, head, labels)
    assert seen == [4, 4, 2]


# ---------------------------------------------------- the plain MoE layer

D_MODEL = 32
MOE = dict(n_experts=4, top_k=2, d_expert=16, n_shared=0,
           dispatch="catwalk")
MOE_CASES = {"cap1": dict(MOE, capacity_factor=1.0),
             "cap_half": dict(MOE, capacity_factor=0.5),
             "cap8": dict(MOE, capacity_factor=8.0),
             "shared": dict(MOE, n_shared=2, capacity_factor=1.0)}
MOE_MESHES = [(2, 2), (1, 4)]


def _moe_case(i, cfg):
    rng = np.random.default_rng(80 + i)
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
    return dict(cfg=cfg, p=p,
                x=rng.standard_normal((8, 16, d)).astype(np.float32),
                w=rng.standard_normal((8, 16, d)).astype(np.float32))


@pytest.fixture(scope="module")
def moe_cases():
    return {name: _moe_case(i, c) for i, (name, c) in enumerate(
        MOE_CASES.items())}


@pytest.fixture(scope="module")
def moe_ranks(moe_cases, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = TD.run(
                "_torch_lm_dist:plain_moe_suite", shape, args=(moe_cases,),
                tmp_dir=tmp_path_factory.mktemp("plain_moe"), kind="lm")
        return cache[shape]
    return get


def _reference_moe(ref, c):
    cfg = MoEConfig(**c["cfg"])
    p = ref.jax.tree.map(ref.jnp.asarray, c["p"])
    x = ref.jnp.asarray(c["x"])
    y, stats = ref.jax.jit(lambda p, x: ref.M.moe_apply(p, x, cfg))(p, x)
    xt = x.reshape(-1, x.shape[-1])
    _, ids = ref.ops.moe_gate_topk(xt @ p["router"], cfg.top_k, renorm=True,
                                   impl="ref")
    t = xt.shape[0]
    counts = np.bincount(np.asarray(ids).reshape(-1),
                         minlength=cfg.n_experts)
    cap = tM._capacity(t, cfg)
    return np.asarray(y), float(stats["aux_loss"]), \
        int(np.clip(counts - cap, 0, None).sum())


@pytest.mark.parametrize("name", list(MOE_CASES))
@pytest.mark.parametrize("shape", MOE_MESHES)
def test_plain_moe_on_a_mesh_matches_the_reference(ref, moe_cases,
                                                  moe_ranks, shape, name):
    y, aux, drops = _reference_moe(ref, moe_cases[name])
    if name in ("cap1", "cap_half"):
        assert drops > 0
    ranks = moe_ranks(shape)
    e = MOE_CASES[name]["n_experts"]
    for rank in ranks:
        got = rank[name]
        assert got["experts"] == e // shape[1]
        _close(got["y"], y, REF_TOL)
        assert abs(got["aux"] - aux) <= 1e-6 * abs(aux)
    row = [r[name]["drops"] for r in ranks if r["coords"][0] == 0]
    assert len(row) == shape[1] and sum(row) == drops


@pytest.mark.parametrize("name", list(MOE_CASES))
@pytest.mark.parametrize("shape", MOE_MESHES)
def test_plain_moe_gradients_match_single_device(moe_cases, moe_ranks,
                                                 shape, name):
    c = moe_cases[name]
    cfg = MoEConfig(**c["cfg"])
    leaves = []

    def track(a):
        t = torch.from_numpy(a).requires_grad_()
        leaves.append(t)
        return t
    p = {k: ({kk: track(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else track(v)) for k, v in c["p"].items()}
    x = track(c["x"])
    y, stats = tM.moe_apply(p, x, cfg)
    (torch.sum(y * torch.from_numpy(c["w"])) + stats["aux_loss"]).backward()
    got = moe_ranks(shape)[0][name]
    pairs = [(got["grads"][k], p[k].grad) for k in ("router", "w_gate",
                                                    "w_up", "w_down")]
    if "shared" in p:
        pairs += [(got["grads"]["shared"][k], p["shared"][k].grad)
                  for k in ("w_gate", "w_up", "w_down")]
    pairs.append((got["x_grad"], x.grad))
    for mine, want in pairs:
        _close(mine, want.numpy(), REF_TOL)


#: (data, model) tilings of the plain layer's rank stages
STAGE_TILINGS = [(2, 2), (1, 4), (4, 1)]


@pytest.mark.parametrize("name", list(MOE_CASES))
@pytest.mark.parametrize("tiling", STAGE_TILINGS)
def test_plain_moe_rank_stages_sum_to_the_layer(moe_cases, tiling, name):
    """``_plain_part``'s rank stages, one part after another and summed
    where its collectives sum (as ``chip_smoke.lm_plain_tiles`` drives
    them on the card), against the single-device layer."""
    c = moe_cases[name]
    cfg = MoEConfig(**c["cfg"])
    d, m = tiling
    p = {k: (v if isinstance(v, dict) else torch.from_numpy(v))
         for k, v in c["p"].items()}
    if "shared" in p:
        p["shared"] = {k: torch.from_numpy(v) for k, v in p["shared"].items()}
    x = torch.from_numpy(c["x"])
    xt = x.reshape(-1, x.shape[-1])
    t, dm = xt.shape
    e, k, f = cfg.n_experts, cfg.top_k, cfg.d_expert
    n, e_loc, f_loc = t // d, e // m, f // d
    cap = tM._capacity(t, cfg)
    with torch.no_grad():
        want = tM.moe_apply(p, x, cfg)[0].reshape(t, dm)
        rows = [xt[j * n:(j + 1) * n] for j in range(d)]
        routes = [tM._route(p, x_j, cfg) for x_j in rows]
        ids = torch.cat([r[2] for r in routes])
        routed = [torch.zeros((n, dm)) for _ in range(d)]
        drops = 0
        for i in range(m):
            e_lo = i * e_loc
            slot_src, token_slot = tM._relocation(ids, cap, e_lo, e_loc)
            drops += int(((ids >= e_lo) & (ids < e_lo + e_loc)).sum()
                         - (slot_src < t).sum())
            expert_in = sum(tM._fill_slots(x_j, slot_src, j * n)
                            for j, x_j in enumerate(rows))
            expert_out = 0
            for j in range(d):
                fs = slice(j * f_loc, (j + 1) * f_loc)
                part = {"w_gate": p["w_gate"][e_lo:e_lo + e_loc, :, fs],
                        "w_up": p["w_up"][e_lo:e_lo + e_loc, :, fs],
                        "w_down": p["w_down"][e_lo:e_lo + e_loc, fs]}
                expert_out = expert_out + tM._expert_ffn(
                    part, expert_in.reshape(e_loc, cap, dm))
            for j in range(d):
                routed[j] += tM._rows_combine(expert_out, token_slot,
                                              routes[j][1], j * n)
        got = torch.cat(routed)
        if "shared" in p:
            got = got + tL.mlp_apply(p["shared"], xt)
    counts = torch.bincount(ids.reshape(-1), minlength=e)
    assert drops == int(torch.clamp(counts - cap, min=0).sum())
    _close(got.numpy(), want.numpy(), REF_TOL)


def test_plain_part_on_one_rank_equals_the_layer(moe_cases, tmp_path):
    """``_plain_part`` itself (its row offset, slot fill, d_ff and combine
    assembly) on a one-rank mesh with every expert: the output bit for
    bit the single-device layer's, the aux loss within 1e-6."""
    got = TD.run("_torch_lm_dist:plain_part_whole", (1, 1),
                 args=(moe_cases,), tmp_dir=tmp_path, kind="lm")[0]
    for name in MOE_CASES:
        r = got[name]
        assert np.array_equal(r["y"], r["want"])
        assert abs(r["aux"] - r["want_aux"]) <= 1e-6 * abs(r["want_aux"])


# ------------------------------------------------- AdamW a piece at a time

@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_in_pieces_equals_the_whole_update(monkeypatch, moments):
    rng = np.random.default_rng(7)

    def leaf(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    params = {"stack": leaf(5, 6, 7, dtype=torch.bfloat16),
              "w": leaf(9, 4), "norm": leaf(3), "scalar": leaf()}
    grads = {k: leaf(*v.shape, dtype=v.dtype) for k, v in params.items()}
    cfg = tO.AdamWConfig(moments_dtype=moments, weight_decay=0.1)
    state = tO.init_adamw(params, cfg)
    state = state._replace(m={k: leaf(*v.shape).to(v.dtype)
                              for k, v in state.m.items()},
                           v={k: leaf(*v.shape).abs().to(v.dtype)
                              for k, v in state.v.items()})
    want = tO.adamw_update(cfg, params, grads, state)
    for chunk in (1, 7, 50):
        monkeypatch.setattr(tO, "UPDATE_CHUNK", chunk)
        got = tO.adamw_update(cfg, params, grads, state)
        for tree_got, tree_want in ((got[0], want[0]), (got[1].m, want[1].m),
                                    (got[1].v, want[1].v)):
            for k in params:
                assert torch.equal(tree_got[k], tree_want[k]), (chunk, k)
