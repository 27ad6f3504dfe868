"""GQA attention through the fused kernel's path
(``attention._GQAAttention``, ``kernels/gqa_attention.py``).

On the CPU (smoke shapes, bf16 inputs from numpy seeds):

* ``_sdpa`` takes the function for bf16 operands of a head dim the
  kernel is built for without a validity mask, and the plain path
  (``_sdpa_plain``) otherwise: a cached decode, float32 operands, another
  head dim, too many heads a group.
* The function's forward on the CPU is the plain blocked path, bit for
  bit; its gradients (q, k, v) equal those of the plain path's
  checkpointed blocks bit for bit at one block of queries and within f32
  rounding over several (the f32 sums of the keys' and values' gradients
  over the blocks, cast once to bf16: at most one bf16 step apart),
  causal and bidirectional, groups of 1, 2 and 4 heads, Sk != Sq.
* The plain version of the kernel (``gqa_attention_plain``) against the
  plain path, and the CPU wrapper's checks.
* A cached decode and MLA (``mla_apply``) never reach the function, and
  their outputs equal those of the plain path alone.
* On fake tensors (``FakeTensorMode``: the dry run) the function models
  the kernel: the operator ``repro::gqa_attention`` allocates only its
  output and ``FlopCounterMode`` counts it at ``model_flops``, the
  products over the allowed (query, key) pairs; a bf16 smoke forward's
  dry-run count holds one such operator a layer.
* The launch's layout copy (``_readable``) touches only operands the
  tensor maps cannot read.

On the card (``cuda``-marked, skipped without one): the kernel's bf16
output against the plain path's at head dims 16-128, groups of 1-16 heads,
causal or not, lengths off the 128-key tile, Sk != Sq (at most one bf16
step apart, a step of at least 2^-8 of the row's largest value:
``_bf16_steps``); its float32 output against a float64 evaluation (each row's
error norm over its norm within 2e-5, which a P rounded once to bf16, at
~1e-3, fails); the launch count; and one training step of
internlm2-1.8b-smoke with the kernel against the plain path within the
benchmark's limits (``bench/limits/internlm2-train.json``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import gqa_attention as tK  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402

#: (B, Sq, Sk, H, G, D, causal)
CASES = {
    "causal_rep1": (2, 13, 13, 2, 2, 16, True),
    "causal_rep2": (2, 19, 19, 4, 2, 16, True),
    "causal_rep4": (1, 11, 11, 8, 2, 16, True),
    "bidir_rep2": (2, 11, 17, 4, 2, 16, False),
    "bidir_rep4_short_keys": (1, 9, 5, 4, 1, 16, False),
    "causal_d64": (1, 10, 10, 4, 2, 64, True),
}


def _inputs(case, dtype=torch.bfloat16):
    b, sq, sk, h, g, d, causal = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((b, sq, h, d), (b, sk, g, d),
                                    (b, sk, g, d)))
    return q, k, v, causal


def _blocks(monkeypatch, n, q, k):
    """Blocks of ``n`` queries (None: all in one)."""
    row = 4 * q.shape[0] * q.shape[2] * k.shape[1]
    monkeypatch.setattr(tA, "SCORE_BLOCK_BYTES",
                        (1 << 62) if n is None else n * row)


def _grads(fn, q, k, v):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(out.dtype)
    return out.detach(), torch.autograd.grad(torch.sum(out * w), leaves)


def _function(causal):
    return lambda q, k, v: tA._GQAAttention.apply(q, k, v, causal)


def _plain(causal):
    return lambda q, k, v: tA._sdpa_plain(q, k, v, causal, None)


def _plain_only(monkeypatch):
    """Every ``_sdpa`` call on the plain path."""
    monkeypatch.setattr(
        tA, "_sdpa", lambda q, k, v, *, causal, kv_valid=None:
        tA._sdpa_plain(q, k, v, causal, kv_valid))


def _bf16_steps(got, want, row_floor=True):
    """How many bf16 steps two bf16 tensors (..., D) lie apart,
    elementwise: a step of the larger magnitude, with ``row_floor`` that
    magnitude taken at least 2^-8 of the row's largest |value|. Below
    that, two paths' own f32 sums (~1e-5 of the row's scale apart: another
    order, and the kernel's P split) exceed a bf16 step of an element that
    cancels to near 0."""
    a, b = got.double(), want.double()
    big = torch.maximum(a.abs(), b.abs())
    if row_floor:
        big = torch.maximum(big, big.amax(-1, keepdim=True) * 2.0 ** -8)
    big = big.clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return (a - b).abs() / step


# ------------------------------------------------------------- dispatch

def _spy(monkeypatch):
    calls = []
    apply = tA._GQAAttention.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return apply(*args)
    monkeypatch.setattr(tA._GQAAttention, "apply", spy)
    return calls


def test_bf16_without_a_mask_takes_the_function(monkeypatch):
    calls = _spy(monkeypatch)
    q, k, v, causal = _inputs("causal_rep2")
    with torch.no_grad():
        got = tA._sdpa(q, k, v, causal=causal)
        want = tA._sdpa_plain(q, k, v, causal, None)
    assert calls == [tuple(q.shape)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("why", ["kv_valid", "float32", "head_dim_8",
                                 "head_dim_24", "too_many_heads_a_group"])
def test_other_operands_take_the_plain_path(monkeypatch, why):
    calls = _spy(monkeypatch)
    b, sq, sk, h, g = 2, 3, 7, 4, 2
    if why == "too_many_heads_a_group":
        h, g = 2 * (tK.MAX_REP + 1), 2
    d = {"head_dim_8": 8, "head_dim_24": 24}.get(why, 16)
    dtype = torch.float32 if why == "float32" else torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen).to(dtype)
               for s in ((b, sq, h, d), (b, sk, g, d), (b, sk, g, d)))
    kv = torch.arange(sk) < sk - 2 if why == "kv_valid" else None
    assert tK.supported(q, k, v) == (why == "kv_valid")
    with torch.no_grad():
        got = tA._sdpa(q, k, v, causal=False, kv_valid=kv)
        want = tA._sdpa_plain(q, k, v, False, kv)
    assert calls == []
    assert torch.equal(got, want)


def test_supported_reads_shapes_dtypes_and_groups():
    q = torch.zeros(1, 4, 6, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 5, 2, 16, dtype=torch.bfloat16)
    assert tK.supported(q, k, k)
    assert not tK.supported(q, k[:, :, :1].expand(1, 5, 4, 16), k)
    assert not tK.supported(q, torch.zeros(1, 5, 4, 16,
                                           dtype=torch.bfloat16), k)
    assert not tK.supported(q, k[:, :0], k[:, :0])
    assert not tK.supported(q, k, k.float())
    assert not tK.supported(q[..., :8], k[..., :8], k[..., :8])
    many = torch.zeros(1, 2, 2 * (tK.MAX_REP + 1), 16, dtype=torch.bfloat16)
    assert not tK.supported(many, k, k)


# -------------------------------------------------- values and gradients

@pytest.mark.parametrize("case", list(CASES))
def test_function_forward_is_the_plain_path(monkeypatch, case):
    q, k, v, causal = _inputs(case)
    for n in (None, 4):
        _blocks(monkeypatch, n, q, k)
        with torch.no_grad():
            got = tA._GQAAttention.apply(q, k, v, causal)
            want = tA._sdpa_plain(q, k, v, causal, None)
        assert got.dtype == q.dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_function_gradients_equal_the_checkpointed_path_in_one_block(
        monkeypatch, case):
    q, k, v, causal = _inputs(case)
    _blocks(monkeypatch, None, q, k)
    got, got_g = _grads(_function(causal), q, k, v)
    want, want_g = _grads(_plain(causal), q, k, v)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)


@pytest.mark.parametrize("block", [1, 3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_function_gradients_over_several_blocks(monkeypatch, case, block):
    """q's gradient is a block's own: bit for bit. k's and v's are f32
    sums over the blocks, cast once: within one bf16 step of the
    checkpointed path's, whose autograd sums the same blocks."""
    q, k, v, causal = _inputs(case)
    _blocks(monkeypatch, block, q, k)
    got, (gq, gk, gv) = _grads(_function(causal), q, k, v)
    want, (wq, wk, wv) = _grads(_plain(causal), q, k, v)
    assert torch.equal(got, want)
    assert torch.equal(gq, wq)
    for a, b in ((gk, wk), (gv, wv)):
        assert float(_bf16_steps(a, b, row_floor=False).max()) <= 1.0


def test_function_backward_recomputes_each_block_once(monkeypatch):
    q, k, v, causal = _inputs("causal_rep2")
    seen = []
    block = tA._sdpa_block

    def spy(qb, rows, *args):
        seen.append((qb.shape[1], torch.is_grad_enabled()))
        return block(qb, rows, *args)
    monkeypatch.setattr(tA, "_sdpa_block", spy)
    _blocks(monkeypatch, 5, q, k)
    _grads(_function(causal), q, k, v)
    # four blocks in the forward without a gradient, then each once with
    # one, last block first
    assert seen == [(5, False)] * 3 + [(4, False), (4, True)] \
        + [(5, True)] * 3


def test_function_passes_only_the_wanted_gradients():
    q, k, v, causal = _inputs("bidir_rep2")

    def grads(fn):
        qq, vv = q.clone().requires_grad_(), v.clone().requires_grad_()
        return torch.autograd.grad(fn(qq, k, vv).float().sum(), [qq, vv])
    got = grads(_function(causal))
    want = grads(_plain(causal))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_plain_path(case):
    q, k, v, causal = _inputs(case)
    scale = tA._inv_sqrt(q.shape[-1])
    got = tK.gqa_attention(q, k, v, causal, scale, torch.float32)
    with torch.no_grad():
        want = tA._sdpa_plain(q.float(), k.float(), v.float(), causal, None)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert tK.gqa_attention(q, k, v, causal, scale).dtype == torch.bfloat16


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q, k, v, causal = _inputs("causal_rep2")
    with pytest.raises(ValueError):
        tK.gqa_attention(q.float(), k, v, causal, 0.25)
    with pytest.raises(ValueError):
        tK.gqa_attention(q, k, v, causal, 0.25, torch.float16)
    with pytest.raises(ValueError):
        tK.gqa_attention(q[..., :8], k[..., :8], v[..., :8], causal, 0.25)


# ---------------------------------------- the dry run's model of the kernel

#: (B, Sq, Sk, H, D) of the FLOP count's cases
FLOP_CASES = [(1, 7, 7, 2, 16), (2, 5, 9, 4, 16), (1, 9, 4, 2, 64),
              (3, 1, 1, 6, 80)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", FLOP_CASES)
def test_model_flops_count_the_allowed_pairs(case, causal):
    b, sq, sk, h, d = case
    allowed = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        allowed = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
    assert tK.model_flops(b, sq, sk, h, d, causal) \
        == 4 * b * h * d * int(allowed.sum())


@pytest.mark.parametrize("case", list(CASES))
def test_fake_forward_allocates_only_the_output(case):
    """On fake tensors the function's forward is the kernel's operator:
    one output of q's shape and type beyond q, k and v, and the kernel's
    model FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline.op_cost import OpCost
    b, sq, sk, h, g, d, causal = CASES[case]
    with FakeTensorMode():
        q = torch.empty(b, sq, h, d, dtype=torch.bfloat16)
        k, v = (torch.empty(b, sk, g, d, dtype=torch.bfloat16)
                for _ in range(2))
        cost = OpCost()
        cost.hold((q, k, v))
        held = cost.live_bytes
        with cost:
            out = tA._sdpa(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert cost.peak_bytes - held == 2 * b * sq * h * d
    assert cost.flops_by_op == {
        "repro.gqa_attention": tK.model_flops(b, sq, sk, h, d, causal)}


def test_fake_forward_of_a_bf16_model_counts_the_kernel_a_layer():
    """The dry run's count (``dryrun.measure`` under ``FakeTensorMode``) of
    a bf16 internlm2-1.8b-smoke forward: one kernel operator a layer, at
    its model FLOPs, and no score products of the plain path."""
    import dataclasses
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(treg.get_config("internlm2-1.8b-smoke"),
                              dtype="bfloat16")
    b, s = 2, 24
    tokens = torch.zeros(b, s, dtype=torch.long)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        got = dryrun.measure(lambda p, t: T.forward(p, cfg, t),
                             (params, tokens), 0, 0)
    hd = cfg.resolved_head_dim
    assert got["flops_by_op"]["repro.gqa_attention"] == cfg.n_layers \
        * tK.model_flops(b, s, s, cfg.n_heads, hd, True)
    assert "aten.bmm" not in got["flops_by_op"]


def test_layout_copy_only_where_the_tensor_maps_cannot_read():
    x = torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16)
    for good in (x, x[:, 2:5], x[:, :, 1:3]):
        assert tK._readable(good) is good
    bf = dict(dtype=torch.bfloat16)
    for bad in (torch.zeros(2, 8, 16, 4, **bf).transpose(2, 3),
                torch.zeros(2 * 8 * 4 * 16 + 1, **bf)[1:].view(2, 8, 4, 16),
                torch.zeros(2, 8, 4, 20, **bf)[..., :16],
                torch.zeros(2, 1, 4, 16, **bf).expand(2, 8, 4, 16)):
        got = tK._readable(bad)
        assert not tK._layout_ok(bad) and tK._layout_ok(got)
        assert torch.equal(got, bad)


# ------------------------------------------- paths that bypass the kernel

@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke",
                                  "deepseek-v2-lite-16b-smoke"])
def test_decode_and_mla_are_unchanged(monkeypatch, arch):
    """A cached decode (GQA with its validity mask) and MLA never reach the
    function; their outputs equal those of the plain path alone."""
    from repro_torch.models import transformer as T
    cfg = treg.get_config(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)))

    def decode():
        state = T.init_serve_state(params, cfg, 2, 12)
        outs = []
        with torch.no_grad():
            for t in range(tokens.shape[1]):
                logits, state = T.decode_step(params, cfg, state,
                                              tokens[:, t:t + 1])
                outs.append(logits)
        return torch.stack(outs)
    calls = _spy(monkeypatch)
    got = decode()
    assert calls == []
    if cfg.mla is not None:
        with torch.no_grad():
            T.forward(params, cfg, tokens)
        assert calls == []
    _plain_only(monkeypatch)
    assert torch.equal(got, decode())


# --------------------------------------------------------------- the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


#: (B, Sq, Sk, H, G, D, causal): head dims 16-128; groups of 1, 2, 3, 7
#: and 16 heads; lengths off the 128-key tile; Sk != Sq
CARD_CASES = [
    (1, 300, 300, 16, 8, 128, True),
    (2, 257, 257, 16, 8, 128, False),
    (1, 200, 333, 4, 2, 64, False),
    (2, 129, 129, 6, 2, 80, True),
    (1, 190, 190, 7, 1, 96, True),
    (1, 100, 61, 32, 2, 128, False),
    (2, 77, 77, 16, 1, 16, True),
    (1, 130, 130, 3, 1, 64, False),
    (1, 513, 513, 9, 3, 16, True),
    (1, 1, 1, 2, 1, 128, True),
    (3, 64, 1000, 4, 4, 96, False),
    (1, 8192, 8192, 2, 1, 128, True),
]


def _card_inputs(case, dev, seed):
    b, sq, sk, h, g, d, causal = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=dev).bfloat16()
               for s in ((b, sq, h, d), (b, sk, g, d), (b, sk, g, d)))
    return q, k, v, causal


@pytest.mark.cuda
def test_cuda_kernel_bf16_output_matches_the_plain_path():
    dev = _cuda()
    for i, case in enumerate(CARD_CASES):
        q, k, v, causal = _card_inputs(case, dev, i)
        got = tK.gqa_attention(q, k, v, causal, tA._inv_sqrt(q.shape[-1]))
        with torch.no_grad():
            want = tA._sdpa_plain(q, k, v, causal, None)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert float(_bf16_steps(got, want).max()) <= 1.0, case


def _row_errors(got, want):
    return ((got.double() - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-300))


@pytest.mark.cuda
def test_cuda_kernel_f32_output_within_2e_5_of_float64():
    """Each row's error norm over its norm within 2e-5 of a float64
    evaluation; P rounded once to bf16 (modelled here in float64) reads
    ~1e-3 on the same rows and fails."""
    dev = _cuda()
    for i, case in enumerate(CARD_CASES):
        q, k, v, causal = _card_inputs(case, dev, 100 + i)
        scale = tA._inv_sqrt(q.shape[-1])
        got = tK.gqa_attention(q, k, v, causal, scale, torch.float32)
        want = tK.gqa_attention_plain(q.double(), k.double(), v.double(),
                                      causal, scale)
        torch.cuda.synchronize()
        assert float(_row_errors(got, want).max()) <= 2e-5, case
    b, sq, h, d = 1, 512, 4, 128
    q, k, v, _ = _card_inputs((b, sq, sq, h, 2, d, True), dev, 7)
    scale = tA._inv_sqrt(d)
    want = tK.gqa_attention_plain(q.double(), k.double(), v.double(), True,
                                  scale)
    qf = q.double().reshape(b, sq, 2, 2, d)
    s = torch.einsum("bigrd,bjgd->bgrij", qf, k.double()) * scale
    s = s.masked_fill(~torch.ones(sq, sq, dtype=torch.bool,
                                  device=dev).tril(), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    once = torch.einsum("bgrij,bjgd->bigrd", p.bfloat16().double(),
                        v.double()) / p.sum(-1)[..., None].permute(
                            0, 3, 1, 2, 4)
    assert float(_row_errors(once.reshape(b, sq, h, d), want).max()) > 2e-5


@pytest.mark.cuda
def test_cuda_function_launches_once_a_call_and_the_plain_path_none(
        monkeypatch):
    dev = _cuda()
    q, k, v, causal = _card_inputs(CARD_CASES[0], dev, 0)
    tK.reset_launches()
    tA._sdpa(q, k, v, causal=causal)
    tA._sdpa(q, k, v, causal=causal)
    assert tK.LAUNCHES["gqa_attention"] == 2
    tA._sdpa_plain(q, k, v, causal, None)
    tA._sdpa(q, k, v, causal=False, kv_valid=torch.ones(
        q.shape[1], dtype=torch.bool, device=dev))
    assert tK.LAUNCHES["gqa_attention"] == 2


@pytest.mark.cuda
def test_cuda_train_step_matches_the_plain_path(monkeypatch):
    """One microbatch's loss and gradients of internlm2-1.8b-smoke (bf16,
    remat) with the kernel against the plain path: the loss within
    ``loss_gap`` 7.5e-5 and each leaf's gradient norm within ``grad_gap``
    0.045 of the larger of its own and the median leaf's (the benchmark's
    limits, bench/limits/internlm2-train.json)."""
    dev = _cuda()
    from repro_torch.models import transformer as T
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train import train_loop as TL
    cfg = treg.get_config("internlm2-1.8b-smoke")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 257))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def loss_and_norms():
        tK.reset_launches()
        loss, _, grads = TL.grads_of(params, cfg, batch)
        return (float(loss), [float(g.float().norm())
                              for g in tree_leaves(grads)],
                tK.LAUNCHES["gqa_attention"])
    got_loss, got, launches = loss_and_norms()
    _plain_only(monkeypatch)
    want_loss, want, none = loss_and_norms()
    # the forward and the block remat's recompute, every layer
    assert launches == 2 * cfg.n_layers and none == 0
    assert abs(got_loss - want_loss) / abs(want_loss) <= 7.5e-5
    med = float(np.median(want))
    assert max(abs(a - b) / max(b, med) for a, b in zip(got, want)) <= 0.045
