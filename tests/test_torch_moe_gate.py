"""The port's MoE router gate vs the reference: the plain PyTorch version
against the reference's ``lax.top_k`` oracle (``kernels/ref.py``) and its
Pallas kernel in interpret mode, the wrappers' checks, and the CUDA kernel
against the plain version on the card.

Logits are made with numpy from fixed seeds and handed to both packages.
Expert ids must be equal, ties included (ties go to the lowest id);
probabilities agree within 1e-6 absolute, the reference's own tolerance
(``tests/test_kernels.py``).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.kernels import moe_gate as tmg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [(7, 8, 2), (300, 64, 6), (1000, 128, 2)]


@pytest.fixture(scope="module")
def ref():
    """The reference gate. Imported here, not at the top, so the ``cuda``
    test below also runs on a GPU machine without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    from repro.kernels import ref as kref
    return types.SimpleNamespace(jnp=jnp, ops=ops, ref=kref)


def _logits(seed, t, e, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((t, e))).astype(np.float32)


def _ties(seed, t, e):
    """Integers in [-2, 2]: most rows hold long runs of equal logits."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2, 3, (t, e)).astype(np.float32)


def _edge_rows(e):
    """Rows that test the kernel's keys and masking: all logits equal; a
    top pair of -0.0 (lower id) and +0.0, which compare equal; logits below
    -1e30 but for two, so the third pick on is a masked expert taken
    again, as the reference's kernel does."""
    rng = np.random.default_rng(e)
    equal = np.full(e, 0.25, np.float32)
    zeros = -1.0 - rng.random(e).astype(np.float32)
    zeros[1], zeros[4] = -0.0, 0.0
    low = (-2e30 * (1.0 + rng.random(e))).astype(np.float32)
    low[e - 1], low[e // 2] = 1.0, 0.5
    return np.stack([equal, zeros, low])


def _assert_same(got, want):
    p, i = got
    wp, wi = (np.asarray(a) for a in want)
    assert p.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_allclose(p.numpy(), wp, atol=1e-6, rtol=0)


@pytest.mark.parametrize("t,e,k", SHAPES)
@pytest.mark.parametrize("renorm", [True, False])
def test_plain_matches_reference_oracle_and_pallas(ref, t, e, k, renorm):
    x = _logits(t + e, t, e)
    got = tmg.moe_gate_topk_plain(torch.from_numpy(x), k, renorm)
    jx = ref.jnp.asarray(x)
    _assert_same(got, ref.ref.moe_gate_topk(jx, k, renorm))
    _assert_same(got, ref.ops.moe_gate_topk(jx, k, renorm, impl="pallas"))
    # the wrapper and ``ops`` on CPU tensors run the plain version
    _assert_same(tops.moe_gate_topk(torch.from_numpy(x), k, renorm),
                 tuple(a.numpy() for a in got))


@pytest.mark.parametrize("renorm", [True, False])
def test_ties_go_to_the_lowest_id(ref, renorm):
    """Tie-heavy logits: ids equal to the Pallas kernel's (and the
    oracle's), every row's picks in (value desc, id asc) order."""
    x = _ties(5, 257, 64)
    p, i = tmg.moe_gate_topk_plain(torch.from_numpy(x), 6, renorm)
    jx = ref.jnp.asarray(x)
    _assert_same((p, i), ref.ops.moe_gate_topk(jx, 6, renorm,
                                                impl="pallas"))
    _assert_same((p, i), ref.ref.moe_gate_topk(jx, 6, renorm))
    ids = i.numpy()
    vals = np.take_along_axis(x, ids, axis=1)
    assert (np.diff(vals, axis=1) <= 0).all()
    same = np.diff(vals, axis=1) == 0
    assert same.any() and (np.diff(ids, axis=1)[same] > 0).all()


@pytest.mark.parametrize("e", [8, 33, 64])
def test_edge_rows_match_reference(ref, e):
    """Equal logits, a -0.0/+0.0 top pair (the lower id first) and logits
    below -1e30 (a masked expert picked again): the plain version gives
    the reference kernel's ids and probabilities. The reference's
    ``lax.top_k`` oracle differs from its own kernel on the last two rows
    (it orders -0.0 below +0.0 and never picks an expert twice); the port
    follows the kernel."""
    x = _edge_rows(e)
    got = tmg.moe_gate_topk_plain(torch.from_numpy(x), min(6, e), True)
    jx = ref.jnp.asarray(x)
    _assert_same(got, ref.ops.moe_gate_topk(jx, min(6, e), True,
                                            impl="pallas"))
    _assert_same((got[0][:1], got[1][:1]),
                 ref.ref.moe_gate_topk(jx[:1], min(6, e), True))
    ids = got[1].numpy()
    assert ids[1, :2].tolist() == [1, 4]
    assert ids[2].tolist() == [e - 1] + [e // 2] * (min(6, e) - 1)


def test_large_logits_and_one_row(ref):
    """Logits of magnitude 80 (exp would overflow without the max shift)
    and a single row."""
    for x in (_logits(9, 33, 64, scale=80.0), _logits(10, 1, 64)):
        got = tmg.moe_gate_topk_plain(torch.from_numpy(x), 6, True)
        assert bool(torch.isfinite(got[0]).all())
        _assert_same(got, ref.ops.moe_gate_topk(ref.jnp.asarray(x), 6, True,
                                                impl="pallas"))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 16),
       renorm=st.booleans())
def test_probs_valid(seed, k, renorm):
    x = torch.from_numpy(_logits(seed, 64, 16, scale=3.0))
    p, i = tmg.moe_gate_topk(x, k, renorm)
    p, i = p.numpy(), i.numpy()
    assert (p >= 0).all() and (p <= 1.0 + 1e-6).all()
    assert (np.diff(p, axis=1) <= 1e-7).all()           # descending
    full = torch.softmax(x, dim=-1).numpy()
    want = np.take_along_axis(full, i, axis=1)
    if renorm:
        np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)
        want = want / want.sum(-1, keepdims=True)
    np.testing.assert_allclose(p, want, atol=1e-6)
    assert all(len(set(row)) == k for row in i)          # distinct experts
    assert ((i >= 0) & (i < 16)).all()


def test_plain_version_computes_in_float64_when_given_it():
    x = torch.from_numpy(_logits(3, 10, 8)).double()
    p, i = tmg.moe_gate_topk_plain(x, 3)
    assert p.dtype == torch.float64 and i.dtype == torch.int32
    p32, i32 = tmg.moe_gate_topk_plain(x.float(), 3)
    assert torch.equal(i, i32)
    np.testing.assert_allclose(p.numpy(), p32.numpy(), atol=1e-6)


def test_refusals_and_no_launch_on_cpu():
    x = torch.from_numpy(_logits(4, 5, 8))
    tmg.reset_launches()
    for bad_k in (0, -1, 9):
        with pytest.raises(ValueError):
            tmg.moe_gate_topk(x, bad_k)
    with pytest.raises(ValueError):
        tmg.moe_gate_topk(x[0], 2)                       # not (T, E)
    p, i = tmg.moe_gate_topk(x[:0], 2)                   # no tokens
    assert p.shape == (0, 2) and i.shape == (0, 2)
    p, i = tmg.moe_gate_topk(x, 8)                       # k = E
    assert sorted(i[0].tolist()) == list(range(8))
    assert tmg.LAUNCHES["moe_gate_topk"] == 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The kernel on the card against the plain version on the same
    inputs: the reference's shapes both ways, one row, a row count that is
    not a multiple of the block's 8 rows, ties, logits of magnitude 80, E
    of 1, 32, 33 and the cap; E of 8, 33, 64, 160 and 256 at T of 1, 6 and
    8,193 with k of 1, 6 and E; rows of equal logits, a -0.0/+0.0 top pair
    and logits below -1e30 (:func:`_edge_rows`); ids bit-exact,
    probabilities within 1e-6.
    Above the cap, and for logits that are not float32, it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    cases = [(t, e, k, renorm, _logits(t + e, t, e))
             for t, e, k in SHAPES for renorm in (True, False)]
    cases += [(1, 64, 6, True, _logits(1, 1, 64)),
              (8195, 64, 6, True, _logits(2, 8195, 64)),
              (301, 64, 6, True, _ties(3, 301, 64)),
              (301, 128, 2, False, _ties(4, 301, 128)),
              (77, 64, 6, True, _logits(5, 77, 64, scale=80.0)),
              (9, 1, 1, True, _logits(6, 9, 1)),
              (9, 32, 32, True, _logits(7, 9, 32)),
              (9, 33, 5, False, _logits(8, 9, 33)),
              (40, tmg.MAX_EXPERTS, 8, True,
               _logits(9, 40, tmg.MAX_EXPERTS))]
    for e in (8, 33, 64, 160, 256):
        for t in (1, 6, 8193):
            for k in sorted({1, min(6, e), e}):
                cases.append((t, e, k, k % 2 == 0, _logits(t * e + k, t, e)))
        edge = _edge_rows(e)
        for k in sorted({min(6, e), e}):
            for renorm in (True, False):
                cases.append((len(edge), e, k, renorm, edge))
    tmg.reset_launches()
    for t, e, k, renorm, x in cases:
        xd = torch.from_numpy(x).to(dev)
        p, i = tmg.moe_gate_topk(xd, k, renorm)
        wp, wi = tmg.moe_gate_topk_plain(xd, k, renorm)
        torch.cuda.synchronize()
        assert torch.equal(i, wi), (t, e, k, renorm)
        assert float((p - wp).abs().max()) <= 1e-6, (t, e, k, renorm)
    assert tmg.LAUNCHES["moe_gate_topk"] == len(cases)
    with pytest.raises(ValueError):
        tmg.moe_gate_topk(torch.zeros((4, tmg.MAX_EXPERTS + 1), device=dev),
                          2)
    with pytest.raises(ValueError):
        tmg.moe_gate_topk(torch.zeros((4, 8), device=dev,
                                      dtype=torch.bfloat16), 2)
