"""The port's SSD scan vs the reference: the token-by-token oracle, the
chunked and the multi-head chunked forms, and the kernel module's wrappers.

Inputs are made with numpy from fixed seeds and handed to both packages.
The reference's Pallas kernel runs in interpret mode on the CPU; the
port's wrappers run their plain versions on CPU tensors. Tolerances are
those of ``tests/test_kernels.py``: 5e-4 (absolute and relative) for
float32 outputs, 5e-2 for bfloat16 outputs (one bfloat16 rounding of
values up to ~4, plus the two frameworks' different f32 summation orders).
The error that the CUDA kernel's bf16 split adds is bounded here through
a model (``ssd_scan_split_model``: the same splits on the host, not the
kernel's sum orders, so it bounds the split rather than reproducing the
kernel); the kernel itself is held against the plain version by the ``cuda``-marked
test at the end, which skips without a card.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402

TOL = {"float32": 5e-4, "bfloat16": 5e-2}


@pytest.fixture(scope="module")
def ref():
    """The reference kernels. Imported here, not at the top, so the
    ``cuda`` test below also runs on a GPU machine without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    from repro.kernels import ref as kref
    return types.SimpleNamespace(jnp=jnp, ops=ops, ref=kref)


def _round(x, dtype):
    """float32 numpy values, rounded to ``dtype`` when it is bfloat16."""
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _inputs(seed, u_shape, n, dtype="float32", shared=False):
    """u (..., L, P), log_decay (..., L) = -softplus(N(0,1)), b and c
    (rows or batch, L, N) = 0.3 N(0,1); u, b, c rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    L = u_shape[-2]
    bc_lead = u_shape[:1] if shared else u_shape[:-2]
    u = rng.standard_normal(u_shape).astype(np.float32)
    ld = -np.logaddexp(rng.standard_normal(u_shape[:-1]), 0.0)
    b = 0.3 * rng.standard_normal(bc_lead + (L, n))
    c = 0.3 * rng.standard_normal(bc_lead + (L, n))
    return (_round(u, dtype), ld.astype(np.float32),
            _round(b.astype(np.float32), dtype),
            _round(c.astype(np.float32), dtype))


def _jax(ref, arrays, dtype):
    u, ld, b, c = arrays
    dt = ref.jnp.bfloat16 if dtype == "bfloat16" else ref.jnp.float32
    return (ref.jnp.asarray(u).astype(dt), ref.jnp.asarray(ld),
            ref.jnp.asarray(b).astype(dt), ref.jnp.asarray(c).astype(dt))


def _torch(arrays, dtype):
    u, ld, b, c = (torch.from_numpy(a) for a in arrays)
    dt = getattr(torch, dtype)
    return u.to(dt), ld, b.to(dt), c.to(dt)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# the shapes of tests/test_kernels.py::test_ssd_matches_oracle
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,L,p,n,chunk", [(2, 130, 16, 8, 64),
                                            (1, 64, 32, 16, 32),
                                            (4, 257, 8, 8, 128)])
def test_ssd_scan_matches_reference(ref, bh, L, p, n, chunk, dtype):
    arrays = _inputs(L, (bh, L, p), n, dtype)
    j, t = _jax(ref, arrays, dtype), _torch(arrays, dtype)
    want_pallas = ref.ops.ssd_scan(*j, chunk=chunk, impl="pallas")
    want_oracle = ref.ref.ssd_scan(*j)
    got = tops.ssd_scan(*t, chunk=chunk)
    assert got.dtype == t[0].dtype and tuple(got.shape) == (bh, L, p)
    _close(got, want_pallas, TOL[dtype])
    _close(got, want_oracle, TOL[dtype])
    _close(tss.ssd_scan_oracle(*t), want_oracle, TOL[dtype])
    _close(tss.ssd_scan_chunked(*t, chunk=chunk), want_oracle, TOL[dtype])


@pytest.mark.parametrize("L", [1, 31, 33, 257])
def test_ssd_scan_ragged_lengths(ref, L):
    """L = 1, chunk - 1, chunk + 1 and 257 with chunk 32: the ragged last
    chunk behaves as the reference's zero padding."""
    arrays = _inputs(7 + L, (3, L, 8), 16)
    j, t = _jax(ref, arrays, "float32"), _torch(arrays, "float32")
    want = ref.ops.ssd_scan(*j, chunk=32, impl="pallas")
    got = tss.ssd_scan(*t, chunk=32)
    _close(got, want, 5e-4)
    _close(tss.ssd_scan_oracle(*t), ref.ref.ssd_scan(*j), 1e-5)


def test_ssd_decay_zero_is_cumulative_outer(ref):
    """log_decay = -30: the state resets each step, y_t = (C_t.B_t) u_t."""
    rng = np.random.default_rng(5)
    u, b, c = (rng.standard_normal((1, 32, k)).astype(np.float32)
               for k in (4, 4, 4))
    ld = np.full((1, 32), -30.0, np.float32)
    got = tss.ssd_scan(*map(torch.from_numpy, (u, ld, b, c)), chunk=16)
    want = np.einsum("zln,zln->zl", c, b)[..., None] * u
    _close(got, want, 1e-4)
    j = _jax(ref, (u, ld, b, c), "float32")
    _close(got, ref.ops.ssd_scan(*j, chunk=16, impl="pallas"), 1e-4)


def test_ssd_long_state_carry(ref):
    """Cross-chunk state carry: constant decay .9, impulse at t=0 only."""
    u = np.zeros((1, 200, 2), np.float32)
    u[0, 0] = 1.0
    b = np.ones((1, 200, 2), np.float32)
    c = np.ones((1, 200, 2), np.float32)
    ld = np.full((1, 200), np.log(0.9), np.float32)
    t = [torch.from_numpy(a) for a in (u, ld, b, c)]
    want = ref.ref.ssd_scan(*_jax(ref, (u, ld, b, c), "float32"))
    np.testing.assert_allclose(tss.ssd_scan(*t, chunk=64).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tss.ssd_scan_oracle(*t).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


# the shapes of tests/test_kernels.py::test_ssd_mh_pallas_vs_ref
@pytest.mark.parametrize("bsz,h,L,p,n", [(2, 3, 130, 16, 8),
                                         (1, 8, 64, 32, 16)])
def test_ssd_scan_mh_matches_reference(ref, bsz, h, L, p, n):
    """Heads sharing B/C: the port's head fold (rows read B and C at their
    batch row) and its plain multi-head form against the reference's
    Pallas head fold (B and C repeated per head), its multi-head chunked
    form and the per-head token-scan oracle."""
    arrays = _inputs(h * L, (bsz, h, L, p), n, shared=True)
    j, t = _jax(ref, arrays, "float32"), _torch(arrays, "float32")
    want_pallas = ref.ops.ssd_scan_mh(*j, chunk=32, impl="pallas")
    want_ref = ref.ops.ssd_scan_mh(*j, chunk=32, impl="ref")
    u, ld, b, c = arrays
    rep = [np.repeat(a[:, None], h, axis=1).reshape(bsz * h, L, n)
           for a in (b, c)]
    want_oracle = np.asarray(ref.ref.ssd_scan(
        u.reshape(bsz * h, L, p), ld.reshape(bsz * h, L),
        *rep)).reshape(bsz, h, L, p)
    for got in (tops.ssd_scan_mh(*t, chunk=32),
                tss.ssd_scan_chunked_mh(*t, chunk=32)):
        assert tuple(got.shape) == (bsz, h, L, p)
        for want in (want_pallas, want_ref, want_oracle):
            _close(got, want, 5e-4)
    # the fold is the same function as the per-row scan on repeated B/C
    folded = tss._ssd_scan(t[0].reshape(bsz * h, L, p),
                           t[1].reshape(bsz * h, L), t[2], t[3], 32, h)
    flat = tss.ssd_scan(t[0].reshape(bsz * h, L, p), t[1].reshape(bsz * h, L),
                        *(torch.from_numpy(r) for r in rep), chunk=32)
    torch.testing.assert_close(folded, flat, atol=1e-6, rtol=1e-6)


def test_plain_versions_compute_in_float64_when_given_it():
    arrays = _inputs(3, (2, 70, 4), 8)
    t32 = [torch.from_numpy(a) for a in arrays]
    t64 = [a.double() for a in t32]
    y64 = tss.ssd_scan_chunked(*t64, chunk=32)
    assert y64.dtype == torch.float64
    torch.testing.assert_close(y64, tss.ssd_scan_oracle(*t64),
                               atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(tss.ssd_scan_chunked(*t32, chunk=32),
                               y64.float(), atol=1e-5, rtol=1e-5)


def test_wrappers_validate_and_count_no_launch_on_cpu():
    tss.reset_launches()
    u, ld, b, c = _torch(_inputs(1, (4, 40, 8), 16), "float32")
    tss.ssd_scan(u, ld, b, c, chunk=16)
    tops.ssd_scan_mh(u.reshape(2, 2, 40, 8), ld.reshape(2, 2, 40), b[:2],
                     c[:2], chunk=16)
    assert tss.LAUNCHES == {"ssd_scan": 0}
    with pytest.raises(ValueError):
        tss.ssd_scan(u[0], ld, b, c)                  # u not 3-D
    with pytest.raises(ValueError):
        tss.ssd_scan(u, ld[:, :-1], b, c)             # log_decay length
    with pytest.raises(ValueError):
        tss.ssd_scan(u, ld, b[:, :, :8], c)           # b and c differ
    with pytest.raises(ValueError):
        tss._ssd_scan(u, ld, b, c, 16, heads=3)       # 4 rows, heads of 3
    with pytest.raises(ValueError):
        tss.ssd_scan(u, ld, b, c, chunk=0)


def test_kernel_limits_raise():
    """What the CUDA kernel does not take raises ``ValueError`` (checked
    here on CPU tensors; the wrapper runs the same check on CUDA ones)."""
    u, ld, b, c = _torch(_inputs(2, (2, 8, 4), 16), "float32")
    tss._check_kernel(u, ld, b, c, tss.MAX_CHUNK)
    bad = [
        (u, ld, b, c, tss.MAX_CHUNK + 1),
        (u.half(), ld, b.half(), c.half(), 16),
        (u, ld, b.bfloat16(), c.bfloat16(), 16),
        (u, ld.double(), b, c, 16),
        (u.transpose(1, 2).contiguous().transpose(1, 2), ld, b, c, 16),
    ]
    wide = torch.zeros((2, 8, tss.MAX_STATE + 1))
    bad.append((u, ld, wide, wide, 16))
    for args in bad:
        with pytest.raises(ValueError):
            tss._check_kernel(*args)


# (rows, heads, L, P, N, chunk): the mamba2-780m prefill call's P, N and
# chunk at a few rows, and the smoke shape
SPLIT_SHAPES = [(8, 4, 300, 64, 128, 128), (4, 4, 2048, 64, 128, 128),
                (16, 8, 70, 16, 16, 32)]


def _kernel_gate(got, want, dtype):
    """The kernel's tolerance, elementwise, with s = max |reference|:
    float32 |y - ref| <= 5e-4 s; bfloat16 |y - ref| <= 2^-8 |ref| + 1e-4 s.
    Returns (all within it, max |y - ref| / s)."""
    err = (got.double() - want).abs()
    s = want.abs().max()
    if dtype == "float32":
        ok = err <= 5e-4 * s
    else:
        ok = err <= 2.0 ** -8 * want.abs() + 1e-4 * s
    return bool(ok.all()), float(err.max() / s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,heads,L,p,n,chunk", SPLIT_SHAPES)
def test_split_model_within_kernel_gates(rows, heads, L, p, n, chunk, dtype):
    """The kernel's split model (operands split into bf16 terms where
    the kernel splits them) against the float64 chunked form: within the
    kernel's gates, and for float32 inputs no further from it than twice
    the plain float32 chunked form (whose error is the float32 cumsum of
    the log decays, as the kernel's)."""
    u, ld, b, c = _torch(_inputs(rows + L, (rows, L, p), n, dtype), dtype)
    b, c = b[:rows // heads], c[:rows // heads]
    got = tss.ssd_scan_split_model(u, ld, b, c, chunk, heads)
    want = tss._ssd_scan_plain(u.double(), ld.double(), b.double(),
                               c.double(), chunk, heads)
    assert got.dtype == u.dtype and got.shape == u.shape
    ok, rel = _kernel_gate(got, want, dtype)
    assert ok, rel
    if dtype == "float32":
        plain = tss._ssd_scan_plain(u, ld, b, c, chunk, heads)
        assert rel <= 2 * _kernel_gate(plain, want, dtype)[1], rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_one_term_fails_the_gate(dtype):
    """The split is what keeps the kernel within its gates: with every
    operand rounded once to bf16 (one term), the model fails them."""
    rows, heads, L, p, n, chunk = SPLIT_SHAPES[0]
    u, ld, b, c = _torch(_inputs(rows + L, (rows, L, p), n, dtype), dtype)
    b, c = b[:rows // heads], c[:rows // heads]
    got = tss._split_model(u, ld, b, c, chunk, heads, 1, 1)
    want = tss._ssd_scan_plain(u.double(), ld.double(), b.double(),
                               c.double(), chunk, heads)
    assert not _kernel_gate(got, want, dtype)[0]


def _f64_reference(u, ld, b, c, chunk, heads):
    return tss._ssd_scan_plain(u.double(), ld.double(), b.double(),
                               c.double(), chunk, heads)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The kernel on the card against the plain version in float64 from
    the same inputs: bf16 and f32, heads sharing B/C, the mamba2-780m
    prefill call (ragged L too), ragged L, P past one tile and P not a
    multiple of the 16-wide MMA tile beside a tile edge, small and maximal
    chunk and state, a chunk the kernel splits (100: it takes at most
    ``KERNEL_CHUNK`` positions at a time), log_decay -30. Tolerance, elementwise, with
    s = max |reference|: float32 output |y - ref| <= 5e-4 s; bfloat16
    output |y - ref| <= 2^-8 |ref| + 1e-4 s (one bf16 rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    cases = [  # rows, heads, L, P, N, chunk, dtype
        (192, 48, 2048, 64, 128, 128, "bfloat16"),
        (192, 48, 2047, 64, 128, 128, "bfloat16"),
        (192, 48, 2048, 64, 128, 128, "float32"),
        (4, 2, 300, 24, 128, 128, "bfloat16"),
        (4, 2, 300, 72, 128, 128, "float32"),
        (6, 3, 200, 72, 64, 64, "bfloat16"),
        (4, 2, 300, 64, 128, 100, "bfloat16"),
        (4, 2, 300, 64, 128, 128, "float32", -30.0),
        (4, 2, 300, 64, 128, 128, "bfloat16", -30.0),
        (8, 4, 300, 64, 128, 128, "bfloat16"),
        (6, 3, 257, 64, 128, 128, "float32"),
        (4, 1, 1, 16, 16, 32, "float32"),
        (4, 2, 127, 100, 8, 128, "bfloat16"),
        (2, 2, 129, 130, 16, 128, "float32"),
        (3, 1, 200, 2, 2, 64, "float32"),
        (16, 8, 70, 16, 16, 32, "bfloat16"),
        (2, 1, 96, 8, 4, 16, "float32"),
        (2, 1, 50, 8, 20, 20, "float32"),
    ]
    for i, (rows, heads, L, p, n, chunk, dtype, *decay) in enumerate(cases):
        u, ld, b, c = _torch(_inputs(i, (rows, L, p), n, dtype), dtype)
        b, c = b[:rows // heads], c[:rows // heads]
        if decay:
            ld = torch.full_like(ld, decay[0])
        u, ld, b, c = (a.to(dev) for a in (u, ld, b, c))
        got = tss._ssd_scan(u, ld, b, c, chunk, heads)
        want = _f64_reference(u, ld, b, c, chunk, heads)
        torch.cuda.synchronize()
        assert got.dtype == u.dtype and got.shape == u.shape
        ok, rel = _kernel_gate(got, want, dtype)
        assert ok, (i, rel)
