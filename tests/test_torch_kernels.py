"""Port RNL kernels vs the reference Pallas kernels, bit for bit.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
reference kernels run in the Pallas interpreter on the CPU. Inputs are made
with numpy from fixed seeds and handed to both packages. The CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked test
at the end, which skips without a card.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compaction  # noqa: E402
from repro_torch.kernels import rnl_neuron as trn  # noqa: E402

NO_SPIKE = 2**30


@pytest.fixture(scope="module")
def ref():
    """The reference kernels and compaction. Imported here, not at the top,
    so the ``cuda`` test below also runs on a GPU machine without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import compaction
    from repro.kernels import rnl_neuron
    return types.SimpleNamespace(jnp=jnp, rn=rnl_neuron,
                                 compaction=compaction)


def _volleys(rng, shape, t_steps, silent=0.4):
    """Spike times in [0, t_steps + 3) — some at or past the cycle end —
    with a ``silent`` share of NO_SPIKE lines."""
    t = rng.integers(0, t_steps + 3, shape)
    return np.where(rng.random(shape) < silent, NO_SPIKE, t).astype(np.int32)


def _weights(rng, shape, lo=-2, hi=8):
    """Integer weights including negative and zero ones."""
    return rng.integers(lo, hi, shape).astype(np.int32)


def _both(ref, jfn, tfn, times, weights, **kw):
    want = jfn(ref.jnp.asarray(times), ref.jnp.asarray(weights), **kw)
    got = tfn(torch.tensor(times), torch.tensor(weights), **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    return got


# (B, Q, n, t_steps, threshold, k): ragged B/Q (not multiples of 8),
# threshold <= 0, t_steps of 0 and 1, dense and clipped dendrites
BANK_CASES = [
    (5, 3, 12, 16, 6, 2),
    (9, 11, 20, 24, 9, None),
    (13, 7, 16, 20, 0, 2),
    (6, 5, 10, 12, -3, None),
    (4, 3, 8, 0, 3, 2),
    (4, 3, 8, 1, 1, None),
    (3, 2, 8, 1, 0, 1),
]


@pytest.mark.parametrize("with_clip", [False, True])
@pytest.mark.parametrize("bsz,q,n,t_steps,threshold,k", BANK_CASES)
def test_bank_matches_reference(ref, bsz, q, n, t_steps, threshold, k,
                                with_clip):
    rng = np.random.default_rng(bsz * 100 + n)
    times = _volleys(rng, (bsz, n), max(t_steps, 4))
    w = _weights(rng, (q, n))
    _both(ref, ref.rn.rnl_fire_times, trn.rnl_fire_times, times, w, t_steps=t_steps,
          threshold=threshold, k=k, with_clip=with_clip)


@pytest.mark.parametrize("with_clip", [False, True])
@pytest.mark.parametrize("c,bsz,q,n,t_steps,threshold,k", [
    (3, 5, 3, 12, 16, 6, 2),
    (2, 9, 11, 20, 24, 9, None),
    (2, 7, 5, 10, 12, 0, 1),
])
def test_layer_matches_reference(ref, c, bsz, q, n, t_steps, threshold, k,
                                 with_clip):
    rng = np.random.default_rng(c * 1000 + bsz)
    times = _volleys(rng, (c, bsz, n), t_steps)
    w = _weights(rng, (c, q, n))
    _both(ref, ref.rn.rnl_fire_times_layer, trn.rnl_fire_times_layer, times, w,
          t_steps=t_steps, threshold=threshold, k=k, with_clip=with_clip)


@pytest.mark.parametrize("bsz,q,n,t_steps,threshold,k", [
    (7, 5, 24, 20, 5, 2),
    (10, 3, 16, 16, 7, None),
    (5, 4, 12, 12, 0, 2),
])
def test_compact_matches_reference(ref, bsz, q, n, t_steps, threshold, k):
    rng = np.random.default_rng(bsz + 7 * n)
    times = _volleys(rng, (bsz, n), t_steps, silent=0.7)
    w = _weights(rng, (q, n))
    comp = ref.compaction.compact_volleys(ref.jnp.asarray(times), t_steps)
    w_c = np.asarray(ref.compaction.gather_weights(ref.jnp.asarray(w),
                                                   comp.line_index))
    ct = np.asarray(comp.times)
    got = _both(ref, ref.rn.rnl_fire_times_compact, trn.rnl_fire_times_compact, ct,
                w_c, t_steps=t_steps, threshold=threshold, k=k)
    # bit-exact vs the uncompacted bank too: dropped lines are inert
    bank = trn.rnl_fire_times(torch.from_numpy(times), torch.from_numpy(w),
                              t_steps=t_steps, threshold=threshold, k=k)
    torch.testing.assert_close(got[0], bank, rtol=0, atol=0)


def test_all_silent_volleys_never_fire(ref):
    times = np.full((3, 9), NO_SPIKE, np.int32)
    w = np.full((4, 9), 7, np.int32)
    got = _both(ref, ref.rn.rnl_fire_times, trn.rnl_fire_times, times, w,
                t_steps=16, threshold=1, k=2, with_clip=True)
    assert (got[0] == NO_SPIKE).all() and (got[1] == 0).all()


def test_zero_and_negative_weights_are_inert(ref):
    times = np.zeros((2, 6), np.int32)
    w = np.array([[0, 0, 0, 0, 0, 0], [-5, -1, 0, -7, 0, -2]], np.int32)
    got = _both(ref, ref.rn.rnl_fire_times, trn.rnl_fire_times, times, w,
                t_steps=16, threshold=1, k=None)
    assert (got[0] == NO_SPIKE).all()


def test_spikes_at_or_past_cycle_end_are_inert(ref):
    times = np.array([[8, 9, 100, NO_SPIKE]], np.int32)
    w = np.full((2, 4), 7, np.int32)
    got = _both(ref, ref.rn.rnl_fire_times, trn.rnl_fire_times, times, w,
                t_steps=8, threshold=2, k=2)
    assert (got[0] == NO_SPIKE).all()


@pytest.mark.parametrize("entry,with_clip", [
    ("bank", False), ("bank", True), ("layer", False), ("layer", True),
    ("compact", False)])
def test_reference_and_plain_agree_past_the_old_line_cap(ref, entry,
                                                         with_clip):
    """n = 2,048 lines (compact: 1,024 active), past the shared-memory caps
    the CUDA launchers once had (450 lines at Q = 1 and B >= 128, 1,614 at
    Q >= 32, 454 compacted lines at Q = 1): the reference computes these
    banks, and the port's plain version agrees with it bit for bit."""
    rng = np.random.default_rng(2048 + with_clip)
    bsz, q, n, t_steps = 4, 2, 2048, 16
    kw = dict(t_steps=t_steps, threshold=150, k=40)

    def weights(shape):
        """The last neuron keeps ~1 % of its lines: it stays silent."""
        w = _weights(rng, shape)
        w[..., -1, :] *= rng.random(shape[-1]) < 0.01
        return w

    if entry == "bank":
        got = _both(ref, ref.rn.rnl_fire_times, trn.rnl_fire_times,
                    _volleys(rng, (bsz, n), t_steps), weights((q, n)),
                    with_clip=with_clip, **kw)
    elif entry == "layer":
        got = _both(ref, ref.rn.rnl_fire_times_layer,
                    trn.rnl_fire_times_layer,
                    _volleys(rng, (2, bsz, n), t_steps),
                    weights((2, q, n)), with_clip=with_clip, **kw)
    else:
        times = _volleys(rng, (bsz, n), t_steps, silent=0.5)
        comp = ref.compaction.compact_volleys(ref.jnp.asarray(times), t_steps)
        ct = np.asarray(comp.times)[:, :1024]
        assert (np.asarray(comp.times)[:, 1024:] >= t_steps).all()
        w_c = np.asarray(ref.compaction.gather_weights(
            ref.jnp.asarray(weights((q, n))), comp.line_index))
        got = _both(ref, ref.rn.rnl_fire_times_compact,
                    trn.rnl_fire_times_compact, ct, w_c[:, :, :1024], **kw)
    fired = got[0] < NO_SPIKE
    assert fired.any() and not fired.all()
    if with_clip:
        assert (got[1] > 0).any()


def test_wrappers_reject_bad_operands():
    t = torch.zeros((2, 4), dtype=torch.int32)
    w = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        trn.rnl_fire_times(t.long(), w, t_steps=4, threshold=1)
    with pytest.raises(ValueError):
        trn.rnl_fire_times(t, w[:, :3], t_steps=4, threshold=1)
    with pytest.raises(ValueError):
        trn.rnl_fire_times_layer(t, w, t_steps=4, threshold=1)
    with pytest.raises(ValueError):
        trn.rnl_fire_times_compact(t, w, t_steps=4, threshold=1)
    with pytest.raises(ValueError):
        trn.rnl_fire_times(t, w, t_steps=4, threshold=1, k=-1)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    trn.reset_launches()
    rng = np.random.default_rng(3)
    t = torch.from_numpy(_volleys(rng, (2, 5, 8), 10))
    w = torch.from_numpy(_weights(rng, (2, 3, 8)))
    got = trn.rnl_fire_times_layer(t, w, t_steps=10, threshold=4, k=2)
    want = trn.rnl_fire_times_layer_plain(t, w, t_steps=10, threshold=4, k=2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(n == 0 for n in trn.LAUNCHES.values())


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Every launch variant on the card against its plain version there
    (bit-exact), including ragged B/Q and threshold <= 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for c, bsz, q, n, t_steps, threshold, k in [
            (3, 13, 11, 20, 24, 7, 2), (2, 64, 12, 28, 32, 10, 3),
            (1, 9, 5, 16, 16, 0, None), (4, 33, 40, 16, 64, 9, 2)]:
        times = torch.from_numpy(_volleys(rng, (c, bsz, n), t_steps)).to(dev)
        w = torch.from_numpy(_weights(rng, (c, q, n))).to(dev)
        kw = dict(t_steps=t_steps, threshold=threshold, k=k)
        for with_clip in (False, True):
            got = trn.rnl_fire_times_layer(times, w, with_clip=with_clip,
                                           **kw)
            want = trn.rnl_fire_times_layer_plain(times, w,
                                                  with_clip=with_clip, **kw)
            for g, r in zip(got if with_clip else (got,),
                            want if with_clip else (want,)):
                torch.testing.assert_close(g, r, rtol=0, atol=0)
            got = trn.rnl_fire_times(times[0], w[0], with_clip=with_clip,
                                     **kw)
            want = trn.rnl_fire_times_plain(times[0], w[0],
                                            with_clip=with_clip, **kw)
            for g, r in zip(got if with_clip else (got,),
                            want if with_clip else (want,)):
                torch.testing.assert_close(g, r, rtol=0, atol=0)
        comp = _compact(times[0], w[0], t_steps)
        got = trn.rnl_fire_times_compact(*comp, **kw)
        want = trn.rnl_fire_times_compact_plain(*comp, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.cuda.synchronize()


def _match_on_card(fn, plain, *args, **kw):
    got, want = fn(*args, **kw), plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, r in zip(got, want):
        assert g.dtype == torch.int32
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    return got


@pytest.mark.cuda
def test_cuda_kernels_past_the_old_caps():
    """Sizes the launchers once refused: n = 2,048 lines at (B, Q) =
    (128, 1) and (256, 64), layer and bank (shared memory grew with n);
    compact over s = 1,024 lines at Q = 1, B = 256; T = 64, and T = 1 with
    threshold <= 0; clip output on and off; and a layer call of 262,148
    volleys at Q = 32 (past the 65,535-tile grid limit). Bit-exact against
    the plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    trn.reset_launches()
    for bsz, q in ((128, 1), (256, 64)):
        times = torch.from_numpy(_volleys(rng, (2, bsz, 2048), 64)).to(dev)
        w = torch.from_numpy(_weights(rng, (2, q, 2048))).to(dev)
        for t_steps, threshold, k in ((64, 2000, 40), (64, 1500, None),
                                      (1, 0, 2), (1, -4, None)):
            kw = dict(t_steps=t_steps, threshold=threshold, k=k)
            for with_clip in (False, True):
                _match_on_card(trn.rnl_fire_times_layer,
                               trn.rnl_fire_times_layer_plain, times, w,
                               with_clip=with_clip, **kw)
                _match_on_card(trn.rnl_fire_times, trn.rnl_fire_times_plain,
                               times[0], w[0], with_clip=with_clip, **kw)
    dense = torch.from_numpy(_volleys(rng, (256, 2400), 64, silent=0.5))
    comp = _compact(dense.to(dev), torch.from_numpy(
        _weights(rng, (1, 2400))).to(dev), 64)
    assert comp[0].shape[1] >= 1024
    for threshold, k in ((300, 20), (0, None)):
        _match_on_card(trn.rnl_fire_times_compact,
                       trn.rnl_fire_times_compact_plain, *comp, t_steps=64,
                       threshold=threshold, k=k)
    many = torch.from_numpy(_volleys(rng, (1, 262_148, 4), 8)).to(dev)
    w32 = torch.from_numpy(_weights(rng, (1, 32, 4))).to(dev)
    for with_clip in (False, True):
        fire = _match_on_card(trn.rnl_fire_times_layer,
                              trn.rnl_fire_times_layer_plain, many, w32,
                              t_steps=8, threshold=3, k=1,
                              with_clip=with_clip)[0]
        assert bool((fire[0, 262_140:] < NO_SPIKE).any())
    torch.cuda.synchronize()
    assert trn.LAUNCHES == {"rnl_fire_times": 16, "rnl_fire_times_layer": 18,
                            "rnl_fire_times_compact": 2}


def _compact(times, w, t_steps):
    comp = compaction.compact_volleys(times, t_steps)
    return (comp.times.contiguous(),
            compaction.gather_weights(w, comp.line_index).contiguous())
