"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's: every batch bit-exact — the synthetic stream and the memmap
corpus, host sharding included — and the corpus files byte-equal."""

import numpy as np
import pytest

from repro.data import pipeline as jDP
from repro_torch.data import pipeline as tDP


def _equal(a, b):
    assert set(a) == set(b) == {"tokens", "labels"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (3, 1), (7, 4)])
def test_synthetic_batches_equal_the_reference(seed, n_hosts):
    for host in range(n_hosts):
        kw = dict(seq_len=33, global_batch=8, vocab_size=97, seed=seed,
                  n_hosts=n_hosts, host_id=host)
        got, want = tDP.SyntheticLM(tDP.DataConfig(**kw)), \
            jDP.SyntheticLM(jDP.DataConfig(**kw))
        np.testing.assert_array_equal(got._succ, want._succ)
        for step in (0, 1, 5, 1000):
            _equal(got.batch(step), want.batch(step))
            assert got.batch(step)["tokens"].shape == (8 // n_hosts, 33)
        for a, b, _ in zip(got, want, range(3)):
            _equal(a, b)


def test_synthetic_batch_is_a_pure_function_of_seed_step_host():
    cfg = tDP.DataConfig(seq_len=16, global_batch=4, vocab_size=50, seed=1)
    a, b = tDP.SyntheticLM(cfg), tDP.SyntheticLM(cfg)
    _equal(a.batch(9), b.batch(9))
    np.testing.assert_array_equal(a.batch(9)["tokens"][:, 1:],
                                  a.batch(9)["labels"][:, :-1])
    assert not np.array_equal(a.batch(9)["tokens"], a.batch(10)["tokens"])
    with pytest.raises(ValueError):
        tDP.DataConfig(seq_len=4, global_batch=6, vocab_size=8,
                       n_hosts=4).host_batch


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_memmap_batches_equal_the_reference(tmp_path, n_hosts):
    toks = np.random.default_rng(0).integers(0, 60000, 5000)
    tDP.write_corpus(tmp_path / "t.bin", toks)
    jDP.write_corpus(tmp_path / "j.bin", toks)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    for host in range(n_hosts):
        kw = dict(seq_len=64, global_batch=6, vocab_size=60000, seed=2,
                  n_hosts=n_hosts, host_id=host)
        got = tDP.MemmapCorpus(tmp_path / "t.bin", tDP.DataConfig(**kw))
        want = jDP.MemmapCorpus(tmp_path / "j.bin", jDP.DataConfig(**kw))
        assert got.n_windows == want.n_windows == 4999 // 64
        for step in (0, 3, 17):
            _equal(got.batch(step), want.batch(step))
        for a, b, _ in zip(got, want, range(2)):
            _equal(a, b)
