"""Data pipeline: deterministic, host-sharded, restart-safe token batches.

A numpy copy of the reference's pipeline (``repro.data.pipeline``): the
same generators, draws and slicing, so both packages read the same
batches. Two sources behind one iterator API:
  * ``SyntheticLM`` — seeded synthetic token streams (markov-ish structure
    so losses actually descend); used by smoke tests, examples and the
    launcher's default.
  * ``MemmapCorpus`` — file-backed uint16/uint32 token memmap (the real
    deployment shape of a pretokenized corpus), sliced per host.

Determinism contract: batch(step, host) is a pure function of
(seed, step, host) — after a restart, resuming from step k reproduces the
exact batch stream. Batches are numpy arrays; the train step moves them to
the parameters' device.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Seeded synthetic LM stream with learnable bigram structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed sparse bigram table: each token has 4 likely successors
        self._succ = rng.integers(0, v, size=(v, 4), dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id, 0xC0FFEE))
        b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choice = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapCorpus:
    """Pretokenized flat corpus on disk; host-sharded strided windows."""

    def __init__(self, path: str | pathlib.Path, cfg: DataConfig,
                 dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        idx = rng.integers(0, self.n_windows, size=cfg.global_batch)
        idx = idx[cfg.host_id::cfg.n_hosts]
        s = cfg.seq_len
        toks = np.stack([self.data[i * s:(i + 1) * s + 1] for i in idx])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def write_corpus(path: str | pathlib.Path, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.uint16).tofile(path)
