"""Byte-level tokenizer (vocab 256 + specials) for self-contained examples."""

from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, add_bos: bool = True) -> np.ndarray:
    ids = list(text.encode("utf-8"))
    if add_bos:
        ids = [BOS] + ids
    return np.array(ids, dtype=np.int32)


def decode(ids) -> str:
    return bytes(int(i) for i in ids if int(i) < 256).decode(
        "utf-8", errors="replace")


def batch_encode(texts, seq_len: int) -> np.ndarray:
    out = np.full((len(texts), seq_len), PAD, dtype=np.int32)
    for r, t in enumerate(texts):
        ids = encode(t)[:seq_len]
        out[r, :len(ids)] = ids
    return out
