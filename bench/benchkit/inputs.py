"""Inputs from the seed: the weights' generator and the token ids, made
on the device. The same seed gives the same inputs; each unit of work
(a step, a forward) has its own stream, so the inputs of unit ``i`` can
be made again after the window without replaying the others."""

from __future__ import annotations

import hashlib
import json
from typing import Tuple

import torch


def derive(seed: int, *parts) -> int:
    """A 60-bit generator seed from ``seed`` (any whole number) and the
    stream's name ``parts``."""
    digest = hashlib.sha256(json.dumps([int(seed), *parts]).encode())
    return int(digest.hexdigest()[:15], 16)


def generator(device, seed: int, *parts) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive(seed, *parts))
    return gen


def token_batch(seed: int, index: int, rows: int, seq: int, vocab: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels), each (rows, seq) int64: ``seq + 1`` ids a row,
    uniform over the vocabulary, the labels shifted by one."""
    ids = torch.randint(0, vocab, (rows, seq + 1), device=device,
                        generator=generator(device, seed, "tokens", index))
    return ids[:, :-1], ids[:, 1:]
