"""Batched LM serving engine, ssm family: static lockstep decoding.

The ssm family's decode state is a recurrence per row, not a positional
KV cache, so it is served by the static wave path: all prompts are
prefilled together, left-aligned with an in-vocab filler after each
prompt, token by token through the cached ``decode_step`` (the exact
one-token recurrence), then one token is sampled per step for every live
slot; slots retire on EOS or budget and are not re-filled. Continuous
batching over per-slot KV-cache positions (the reference's ``serve`` for
attention families) comes with the attention slice (ROADMAP, Queue 1).

Greedy decoding takes the first maximum of the float32 logits, as the
reference does, and so matches it token for token. Temperature sampling
draws from a ``torch.Generator`` seeded from ``ServeConfig.seed``: it is
deterministic for a seed but cannot reproduce ``jax.random``'s draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokenizer as tok
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.slots import SlotPool


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0        # 0 = greedy
    eos_id: int = tok.EOS
    seed: int = 0


@dataclasses.dataclass
class LMRequest:
    """One prompt's bookkeeping through the slot pool."""

    req_id: int
    prompt: np.ndarray              # (len,) int32 token ids
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)


def _to_device(params: Dict[str, Any], device: torch.device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


class Engine:
    """LM engine over ``params`` on ``device`` (``None`` = ``cuda``; raises
    when CUDA is absent); parameters elsewhere are copied there."""

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.scfg = scfg
        # filler token for rows past their prompt: must be in-vocab —
        # smoke configs cap vocab below tok.PAD, and an out-of-vocab id
        # cannot be looked up
        self._fill = int(min(tok.PAD, cfg.vocab_size - 1))
        # decode steps of the last generate() call
        self.n_steps = 0

    @property
    def _per_slot_ok(self) -> bool:
        """Families whose decode state re-fills per slot (KV caches)."""
        return self.cfg.family not in ("ssm", "hybrid", "audio")

    def generate(self, prompts: List[np.ndarray],
                 max_new_tokens: int = 32) -> List[np.ndarray]:
        """Generate continuations for ``prompts``; results in order.

        ssm / hybrid / audio keep the static lockstep path
        (:meth:`_generate_static`); attention families route through
        :meth:`serve`."""
        if not self._per_slot_ok:
            return self._generate_static(prompts, max_new_tokens)
        return self.serve(prompts, max_new_tokens, n_slots=len(prompts))

    def serve(self, prompts: List[np.ndarray], max_new_tokens: int = 32, *,
              n_slots: int | None = None,
              continuous: bool = True) -> List[np.ndarray]:
        """Slot-based decode with per-slot cache positions: refused for
        families served statically (``ValueError``, as the reference's
        ``per_slot_state``); not ported yet for attention families."""
        del max_new_tokens, continuous
        b = len(prompts) if n_slots is None else int(n_slots)
        if b < 1:
            raise ValueError(f"need at least one slot, got {b}")
        if not self._per_slot_ok:
            raise ValueError(
                "per-slot positions need attention KV caches; the "
                f"{self.cfg.family!r} family is served statically")
        raise NotImplementedError(
            "continuous serving of attention families comes with the "
            "attention slice of the port (ROADMAP, Queue 1)")

    def _generate_static(self, prompts: List[np.ndarray],
                         max_new_tokens: int = 32) -> List[np.ndarray]:
        """Static lockstep batching: all prompts prefilled together
        left-aligned (in-vocab filler after each), one token per step for
        every live slot, per-slot retirement without re-fill."""
        b = len(prompts)
        scfg = self.scfg
        for r, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError(f"empty prompt (request {r})")
        max_prompt = max(len(p) for p in prompts)
        state = T.init_serve_state(self.params, self.cfg, b, scfg.max_len)

        # one slot per request; FIFO admission puts prompt r into slot r,
        # matching batch row r of the decode state
        pool: SlotPool[int, None] = SlotPool(b)
        for r in range(b):
            pool.submit(r)
        pool.admit()

        mat = np.full((b, max_prompt), self._fill, np.int32)
        for r, p in enumerate(prompts):
            mat[r, :len(p)] = p
        gen = torch.Generator().manual_seed(scfg.seed)
        outs: List[List[int]] = [[] for _ in range(b)]
        logits = None
        self.n_steps = 0
        for t in range(max_prompt):
            logits, state = T.decode_step(self.params, self.cfg, state,
                                          mat[:, t:t + 1])
            self.n_steps += 1
        # first generated token comes from the final prompt position
        for _ in range(max_new_tokens):
            lg = logits.float().cpu()
            if scfg.temperature > 0:
                probs = torch.softmax(lg / scfg.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0].numpy()
            else:
                nxt = lg.numpy().argmax(-1)
            for r, _ in list(pool.live()):
                outs[r].append(int(nxt[r]))
                if nxt[r] == scfg.eos_id or len(outs[r]) >= max_new_tokens:
                    pool.retire(r)
            if pool.n_live == 0:
                break
            logits, state = T.decode_step(self.params, self.cfg, state,
                                          nxt.astype(np.int32)[:, None])
            self.n_steps += 1
        return [np.array(o, np.int32) for o in outs]
