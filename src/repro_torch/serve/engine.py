"""Batched LM serving engine: continuous batching over per-slot decode
state for attention families, static lockstep decoding for the ssm,
hybrid and audio families.

Attention families (dense, vlm, moe) decode over a fixed pool of B slots, the
batch rows of ``decode_step``. Each slot owns its request's decode state:
a cursor into the prompt and the last sampled token (host side, in the
slot's ``SlotEntry.state``) and its own write position into the KV cache
(``attention.KVCache`` with vector ``pos``; ``transformer.per_slot_state``).
A request is admitted into a free slot, prefilled token by token through
the cached decode path, decodes until EOS or budget, and retires; the
freed row's cache position resets to zero (``transformer.reset_slots``)
and the row re-fills from the pending queue at the top of the next step
while the other rows keep decoding (``continuous=True``), or only once the
pool has drained (``continuous=False``, the wave baseline). Free rows
decode an in-vocab filler whose outputs are discarded.

The ssm and hybrid families' decode state is a recurrence per row (and,
for hybrid, the shared block's KV caches), and the audio family's holds an
encoder output per request, so they are served by the static wave path:
all prompts are prefilled together, left-aligned with the filler after
each prompt, then one token is sampled per step for every live slot;
slots retire on EOS or budget and are not re-filled. Given ``frames``,
``generate`` takes that path for any family, as the reference does.

Greedy decoding takes the first maximum of the float32 logits, as the
reference does, and so matches it token for token. Temperature sampling
draws from a ``torch.Generator`` seeded from ``ServeConfig.seed``: it is
deterministic for a seed but cannot reproduce ``jax.random``'s draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

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
        # decode steps of the last serve() / generate() call
        self.n_steps = 0

    @property
    def _per_slot_ok(self) -> bool:
        """Families whose decode state re-fills per slot (KV caches)."""
        return self.cfg.family not in ("ssm", "hybrid", "audio")

    def generate(self, prompts: List[np.ndarray],
                 max_new_tokens: int = 32,
                 frames: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """Generate continuations for ``prompts``; results in order.

        ``frames`` (B, S_enc, d_embed): the audio family's frame embeddings,
        one row per prompt. Given frames, and for ssm / hybrid / audio, the
        static lockstep path (:meth:`_generate_static`); otherwise the
        attention families route through :meth:`serve` with one slot per
        request."""
        if frames is not None or not self._per_slot_ok:
            return self._generate_static(prompts, max_new_tokens, frames)
        return self.serve(prompts, max_new_tokens, n_slots=len(prompts))

    def serve(self, prompts: List[np.ndarray], max_new_tokens: int = 32, *,
              n_slots: int | None = None,
              continuous: bool = True) -> List[np.ndarray]:
        """Slot-based decode over ``n_slots`` rows; results in order.

        ``continuous=True`` re-fills freed slots from the pending queue
        mid-flight (the top of every step); ``continuous=False`` is the
        wave baseline — admission only when the pool has fully drained, so
        a batch's slowest request gates the next wave. Refused for
        families served statically (``ValueError``, as the reference's
        ``per_slot_state``).
        """
        scfg = self.scfg
        b = len(prompts) if n_slots is None else int(n_slots)
        if b < 1:
            raise ValueError(f"need at least one slot, got {b}")
        if not self._per_slot_ok:
            raise ValueError(
                "per-slot positions need attention KV caches; the "
                f"{self.cfg.family!r} family is served statically")
        state = T.per_slot_state(
            T.init_serve_state(self.params, self.cfg, b, scfg.max_len), b)

        def on_admit(idx: int, entry) -> None:
            del idx
            # cursor into the prompt + last sampled token: the slot's
            # host-side decode state (the cache position lives in the
            # ServeState's per-slot pos, reset at admission below)
            entry.state = {"fed": 0, "last": int(tok.PAD)}

        pool: SlotPool[LMRequest, Dict[str, int]] = SlotPool(
            b, on_admit=on_admit)
        reqs = [
            LMRequest(req_id=i, prompt=np.asarray(p, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
        for r in reqs:
            if r.prompt.size == 0:
                raise ValueError(f"empty prompt (request {r.req_id})")
            pool.submit(r)

        gen = torch.Generator().manual_seed(scfg.seed)
        self.n_steps = 0
        while pool.has_work:
            if continuous or pool.n_live == 0:
                admitted = pool.admit()
                if admitted:
                    free = np.zeros((b,), bool)
                    for idx, _ in admitted:
                        free[idx] = True
                    # re-filled rows restart at cache position 0; stale
                    # K/V above it is hidden by the pos-derived validity
                    # mask, so no clearing
                    state = T.reset_slots(state, free)
            # free rows decode an in-vocab filler: their outputs are unused
            tokens = np.full((b, 1), self._fill, np.int32)
            for idx, entry in pool.live():
                req, st = entry.item, entry.state
                tokens[idx, 0] = (req.prompt[st["fed"]]
                                  if st["fed"] < len(req.prompt)
                                  else st["last"])
            logits, state = T.decode_step(self.params, self.cfg, state,
                                          tokens)
            self.n_steps += 1
            nxt = self._sample(logits, gen)
            for idx, entry in list(pool.live()):
                req, st = entry.item, entry.state
                st["fed"] += 1
                if st["fed"] < len(req.prompt):
                    continue            # mid-prefill: logits not sampled
                # this step consumed the final prompt token (first
                # generated token) or the previous sample (next one)
                t_new = int(nxt[idx])
                req.tokens.append(t_new)
                st["last"] = t_new
                if (t_new == scfg.eos_id
                        or len(req.tokens) >= req.max_new_tokens
                        or st["fed"] >= scfg.max_len):
                    pool.retire(idx)
        return [np.asarray(r.tokens, np.int32) for r in reqs]

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> np.ndarray:
        """Next token per row of ``logits`` (B, V): the first maximum of
        the float32 logits (greedy), or a draw from ``gen`` at the
        temperature."""
        lg = logits.float().cpu()
        if self.scfg.temperature > 0:
            probs = torch.softmax(lg / self.scfg.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0].numpy()
        return lg.numpy().argmax(-1)

    def _generate_static(self, prompts: List[np.ndarray],
                         max_new_tokens: int = 32,
                         frames: Optional[np.ndarray] = None
                         ) -> List[np.ndarray]:
        """Static lockstep batching: all prompts prefilled together
        left-aligned (in-vocab filler after each), one token per step for
        every live slot, per-slot retirement without re-fill; ``frames``
        are encoded once, in ``init_serve_state``."""
        b = len(prompts)
        scfg = self.scfg
        for r, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError(f"empty prompt (request {r})")
        max_prompt = max(len(p) for p in prompts)
        state = T.init_serve_state(self.params, self.cfg, b, scfg.max_len,
                                   frames=frames)

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
            nxt = self._sample(logits, gen)
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
