"""The ``prefill`` mix: ``repro_torch.models.transformer.forward(params,
cfg, tokens, logits_mode="last")`` on batches of prompts, back to back
(the reference's ``prefill`` step kind, as the dry run builds it).

Set-up makes the weights from the seed and warms the one shape with the
window's first batch. Each forward in the window takes its own prompts
and keeps its last-position logits; once the window has closed, the
plain reference computes the logits of a sample of the completed
forwards, drawn from the seed, from the same weights and prompts.
"""

from __future__ import annotations

import random
import sys
import time
import traceback
from typing import Any, Dict, List

import torch

from benchkit import inputs, program
from references import plain


def prompts(cell, seed: int, index: int, dev) -> torch.Tensor:
    mix = cell.mix
    return inputs.token_batch(seed, index, mix["batch"], mix["seq_len"],
                              cell.config["vocab_size"], dev)[0]


def readings(got: List[torch.Tensor], want: List[torch.Tensor]
             ) -> Dict[str, float]:
    """``logit_err``: the worst prompt's relative error of its logits,
    ||got - want|| / ||want||; ``top_gap``: the widest gap by which the
    reference's logit of the program's top token lies below the
    reference's top logit."""
    err, gap = 0.0, 0.0
    for g, w in zip(got, want):
        g = g.to(torch.float32)
        rel = torch.linalg.vector_norm(g - w, dim=-1) \
            / torch.linalg.vector_norm(w, dim=-1)
        top = torch.gather(w, -1, torch.argmax(g, -1, keepdim=True))[:, 0]
        err = max(err, float(rel.max()))
        gap = max(gap, float((w.max(-1).values - top).max()))
    return dict(logit_err=err, top_gap=gap)


def reference_logits(cell, seed: int, which: List[int], dev,
                     precision: str = "f32") -> List[torch.Tensor]:
    ref = cell.reference
    with plain.float32_products():
        params = ref.init(inputs.generator(dev, seed, "weights"),
                          cell.config, dev)
        return [ref.last_logits(params, prompts(cell, seed, i, dev),
                                cell.config, plain.Precision(precision))
                for i in which]


def checked(seed: int, done: int, k: int) -> List[int]:
    """The forwards the reference checks: ``k`` of the ``done`` completed
    ones, drawn from the seed."""
    return sorted(random.Random(inputs.derive(seed, "checked")).sample(
        range(done), min(k, done)))


def build(cell, seed: int, dev):
    """The program's forward on the benchmark's weights from the seed:
    ``forward(tokens) -> (B, V)`` last-position logits."""
    from repro_torch.models import transformer as T
    cfg = program.model_config(cell.config)
    params = cell.reference.init(inputs.generator(dev, seed, "weights"),
                                 cell.config, dev)

    def forward(tokens):
        return T.forward(params, cfg, tokens, logits_mode="last")[0][:, -1]
    return forward


def run(cell, seed: int, seconds: float, tracer, dev,
        forward_of=None) -> Dict[str, Any]:
    """Set-up, the window, then the reference; see the module docstring.
    ``forward_of(fn)``: wraps the forward (a planted fault's hook)."""
    forward = build(cell, seed, dev)
    if forward_of is not None:
        forward = forward_of(forward)
    mix = cell.mix
    with torch.no_grad():
        forward(prompts(cell, seed, -1, dev))      # warms the one shape
        program.sync(dev)
        setup_peak = program.peak_bytes(dev)
        program.reset_peak(dev)
        program.reset_counters()
        outs: List[torch.Tensor] = []
        failed = 0
        with tracer:
            t0 = time.perf_counter()
            t1, deadline = t0, t0 + seconds
            while time.perf_counter() < deadline:
                try:
                    with tracer.span("making the prompts"):
                        tokens = prompts(cell, seed, len(outs), dev)
                    with tracer.span("forward (host launching)"):
                        out = forward(tokens)
                    with tracer.span("waiting for the forward"):
                        program.sync(dev)
                except Exception:  # a forward that raises is counted
                    traceback.print_exc(file=sys.stderr)
                    failed += 1
                    break
                outs.append(out)
                t1 = time.perf_counter()
    window_peak = program.peak_bytes(dev)
    counts = program.counters()
    trace = tracer.summary(t0, t1) if hasattr(tracer, "summary") else None
    done = len(outs)
    which = checked(seed, done, mix["checked_forwards"])
    got = [outs[i] for i in which]
    del outs, forward
    program.release(dev)
    want = reference_logits(cell, seed, which, dev)
    return dict(
        t_window=t0, units=done, attempted=done + failed, failed=failed,
        sound=done > 0 and not failed,
        e2e=dict(prefill_tokens_per_s=done * mix["batch"] * mix["seq_len"]
                 / (t1 - t0) if done else 0.0,
                 peak_mem_gib=window_peak / 2 ** 30),
        memory_peak_bytes=max(setup_peak, window_peak),
        readings=readings(got, want), counters=counts, trace=trace)
