"""What the ``attention_kernel.*`` readers share: the share of the
records' ``attention.scores`` spans that hold an ``attention.kernel``
span, from ``repro_torch.tracing.records()`` after the window."""

from __future__ import annotations

import importlib
from typing import Optional


def share() -> Optional[float]:
    """100 x the ``attention.scores`` spans with an ``attention.kernel``
    child over all of them; None where the program has no fused attention
    kernel or no tracing, keeps no ``attention.scores`` spans, or dropped
    some."""
    try:
        from repro_torch import tracing
        importlib.import_module("repro_torch.kernels.gqa_attention")
    except ImportError:
        return None
    if tracing.COUNTS["dropped"]:
        return None
    recs = tracing.records()
    scores = [i for i, r in enumerate(recs) if r["name"] == "attention.scores"]
    if not scores:
        return None
    held = {r["parent"] for r in recs if r["name"] == "attention.kernel"}
    return 100.0 * sum(i in held for i in scores) / len(scores)
