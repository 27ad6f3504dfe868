"""The yardstick's arithmetic: the card's peak and the work a cell needs.

Every count comes from the configuration file's published sizes and the
traffic mix's shapes, never from the program or from what ran: the same
work reads the same whatever implements it. Recomputation (remat) is not
counted.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

#: NVIDIA H100 SXM data sheet, the dense bf16 tensor-core rate at the
#: 700 W limit, FLOP/s
PEAK_BF16_FLOPS = 989e12


def model_flops(ref: ModuleType, cfg: Dict, mix: Dict) -> float:
    """The model FLOPs of one unit of the mix (a training step or a
    prefill forward), from ``ref``'s counts of the configuration:

    - training: 6 x the weights that multiply a token (the layers' and
      the head's) x the step's tokens, plus 3 x the forward FLOPs of the
      sequence mixer (causal attention);
    - prefill: 2 x the layers' weights x the tokens, plus the mixer's
      forward FLOPs, plus 2 x the head's weights at the positions whose
      logits are made (the last of each prompt).
    """
    w = ref.matmul_params(cfg)
    if mix["kind"] == "train":
        rows, seq = mix["global_batch"], mix["seq_len"]
        return 6.0 * (w["layers"] + w["head"]) * rows * seq \
            + 3.0 * ref.mixer_flops(cfg, rows, seq)
    if mix["kind"] == "prefill":
        rows, seq = mix["batch"], mix["seq_len"]
        return 2.0 * w["layers"] * rows * seq + ref.mixer_flops(cfg, rows, seq) \
            + 2.0 * w["head"] * rows
    raise ValueError(f"no model FLOPs for a {mix['kind']!r} mix")

