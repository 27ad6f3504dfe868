"""Stand-ins for every model input of a dry-run cell: ``meta`` tensors
(shape and dtype, no storage), so the dry run allocates nothing for them.

``input_specs(cfg, shape)`` returns the batch dict for the cell's kind:
  train   -> {tokens, labels[, patches | frames]}
  prefill -> {tokens[, patches | frames]}
  decode  -> {tokens (B, 1)}  (the serve cache is built separately)
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _spec((b, 1), torch.int32)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    specs = {"tokens": _spec((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _spec((b, s), torch.int32)
    if cfg.family == "vlm":
        specs["patches"] = _spec(
            (b, cfg.frontend.n_tokens, cfg.frontend.d_embed), torch.bfloat16)
    if cfg.family == "audio":
        specs["frames"] = _spec(
            (b, cfg.encdec.encoder_seq, cfg.frontend.d_embed), torch.bfloat16)
    return specs


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic sequence mixing (assignment rule)."""
    return not (shape.name == "long_500k" and cfg.full_attention_only)
