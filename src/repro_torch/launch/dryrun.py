"""The launcher's ``--opt`` layout transform, ``apply_opt``.

The reference module also compiles every (architecture, shape, mesh) cell
ahead of time on virtual TPU meshes; that part has no counterpart here.
``apply_opt`` is a pure config transform. On one device only the MoE
settings change what runs (capacity factor 1.0; ``catwalk_ep`` dispatch,
which runs ``moe_apply`` without a mesh, as the reference does). Under a
``("data", "model")`` mesh ``catwalk_ep`` runs the expert-parallel layer
and ``batch_over_model`` splits the rows over ``model`` too; ``act_sp``
keeps each rank's block of the sequence between the layers (sequence
parallelism, :func:`repro_torch.models.transformer.forward`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def apply_opt(cfg: ModelConfig) -> ModelConfig:
    """Beyond-baseline layout (--opt): per-family settings from the
    reference's layout search. The paper-baseline layout stays the
    default."""
    repl = {}
    if cfg.family in ("ssm", "hybrid"):
        repl["batch_over_model"] = True      # batch over every device
    elif cfg.resolved_head_dim % 128 == 0:
        # sequence-parallel activations pay off only for head dims that
        # are multiples of 128 (glm4, llama, internlm, arctic, deepseek)
        repl["act_sp"] = True
    if cfg.moe is not None:
        # expert-parallel relocation dispatch
        repl["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=1.0, dispatch="catwalk_ep",
            ep_fsdp=cfg.param_count() > 100e9)
    return dataclasses.replace(cfg, **repl)
