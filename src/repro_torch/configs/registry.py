"""Architecture registry: ``--arch <id>`` resolution.

All ten assigned architectures plus the paper's own TNN column bank
(``tnn-catwalk``). Each config module exports ``CONFIG``.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "glm4-9b": "glm4_9b",
    "llama3.2-3b": "llama3_2_3b",
    "internlm2-1.8b": "internlm2_1_8b",
    "stablelm-3b": "stablelm_3b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "arctic-480b": "arctic_480b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-780m": "mamba2_780m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return get_config(arch[:-len("-smoke")]).smoke()
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
