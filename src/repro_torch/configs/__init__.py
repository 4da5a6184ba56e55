"""Architecture registry, the port's copy of ``repro.configs``.

Each module defines CONFIG (full size) and SMOKE (reduced, same family and
topology, runnable on the CPU), with the same values as the reference. The
registry holds every family, and the port serves them all
(``models.lm.PORTED_FAMILIES``); it trains those in
``models.lm.TRAINED_FAMILIES``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "codeqwen1_5_7b",
    "starcoder2_7b",
    "qwen2_1_5b",
    "qwen2_5_14b",
    "arctic_480b",
    "llama4_scout_17b_a16e",
    "qwen2_vl_72b",
    "hubert_xlarge",
    "zamba2_2_7b",
    "rwkv6_7b",
]

# CLI-friendly aliases (dashes/dots as published)
ALIASES: Dict[str, str] = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "arctic-480b": "arctic_480b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2_7b",
    "rwkv6-7b": "rwkv6_7b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{arch}", __name__)
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
