"""Registry of the port's archs (+ their smoke configs): every arch of the
JAX package's registry, by the same public ids.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.config import ModelConfig

ARCHS: List[str] = ["granite_8b", "qwen3_4b", "gemma3_27b", "mamba2_780m",
                    "recurrentgemma_9b", "minicpm_2b", "mixtral_8x22b",
                    "arctic_480b", "musicgen_medium", "llama32_vision_90b"]

# public ids whose module name is not the id with dashes as underscores
_ALIASES = {"llama-3.2-vision-90b": "llama32_vision_90b"}


def canon(name: str) -> str:
    """Public id (dashes, dots) -> module name (underscores)."""
    return _ALIASES.get(name, name.replace("-", "_").replace(".", ""))


def _module(name: str):
    mod = canon(name)
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: _module(a).config() for a in ARCHS}
