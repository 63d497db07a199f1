"""Registry of the archs this slice of the port serves (+ their smoke configs).

The other archs of ``repro.configs`` need block kinds the port does not
have yet; asking for one raises a ``KeyError`` naming the ROADMAP item
that ports it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.config import ModelConfig

ARCHS: List[str] = ["granite_8b", "qwen3_4b", "gemma3_27b"]

# archs of the JAX package not ported yet -> the ROADMAP item that ports them
_LATER = {
    "mamba2_780m": "section 2 item 3 (recurrent stacks)",
    "recurrentgemma_9b": "section 2 item 3 (recurrent stacks)",
    "mixtral_8x22b": "section 2 item 4 (MoE)",
    "arctic_480b": "section 2 item 4 (MoE)",
    "llama32_vision_90b": "section 2 item 5 (cross-attention)",
    "musicgen_medium": "section 2 item 5 (cross-attention)",
    "minicpm_2b": "section 2 item 8 (the rest)",
}


def canon(name: str) -> str:
    """Public id (dashes, dots) -> module name (underscores)."""
    return name.replace("-", "_").replace(".", "")


def _module(name: str):
    mod = canon(name)
    if mod in _LATER:
        raise KeyError(f"arch {name!r} is not ported yet: ROADMAP.md "
                       f"{_LATER[mod]}")
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: _module(a).config() for a in ARCHS}
