"""Architecture configs of the port (copies of ``repro.configs``).

The paper's own model and the dense transformers are ported;
``get_config(name)`` returns the full production config and
``get_config(name).reduced()`` the CPU smoke variant.  Every other name of
``repro.configs`` raises ``KeyError`` until its model family lands.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from ..models.config import ArchConfig

_MODULES = ["paper_logreg", "qwen3_14b", "gemma_7b", "qwen2p5_32b",
            "starcoder2_15b"]

_ALIASES = {
    "paper-logreg": "paper_logreg",
    "qwen3-14b": "qwen3_14b",
    "gemma-7b": "gemma_7b",
    "qwen2.5-32b": "qwen2p5_32b",
    "starcoder2-15b": "starcoder2_15b",
}

PORTED = list(_ALIASES)


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in _MODULES:
        raise KeyError(f"config '{name}' is not ported yet; the port has "
                       f"{sorted(_ALIASES)}")
    return import_module(f".{mod_name}", __package__).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get_config(name) for name in _ALIASES}
