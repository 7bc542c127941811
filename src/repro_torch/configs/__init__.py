"""Architecture configs of the port (copies of ``repro.configs``).

Every config of the reference is here: the paper's own model, the dense
transformers, the MoE family, the recurrent families (rwkv6-1.6b, the
zamba2-1.2b hybrid), the encoder-decoder whisper-large-v3 and the early-
fusion VLM chameleon-34b.  ``get_config(name)`` returns the full
production config and ``get_config(name).reduced()`` the CPU smoke
variant; an unknown name raises ``KeyError``.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from ..models.config import ArchConfig

_MODULES = ["paper_logreg", "qwen3_14b", "gemma_7b", "qwen2p5_32b",
            "starcoder2_15b", "olmoe_1b_7b", "deepseek_moe_16b",
            "rwkv6_1p6b", "zamba2_1p2b", "whisper_large_v3",
            "chameleon_34b"]

_ALIASES = {
    "paper-logreg": "paper_logreg",
    "qwen3-14b": "qwen3_14b",
    "gemma-7b": "gemma_7b",
    "qwen2.5-32b": "qwen2p5_32b",
    "starcoder2-15b": "starcoder2_15b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-large-v3": "whisper_large_v3",
    "chameleon-34b": "chameleon_34b",
}

# the reference's production architectures (``repro.configs.ASSIGNED``, in
# its order): every config but the paper's own model
ASSIGNED = ["zamba2-1.2b", "starcoder2-15b", "deepseek-moe-16b", "rwkv6-1.6b",
            "chameleon-34b", "qwen3-14b", "gemma-7b", "whisper-large-v3",
            "qwen2.5-32b", "olmoe-1b-7b"]


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in _MODULES:
        raise KeyError(f"unknown config '{name}'; the port has "
                       f"{sorted(_ALIASES)}")
    return import_module(f".{mod_name}", __package__).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get_config(name) for name in _ALIASES}
