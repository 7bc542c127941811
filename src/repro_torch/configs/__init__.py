"""Architecture configs of the port.

Only the paper's own model is ported so far; every other name of
``repro.configs`` raises ``KeyError`` until its model family lands.
"""
from __future__ import annotations

from ..models.config import ArchConfig
from .paper_logreg import CONFIG as _PAPER_LOGREG

_CONFIGS = {"paper-logreg": _PAPER_LOGREG, "paper_logreg": _PAPER_LOGREG}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"config '{name}' is not ported yet; the port has "
                       f"{sorted(_CONFIGS)}")
    return _CONFIGS[name]
