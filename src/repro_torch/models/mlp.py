"""Gated MLP (SwiGLU / GeGLU) and plain GELU feed-forward
(``repro.models.mlp``)."""
from __future__ import annotations

from typing import Dict

import torch

from .config import ArchConfig
from .layers import activation_fn, dense_init


def init_mlp(cfg: ArchConfig, gen: torch.Generator, dtype: torch.dtype,
             d_ff: int = 0) -> Dict:
    d_ff = d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, cfg.d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, cfg.d_model, dtype)}
    if cfg.activation in ("silu", "geglu"):
        p["w_gate"] = dense_init(gen, cfg.d_model, d_ff, dtype)
    return p


def mlp_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    up = x @ params["w_up"]
    if "w_gate" in params:
        up = act(x @ params["w_gate"]) * up
    else:
        up = act(up)
    return up @ params["w_down"]
