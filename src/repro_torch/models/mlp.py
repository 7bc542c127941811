"""Gated MLP (SwiGLU / GeGLU) and plain GELU feed-forward
(``repro.models.mlp``).  Inside ``core.distributed.model_parallel`` the
weights are this rank's d_ff columns of ``w_up`` / ``w_gate`` and rows of
``w_down`` (column- then row-parallel), and the parts are summed over
``model``."""
from __future__ import annotations

from typing import Dict

import torch

from .config import ArchConfig
from ..core.distributed import copy_to_model, reduce_from_model
from .layers import activation_fn, dense_init, matmul


def init_mlp(cfg: ArchConfig, gen: torch.Generator, dtype: torch.dtype,
             d_ff: int = 0) -> Dict:
    d_ff = d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, cfg.d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, cfg.d_model, dtype)}
    if cfg.activation in ("silu", "geglu"):
        p["w_gate"] = dense_init(gen, cfg.d_model, d_ff, dtype)
    return p


def mlp_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    return reduce_from_model(mlp_partial(cfg, params, copy_to_model(x)))


def mlp_partial(cfg: ArchConfig, params: Dict, x: torch.Tensor
                ) -> torch.Tensor:
    """The MLP on the d_ff columns ``params`` holds: the whole output
    outside ``model_parallel``, this rank's part inside it."""
    act = activation_fn(cfg.activation)
    up = matmul(x, params["w_up"])
    if "w_gate" in params:
        up = act(matmul(x, params["w_gate"])) * up
    else:
        up = act(up)
    return matmul(up, params["w_down"])
