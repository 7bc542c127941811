"""Multinomial logistic regression — the paper's own experimental model.

Parameters are plain ``dict[str, Tensor]`` with the reference's key names
(``{"w": (D, C), "b": (C,)}``), so :func:`repro_torch.core.flatten.tree_to_vector`
lays them out exactly as ``repro`` does.  ``jax.random`` init cannot be
reproduced in torch: tests start both packages from the same weights via
:func:`repro_torch.convert.params_from_jax`.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from ..device import DeviceLike, resolve_device
from .config import ArchConfig
from .layers import cross_entropy_loss

Params = Dict[str, Any]
Seed = Union[int, torch.Generator]


def _generator(seed: Seed, device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def init_logistic(cfg: ArchConfig, seed: Seed,
                  device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    return {
        "w": torch.randn(cfg.input_dim, cfg.num_classes, generator=gen,
                         device=dev) * 0.01,
        "b": torch.zeros(cfg.num_classes, device=dev),
    }


def logistic_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def logistic_loss(params: Params, batch) -> torch.Tensor:
    """batch = (x, y, sample_weights)."""
    x, y, w = batch
    return cross_entropy_loss(logistic_apply(params, x), y, w)


def make_mlp_classifier(cfg: ArchConfig, hidden: int = 128):
    """2-layer MLP classifier (a DNN variant for the last-layer-scope
    experiments — the paper's §III-B efficiency note targets DNNs).
    Returns ``(init, apply, loss)``; ``init(seed, device="cuda")``."""
    def init(seed: Seed, device: DeviceLike = "cuda") -> Params:
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        return {
            "hidden": {"w": torch.randn(cfg.input_dim, hidden, generator=gen,
                                        device=dev) * cfg.input_dim ** -0.5,
                       "b": torch.zeros(hidden, device=dev)},
            "head": {"w": torch.randn(hidden, cfg.num_classes, generator=gen,
                                      device=dev) * hidden ** -0.5,
                     "b": torch.zeros(cfg.num_classes, device=dev)},
        }

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ params["hidden"]["w"] + params["hidden"]["b"])
        return h @ params["head"]["w"] + params["head"]["b"]

    def loss(params: Params, batch) -> torch.Tensor:
        x, y, w = batch
        return cross_entropy_loss(apply(params, x), y, w)

    return init, apply, loss
