"""Model registry of the port — one bundle per architecture family.

Only the ``logreg`` family is ported; the transformer families of
``repro.models.registry`` raise until their slice lands.  The bundle keeps
the reference's field names; ``init`` takes a seed or ``torch.Generator``
and ``device=`` in place of a ``jax.random`` key.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch

from .config import ArchConfig
from .logistic import init_logistic, logistic_apply, logistic_loss


@dataclass(frozen=True)
class ModelBundle:
    config: ArchConfig
    init: Callable
    train_loss: Callable
    forward: Callable
    prefill: Optional[Callable]
    decode: Optional[Callable]
    init_cache: Optional[Callable]
    batch_spec: Callable


def get_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family != "logreg":
        raise NotImplementedError(
            f"model family '{cfg.family}' ({cfg.name}) is not ported yet; "
            "the port has the 'logreg' family only")
    return ModelBundle(
        config=cfg,
        init=partial(init_logistic, cfg),
        train_loss=lambda p, b: (logistic_loss(p, b),
                                 torch.zeros((), device=b[0].device)),
        forward=lambda p, b: logistic_apply(p, b["x"]),
        prefill=None, decode=None, init_cache=None,
        batch_spec=lambda batch, seq: {
            "x": ((batch, cfg.input_dim), torch.float32),
            "y": ((batch,), torch.int32)})
