"""Model registry of the port — one bundle per architecture family.

The ``logreg``, ``dense``, ``moe``, ``ssm`` and ``hybrid`` families are
ported (one decoder-only bundle serves the last four); ``vlm`` and
``audio`` of ``repro.models.registry`` raise ``NotImplementedError``,
naming ``repro.models.vlm`` / ``repro.models.encdec``, until their slice
lands.  The bundle keeps
the reference's field names:

    bundle.init(seed | Generator, device="cuda")  -> params
    bundle.train_loss(params, batch)              -> (scalar_loss, aux)
    bundle.forward(params, batch)                 -> logits
    bundle.prefill(params, batch, max_seq)        -> (last_logits, cache)
    bundle.decode(params, token, cache)           -> (logits, cache)
    bundle.init_cache(batch_size, max_seq, device="cuda") -> cache
    bundle.batch_spec(batch, seq)                 -> {name: (shape, dtype)}

``init`` takes a seed or a ``torch.Generator`` in place of a ``jax.random``
key; a seed makes a generator on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Union

import torch

from ..device import DeviceLike, resolve_device
from .config import ArchConfig
from .layers import cross_entropy_loss
from .logistic import init_logistic, logistic_apply, logistic_loss
from .transformer import (check_family, decode_step, forward_train, init_lm,
                          init_lm_cache, prefill)


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


def _generator(seed: Union[int, torch.Generator],
               device: DeviceLike) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def _lm_next_token_loss(cfg: ArchConfig, params, batch: Dict,
                        window: Optional[int] = None, remat: bool = False):
    logits, aux = forward_train(cfg, params, batch["tokens"], window=window,
                                remat=remat)
    ce = cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])
    return ce + cfg.router_aux_coef * aux, aux


def get_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "logreg":
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

    check_family(cfg)
    return ModelBundle(
        config=cfg,
        init=lambda seed, device="cuda": init_lm(cfg, _generator(seed,
                                                                 device)),
        train_loss=partial(_lm_next_token_loss, cfg),
        forward=lambda p, b: forward_train(cfg, p, b["tokens"])[0],
        prefill=lambda p, b, max_seq: prefill(cfg, p, b["tokens"], max_seq),
        decode=lambda p, tok, cache: decode_step(cfg, p, tok, cache),
        init_cache=lambda batch, max_seq, device="cuda": init_lm_cache(
            cfg, batch, max_seq, device=device),
        batch_spec=lambda batch, seq: {"tokens": ((batch, seq),
                                                  torch.int32)})
