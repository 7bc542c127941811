"""Chameleon-style early-fusion VLM of the port (``repro.models.vlm``).

The image tokenizer is a stub, as in the reference: the caller supplies
patch/code embeddings (B, n_img, d_model).  They are projected
(``img_proj``) and placed ahead of the text embeddings in one causal
stream, which the dense decoder of ``repro_torch.models.transformer`` runs.
Decode continues text-only through the dense ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..core.distributed import copy_to_model, gather_from_model
from .config import ArchConfig
from .layers import dense_init, dtype_of, embed_lookup
from .transformer import (LMCache, decode_step, forward_embedded, init_lm,
                          prefill_embedded)

Pytree = Any


def init_vlm(cfg: ArchConfig, gen: torch.Generator) -> Pytree:
    """The dense LM's params, then ``img_proj`` (d, d) drawn after them."""
    params = init_lm(cfg, gen)
    params["img_proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                    dtype_of(cfg.dtype))
    return params


def _fuse(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
          image_embeds: torch.Tensor) -> torch.Tensor:
    """[projected image embeddings ; text embeddings] along the seq axis;
    the image embeddings are cast to the embedding's dtype first.  Inside
    ``model_parallel`` ``img_proj`` is this rank's output columns
    (column-parallel) and the projection is gathered whole over
    ``model``."""
    emb = params["embed"]
    img = gather_from_model(copy_to_model(image_embeds.to(emb.dtype))
                            @ params["img_proj"])
    return torch.cat([img, embed_lookup(emb, tokens, cfg.vocab_size)],
                     dim=1)


def vlm_forward_train(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                      image_embeds: torch.Tensor,
                      window: Optional[int] = None, remat=False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_text), image_embeds (B, n_img, d) → logits over the
    whole fused sequence (B, n_img + S_text, V) and the aux loss (the
    training loss masks the image positions); ``remat`` is the per-layer
    activation-checkpoint policy of the stack (``transformer.remat_wrap``)."""
    window = window if window is not None else cfg.sliding_window
    return forward_embedded(cfg, params,
                            _fuse(cfg, params, tokens, image_embeds), window,
                            remat)


def vlm_prefill(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                image_embeds: torch.Tensor, max_seq: int,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, LMCache]:
    """Prefill over the fused stream (its K/V ring-placed into
    ``cache_capacity(cfg, max_seq)`` rows; ``max_seq`` counts the image
    tokens); decode then continues text-only at position n_img + S_text."""
    window = window if window is not None else cfg.sliding_window
    return prefill_embedded(cfg, params,
                            _fuse(cfg, params, tokens, image_embeds),
                            max_seq, window)


vlm_decode_step = decode_step   # decode continues text-only, as the dense LM
