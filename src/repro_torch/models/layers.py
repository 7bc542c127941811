"""Shared layers of the port (the subset the logistic family needs)."""
from __future__ import annotations

from typing import Optional

import torch


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token-level CE. logits (..., V), labels (...,) int; with
    ``weights`` the weighted sum over max(Σ weights, 1), as in
    ``repro.models.layers.cross_entropy_loss``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp(min=1.0)
