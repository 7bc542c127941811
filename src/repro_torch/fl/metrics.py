"""Evaluation metrics for the FL experiments (paper §IV-A4)."""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.func import vmap

Tree = Any


@torch.no_grad()
def evaluate_classifier(apply_fn: Callable, params: Tree, x: torch.Tensor,
                        y: torch.Tensor, batch: int = 4096
                        ) -> Tuple[float, float]:
    """Return ``(mean_nll, accuracy)`` on a held-out set."""
    n = x.shape[0]
    total_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    total_correct = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, n, batch):
        bx, by = x[start:start + batch], y[start:start + batch].long()
        logits = apply_fn(params, bx)
        logp = torch.log_softmax(logits, dim=-1)
        total_nll += -torch.gather(logp, -1, by[:, None])[:, 0].sum()
        total_correct += (logits.argmax(dim=-1) == by).sum()
    return float(total_nll) / n, float(total_correct) / n


@torch.no_grad()
def global_train_loss(loss_fn: Callable, params: Tree, x: torch.Tensor,
                      y: torch.Tensor, mask: torch.Tensor) -> float:
    """f(w) = mask-weighted mean loss over ALL devices' data (paper eq. 1)."""
    def per_device(cx, cy, cm):
        return loss_fn(params, (cx, cy, cm)) * cm.sum().clamp(min=1.0), cm.sum()

    losses, counts = vmap(per_device)(x, y, mask)
    return float(losses.sum() / counts.sum().clamp(min=1.0))
