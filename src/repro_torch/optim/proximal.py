"""FedProx proximal objective wrapper (``repro.optim.proximal``; Li et al.
2020, the paper's ref [8]).

FedProx adds ``(μ/2)·‖w − w_global‖²`` to each client's local objective so
local optimization cannot drift far from the round's global parameters.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.flatten import tree_leaves


def proximal_loss_fn(loss_fn: Callable, mu: float) -> Callable:
    """Wrap ``loss_fn(params, batch) -> scalar`` as ``(params, batch,
    anchor) -> scalar`` with the proximal term, ``anchor`` the round's
    global parameters w^t."""
    if mu == 0.0:
        return lambda params, batch, anchor: loss_fn(params, batch)

    def wrapped(params, batch, anchor):
        base = loss_fn(params, batch)
        sq = sum(torch.sum((p.to(torch.float32) - a.to(torch.float32)) ** 2)
                 for p, a in zip(tree_leaves(params), tree_leaves(anchor)))
        return base + 0.5 * mu * sq

    return wrapped
