"""Tree-native optimizers (``repro.optim.optimizers``).

All share the functional interface

    state = <name>_init(params)
    new_params, new_state = <name>_update(params, grads, state, lr, **kw)

over trees of tensors (``core.flatten``'s dict / list / tuple nesting);
``lr`` is a float or a 0-d tensor (a schedule's value).
``make_optimizer(name, **defaults)`` returns an ``(init, update)`` pair
with the hyper-parameters bound.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..core.flatten import tree_leaves, tree_map, tree_unflatten

Tree = Any


class SGDState(NamedTuple):
    momentum: Tree             # zeros-like(params) when momentum == 0 too
    count: torch.Tensor        # 0-d int32


class AdamWState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor        # 0-d int32


OptState = Any


def _count_like(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _unzip(template: Tree, pairs: list, n: int) -> Tuple[Tree, ...]:
    return tuple(tree_unflatten(template, [p[i] for p in pairs])
                 for i in range(n))


def sgd_init(params: Tree) -> SGDState:
    return SGDState(momentum=tree_map(torch.zeros_like, params),
                    count=_count_like(params))


def sgd_update(params: Tree, grads: Tree, state: SGDState, lr,
               momentum: float = 0.0, weight_decay: float = 0.0,
               nesterov: bool = False) -> Tuple[Tree, SGDState]:
    def upd(p, g, m):
        g = g + weight_decay * p if weight_decay else g
        m_new = momentum * m + g
        step = ((g + momentum * m_new) if nesterov
                else (m_new if momentum else g))
        return (p - lr * step).to(p.dtype), m_new.to(m.dtype)

    pairs = [upd(p, g, m) for p, g, m in zip(tree_leaves(params),
                                              tree_leaves(grads),
                                              tree_leaves(state.momentum))]
    new_params, new_mom = _unzip(params, pairs, 2)
    return new_params, SGDState(new_mom, state.count + 1)


def adamw_init(params: Tree) -> AdamWState:
    zeros32 = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    return AdamWState(mu=zeros32, nu=tree_map(torch.clone, zeros32),
                      count=_count_like(params))


def adamw_update(params: Tree, grads: Tree, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> Tuple[Tree, AdamWState]:
    count = state.count + 1
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32)
        mu_new = b1 * mu + (1 - b1) * g32
        nu_new = b2 * nu + (1 - b2) * g32 * g32
        step = (mu_new / c1) / (torch.sqrt(nu_new / c2) + eps)
        if weight_decay:
            step = step + weight_decay * p.to(torch.float32)
        return (p - lr * step).to(p.dtype), mu_new, nu_new

    triples = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu))]
    new_params, mu, nu = _unzip(params, triples, 3)
    return new_params, AdamWState(mu, nu, count)


def make_optimizer(name: str, **defaults) -> Tuple[Callable, Callable]:
    """Return ``(init_fn, update_fn(params, grads, state, lr))`` with the
    hyper-parameters bound."""
    if name == "sgd":
        def update(params, grads, state, lr):
            return sgd_update(params, grads, state, lr, **defaults)
        return sgd_init, update
    if name == "adamw":
        def update(params, grads, state, lr):
            return adamw_update(params, grads, state, lr, **defaults)
        return adamw_init, update
    raise KeyError(f"unknown optimizer '{name}'")
