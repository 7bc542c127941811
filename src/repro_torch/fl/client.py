"""Client-side local optimization (Algorithm 1, line 4), batched over K.

``client_update`` runs mini-batch SGD (optionally with the FedProx proximal
term) for all K clients of a round at once: parameters carry an explicit
leading K axis and each iteration takes one step of every client.  The
forward pass is ``torch.func.vmap`` of the per-client loss, and one autograd
pass over the sum of the K losses gives every client its own gradient
(client k's loss depends on its own parameters alone) at a fraction of the
cost of ``vmap(grad(...))``.  Computational heterogeneity is a per-client
step budget: steps beyond a client's budget are masked, as in
``repro.fl.client``.  Iterations past the largest budget of the round are
skipped, since a masked step leaves the parameters exactly as they are.

Mini-batch indices come from :func:`draw_batch_indices` (with replacement,
probabilities mask/Σmask, from a ``torch.Generator`` on the data's device).
The draw is separate so a caller can hand in a ``(K, max_steps, batch)``
index tensor instead — the tests replay the reference's ``jax.random``
stream that way.

:func:`cohort_update` is the fleet-scale form: the cohort's shards are
generated on the card from device ids (``data.fleetgen``), chunk by chunk,
and each chunk runs ``client_update`` against the cohort's index tensor,
drawn once for the whole cohort.

Loss functions follow ``loss_fn(params, (x, y, sample_weight)) -> scalar``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.func import grad, vmap

from ..core.flatten import tree_leaves, tree_map, tree_unflatten

Tree = Any


def draw_batch_indices(mask: torch.Tensor, max_steps: int, batch_size: int,
                       generator: torch.Generator) -> torch.Tensor:
    """``(K, max_steps, batch_size)`` int64 sample indices per client, drawn
    with replacement with probabilities ``mask / Σ mask`` (mask (K, m))."""
    probs = mask / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    idx = torch.multinomial(probs, max_steps * batch_size, replacement=True,
                            generator=generator)
    return idx.view(mask.shape[0], max_steps, batch_size)


def stacked_grad(loss_fn: Callable) -> Callable:
    """``fn(params, batch)`` → per-client gradients, for params and batch
    with a leading K axis (``vmap(grad(loss_fn))`` by one autograd pass)."""
    batched_loss = vmap(loss_fn, in_dims=(0, 0))

    def run(params: Tree, batch) -> Tree:
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            total = batched_loss(p, batch).sum()
            grads = torch.autograd.grad(total, tree_leaves(p))
        return tree_unflatten(p, list(grads))
    return run


def local_gradient(loss_fn: Callable, params: Tree, x: torch.Tensor,
                   y: torch.Tensor, mask: torch.Tensor) -> Tree:
    """Full-local-dataset gradient ∇F_k(w) — used for the ∇f(w^t) estimate."""
    return grad(loss_fn)(params, (x, y, mask))


def client_update(loss_fn: Callable, global_params: Tree, x: torch.Tensor,
                  y: torch.Tensor, mask: torch.Tensor, num_steps: torch.Tensor,
                  batch_idx: torch.Tensor, *, lr: float, mu: float = 0.0
                  ) -> Tuple[Tree, Tree]:
    """Local SGD of K clients: ``x (K, m, ...)``, ``y (K, m)``,
    ``mask (K, m)``, ``num_steps (K,)``, ``batch_idx (K, max_steps, batch)``.

    Returns ``(deltas, first_grads)`` as stacked trees (leading K axis): the
    updates Δ_k = w_k^{t+1} − w^t and each client's full-local-dataset
    gradient at w^t (the K₂=0 global-gradient estimate, §III-B).
    """
    if mu != 0.0:
        def step_loss(p, batch):
            base = loss_fn(p, batch)
            sq = sum(((a.float() - b.float()) ** 2).sum()
                     for a, b in zip(tree_leaves(p), tree_leaves(global_params)))
            return base + 0.5 * mu * sq
    else:
        step_loss = loss_fn

    K, max_steps, batch_size = batch_idx.shape
    batched_grad = stacked_grad(step_loss)
    rows = torch.arange(K, device=x.device)[:, None]
    ones = torch.ones((K, batch_size), dtype=torch.float32, device=x.device)
    stacked_global = tree_map(lambda p: p.unsqueeze(0).expand(K, *p.shape),
                              global_params)
    params = tree_map(torch.clone, stacked_global)
    for step in range(min(max_steps, int(num_steps.max()))):
        idx = batch_idx[:, step]
        g = batched_grad(params, (x[rows, idx], y[rows, idx], ones))
        live = (step < num_steps).float()
        params = tree_map(
            lambda p, gg: (p - lr * live.view(-1, *([1] * (p.dim() - 1)))
                           * gg.float()).to(p.dtype),
            params, g)

    deltas = tree_map(lambda p, g0: p - g0, params, global_params)
    first_grads = stacked_grad(loss_fn)(stacked_global, (x, y, mask))
    return deltas, first_grads


def cohort_update(loss_fn: Callable, global_params: Tree, shard: Callable,
                  device_ids: torch.Tensor, num_steps: torch.Tensor,
                  batch_idx: torch.Tensor, *, lr: float, mu: float = 0.0,
                  chunk: Optional[int] = None) -> Tuple[Tree, Tree]:
    """``client_update`` over a virtual cohort: ``shard(ids) -> (x, y,
    mask)`` generates the shards of ``device_ids (P,)`` on their device.
    With ``chunk`` set, at most ``chunk`` shards exist at once: each slice
    of ids, step budgets and ``batch_idx (P, max_steps, batch)`` trains on
    its own and the stacked results are concatenated.  The indices come in
    drawn for the whole cohort, so a device trains on the same batches
    whatever the chunking."""
    P = int(device_ids.shape[0])
    step = P if chunk is None or P <= chunk else int(chunk)
    parts = []
    for s in range(0, P, step):
        x, y, mask = shard(device_ids[s:s + step])
        parts.append(client_update(loss_fn, global_params, x, y, mask,
                                   num_steps[s:s + step],
                                   batch_idx[s:s + step], lr=lr, mu=mu))
        del x, y, mask
    if len(parts) == 1:
        return parts[0]
    return tuple(tree_map(lambda *c: torch.cat(c), *[p[i] for p in parts])
                 for i in range(2))
