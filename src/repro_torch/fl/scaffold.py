"""SCAFFOLD (Karimireddy et al. 2020, the paper's ref [10]) and its
contextual hybrid (``repro.fl.scaffold``).

SCAFFOLD corrects client drift with control variates: the server keeps a
global variate ``c`` and every client a local ``c_i``; local SGD steps use
``g + c − c_i``, and after a round (option II of the paper)

    c_i⁺ = c_i − c − Δ_i / (steps_i · lr)
    c   ← c + (K/N) · mean_i (c_i⁺ − c_i)

The K clients of a round step together, as ``fl.client.client_update``
does (vmap forward, one autograd pass a step), each gated by its own step
budget.  The per-client variates are stacked ``(N, …)`` on the device and
written back with an index assignment.  The server combine goes through
the ``core.aggregation`` registry, so ``aggregator='contextual'`` (the
beyond-paper SCAFFOLD(Contextual)) launches ``gram`` and ``combine`` on
the card.

The reference draws each step's mini-batch with ``jax.random.choice``
(``repro/fl/scaffold.py:47-51``), which torch cannot reproduce: here the
``(K, max_steps, batch)`` indices come from a seeded ``torch.Generator``
(``fl.client.draw_batch_indices``), or are handed in (``batch_idx`` on the
round function, ``batch_indices`` on :func:`run_scaffold`) — the tests
replay the reference's draws that way.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import AggregatorConfig, SolveConfig, aggregate
from ..core.flatten import tree_leaves, tree_map
from ..device import DeviceLike, resolve_device
from ..obs import spans
from .client import draw_batch_indices, stacked_grad
from .server import ServerConfig, _index, sample_round

Tree = Any


class ScaffoldState(NamedTuple):
    params: Tree
    c_global: Tree            # control variate
    c_locals: Tree            # stacked (N, …) per-client variates
    round_idx: int


def init_scaffold(params: Tree, num_devices: int) -> ScaffoldState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    c_locals = tree_map(lambda z: torch.zeros((num_devices,) + tuple(z.shape),
                                              dtype=torch.float32,
                                              device=z.device), zeros)
    return ScaffoldState(params, zeros, c_locals, 0)


def _rows(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A (K,) vector shaped to broadcast over a stacked (K, …) leaf."""
    return v.view(-1, *([1] * (p.dim() - 1)))


def build_scaffold_round_fn(loss_fn: Callable, cfg: ServerConfig,
                            samples_per_device: int,
                            device: DeviceLike = "cuda") -> Callable:
    """``round_fn(state, data, sel, num_steps, generator=None, *,
    batch_idx=None) -> (state, info)``; ``data`` is ``(x, y, mask)`` on
    ``device``, ``batch_idx`` the ``(K, max_steps, batch)`` indices (else
    drawn from ``generator``)."""
    dev = resolve_device(device)
    steps_per_epoch = max(samples_per_device // cfg.batch_size, 1)
    max_steps = cfg.max_epochs * steps_per_epoch
    lr = cfg.lr
    agg_cfg = AggregatorConfig(
        name=cfg.aggregator,
        solve=SolveConfig(beta=cfg.smoothness, ridge=cfg.ridge),
        gram_scope=cfg.gram_scope)
    agg_fn = aggregate(cfg.aggregator)
    batched_grad = stacked_grad(loss_fn)

    def round_fn(state: ScaffoldState, data, sel, num_steps,
                 generator: Optional[torch.Generator] = None, *,
                 batch_idx: Optional[torch.Tensor] = None
                 ) -> Tuple[ScaffoldState, Dict[str, torch.Tensor]]:
        x, y, mask = data
        sel_t = _index(sel, dev)
        K = int(sel_t.shape[0])
        cx, cy, cm = x[sel_t], y[sel_t], mask[sel_t]
        if batch_idx is None:
            if generator is None:
                raise ValueError("round_fn needs a generator or batch_idx")
            batch_idx = draw_batch_indices(cm, max_steps, cfg.batch_size,
                                           generator)
        elif tuple(batch_idx.shape) != (K, max_steps, cfg.batch_size):
            raise ValueError(f"batch_idx shape {tuple(batch_idx.shape)} != "
                             f"{(K, max_steps, cfg.batch_size)}")
        batch_idx = batch_idx.to(dev)
        steps = _index(num_steps, dev)
        c_sel = tree_map(lambda c: c[sel_t], state.c_locals)

        # -- K clients of drift-corrected local SGD, stepping together
        stacked = tree_map(lambda p: p.unsqueeze(0).expand(K, *p.shape),
                           state.params)
        params = tree_map(torch.clone, stacked)
        rows = torch.arange(K, device=dev)[:, None]
        ones = torch.ones((K, cfg.batch_size), dtype=torch.float32,
                          device=dev)
        for step in range(min(max_steps, int(steps.max()))):
            idx = batch_idx[:, step]
            g = batched_grad(params, (cx[rows, idx], cy[rows, idx], ones))
            live = (step < steps).float()
            params = tree_map(
                lambda p, gg, cg, ci: (p - lr * _rows(live, p) * (
                    gg.float() + cg - ci)).to(p.dtype),
                params, g, state.c_global, c_sel)
        deltas = tree_map(lambda p, p0: p - p0, params, state.params)
        denom = torch.clamp(steps.float() * lr, min=1e-12)
        c_new = tree_map(lambda ci, cg, d: ci - cg - d.float() / _rows(
            denom, d), c_sel, state.c_global, deltas)
        grads = batched_grad(stacked, (cx, cy, cm))

        grad_est = tree_map(lambda gr: gr.mean(dim=0), grads)
        new_params, info = agg_fn(state.params, deltas, grad_est, agg_cfg)

        # server variate update: c += (K/N)·mean(c_i⁺ − c_i)
        N = cfg.num_devices
        c_global = tree_map(lambda c, new, old: c + (K / N) * (
            new - old).mean(dim=0), state.c_global, c_new, c_sel)

        def write(all_c, new):
            out = all_c.clone()
            out[sel_t] = new
            return out
        c_locals = tree_map(write, state.c_locals, c_new)

        info = dict(info)
        info["c_norm"] = torch.sqrt(sum(l.square().sum()
                                        for l in tree_leaves(c_global)))
        return ScaffoldState(new_params, c_global, c_locals,
                             state.round_idx + 1), info

    return round_fn


def run_scaffold(name: str, loss_fn: Callable, apply_fn: Callable,
                 init_params: Tree, dataset, cfg: ServerConfig,
                 num_rounds: int, selection_seed: int = 1234,
                 batch_indices: Optional[
                     Callable[[int, np.ndarray, int], torch.Tensor]] = None,
                 device: DeviceLike = "cuda"):
    """The simulation loop of ``run_simulation`` with SCAFFOLD's rounds.

    Selection and step budgets come from ``sample_round`` on a numpy
    generator seeded with ``selection_seed`` (the reference's draws);
    mini-batches from a ``torch.Generator`` on ``device`` with the same
    seed, or from ``batch_indices(round, sel, max_steps)``.  Each round
    opens the spans ``round`` > ``update_aggregate`` and ``eval``."""
    from .metrics import evaluate_classifier, global_train_loss
    from .simulation import SimulationResult

    dev = resolve_device(device)
    round_fn = build_scaffold_round_fn(loss_fn, cfg,
                                       dataset.samples_per_device, device=dev)
    steps_per_epoch = max(dataset.samples_per_device // cfg.batch_size, 1)
    max_steps = cfg.max_epochs * steps_per_epoch
    state = init_scaffold(tree_map(lambda a: torch.as_tensor(a, device=dev),
                                   init_params), cfg.num_devices)
    data = (torch.as_tensor(dataset.x, device=dev),
            torch.as_tensor(dataset.y, dtype=torch.long, device=dev),
            torch.as_tensor(dataset.mask, device=dev))
    test_x = torch.as_tensor(dataset.test_x, device=dev)
    test_y = torch.as_tensor(dataset.test_y, dtype=torch.long, device=dev)
    rng = np.random.RandomState(selection_seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(selection_seed)
    result = SimulationResult(name=name)
    t0 = time.time()
    for t in range(num_rounds):
        with spans.span("round", round=t):
            sel, _, num_steps = sample_round(rng, cfg, steps_per_epoch)
            with spans.span("update_aggregate"):
                idx = (None if batch_indices is None
                       else batch_indices(t, sel, max_steps))
                state, _ = round_fn(state, data, sel, num_steps, gen,
                                    batch_idx=idx)
            with spans.span("eval"):
                result.train_loss.append(global_train_loss(
                    loss_fn, state.params, *data))
                nll, acc = evaluate_classifier(apply_fn, state.params,
                                               test_x, test_y)
            result.test_acc.append(acc)
            result.test_nll.append(nll)
    result.wall_time = time.time() - t0
    return result
