"""Server-side round orchestration (Algorithm 1 + Algorithm 2).

``build_round_fn`` returns ONE function executing a full FL round:

  1. gather the K selected clients' shards from the device-resident dataset,
  2. run ``client_update`` on all of them (heterogeneous step budgets),
  3. estimate ∇f(w^t) from K₂ separately-sampled devices (or K₂=0 → reuse
     the round's own first-step gradients, §III-B),
  4. aggregate with the configured strategy (fedavg / folb / contextual / …).

Device sampling stays on the host (numpy RNG, seeded identically across
algorithms as in the paper's §IV-A3) and is bit-identical to
``repro.fl.server.sample_round``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from ..core import AggregatorConfig, SolveConfig, aggregate
from ..core.flatten import tree_leaves, tree_map
from ..device import DeviceLike, resolve_device
from .client import client_update, draw_batch_indices, local_gradient

Tree = Any


@dataclass(frozen=True)
class ServerConfig:
    aggregator: str = "contextual"
    num_devices: int = 30            # N
    clients_per_round: int = 10      # K
    grad_sample: int = 0             # K₂ (0 → reuse S_t, §III-B)
    lr: float = 0.03                 # client learning rate l
    beta: Optional[float] = None     # None → paper's β = 1/l
    mu: float = 0.0                  # FedProx proximal coefficient
    batch_size: int = 32
    min_epochs: int = 1              # computational heterogeneity:
    max_epochs: int = 20             #   epochs ~ U[min, max] per client/round
    gram_scope: Optional[str] = None # e.g. "last_layer" (§III-B efficiency)
    ridge: float = 1e-6
    expected_pool: Optional[int] = None  # N' for contextual_expected
    # -- adversarial wiring (repro_torch.robust) ---------------------------
    attack: Optional[Any] = None         # AttackModel; None → honest run
    malicious: Tuple[int, ...] = ()      # device ids under adversarial control
    robust: Optional[Any] = None         # RobustConfig for robust aggregators

    @property
    def smoothness(self) -> float:
        return self.beta if self.beta is not None else 1.0 / self.lr


class RoundState(NamedTuple):
    params: Tree
    round_idx: int


def init_server(params: Tree) -> RoundState:
    return RoundState(params=params, round_idx=0)


def _index(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def build_round_fn(loss_fn: Callable, cfg: ServerConfig,
                   samples_per_device: int,
                   device: DeviceLike = "cuda") -> Callable:
    """Return ``round_fn(state, data, sel, grad_sel, num_steps, generator=None,
    *, batch_idx=None, attack_noise=None) -> (RoundState, info)``.

    * ``data``       — ``(x (N,m,...), y (N,m), mask (N,m))`` tensors on
      ``device``
    * ``sel``        — (K,) selected client ids S_t
    * ``grad_sel``   — (K₂,) ids for the ∇f estimate (ignored if K₂=0)
    * ``num_steps``  — (K,) per-client local step budgets
    * ``generator``  — ``torch.Generator`` on ``device`` for the mini-batch
      draws, or ``batch_idx`` (K, max_steps, batch) to hand them in
    * ``attack_noise(tag, deltas, grads)`` — the adversary's standard-normal
      draws (``robust.attacks.Noise`` with a stream tag: 0 for the cohort's
      rows, 1 for the K₂ gradient sample), called only when ``cfg.attack``
      needs noise and a malicious device is in the rows it corrupts

    With ``cfg.attack`` (an update-space attack) and ``cfg.malicious``, the
    rows of malicious devices are corrupted after ``client_update`` (and in
    the K₂ gradient sample); honest rows stay bit-identical, so a cohort
    without a malicious device runs exactly the clean round.
    """
    dev = resolve_device(device)
    steps_per_epoch = max(samples_per_device // cfg.batch_size, 1)
    max_steps = cfg.max_epochs * steps_per_epoch
    agg_cfg = AggregatorConfig(
        name=cfg.aggregator,
        solve=SolveConfig(beta=cfg.smoothness, ridge=cfg.ridge),
        gram_scope=cfg.gram_scope, robust=cfg.robust)
    try:
        agg_fn = aggregate(cfg.aggregator)
    except KeyError:
        # robust variants register on package import; pull them in lazily,
        # as the reference does, so core never imports upward
        from .. import robust  # noqa: F401
        agg_fn = aggregate(cfg.aggregator)
    # robust contextual variants take the stacked per-client gradient
    # reports (the (K, J) cross matrix their pooling defends)
    grad_stack = getattr(agg_fn, "grad_stack", False)
    # update-space attacks corrupt after local training (label_flip poisons
    # the dataset in run_simulation instead)
    attack = cfg.attack
    if attack is not None and (attack.corrupts_data or not cfg.malicious):
        attack = None
    mal = np.asarray(sorted(set(cfg.malicious)), np.int64)

    def corrupt(tag, ids, deltas, grads, attack_noise):
        """The attack on the rows of ``ids`` that are malicious; the inputs
        themselves when none is."""
        rows = np.isin(np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                                  else ids, np.int64), mal)
        if not rows.any():
            return deltas, grads
        from ..robust.attacks import corrupt_stacked
        noise = (None if attack_noise is None
                 else lambda d, g: attack_noise(tag, d, g))
        return corrupt_stacked(attack, deltas, grads,
                               torch.as_tensor(rows, device=dev), noise)

    def round_fn(state: RoundState, data, sel, grad_sel, num_steps,
                 generator: Optional[torch.Generator] = None, *,
                 batch_idx: Optional[torch.Tensor] = None,
                 attack_noise: Optional[Callable] = None
                 ) -> Tuple[RoundState, Dict[str, torch.Tensor]]:
        x, y, mask = data
        sel_t = _index(sel, dev)
        K = sel_t.shape[0]
        cx, cy, cm = x[sel_t], y[sel_t], mask[sel_t]
        if batch_idx is None:
            if generator is None:
                raise ValueError("round_fn needs a generator or batch_idx")
            batch_idx = draw_batch_indices(cm, max_steps, cfg.batch_size,
                                           generator)
        elif tuple(batch_idx.shape) != (K, max_steps, cfg.batch_size):
            raise ValueError(f"batch_idx shape {tuple(batch_idx.shape)} != "
                             f"{(K, max_steps, cfg.batch_size)}")
        deltas, first_grads = client_update(
            loss_fn, state.params, cx, cy, cm, _index(num_steps, dev),
            batch_idx.to(dev), lr=cfg.lr, mu=cfg.mu)
        if attack is not None:
            deltas, first_grads = corrupt(0, sel, deltas, first_grads,
                                          attack_noise)

        if cfg.grad_sample > 0:
            gs = _index(grad_sel, dev)
            grads = vmap(lambda xx, yy, mm: local_gradient(
                loss_fn, state.params, xx, yy, mm))(x[gs], y[gs], mask[gs])
            if attack is not None:
                _, grads = corrupt(1, grad_sel, grads, grads, attack_noise)
        else:
            grads = first_grads
        grad_est = (grads if grad_stack
                    else tree_map(lambda g: g.mean(dim=0), grads))

        if cfg.aggregator == "contextual_expected":
            new_params, info = agg_fn(
                state.params, deltas, grad_est, agg_cfg,
                pool_size=cfg.expected_pool or cfg.num_devices)
        else:
            new_params, info = agg_fn(state.params, deltas, grad_est, agg_cfg)

        info = dict(info)
        info["update_norms"] = torch.sqrt(sum(
            l.float().reshape(K, -1).square().sum(dim=1)
            for l in tree_leaves(deltas)))
        return RoundState(new_params, state.round_idx + 1), info

    return round_fn


def sample_round(rng: np.random.RandomState, cfg: ServerConfig,
                 steps_per_epoch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side per-round randomness: S_t, the K₂ gradient sample, and the
    per-client local step budgets (epochs ~ U[min,max] × steps/epoch).

    Both S_t and the K₂ sample are drawn WITHOUT replacement (a device
    reports one gradient, duplicating it would silently bias the ∇f
    estimate), so both K and K₂ must fit in N."""
    if cfg.clients_per_round > cfg.num_devices:
        raise ValueError(
            f"clients_per_round={cfg.clients_per_round} exceeds "
            f"num_devices={cfg.num_devices}; cannot select a round cohort")
    if cfg.grad_sample > cfg.num_devices:
        raise ValueError(
            f"grad_sample={cfg.grad_sample} exceeds num_devices="
            f"{cfg.num_devices}; the K₂ gradient sample is drawn without "
            "replacement — use grad_sample <= num_devices (or 0 to reuse "
            "the round's own first-step gradients)")
    sel = rng.choice(cfg.num_devices, size=cfg.clients_per_round, replace=False)
    k2 = max(cfg.grad_sample, 1)
    grad_sel = rng.choice(cfg.num_devices, size=k2, replace=False)
    epochs = rng.randint(cfg.min_epochs, cfg.max_epochs + 1,
                         size=cfg.clients_per_round)
    num_steps = (epochs * steps_per_epoch).astype(np.int32)
    return sel.astype(np.int32), grad_sel.astype(np.int32), num_steps
