"""Buffered asynchronous aggregation with staleness-aware contextual solve
(``repro.edge.async_server``).

In the async runtime updates arrive one at a time, each computed against the
model version the device was *dispatched* with.  The server buffers arrivals
and aggregates whenever ``buffer_size`` updates are present.  Staleness
τ_k = (current model version) − (dispatch version) is discounted by a weight
s_k = s(τ_k) ∈ (0, 1]:

  * ``contextual_async`` — the paper's K×K contextual solve over the buffer
    under a shrink-to-noise staleness model: a τ-stale update is treated as
    Δ̃_k with mean s_k·Δ_k and uncorrelated residual energy (1−s_k²)·‖Δ_k‖².
    The expected bound then has staleness-discounted Gram cross-terms

        E⟨Δ̃_j, Δ̃_k⟩ = s_j s_k G_jk (j≠k),   E‖Δ̃_k‖² = G_kk,
        E⟨Δ̃_k, ∇f⟩ = s_k c_k,

    and its stationary α is applied to the raw buffered updates; with
    s ≡ 1 this is exactly ``contextual``.
  * ``fedbuff``  — FedBuff-style baseline: w ← w + (1/M) Σ_k s_k Δ_k
    (the server mixing rate η is folded into s by the runtime).
  * ``fedasync`` — the M=1 special case of the same rule.

All three are registered in ``repro_torch.core.aggregation``.  (G, c) come
from ``kernels.ops.gram_and_cross`` and each leaf's update is applied by
``stacked_weighted_sum`` (weights rounded to the leaf's dtype), so on the
card every flush launches the ``combine`` kernel once per leaf and every
``contextual_async`` flush the ``gram`` kernel once; the K×K discounting and
solve are torch on the same device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.aggregation import (AggregatorConfig, _num_clients,
                                _stacked_to_matrix, aggregate,
                                register_aggregator)
from ..core.flatten import (scope_vector, stacked_weighted_sum, tree_add,
                            tree_leaves, tree_map)
from ..core.gram import gram_residual
from ..core.solve import (SolveConfig, bound_value, solve_alpha,
                          theorem1_reduction)
from ..kernels.ops import gram_and_cross

Tree = Any
Info = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# staleness discounting
# ---------------------------------------------------------------------------

def staleness_weight(tau: float, mode: str = "poly",
                     decay: float = 0.5) -> float:
    """s(τ) ∈ (0, 1]: monotone non-increasing discount of a τ-versions-old
    update.  ``poly``: (1+τ)^(−a) (FedAsync's polynomial family), ``exp``:
    e^(−aτ), ``const``: 1 (no discounting)."""
    tau = max(float(tau), 0.0)
    if mode == "const":
        return 1.0
    if mode == "exp":
        return math.exp(-decay * tau)
    if mode == "poly":
        return (1.0 + tau) ** (-decay)
    raise KeyError(f"unknown staleness mode '{mode}' (poly|exp|const)")


# ---------------------------------------------------------------------------
# aggregators (registered into core.aggregation)
# ---------------------------------------------------------------------------

def _staleness_or_ones(stacked: Tree, cfg: AggregatorConfig) -> torch.Tensor:
    dev = tree_leaves(stacked)[0].device
    if cfg.staleness is None:
        return torch.ones((_num_clients(stacked),), dtype=torch.float32,
                          device=dev)
    return torch.as_tensor(cfg.staleness, dtype=torch.float32, device=dev)


def aggregate_contextual_async(params: Tree, stacked_updates: Tree,
                               grad_tree: Tree, cfg: AggregatorConfig
                               ) -> Tuple[Tree, Info]:
    """Contextual K×K solve with staleness-discounted Gram cross-terms.

    The diagonal stays at full energy: discounting the whole Gram as S·G·S
    and re-scaling α by s cancels exactly for invertible G, which would make
    staleness a no-op.  Keeping E‖Δ̃_k‖² = G_kk while crediting only s_k of
    the alignment is what shrinks a stale update's α."""
    s = _staleness_or_ones(stacked_updates, cfg)
    U = _stacked_to_matrix(stacked_updates, cfg.gram_scope)
    g = scope_vector(grad_tree, cfg.gram_scope)
    G, c = gram_and_cross(U, g)
    d = torch.diagonal(G)
    Gd = G * torch.outer(s, s) + torch.diag(d * (1.0 - s * s))
    cd = c * s
    alpha = solve_alpha(Gd, cd, cfg.solve)
    new = tree_add(params, stacked_weighted_sum(stacked_updates, alpha))
    beta = cfg.solve.beta
    info = {
        "alpha": alpha,
        "staleness_weight": s,
        "bound": bound_value(Gd, cd, alpha, beta),
        "theorem1_reduction": theorem1_reduction(Gd, alpha, beta),
        "stationarity_residual": torch.linalg.vector_norm(
            gram_residual(Gd, cd, alpha, beta)),
        "gram_diag": d,
    }
    return new, info


def aggregate_fedbuff(params: Tree, stacked_updates: Tree,
                      grad_tree: Optional[Tree], cfg: AggregatorConfig
                      ) -> Tuple[Tree, Info]:
    """FedBuff: uniform mean of staleness-discounted buffered updates.
    FedAsync is this with a single-update buffer."""
    s = _staleness_or_ones(stacked_updates, cfg)
    w = s / s.shape[0]
    new = tree_add(params, stacked_weighted_sum(stacked_updates, w))
    return new, {"alpha": w, "staleness_weight": s}


register_aggregator("contextual_async", aggregate_contextual_async)
register_aggregator("fedbuff", aggregate_fedbuff)
register_aggregator("fedasync", aggregate_fedbuff)


# ---------------------------------------------------------------------------
# async server config + update buffer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AsyncConfig:
    """Configuration of the asynchronous edge server (mirrors the sync
    :class:`repro_torch.fl.ServerConfig` where the concepts coincide)."""
    aggregator: str = "contextual_async"  # contextual_async | fedbuff | fedasync
    num_devices: int = 30                 # N
    buffer_size: int = 5                  # M updates per aggregation
    concurrency: Optional[int] = None     # in-flight cap (None → all devices)
    lr: float = 0.03                      # client learning rate l
    server_lr: float = 1.0                # η for fedasync/fedbuff mixing
    beta: Optional[float] = None          # None → paper's β = 1/l
    mu: float = 0.0                       # FedProx proximal coefficient
    batch_size: int = 32
    min_epochs: int = 1                   # per-dispatch epoch draw ~ U[min,max]
    max_epochs: int = 20
    gram_scope: Optional[str] = None
    ridge: float = 1e-6
    staleness_mode: str = "poly"          # poly | exp | const
    staleness_decay: float = 0.5

    def __post_init__(self):
        if self.aggregator == "fedasync" and self.buffer_size != 1:
            raise ValueError("fedasync aggregates every arrival; set "
                             f"buffer_size=1 (got {self.buffer_size})")
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.concurrency is not None and self.concurrency < 1:
            raise ValueError("concurrency must be >= 1 (or None for one task "
                             f"per device), got {self.concurrency}")

    @property
    def smoothness(self) -> float:
        return self.beta if self.beta is not None else 1.0 / self.lr

    def weight(self, tau: float) -> float:
        return staleness_weight(tau, self.staleness_mode, self.staleness_decay)


@dataclass
class BufferedUpdate:
    delta: Tree            # w_k(after local steps) − w(dispatch version)
    grad: Tree             # ∇F_k at the dispatch params (K₂=0-style estimate)
    dispatch_version: int
    device_id: int


class AsyncBuffer:
    """Holds arrived updates and flushes them through the configured
    aggregator once ``cfg.buffer_size`` are present."""

    def __init__(self, cfg: AsyncConfig):
        self.cfg = cfg
        self.items: List[BufferedUpdate] = []
        self.agg_fn = aggregate(cfg.aggregator)
        self.base_cfg = AggregatorConfig(
            name=cfg.aggregator,
            solve=SolveConfig(beta=cfg.smoothness, ridge=cfg.ridge),
            gram_scope=cfg.gram_scope)

    def add(self, update: BufferedUpdate) -> None:
        self.items.append(update)

    def ready(self) -> bool:
        return len(self.items) >= self.cfg.buffer_size

    def flush(self, params: Tree, current_version: int
              ) -> Tuple[Tree, Dict[str, Any]]:
        """Aggregate the buffered updates into ``params`` and clear.
        ``info["staleness"]`` and ``info["device_ids"]`` are numpy arrays,
        the rest tensors on the parameters' device."""
        if not self.items:
            raise RuntimeError("flush() on an empty buffer")
        dev = tree_leaves(params)[0].device
        taus = np.array([current_version - u.dispatch_version
                         for u in self.items], np.float32)
        s = np.array([self.cfg.weight(t) for t in taus], np.float32)
        # the server mixing rate η rides along in the aggregator's effective
        # weights (fedbuff/fedasync only); s itself stays the documented
        # s(τ) ∈ (0, 1] in the info dict below
        s_eff = (s * self.cfg.server_lr
                 if self.cfg.aggregator in ("fedbuff", "fedasync") else s)

        stacked = tree_map(lambda *xs: torch.stack(xs),
                           *[u.delta for u in self.items])
        # ∇f estimate: staleness-weighted mean of the buffered local
        # gradients, summed in buffer order from 0 as the reference does;
        # the f32 weights enter as Python floats (exact)
        gw = [float(w) for w in s / max(float(s.sum()), 1e-12)]
        grad_est = tree_map(lambda *gs: sum(w * g for w, g in zip(gw, gs)),
                            *[u.grad for u in self.items])

        agg_cfg = replace(self.base_cfg,
                          staleness=torch.as_tensor(s_eff, device=dev))
        new_params, info = self.agg_fn(params, stacked, grad_est, agg_cfg)
        info = dict(info)
        info["staleness_weight"] = torch.as_tensor(s, device=dev)
        info["staleness"] = taus
        info["device_ids"] = np.array([u.device_id for u in self.items])
        self.items = []
        return new_params, info
