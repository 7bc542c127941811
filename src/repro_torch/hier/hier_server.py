"""Cloud-side aggregation over gateway summaries + hierarchical baselines
(``repro.hier.hier_server``).

The cloud receives one summary per reporting top-tier child and solves the
P×P contextual system over their combined updates,

    G₂ = [⟨ū_g, ū_h⟩],   c₂ = [⟨ū_g, ĝ⟩],   γ* = −(1/β) G₂⁺ c₂,

then applies ``w ← w + Σ_g γ_g ū_g``.  Four strategies are registered in
``core.aggregation`` (the stacked leading axis is the top-tier children):

  * ``hier_contextual``        — contextual solve at every tier;
  * ``hier_fedavg``            — count-weighted mean at every tier;
  * ``hier_relay``             — gateways forward raw updates, the cloud runs
                                 the flat contextual solve;
  * ``hier_contextual_sketch`` — compressed summaries; the γ stage solves on
                                 sketched cross-terms (``gram_override``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compress import CompressConfig
from ..core.aggregation import (AggregatorConfig, aggregate,
                                aggregate_contextual, aggregate_fedavg,
                                register_aggregator)
from ..core.solve import SolveConfig
from .gateway import GatewaySummary

Tree = Any


def aggregate_hier_contextual(params: Tree, stacked_updates: Tree,
                              grad_tree: Tree, cfg: AggregatorConfig
                              ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """Cloud γ-solve over stacked child combinations (the P×P stage); the
    info dict also carries ``gamma``."""
    new, info = aggregate_contextual(params, stacked_updates, grad_tree, cfg)
    info = dict(info)
    info["gamma"] = info["alpha"]
    return new, info


def aggregate_hier_fedavg(params: Tree, stacked_updates: Tree,
                          grad_tree: Optional[Tree], cfg: AggregatorConfig
                          ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """Count-weighted mean of child combinations (``cfg.client_weights`` =
    devices under each child)."""
    return aggregate_fedavg(params, stacked_updates, grad_tree, cfg)


def aggregate_hier_contextual_sketch(params: Tree, stacked_updates: Tree,
                                     grad_tree: Tree, cfg: AggregatorConfig
                                     ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """γ-solve over compressed child combinations: the sketched cross-terms
    arrive through ``cfg.gram_override``, the decoded updates as the stacked
    members."""
    return aggregate_hier_contextual(params, stacked_updates, grad_tree, cfg)


register_aggregator("hier_contextual", aggregate_hier_contextual)
register_aggregator("hier_fedavg", aggregate_hier_fedavg)
register_aggregator("hier_relay", aggregate_contextual)
register_aggregator("hier_contextual_sketch", aggregate_hier_contextual_sketch)


def cloud_aggregate(params: Tree, stacked_members: Tree, grad_est: Tree,
                    member_counts: Sequence[int], cfg: "HierConfig",
                    combos: bool = True,
                    gram_override: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None,
                    solve_scale: float = 1.0) -> Tuple[Tree, Dict[str, Any]]:
    """Final tier through the ``core.aggregation`` registry: over child
    combinations (``combos=True``) the solve conserves mass (Σγ = 1); over
    raw device updates (star, relay) it is the paper's unconstrained solve,
    with the §III-C ``solve_scale`` for a fan-in-sampled cohort."""
    solve = cfg.solve_config()
    if combos:
        solve = replace(solve, sum_to=1.0)
    if solve_scale != 1.0:
        solve = replace(solve,
                        expectation_scale=solve.expectation_scale * solve_scale)
    weights = None
    if cfg.aggregator == "hier_fedavg":
        weights = torch.as_tensor(list(member_counts), dtype=torch.float32)
    agg_cfg = AggregatorConfig(name=cfg.aggregator, solve=solve,
                               gram_scope=cfg.gram_scope,
                               client_weights=weights,
                               gram_override=gram_override)
    new_params, info = aggregate(cfg.aggregator)(params, stacked_members,
                                                 grad_est, agg_cfg)
    info = dict(info)
    info.setdefault("gamma", info["alpha"])
    return new_params, info


def _host(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def blockdiag_diagnostics(summaries: Sequence[GatewaySummary], gamma,
                          beta: float) -> Dict[str, Any]:
    """Block-wise view of the induced device-level solve: the effective
    weights ``α_k = γ_g α_{g,k}`` priced under the block-diagonal Gram of
    the shipped diagonal blocks (numpy, f64)."""
    gam = _host(gamma)
    Gs = [_host(s.G).astype(np.float64) for s in summaries]
    cs = [_host(s.c).astype(np.float64) for s in summaries]
    als = [_host(s.alpha).astype(np.float64) for s in summaries]
    alpha_full = np.concatenate([gam[g] * a for g, a in enumerate(als)])
    c_full = np.concatenate(cs)
    quad = sum(float(a @ G @ a) * gam[g] * gam[g]
               for g, (G, a) in enumerate(zip(Gs, als)))
    return {
        "alpha_effective": alpha_full,
        "blockdiag_bound": float(c_full @ alpha_full) + 0.5 * beta * quad,
        "tier1_theorem1_reductions": np.asarray(
            [0.5 * beta * float(a @ G @ a) for G, a in zip(Gs, als)]),
        "devices_represented": int(sum(s.num_updates for s in summaries)),
    }


@dataclass(frozen=True)
class HierConfig:
    """Configuration of a hierarchical run (as ``repro.hier.HierConfig``)."""
    aggregator: str = "hier_contextual"  # hier_contextual | hier_fedavg |
                                         # hier_relay | hier_contextual_sketch
    fan_in: Optional[int] = None         # devices sampled per gateway per
                                         # round (None → every child)
    compress: Optional[CompressConfig] = None
                                         # summary compression; requires the
                                         # _sketch aggregator (defaulted when
                                         # that name is chosen)
    gateway_grad: str = "local"          # "local" (each subtree's ĝ) or
                                         # "global" (gradient pre-pass)
    lr: float = 0.03                     # client learning rate l
    beta: Optional[float] = None         # None → paper's β = 1/l
    mu: float = 0.0                      # FedProx proximal coefficient
    batch_size: int = 32
    min_epochs: int = 1                  # per-round epoch draw ~ U[min,max]
    max_epochs: int = 20
    gram_scope: Optional[str] = None
    ridge: float = 1e-6
    robust: Optional[Any] = None         # repro_torch.robust RobustConfig:
                                         # clip + median-of-means/trimmed
                                         # pooling on the tier (G, c)
                                         # statistics before each solve

    def __post_init__(self):
        if self.aggregator not in ("hier_contextual", "hier_fedavg",
                                   "hier_relay", "hier_contextual_sketch"):
            raise ValueError(f"unknown hier aggregator '{self.aggregator}' "
                             "(hier_contextual|hier_fedavg|hier_relay|"
                             "hier_contextual_sketch)")
        if self.fan_in is not None and self.fan_in < 1:
            raise ValueError(f"fan_in must be >= 1 (or None for all "
                             f"children), got {self.fan_in}")
        if self.gateway_grad not in ("global", "local"):
            raise ValueError(f"gateway_grad must be 'global' or 'local', "
                             f"got '{self.gateway_grad}'")
        if self.aggregator == "hier_contextual_sketch" and self.compress is None:
            object.__setattr__(self, "compress", CompressConfig())
        if self.compress is not None:
            if self.aggregator != "hier_contextual_sketch":
                raise ValueError("summary compression requires the "
                                 "'hier_contextual_sketch' aggregator, got "
                                 f"'{self.aggregator}'")
            if self.gateway_grad != "local":
                raise ValueError("summary compression composes with "
                                 "gateway_grad='local' only: the gradient "
                                 "pre-pass would ship full-width ĝ both ways "
                                 "and defeat the uplink budget")
        if self.robust is not None:
            from ..robust.gramstats import RobustConfig
            if not isinstance(self.robust, RobustConfig):
                raise TypeError("HierConfig.robust must be a "
                                "repro_torch.robust.RobustConfig, got "
                                f"{type(self.robust).__name__}")
            if self.aggregator != "hier_contextual":
                raise ValueError("robust tier statistics require the "
                                 "'hier_contextual' aggregator (the solve "
                                 "they harden), got "
                                 f"'{self.aggregator}'")
            if self.gateway_grad != "local":
                raise ValueError("robust tier statistics require "
                                 "gateway_grad='local': median-of-means/"
                                 "trimmed pooling acts on the per-member "
                                 "gradient columns, which the global "
                                 "pre-pass pre-averages away")

    @property
    def smoothness(self) -> float:
        return self.beta if self.beta is not None else 1.0 / self.lr

    @property
    def tier_mode(self) -> str:
        """Per-tier rule below the cloud: contextual everywhere except the
        hier-FedAvg baseline's count-weighted means."""
        return "mean" if self.aggregator == "hier_fedavg" else "contextual"

    @property
    def compressing(self) -> bool:
        return self.compress is not None

    def solve_config(self) -> SolveConfig:
        return SolveConfig(beta=self.smoothness, ridge=self.ridge)
