"""The hierarchical round engine over dense (P, n) round matrices
(``repro.hier.fused``).

A round's stacked client updates and gradients are flattened once into
(P, n) f32 matrices ``D`` and ``GM``; every tier node (gateway summary,
regional merge, cloud apply) is then one call over rows of them.  The
reference compiles each stage with ``jit`` and caches it by shape; PyTorch
runs eagerly, so here the stages are plain functions (:func:`summary_stage`,
:func:`cloud_stage`) and there is no stage cache.

Each Gram reduction goes through ``kernels.ops.gram_and_cross``, so on the
card every gateway, merge and cloud solve launches the ``gram`` kernel; a
robust stage (``HierConfig.robust``) also forms its members' (K, K) cross
matrix through ``kernels.ops.gram_block_and_cross`` (``gram_block``); the
α-weighted combinations ``α @ U`` stay ``torch.matmul``, as the reference
leaves them to XLA outside any Pallas kernel.  The solves use
``core.solve.solve_alpha`` (the Σγ = 1 KKT branch for merges and the
cloud's combination stage).  ``tests/test_torch_hier.py`` holds each stage
against the reference engine.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.aggregation import _stacked_to_matrix
from ..core.flatten import (select_scope, tree_add, tree_leaves, tree_size,
                            vector_to_tree)
from ..core.solve import SolveConfig, bound_value, solve_alpha
from ..kernels.ops import gram_and_cross
from .gateway import solve_diagnostics

Tree = Any


def scope_indices(template: Tree, scope: Optional[str]
                  ) -> Optional[np.ndarray]:
    """Flat-vector column indices selected by ``gram_scope`` (None → the
    whole vector)."""
    if scope is None or scope == "full":
        return None
    leaves = tree_leaves(template)
    kept = [l.numel() > 0 for l in tree_leaves(select_scope(template, scope))]
    idx, offset = [], 0
    for leaf, keep in zip(leaves, kept):
        if keep:
            idx.append(np.arange(offset, offset + leaf.numel(), dtype=np.int64))
        offset += leaf.numel()
    return np.concatenate(idx) if idx else np.zeros((0,), np.int64)


def _gram(U: torch.Tensor, g: torch.Tensor, idx: Optional[torch.Tensor]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    if idx is not None:
        U, g = U[:, idx], g[idx]
    return gram_and_cross(U.contiguous(), g.contiguous())


def _robust_solve(U: torch.Tensor, GR: torch.Tensor, w: torch.Tensor,
                  cfg: SolveConfig, robust, idx: Optional[torch.Tensor]):
    """The robust tier solve over member rows: G from ``gram``, the (K, K)
    cross matrix ``Us GRsᵀ`` from ``gram_block`` (so the pooling can
    down-vote poisoned gradient columns), then ``robustify`` and the solve.
    Returns ``(Gr, cr, alpha, s)``; the caller combines with ``s ⊙ α``."""
    from ..robust.aggregators import cross_stats
    from ..robust.gramstats import robustify
    if idx is not None:
        U, GR = U[:, idx], GR[:, idx]
    G, C = cross_stats(U.contiguous(), GR.contiguous(), w)
    Gr, cr, s = robustify(G, C, w, robust)
    return Gr, cr, solve_alpha(Gr, cr, cfg), s


def _robust_on(robust, applies: bool):
    """``robust`` when it hardens this stage (a contextual solve over
    members, defenses enabled), else None."""
    return robust if applies and getattr(robust, "enabled", False) else None


def summary_stage(U: torch.Tensor, GR: torch.Tensor, counts: torch.Tensor,
                  g: Optional[torch.Tensor], solve_cfg: SolveConfig,
                  mode: str, *, pool_scale: float = 1.0,
                  sum_to: Optional[float] = None,
                  scope_idx: Optional[torch.Tensor] = None,
                  robust=None) -> Dict[str, Any]:
    """One tier node over its member rows ``U (K, n)``, ``GR (K, n)`` — the
    engine's form of ``gateway.summarize_updates`` (``sum_to=1`` makes it
    the parent-tier merge).  Returns G, c, alpha, u_bar, ghat, info.

    With ``robust`` (a RobustConfig, contextual mode) the full (K, K) cross
    matrix replaces the premixed c (``_robust_solve``); α is then the
    clipped ``s ⊙ α``, ``info`` carries ``clip_scale``, and the shipped ĝ
    stays the plain weighted mean (the streamed engine holds no per-member
    gradient norms)."""
    cfg = solve_cfg
    if pool_scale != 1.0:
        cfg = replace(cfg, expectation_scale=cfg.expectation_scale
                      * pool_scale)
    if sum_to is not None:
        cfg = replace(cfg, sum_to=sum_to)
    w = counts / counts.sum().clamp(min=1e-12)
    ghat = w @ GR
    robust = _robust_on(robust, mode == "contextual")
    if robust is not None:
        Gr, cr, alpha, s = _robust_solve(U, GR, w, cfg, robust, scope_idx)
        eff = s * alpha
        info = solve_diagnostics(Gr, cr, alpha, cfg.beta)
        info["clip_scale"] = s
        return {"G": Gr, "c": cr, "alpha": eff, "u_bar": eff @ U,
                "ghat": ghat, "info": info}
    G, c = _gram(U, ghat if g is None else g, scope_idx)
    if mode == "contextual":
        alpha = solve_alpha(G, c, cfg)
        info = solve_diagnostics(G, c, alpha, cfg.beta)
    else:                                   # "mean" (hier-FedAvg tier)
        alpha = w
        info = {"bound": bound_value(G, c, alpha, cfg.beta)}
    return {"G": G, "c": c, "alpha": alpha, "u_bar": alpha @ U,
            "ghat": ghat, "info": info}


def cloud_stage(U: torch.Tensor, ghat: Optional[torch.Tensor],
                counts: torch.Tensor, solve_cfg: SolveConfig, kind: str, *,
                solve_scale: float = 1.0,
                override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                scope_idx: Optional[torch.Tensor] = None,
                robust=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The final tier: ``(delta (n,), info)`` — the engine's form of
    ``hier_server.cloud_aggregate``.  ``kind``: "combo" (Σγ = 1 over child
    combinations), "raw" (the paper's solve over raw updates, with the
    §III-C ``solve_scale``), or "fedavg" (count-weighted mean).
    ``override`` supplies sketched (G₂, c₂) for compressed summaries.
    With ``robust`` on a "raw" solve, ``ghat`` is the (K, n) per-member
    gradient matrix and the solve is ``summary_stage``'s robust one."""
    if kind == "fedavg":
        alpha = counts / counts.sum().clamp(min=1e-12)
        return alpha @ U, {"alpha": alpha, "gamma": alpha}
    cfg = solve_cfg
    if kind == "combo":
        cfg = replace(cfg, sum_to=1.0)
    elif solve_scale != 1.0:
        cfg = replace(cfg, expectation_scale=cfg.expectation_scale
                      * solve_scale)
    robust = _robust_on(robust, kind == "raw")
    if robust is not None:
        w = counts / counts.sum().clamp(min=1e-12)
        Gr, cr, alpha, s = _robust_solve(U, ghat, w, cfg, robust, scope_idx)
        eff = s * alpha
        return eff @ U, {"alpha": eff, "gamma": eff,
                         **solve_diagnostics(Gr, cr, alpha, cfg.beta),
                         "gram_diag": torch.diagonal(Gr), "clip_scale": s}
    G, c = override if override is not None else _gram(U, ghat, scope_idx)
    alpha = solve_alpha(G, c, cfg)
    info = {"alpha": alpha, "gamma": alpha,
            **solve_diagnostics(G, c, alpha, cfg.beta),
            "gram_diag": torch.diagonal(G)}
    return alpha @ U, info


def _counts(counts: Sequence[float], device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(counts, np.float32), device=device)


def apply_delta(params: Tree, delta_vec: torch.Tensor) -> Tree:
    """``w ← w + Δ`` with a flat Δ — the one tree conversion per round."""
    return tree_add(params, vector_to_tree(delta_vec, params))


def weighted_mean_rows(vecs: Sequence[torch.Tensor],
                       w: torch.Tensor) -> torch.Tensor:
    """Count-weighted mean of (n,) vectors; takes raw counts."""
    return (w / w.sum().clamp(min=1e-12)) @ torch.stack(list(vecs))


class HierRoundEngine:
    """Per-run engine: holds the model width, solve config, tier mode and
    gram scope, and wraps each round's stacked updates as a
    :class:`FusedRoundContext` — the round API ``run_hier_simulation``
    drives."""

    name = "fused"

    def __init__(self, params_template: Tree, solve_cfg: SolveConfig,
                 tier_mode: str, gram_scope: Optional[str] = None,
                 robust=None):
        self.n = tree_size(params_template)
        self.solve_cfg = solve_cfg
        self.tier_mode = tier_mode
        self.gram_scope = gram_scope
        # RobustConfig (or None): hardens the member-level stages (gateway,
        # cloud_raw); merges and combos act on children already hardened
        self.robust = robust
        idx = scope_indices(params_template, gram_scope)
        dev = tree_leaves(params_template)[0].device
        self.scope_idx = (None if idx is None
                          else torch.as_tensor(idx, device=dev))

    def peak_round_bytes(self, P: int, dense_fallback_members: int = 0
                         ) -> float:
        """The round matrices' footprint: D and GM as (P, n) f32.
        ``dense_fallback_members`` belongs to the streamed engine."""
        del dense_fallback_members
        return float(2 * P * self.n * 4)

    def begin_round(self, stacked_deltas: Tree,
                    stacked_grads: Tree) -> "FusedRoundContext":
        return FusedRoundContext(self, _stacked_to_matrix(stacked_deltas, None),
                                 _stacked_to_matrix(stacked_grads, None))


class FusedRoundContext:
    """One round's state: the flat (P, n) round matrices plus any decoded
    device rows (device-uplink compression); refs are plain (n,) vectors."""

    name = "fused"

    def __init__(self, engine: HierRoundEngine, D: torch.Tensor,
                 GM: torch.Tensor):
        self.engine = engine
        self.D, self.GM = D, GM
        self.P = int(D.shape[0])
        self._dec: Dict[int, torch.Tensor] = {}
        self._dec_g: Dict[int, torch.Tensor] = {}

    # -- device-uplink decodes ---------------------------------------------

    def add_decoded_row(self, i: int, d_vec: torch.Tensor,
                        g_vec: torch.Tensor) -> None:
        self._dec[i] = d_vec
        self._dec_g[i] = g_vec

    def _rows(self, idxs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(U, GR): the cohort's rows, with device-uplink decodes in place
        of the rows they replace."""
        sel = torch.as_tensor(np.asarray(idxs, np.int64), device=self.D.device)
        U, GR = self.D[sel], self.GM[sel]
        if not self._dec:
            return U, GR
        idxs = [int(i) for i in idxs]
        dec = [k for k, i in enumerate(idxs) if i in self._dec]
        if dec:
            pos = torch.as_tensor(dec, dtype=torch.long, device=self.D.device)
            U[pos] = torch.stack([self._dec[idxs[k]] for k in dec])
            GR[pos] = torch.stack([self._dec_g[idxs[k]] for k in dec])
        return U, GR

    # -- gradient refs ------------------------------------------------------

    def mean_grad(self, idxs) -> torch.Tensor:
        sel = torch.as_tensor(np.asarray(idxs, np.int64), device=self.GM.device)
        return self.GM[sel].mean(dim=0)

    def compose_grads(self, refs, counts) -> torch.Tensor:
        return weighted_mean_rows(refs, _counts(counts, self.GM.device))

    # -- tier stages ---------------------------------------------------------

    def gateway(self, idxs, *, solve_grad=None,
                pool_scale: float = 1.0) -> Dict[str, Any]:
        U, GR = self._rows(idxs)
        eng = self.engine
        return summary_stage(U, GR, torch.ones(len(idxs), device=U.device),
                             solve_grad, eng.solve_cfg, eng.tier_mode,
                             pool_scale=pool_scale, scope_idx=eng.scope_idx,
                             robust=eng.robust)

    def merge(self, u_refs, g_refs, counts, *,
              solve_grad=None) -> Dict[str, Any]:
        eng = self.engine
        return summary_stage(torch.stack(list(u_refs)),
                             torch.stack(list(g_refs)),
                             _counts(counts, self.D.device), solve_grad,
                             eng.solve_cfg, eng.tier_mode, sum_to=1.0,
                             scope_idx=eng.scope_idx)

    def cloud_raw(self, idxs, kind: str, *, solve_scale: float = 1.0
                  ) -> Tuple[torch.Tensor, Dict]:
        U, GR = self._rows(idxs)
        eng = self.engine
        robust = _robust_on(eng.robust, kind == "raw")
        return cloud_stage(U, GR if robust is not None else GR.mean(dim=0),
                           torch.ones(len(idxs), device=U.device),
                           eng.solve_cfg, kind, solve_scale=solve_scale,
                           scope_idx=eng.scope_idx, robust=robust)

    def cloud_combo(self, u_refs, counts, ghat, *, kind: str = "combo",
                    override=None) -> Tuple[torch.Tensor, Dict]:
        eng = self.engine
        return cloud_stage(torch.stack(list(u_refs)), ghat,
                           _counts(counts, self.D.device), eng.solve_cfg,
                           kind, override=override, scope_idx=eng.scope_idx)

    # -- vector materialization / final apply --------------------------------

    def materialize(self, ref) -> torch.Tensor:
        return ref

    def apply(self, params: Tree, delta_ref: torch.Tensor) -> Tree:
        """``w ← w + Δ`` with a flat Δ."""
        return apply_delta(params, delta_ref)
