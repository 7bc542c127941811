"""The streamed hierarchical round engine — big-model rounds without (P, n)
round matrices (``repro.hier.streamed``).

The fused engine (``hier/fused.py``) flattens a round's P client updates
into dense (P, n) f32 matrices.  At transformer width that means P extra
full-width f32 model copies, and as many again for the gradient estimates,
just to run K×K solves.  This engine uses the identity the whole tier tree
lives on: every Gram block, c-term and combined update of every tier is a
function of the device-level pair

    G = D Dᵀ,  C = D GMᵀ  ∈ R^{P×P}

and small per-tier weight vectors.  A gateway cohort's Gram is the
sub-block ``G[idx][:, idx]``, its c-term the row-mix ``C[idx] @ w``; a
parent tier over child combinations ``ū_g = α_g @ U_g`` has Gram
``W G Wᵀ``; the cloud's final step is one effective row-mix ``Σ_g γ_g α_g``
applied to D.  So one pass over the leaf slabs through the ``stream_stats``
kernel accumulates all a round needs (:meth:`StreamedRoundEngine.begin_round`),
the tier solves run in P-dimensional space, and a second pass writes
``α @ U`` leaf by leaf into the parameters through the ``combine`` kernel
(:meth:`StreamedRoundContext.apply`).

Payloads (ū_g, ĝ_g) stay symbolic :class:`RowMix` weights over the round's
P rows until compression needs n floats: ``materialize`` then builds the
vector with one ``mix_rows`` per slab.  Above a compression hop the decoded
summaries are dense (n,) vectors, and those tiers run the fused engine's
stage functions over the small (#children, n) stacks.

The four P-space stages are plain functions, as the port's fused stages
are (no jit caches).  With ``robust`` (``HierConfig.robust``) the device
tier and the raw cloud run ``robustify`` on the cohort's sub-blocks of
(G, C) before their solves: no new kernel, as C is the round's D GMᵀ.
On the card the kernels take each slab as it lies, of any width, with no
pad and no copy; there is no autotune
(``ROADMAP.md``'s dispatch contract), so the reference's capped timing
(``AUTOTUNE_CAP_COLS``, ``select_impl_for``) has no counterpart here.

On a mesh of ranks (``mesh``) each rank reads only its column windows of
each slab (``sharding.stream_windows``: one window a rank over the slab's
flattened columns, edges on 256-column multiples) in all three passes:
its (G, C) partials are summed by one all-reduce, and the materialized
vectors and the applied parameters are gathered window by window, so every
rank ends the round with the same bits.  The P-space stages and the fused
stages above a compression hop run whole on every rank.
``tests/test_torch_streamed.py`` holds every stage against the reference,
``tests/test_torch_streamed_mesh.py`` the split on 8 ranks.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.distributed import all_gather_windows, all_reduce_sum
from ..core.flatten import (ChunkedFlatView, mix_rows, tree_leaves,
                            tree_map, tree_size)
from ..core.solve import SolveConfig, bound_value, solve_alpha
from ..kernels.ops import stream_stats, weighted_combine
from ..obs import current_tracker, spans
from ..sharding.specs import stream_axes, stream_windows, window_width
from .fused import (_robust_on, apply_delta, cloud_stage, scope_indices,
                    summary_stage, weighted_mean_rows)
from .gateway import solve_diagnostics

Tree = Any

DEFAULT_CHUNK = 1 << 16


def dense_round_bytes(P: int, n: int) -> float:
    """What the fused engine's round matrices would occupy: D + GM f32."""
    return float(2 * P * n * 4)


@dataclass
class RowMix:
    """A symbolic n-vector: weights ``w`` (P,) f32 over the round's stacked
    rows of the update (``src='delta'``) or gradient (``src='grad'``) tree."""
    w: torch.Tensor
    src: str


def _is_mix(ref) -> bool:
    return isinstance(ref, RowMix)


def _adjust(cfg: SolveConfig, *, scale: float = 1.0,
            sum_to: Optional[float] = None) -> SolveConfig:
    if scale != 1.0:
        cfg = replace(cfg, expectation_scale=cfg.expectation_scale * scale)
    if sum_to is not None:
        cfg = replace(cfg, sum_to=sum_to)
    return cfg


def _weights(counts: torch.Tensor) -> torch.Tensor:
    return counts / counts.sum().clamp(min=1e-12)


def _scatter(P: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((P,), dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out


def _solve_info(Gs, c, cfg, mode, wts):
    """The per-tier solve and its diagnostics (fused ``summary_stage``'s)."""
    if mode == "contextual":
        alpha = solve_alpha(Gs, c, cfg)
        return alpha, solve_diagnostics(Gs, c, alpha, cfg.beta)
    return wts, {"bound": bound_value(Gs, c, wts, cfg.beta)}   # "mean"


def _cloud_solve_info(Gs, c, cfg):
    """The final-tier solve and the cloud's info keys (fused
    ``cloud_stage``'s)."""
    gamma = solve_alpha(Gs, c, cfg)
    return gamma, {"alpha": gamma, "gamma": gamma,
                   **solve_diagnostics(Gs, c, gamma, cfg.beta),
                   "gram_diag": torch.diagonal(Gs)}


def _robust_solve(G: torch.Tensor, C: torch.Tensor, idx: torch.Tensor,
                  wts: torch.Tensor, cfg: SolveConfig, robust):
    """``robustify`` on the cohort's sub-blocks ``G[idx][:, idx]`` and
    ``C[idx][:, idx]`` (exactly the fused engine's ``Us GRsᵀ``), then the
    solve: ``(Gr, cr, alpha, s)``."""
    from ..robust.gramstats import robustify
    Gr, cr, s = robustify(G[idx][:, idx], C[idx][:, idx], wts, robust)
    return Gr, cr, solve_alpha(Gr, cr, cfg), s


def tier_stage(G: torch.Tensor, C: torch.Tensor, idx: torch.Tensor,
               counts: torch.Tensor, solve_cfg: SolveConfig, mode: str, *,
               pool_scale: float = 1.0,
               g_w: Optional[torch.Tensor] = None,
               robust=None) -> Dict[str, Any]:
    """Device tier over row indices ``idx (K,)`` → G, c, alpha, u_w, ghat_w,
    info.  ``g_w`` (P,) replaces the cohort's own ĝ mix in the c-term.
    With ``robust`` (contextual mode) the cohort's cross sub-block feeds
    clipping and pooling before the solve; α is the clipped ``s ⊙ α`` and
    the shipped ĝ mix stays the plain weighted mean."""
    cfg = _adjust(solve_cfg, scale=pool_scale)
    wts = _weights(counts)
    ghat_w = _scatter(G.shape[0], idx, wts)
    robust = _robust_on(robust, mode == "contextual")
    if robust is not None:
        Gr, cr, alpha, s = _robust_solve(G, C, idx, wts, cfg, robust)
        eff = s * alpha
        info = solve_diagnostics(Gr, cr, alpha, cfg.beta)
        info["clip_scale"] = s
        return {"G": Gr, "c": cr, "alpha": eff,
                "u_w": _scatter(G.shape[0], idx, eff), "ghat_w": ghat_w,
                "info": info}
    Gs = G[idx][:, idx]
    c = C[idx] @ (ghat_w if g_w is None else g_w)
    alpha, info = _solve_info(Gs, c, cfg, mode, wts)
    return {"G": Gs, "c": c, "alpha": alpha,
            "u_w": _scatter(G.shape[0], idx, alpha), "ghat_w": ghat_w,
            "info": info}


def merge_stage(G: torch.Tensor, C: torch.Tensor, W: torch.Tensor,
                GW: torch.Tensor, counts: torch.Tensor,
                solve_cfg: SolveConfig, mode: str, *,
                sum_to: Optional[float] = 1.0,
                g_w: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Parent tier over child row-mixes ``W (K, P)``, ``GW (K, P)``: Gram
    ``W G Wᵀ``, c-term ``(W C) ĝ_w``."""
    cfg = _adjust(solve_cfg, sum_to=sum_to)
    wts = _weights(counts)
    ghat_w = wts @ GW
    Gs = W @ G @ W.T
    c = (W @ C) @ (ghat_w if g_w is None else g_w)
    alpha, info = _solve_info(Gs, c, cfg, mode, wts)
    return {"G": Gs, "c": c, "alpha": alpha, "u_w": alpha @ W,
            "ghat_w": ghat_w, "info": info}


def cloud_raw_stage(G: torch.Tensor, C: torch.Tensor, idx: torch.Tensor,
                    counts: torch.Tensor, solve_cfg: SolveConfig, kind: str,
                    *, solve_scale: float = 1.0,
                    robust=None) -> Dict[str, Any]:
    """Final tier over raw device rows (star / relay) → u_w, info: the fused
    ``cloud_stage`` on sub-blocks, with the same robust hook."""
    wts = _weights(counts)
    robust = _robust_on(robust, kind == "raw")
    if kind == "fedavg":
        alpha, info = wts, {"alpha": wts, "gamma": wts}
    elif robust is not None:
        cfg = _adjust(solve_cfg, scale=solve_scale)
        Gr, cr, gamma, s = _robust_solve(G, C, idx, wts, cfg, robust)
        alpha = s * gamma
        info = {"alpha": alpha, "gamma": alpha,
                **solve_diagnostics(Gr, cr, gamma, cfg.beta),
                "gram_diag": torch.diagonal(Gr), "clip_scale": s}
    else:
        cfg = _adjust(solve_cfg, scale=solve_scale)
        c = C[idx] @ _scatter(G.shape[0], idx, wts)
        alpha, info = _cloud_solve_info(G[idx][:, idx], c, cfg)
    return {"u_w": _scatter(G.shape[0], idx, alpha), "info": info}


def cloud_combo_stage(G: torch.Tensor, C: torch.Tensor, W: torch.Tensor,
                      g_w: torch.Tensor, counts: torch.Tensor,
                      solve_cfg: SolveConfig, kind: str) -> Dict[str, Any]:
    """Final tier over child combinations ``W (K, P)`` → eff_w, info, with
    the mass-conserving Σγ = 1 solve; ``eff_w = γ @ W`` is the round's one
    effective row-mix."""
    if kind == "fedavg":
        gamma = _weights(counts)
        info = {"alpha": gamma, "gamma": gamma}
    else:
        cfg = _adjust(solve_cfg, sum_to=1.0 if kind == "combo" else None)
        gamma, info = _cloud_solve_info(W @ G @ W.T, (W @ C) @ g_w, cfg)
    return {"eff_w": gamma @ W, "info": info}


class StreamedRoundEngine:
    """Peer of :class:`repro_torch.hier.fused.HierRoundEngine` with the same
    constructor plus ``chunk`` — the reference's column chunk, which sets
    the memory model :meth:`peak_round_bytes` reports; the kernel walks
    each slab in tiles of its own — ``donate_params``: :meth:`apply`
    then updates the parameter tensors in place (the reference donates
    them) — and ``mesh``: on a mesh of ranks each pass reads only this
    rank's column windows (the reference's ``stream_round_shardings``
    placement, as flat windows)."""

    name = "streamed"

    def __init__(self, params_template: Tree, solve_cfg: SolveConfig,
                 tier_mode: str, gram_scope: Optional[str] = None, *,
                 chunk: Optional[int] = None, donate_params: bool = False,
                 robust=None, mesh=None):
        # a mesh of ranks splits every pass over its ranks' column windows
        # (sharding.stream_windows); a mesh without a process group (one
        # rank, or emulated) runs the round whole on this rank
        self.mesh = mesh
        self.split = mesh is not None and mesh.device_mesh is not None
        self.axes = stream_axes(mesh) if self.split else ()
        self.n = tree_size(params_template)
        self.solve_cfg = solve_cfg
        self.tier_mode = tier_mode
        self.gram_scope = gram_scope
        self.chunk = int(chunk if chunk is not None else
                         os.environ.get("REPRO_STREAM_CHUNK", DEFAULT_CHUNK))
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        self.donate_params = bool(donate_params)
        # RobustConfig (or None): hardens the device-tier and raw cloud
        # stages, on the statistics the accumulate pass already holds
        self.robust = robust
        # scoped columns of the fused fallback stages above a compression hop
        idx = scope_indices(params_template, gram_scope)
        dev = tree_leaves(params_template)[0].device
        self.scope_idx = (None if idx is None
                          else torch.as_tensor(idx, device=dev))

    def peak_round_bytes(self, P: int, dense_fallback_members: int = 0
                         ) -> float:
        """The reference's model of the round-matrix working set: two
        (P, chunk) f32 column tiles plus the two (P, P) f32 accumulators,
        and, above a compression hop, the fallback stages' two dense
        (members, n) f32 stacks (``dense_fallback_members``: the largest
        summary-tier fan-in)."""
        bn = min(self.chunk, self.n)
        return float(2 * P * bn * 4 + 2 * P * P * 4
                     + 2 * dense_fallback_members * self.n * 4)

    def window(self, width: int) -> Tuple[int, int]:
        """This rank's column window of a slab of ``width`` columns
        (``sharding.stream_windows``); without a split, the whole slab."""
        return stream_windows(self.mesh, width) if self.split else (0, width)

    def gather(self, part: torch.Tensor, out: torch.Tensor) -> None:
        """Every rank's window of a slab's columns into ``out`` (the slab's
        (width,) row), in rank order; ``part`` is this rank's, which may lie
        in ``out`` at its own window.  Without a split ``part`` is ``out``."""
        if self.split:
            all_gather_windows(self.mesh, part,
                               window_width(out.shape[0], self.mesh.size),
                               self.axes, out)

    def begin_round(self, stacked_deltas: Tree,
                    stacked_grads: Tree) -> "StreamedRoundContext":
        """One pass over the scoped leaf slabs: (G, C) summed in slab order
        by ``stream_stats`` (the kernel adds each slab into them).  On a
        mesh of ranks each rank reads only its window of each slab (an
        empty window launches nothing), and one all-reduce over every mesh
        axis sums the stacked (2, P, P) partials."""
        dview = ChunkedFlatView(stacked_deltas, self.gram_scope)
        gview = ChunkedFlatView(stacked_grads, self.gram_scope)
        P = dview.K
        scoped = dview.scoped_slabs
        dev = dview.slabs[0].matrix.device
        stats = torch.zeros((2, P, P), dtype=torch.float32, device=dev)
        G, C = stats[0], stats[1]
        n_chunks = sum(-(-s.width // self.chunk) for s in scoped)
        with spans.span("stream_accumulate", P=P, chunks=n_chunks,
                        chunk_cols=self.chunk, slabs=len(scoped)):
            for s in scoped:
                w0, w1 = self.window(s.width)
                if w1 > w0:
                    stream_stats(s.matrix[:, w0:w1],
                                 gview.slabs[s.index].matrix[:, w0:w1],
                                 out=(G, C))
            if self.split:
                all_reduce_sum(self.mesh, stats, self.axes)
        tr = current_tracker()
        if tr.active:
            tr.scope("hier/streamed").log({
                "P": P, "chunk_cols": self.chunk, "num_chunks": n_chunks,
                "num_slabs": len(scoped),
                "peak_round_matrix_bytes": self.peak_round_bytes(P),
                "dense_round_matrix_bytes": dense_round_bytes(P, self.n)})
        return StreamedRoundContext(self, dview, gview, G, C)


class StreamedRoundContext:
    """One round's state: the (P, P) statistics and the slab views of the
    stacked update and gradient trees.  The surface of
    :class:`repro_torch.hier.fused.FusedRoundContext`; refs are
    :class:`RowMix` until compression makes them dense."""

    name = "streamed"

    def __init__(self, engine: StreamedRoundEngine, dview: ChunkedFlatView, gview: ChunkedFlatView,
                 G: torch.Tensor, C: torch.Tensor):
        self.engine = engine
        self._dview, self._gview = dview, gview
        self.G, self.C = G, C
        self.P = dview.K
        self.device = G.device

    # -- device-uplink decodes (a fused-engine feature) ----------------------

    def add_decoded_row(self, i: int, d_vec, g_vec) -> None:
        raise NotImplementedError(
            "device-uplink decode rows need the dense round matrices; "
            "run_hier_simulation rejects engine='streamed' for that config "
            "and auto-selects the fused engine")

    # -- helpers -------------------------------------------------------------

    def _idx(self, idxs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idxs, np.int64), device=self.device)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _mix_matrix(self, refs) -> torch.Tensor:
        return torch.stack([r.w for r in refs])

    def _wrap(self, out) -> Dict[str, Any]:
        return {"G": out["G"], "c": out["c"], "alpha": out["alpha"],
                "u_bar": RowMix(out["u_w"], "delta"),
                "ghat": RowMix(out["ghat_w"], "grad"), "info": out["info"]}

    # -- gradient refs -------------------------------------------------------

    def mean_grad(self, idxs) -> RowMix:
        w = torch.zeros((self.P,), dtype=torch.float32, device=self.device)
        w[self._idx(idxs)] = 1.0 / len(idxs)
        return RowMix(w, "grad")

    def compose_grads(self, refs, counts):
        refs = list(refs)
        if all(_is_mix(r) for r in refs):
            w = np.asarray(counts, np.float64)
            w = w / max(float(w.sum()), 1e-12)
            return RowMix(sum(float(wi) * r.w for wi, r in zip(w, refs)),
                          refs[0].src)
        return weighted_mean_rows([self.materialize(r) for r in refs],
                                  self._f32(counts))

    # -- tier stages ---------------------------------------------------------

    def gateway(self, idxs, *, solve_grad=None,
                pool_scale: float = 1.0) -> Dict[str, Any]:
        eng = self.engine
        out = tier_stage(self.G, self.C, self._idx(idxs),
                         torch.ones(len(idxs), device=self.device),
                         eng.solve_cfg, eng.tier_mode, pool_scale=pool_scale,
                         g_w=None if solve_grad is None else solve_grad.w,
                         robust=eng.robust)
        return self._wrap(out)

    def merge(self, u_refs, g_refs, counts, *,
              solve_grad=None) -> Dict[str, Any]:
        eng = self.engine
        u_refs, g_refs = list(u_refs), list(g_refs)
        if (any(not _is_mix(r) for r in u_refs + g_refs)
                or (solve_grad is not None and not _is_mix(solve_grad))):
            # above a compression hop the children are decoded (n,) vectors:
            # the fused stage over the small (#children, n) stacks
            return summary_stage(
                torch.stack([self.materialize(r) for r in u_refs]),
                torch.stack([self.materialize(r) for r in g_refs]),
                self._f32(counts),
                None if solve_grad is None else self.materialize(solve_grad),
                eng.solve_cfg, eng.tier_mode, sum_to=1.0,
                scope_idx=eng.scope_idx)
        out = merge_stage(self.G, self.C, self._mix_matrix(u_refs),
                          self._mix_matrix(g_refs), self._f32(counts),
                          eng.solve_cfg, eng.tier_mode, sum_to=1.0,
                          g_w=None if solve_grad is None else solve_grad.w)
        return self._wrap(out)

    def cloud_raw(self, idxs, kind: str, *, solve_scale: float = 1.0
                  ) -> Tuple[RowMix, Dict]:
        out = cloud_raw_stage(self.G, self.C, self._idx(idxs),
                              torch.ones(len(idxs), device=self.device),
                              self.engine.solve_cfg, kind,
                              solve_scale=solve_scale,
                              robust=self.engine.robust)
        return RowMix(out["u_w"], "delta"), out["info"]

    def cloud_combo(self, u_refs, counts, ghat, *, kind: str = "combo",
                    override=None) -> Tuple[Any, Dict]:
        eng = self.engine
        u_refs = list(u_refs)
        if (override is not None or any(not _is_mix(r) for r in u_refs)
                or (ghat is not None and not _is_mix(ghat))):
            return cloud_stage(
                torch.stack([self.materialize(r) for r in u_refs]),
                self.materialize(ghat), self._f32(counts), eng.solve_cfg,
                kind, override=override, scope_idx=eng.scope_idx)
        out = cloud_combo_stage(self.G, self.C, self._mix_matrix(u_refs),
                                ghat.w, self._f32(counts), eng.solve_cfg,
                                kind)
        return RowMix(out["eff_w"], "delta"), out["info"]

    # -- vector materialization / final apply --------------------------------

    def materialize(self, ref) -> torch.Tensor:
        """A ref as an (n,) f32 vector: one ``mix_rows`` per leaf slab (on
        a mesh, per window, the windows then gathered), each written into
        its columns — the only full-width vector this engine builds, and
        only when compression needs one."""
        if not _is_mix(ref):
            return ref
        view = self._dview if ref.src == "delta" else self._gview
        eng = self.engine
        with spans.span("stream_materialize", src=ref.src, P=self.P):
            out = torch.empty((view.n,), dtype=torch.float32,
                              device=self.device)
            for s in view.slabs:
                part = out[s.offset:s.offset + s.width]
                w0, w1 = eng.window(s.width)
                if w1 > w0:
                    mix_rows(ref.w, s.matrix[:, w0:w1], out=part[w0:w1])
                eng.gather(part[w0:w1], part)
            return out

    def apply(self, params: Tree, delta_ref) -> Tree:
        """``w ← w + α @ U`` leaf by leaf through the ``combine`` kernel (the
        weights rounded to each leaf's dtype, f32 accumulation, as
        ``mix_rows``; rounded once per dtype, not per leaf), into the
        parameter tensors themselves when the engine donates them.  On a
        mesh each rank combines its windows and gathers the others'."""
        if not _is_mix(delta_ref):
            return apply_delta(params, delta_ref)
        eng = self.engine
        donate = eng.donate_params
        slabs = iter(self._dview.slabs)
        weights = {}

        def step(p):
            m = next(slabs).matrix
            if m.dtype not in weights:
                weights[m.dtype] = delta_ref.w.to(m.dtype).float()
            flat = p.view(-1) if donate else p.reshape(-1)
            new = flat if donate else torch.empty_like(flat)
            w0, w1 = eng.window(m.shape[1])
            if w1 > w0:
                weighted_combine(flat[w0:w1], m[:, w0:w1], weights[m.dtype],
                                 out=new[w0:w1])
            eng.gather(new[w0:w1], new)
            return p if donate else new.view(p.shape)

        with spans.span("stream_apply", P=self.P):
            return tree_map(step, params)
