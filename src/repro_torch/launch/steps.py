"""Step builders of the port — the train and serve programs
(``repro.launch.steps``).

``build_train_step`` runs the paper's FL round at LM scale:

  * the global batch is split into C cohorts (C = |pod|·|data| mesh axes,
    every axis with ``dp_only``): cohort k takes rows [k·B/C, (k+1)·B/C),
    each one FL client holding its private shard;
  * every cohort runs ``local_steps`` of SGD from the same global params
    (``torch.autograd.grad`` of the bundle's ``train_loss``);
  * the contextual aggregation forms G and c on the paper's last-layer
    scope through the ``gram`` op (``gram_pallas``'s function), solves the
    C×C system (``solve_alpha_simple``) and applies w + Σ α_k Δ_k leaf by
    leaf through the ``combine`` op (``combine_pallas``'s function, in w's
    dtype, with no f32 copy of a leaf); ``aggregator='fedavg'`` takes the
    uniform mean.

On one rank (a host mesh, or an emulated mesh of any shape) every cohort
runs on it in turn, each Δ written into a preallocated stacked leaf.  On a
mesh of ranks a rank computes the cohort at its ``pod``/``data``
coordinates, and the step is placed (:func:`train_placement`):

  * ``"tp"``: every leaf is this rank's block under
    ``param_pspecs(mode="tp")`` (``sharding.place_params``) and the batch
    is its cohort's rows (``sharding.place_batch``); the ranks
    along ``model`` split their cohort's forward and backward
    (``core.distributed.model_parallel``: column- / row-parallel
    projections, vocab-parallel embedding and loss, expert-parallel MoE,
    head-parallel Mamba2 and RWKV6);
    the scoped U is this rank's columns (a leaf whole on every ``model``
    rank counted on the first one only), its rows all-gathered over the
    cohort axes, G and c from the ``gram`` op on those columns summed over
    ``model``, α solved on every rank; each leaf's α_k Δ_k is all-reduced
    over the cohort axes and combined into the local block;
  * ``"fsdp"`` (≥ ``FSDP_THRESHOLD`` params): "tp" with the leaves also
    split over ``data``, all-gathered over ``data`` once a step for the
    cohort's compute; their α_k Δ_k is reduce-scattered over ``data``
    (all-reduced over ``pod``) back to the local block;
  * ``"replicated"`` (``mode="dp"``, ``dp_only``, or a model that does
    not run on shards: the logistic model): every rank holds every leaf
    whole, ranks along ``model`` compute the same cohort, the scoped rows
    of U are all-gathered and the combine all-reduced over the cohort
    axes.

Every rank ends with its block of the same new params.

``build_prefill_step`` / ``build_decode_step`` are the serving programs for
the inference shapes.  On a mesh of ranks they are placed as the train
step is (:func:`train_placement`): the params are this rank's blocks under
``param_pspecs(mode="tp")`` (FSDP leaves gathered over ``data`` for each
call), the inputs its rows under ``batch_pspec``, and every cache leaf its
block under ``cache_pspecs`` (:func:`serve_cache_shard`: KV seq over
'model', or over ('pod', 'data', 'model') when the batch is replicated,
as at batch 1).  The models run inside ``model_parallel`` with that cache
placement: a prefill writes each rank's seq block of the K/V, a decode
step runs ``flash_decode`` on it and merges the blocks' (o, lse)
partials.  The logits come back whole over the vocabulary, for this
rank's rows.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..core.distributed import (CacheShard, all_gather_dim,
                                all_gather_rows, all_reduce_sum,
                                model_parallel, reduce_scatter_dim)
from ..core.flatten import (tree_leaves, tree_leaves_with_path,
                            tree_unflatten)
from ..core.solve import solve_alpha_simple
from ..kernels.ops import gram_and_cross, weighted_combine
from ..models.config import ArchConfig
from ..models.registry import get_model
from ..sharding.specs import (FSDP_THRESHOLD, batch_pspec, cache_pspecs,
                              dim_axes, dropped_axes, map_with_path, named,
                              param_pspecs, spec_leaves)
from .mesh import Mesh
from .shapes import InputShape, TensorSpec, fake_mode, meta_params, to_meta

Pytree = Any


def num_cohorts(mesh: Mesh, dp_only: bool = False,
                batch: int = 1 << 30) -> int:
    c = 1
    names = ("pod", "data", "model") if dp_only else ("pod", "data")
    for a in names:
        c *= mesh.shape.get(a, 1)
    if dp_only and batch % c != 0:       # model axis doesn't divide the batch
        c //= mesh.shape.get("model", 1)
    return c


def cohort_axes(mesh: Mesh, dp_only: bool = False, batch: int = 1 << 30):
    names = ("pod", "data", "model") if dp_only else ("pod", "data")
    axes = tuple(a for a in names if a in mesh.shape)
    if dp_only and batch % num_cohorts(mesh, True, 1 << 30) != 0:
        axes = tuple(a for a in axes if a != "model")
    return axes if len(axes) > 1 else axes[0]


# --------------------------------------------------------------- parameters

def _with_shardings(mesh: Mesh, tree: Pytree, specs: Pytree) -> Pytree:
    """Each tensor leaf of ``tree`` as a :class:`TensorSpec` with its spec
    of ``specs`` (a tree of the same structure) on ``mesh``."""
    flat = iter([s for _, s in spec_leaves(specs)])
    return map_with_path(tree, lambda path, t: TensorSpec(
        t, named(mesh, next(flat))) if torch.is_tensor(t) else t)


def params_sds(cfg: ArchConfig, mesh: Mesh, mode: str = "tp") -> Pytree:
    """The parameters as :class:`TensorSpec` leaves: ``meta`` tensors with
    their shardings (nothing allocated)."""
    shapes = meta_params(cfg)
    return _with_shardings(mesh, shapes,
                           param_pspecs(cfg, shapes, mesh, mode=mode))


def cache_sds(cfg: ArchConfig, mesh: Mesh, shape: InputShape) -> Pytree:
    """The decode cache as :class:`TensorSpec` leaves (whisper's from a
    shape-only prefill: self K/V and cross K/V; no cache shape depends on
    the encoder's depth, so that prefill runs one encoder layer)."""
    cache = cache_shapes(cfg, shape)
    return _with_shardings(mesh, cache, cache_pspecs(cfg, cache, mesh,
                                                     shape.global_batch))


def cache_shapes(cfg: ArchConfig, shape: InputShape) -> Pytree:
    """The whole decode cache of ``shape`` as ``meta`` tensors (nothing
    allocated)."""
    bundle = get_model(cfg)
    B = shape.global_batch
    with fake_mode():
        if bundle.init_cache is not None:
            cache = bundle.init_cache(B, shape.seq_len, device="cpu")
        else:
            bundle = get_model(dataclasses.replace(cfg, encoder_layers=1))
            params = bundle.init(torch.Generator(device="cpu"), device="cpu")
            dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
            prompt = {"frames": torch.empty(
                (B, cfg.max_source_positions, cfg.d_model), dtype=dt),
                "tokens": torch.zeros((B, 8), dtype=torch.int32)}
            cache = bundle.prefill(params, prompt, shape.seq_len)[1]
    return to_meta(cache)


# --------------------------------------------------------------- train step

# families whose models run on 'model' shards (``core.distributed.
# model_parallel``); the others (logreg) keep the replicated step on a
# mesh of ranks
TP_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
# a vocabulary leaf may stay whole over 'model' (its dim does not divide):
# the models then look up, project and take the loss on the whole of it
_WHOLE_OK = re.compile(r"(^|/)(embed|lm_head)$")


def train_placement(cfg: ArchConfig, mesh: Mesh, mode: str = "tp",
                    dp_only: bool = False) -> str:
    """How :func:`build_train_step` holds the params: ``"tp"``,
    ``"fsdp"`` or ``"replicated"`` (a one-rank mesh without a process
    group and an emulated mesh always replicate)."""
    if mode not in ("tp", "dp"):
        raise ValueError(f"unknown placement mode {mode!r}")
    if (mode == "dp" or dp_only or mesh.device_mesh is None
            or cfg.family not in TP_FAMILIES):
        return "replicated"
    return ("fsdp" if cfg.param_count_estimate() >= FSDP_THRESHOLD
            else "tp")


def placement_note(cfg: ArchConfig, placement: str) -> Optional[str]:
    """Why a step on a mesh of ranks is replicated, where that is the
    family's doing (None otherwise)."""
    if placement == "replicated" and cfg.family not in TP_FAMILIES:
        return (f"family {cfg.family!r} keeps the replicated step: its "
                "model does not run on 'model' shards")
    return None


def _placed_layout(cfg: ArchConfig, mesh: Mesh) -> Tuple[list, list]:
    """Per leaf, in flattening order: the dim split over ``data`` (None)
    and whether the leaf is split over ``model``.  Raises when a rule's
    axis does not divide its dim (the rules would replicate it), but for a
    vocabulary leaf's ``model`` axis, which the models run whole."""
    shapes = meta_params(cfg)
    bad = [(path, dim, axis) for path, dim, axis in
           dropped_axes(cfg, shapes, mesh)
           if not (axis == "model" and _WHOLE_OK.search(path))]
    if bad:
        raise ValueError(
            f"{cfg.name} on {dict(mesh.shape)}: the placed step needs every "
            "rule's axis to divide its dim; these do not: " + ", ".join(
                f"{path} dim {dim} over {axis!r}" for path, dim, axis in bad))
    data_dim, split = [], []
    for _, spec in spec_leaves(param_pspecs(cfg, shapes, mesh, "tp")):
        axes = [(d, n if isinstance(n, tuple) else (n,))
                for d, n in enumerate(spec) if n is not None]
        data_dim.append(next((d for d, n in axes if "data" in n), None))
        split.append(any("model" in n for _, n in axes))
    return data_dim, split


def _scoped_matrix(updates: Pytree, scope_paths: Tuple[str, ...],
                   C: int) -> torch.Tensor:
    """The gram-scope slice of stacked updates as (C, n_scope) f32 (every
    leaf when none matches: small models, or a tied head's lone norm)."""
    flat = tree_leaves_with_path(updates)
    picked = [leaf for name, leaf in flat
              if any(s in name for s in scope_paths)] or [
                  leaf for _, leaf in flat]
    return torch.cat([leaf.reshape(C, leaf.numel() // C).float()
                      for leaf in picked], dim=1)


def _loss_and_grads(loss_fn: Callable, params: Pytree, batch
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``loss_fn`` at ``params`` and its grads, leaf by leaf in flattening
    order, each contiguous and in its leaf's dtype (as ``jax.grad``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), [g.contiguous() for g in grads]


def build_train_step(cfg: ArchConfig, mesh: Mesh, shape: InputShape, *,
                     aggregator: str = "contextual", lr: float = 0.02,
                     local_steps: int = 1,
                     gram_scope: Tuple[str, ...] = ("lm_head", "final_norm"),
                     ridge: float = 1e-6, remat="full", dp_only: bool = False,
                     server_momentum: float = 0.0, mode: str = "tp"
                     ) -> Callable:
    """Returns ``train_step(params, batch) -> (params, metrics)`` — or, when
    ``server_momentum > 0``, ``train_step((params, velocity), batch)`` with
    an f32 velocity tree (FedAvgM-style: v ← μv + Σα_kΔ_k; w ← w + v).

    ``dp_only=True`` treats every mesh axis as data parallelism.  ``remat``:
    False | "full" | "dots" (``models.transformer.remat_wrap``).  ``mode``:
    "tp" places the params by ``param_pspecs`` on a mesh of ranks, "dp"
    replicates them (:func:`train_placement`; the step's ``placement``
    attribute says which): a placed step takes and returns this rank's
    blocks (``sharding.place_params``), the velocity's too, and takes its
    cohort's rows of the batch (``sharding.place_batch``).  The metrics
    are ``loss`` (the mean of the cohorts' losses at w₀), ``alpha`` (C,)
    and, for the contextual aggregator, ``gram_diag_mean`` and ``bound``
    (Theorem 1's g(α), negative at α*)."""
    bundle = get_model(cfg)
    C = num_cohorts(mesh, dp_only, shape.global_batch)
    beta = 1.0 / lr                      # paper §III-B: β = 1/l
    caxes = cohort_axes(mesh, dp_only, shape.global_batch)
    caxes = (caxes,) if isinstance(caxes, str) else tuple(caxes)
    ranked = mesh.device_mesh is not None
    placement = train_placement(cfg, mesh, mode, dp_only)
    placed = placement != "replicated"
    if placed:
        if shape.global_batch % C:
            raise ValueError(
                f"the placed step splits the batch of {shape.global_batch} "
                f"rows into {C} cohorts over {caxes}: it does not divide")
        data_dim, split = _placed_layout(cfg, mesh)
        first_model_rank = mesh.coordinate("model") == 0
    if ranked:
        k = 0
        for a in caxes:
            k = k * mesh.shape[a] + mesh.coordinate(a)
        local = [k]
    else:
        local = list(range(C))

    if cfg.family == "logreg":
        def loss_fn(p, b):
            return bundle.train_loss(p, (b["x"], b["y"], None))[0]
    else:
        def loss_fn(p, b):
            return bundle.train_loss(p, b, remat=remat)[0]

    def cohort_update(params: Pytree, cohort_batch) -> Tuple[list, Any]:
        """One client's local optimisation: (Δ leaves, loss at w₀)."""
        if local_steps == 1:
            l0, grads = _loss_and_grads(loss_fn, params, cohort_batch)
            # one rounding of the f32 product, as (−lr·g in f32) cast
            return [g.mul_(-lr) for g in grads], l0
        p0 = tree_leaves(params)
        cur = params
        for s in range(local_steps):
            loss, grads = _loss_and_grads(loss_fn, cur, cohort_batch)
            if s == 0:
                l0 = loss
            cur = tree_unflatten(params, [
                (p.float() - lr * g.float()).to(p.dtype)
                for p, g in zip(tree_leaves(cur), grads)])
            del grads
        return [pt - p for pt, p in zip(tree_leaves(cur), p0)], l0

    def train_step(params_or_state, batch):
        if server_momentum > 0.0:
            params, velocity = params_or_state
        else:
            params, velocity = params_or_state, None
        leaves = tree_leaves(params)
        B = next(iter(batch.values())).shape[0]
        rows = B // C
        if placed and B != shape.global_batch // C:
            raise ValueError(
                f"the placed step takes this rank's cohort of "
                f"{shape.global_batch // C} rows (sharding.place_batch), "
                f"not {B}")
        stacked, losses = None, []
        for i, k in enumerate(local):
            cohort = batch if placed else {
                name: x[k * rows:(k + 1) * rows] for name, x in batch.items()}
            if placed:
                # FSDP leaves whole over 'data' for the cohort's compute
                work = tree_unflatten(params, [
                    p if dim is None else all_gather_dim(mesh, p, dim,
                                                         ("data",))
                    for p, dim in zip(leaves, data_dim)])
                with model_parallel(mesh):
                    delta, l0 = cohort_update(work, cohort)
                del work
            else:
                delta, l0 = cohort_update(params, cohort)
            losses.append(l0)
            if len(local) == 1:
                stacked = [d.unsqueeze(0) for d in delta]
            else:
                if stacked is None:
                    stacked = [torch.empty((len(local),) + tuple(d.shape),
                                           dtype=d.dtype, device=d.device)
                               for d in delta]
                for dst, d in zip(stacked, delta):
                    dst[i].copy_(d)
            del delta
        losses = torch.stack(losses).float()
        dev = losses.device
        if ranked:
            losses = all_gather_rows(mesh, losses, caxes)

        if aggregator == "fedavg":
            alpha = torch.full((C,), 1.0 / C, dtype=torch.float32,
                               device=dev)
            info = {}
        else:
            # ∇f estimate, K₂=0 form: mean of local first-step directions
            # placed: this rank's columns; a leaf whole on every 'model'
            # rank counts on the first one only
            held = stacked if not placed else [
                d if split[j] or first_model_rank else
                d.new_empty((d.shape[0], 0)) for j, d in enumerate(stacked)]
            U = _scoped_matrix(tree_unflatten(params, held), gram_scope,
                               len(local))
            if ranked:
                U = all_gather_rows(mesh, U, caxes)
            gvec = -U.mean(0) / (lr * local_steps)
            if U.shape[1]:
                G, c = gram_and_cross(U, gvec)
            else:
                G = U.new_zeros((U.shape[0], U.shape[0]))
                c = U.new_zeros((U.shape[0],))
            del U, gvec
            if placed:
                G = all_reduce_sum(mesh, G, ("model",))
                c = all_reduce_sum(mesh, c, ("model",))
            alpha = solve_alpha_simple(G, c, beta, ridge)
            info = {"gram_diag_mean": torch.diagonal(G).mean(),
                    "bound": c @ alpha + 0.5 * beta * alpha @ G @ alpha}

        # ``local`` is a run of consecutive cohorts: a slice, with no index
        # tensor made from a list (which a fake-tensor trace refuses)
        a_local = alpha[local[0]:local[-1] + 1]
        v_leaves = None if velocity is None else tree_leaves(velocity)
        new, new_velocity = [], []
        stacked_shape = [tuple(d.shape[1:]) for d in stacked]
        for j, p in enumerate(leaves):
            U_j, stacked[j] = stacked[j].reshape(len(local), -1), None
            a_j = a_local
            if v_leaves is not None or ranked:
                # the combined update in f32 (all-reduced over the cohort
                # axes), then applied by the combine op with weight 1
                comb = torch.einsum("k,kn->n", a_local, U_j.float())
                if placed and data_dim[j] is not None:
                    whole = stacked_shape[j]
                    comb = reduce_scatter_dim(mesh, comb.view(whole),
                                              data_dim[j], "data")
                    comb = all_reduce_sum(mesh, comb, tuple(
                        a for a in caxes if a != "data")).reshape(-1)
                elif ranked:
                    comb = all_reduce_sum(mesh, comb, caxes)
                if v_leaves is not None:
                    comb = (server_momentum * v_leaves[j].float().reshape(-1)
                            + comb)
                    new_velocity.append(comb.view(p.shape))
                U_j = comb[None]
                a_j = torch.ones(1, dtype=torch.float32, device=dev)
            new.append(weighted_combine(p.reshape(-1), U_j, a_j)
                       .view(p.shape))
            del U_j
        new_params = tree_unflatten(params, new)
        metrics = {"loss": losses.mean(), "alpha": alpha, **info}
        if velocity is not None:
            return (new_params, tree_unflatten(params, new_velocity)), metrics
        return new_params, metrics

    train_step.placement = placement
    return train_step


# --------------------------------------------------------------- serve steps

def serve_cache_shard(cfg: ArchConfig, mesh: Mesh,
                      shape: InputShape) -> CacheShard:
    """The cache placement of the placed serve steps: the axes that
    ``cache_pspecs`` puts on the seq dim of the KV leaves and on the head
    dim of the stacked recurrent states (``()`` where the divisibility
    guard leaves it whole)."""
    cache = cache_shapes(cfg, shape)
    specs = cache_pspecs(cfg, cache, mesh, shape.global_batch)
    leaves = dict(spec_leaves(specs))

    def axes(*paths):
        spec = next((leaves[p] for p in paths if p in leaves), None)
        return dim_axes(spec, 2) if spec is not None else ()
    return CacheShard(mesh, axes("kv/k", "shared_kv/k", "self_kv/k"),
                      axes("ssm/wkv", "ssm/ssm"), axes("cross_k"))


def _serve_rows(mesh: Mesh, batch: int) -> int:
    """This rank's rows of a serve input of ``batch`` rows (``batch_pspec``:
    split over the batch axes where they divide, else whole)."""
    ways = 1
    for name in batch_pspec(mesh, batch):
        for a in ((name,) if isinstance(name, str) else name or ()):
            ways *= mesh.shape[a]
    return batch // ways


def _placed_serve(cfg: ArchConfig, mesh: Mesh, shape: InputShape,
                  run: Callable) -> Callable:
    """``run(params, first_input, *rest)`` as a placed step: the first input
    must be this rank's rows, the FSDP leaves are gathered over ``data``
    for the call, the models run inside ``model_parallel`` with the cache
    placement, and the logits (the first output) come back whole over the
    vocabulary."""
    data_dim, _ = _placed_layout(cfg, mesh)
    cs = serve_cache_shard(cfg, mesh, shape)
    rows = _serve_rows(mesh, shape.global_batch)

    def step(params, inputs, *rest):
        got = next(iter(inputs.values())) if isinstance(inputs, dict) \
            else inputs
        if got.shape[0] != rows:
            raise ValueError(
                f"the placed serve step takes this rank's {rows} of "
                f"{shape.global_batch} rows (batch_pspec), not "
                f"{got.shape[0]}")
        # FSDP leaves whole over 'data' for the call (a 'data' axis of one
        # rank holds them whole already: no copy of the model)
        work = params if mesh.shape.get("data", 1) == 1 else tree_unflatten(
            params, [p if dim is None else
                     all_gather_dim(mesh, p, dim, ("data",))
                     for p, dim in zip(tree_leaves(params), data_dim)])
        with torch.no_grad(), model_parallel(mesh, cache=cs):
            logits, cache = run(work, inputs, *rest)
        if logits.shape[-1] != cfg.vocab_size:
            logits = all_gather_dim(mesh, logits, logits.dim() - 1,
                                    ("model",))
        return logits, cache

    return step


def _serve_step(cfg: ArchConfig, mesh: Mesh, shape: InputShape, mode: str,
                run: Callable) -> Callable:
    """``run`` placed as :func:`train_placement` says (``mode`` as the
    train step's), with that as the step's ``placement`` attribute."""
    placement = train_placement(cfg, mesh, mode)
    inner = run if placement == "replicated" else _placed_serve(
        cfg, mesh, shape, run)

    def step(*args):
        return inner(*args)

    step.placement = placement
    return step


def build_prefill_step(cfg: ArchConfig, mesh: Mesh, shape: InputShape,
                       mode: str = "tp") -> Callable:
    """``prefill_step(params, batch) -> (last logits, cache)``, placed on a
    mesh of ranks (the module's docstring)."""
    bundle = get_model(cfg)
    return _serve_step(cfg, mesh, shape, mode,
                       lambda p, b: bundle.prefill(p, b, shape.seq_len))


def build_decode_step(cfg: ArchConfig, mesh: Mesh, shape: InputShape,
                      mode: str = "tp") -> Callable:
    """``decode_step(params, token, cache) -> (logits, cache)``, placed on
    a mesh of ranks (the cache this rank's blocks, written in place)."""
    return _serve_step(cfg, mesh, shape, mode, get_model(cfg).decode)
