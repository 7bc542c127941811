"""Distributed forms of the contextual aggregation
(``repro.core.distributed``).

The reference calls these inside ``shard_map``; here every rank of the
mesh's process group calls them with its own shard.  The layout is the
reference's:

  * each cohort (FL client) k lives on one coordinate of the ``data`` axis
    and holds its update vector, split over the ``model`` axis;
  * the Gram needs all-pairs inner products: the (scoped) update slices are
    all-gathered over ``data`` (``lax.all_gather`` → ``all_gather`` on that
    axis's group, rows in coordinate order, so cohort k is the rank at
    coordinate k, as ``lax.axis_index``), contracted locally by the port's
    ``gram`` op, and summed over ``model`` (``psum`` → ``all_reduce``);
  * the combine is an α-weighted sum over ``data``.

``pmean`` is a sum then a division: the gloo backend has no average, and
the same code runs on gloo (the CPU tests) and NCCL (the card).  A one-rank
mesh without a process group runs no collective; an emulated mesh
(``launch.mesh.emulated_mesh``) with more than one coordinate on an axis
is refused, since its logical devices share one rank.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..kernels.ops import gram_and_cross
from ..launch.mesh import Mesh
from .solve import solve_alpha_simple


def _live_axes(mesh: Mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """The axes of ``axes`` to run a collective over: all of them on a mesh
    of ranks (size-1 axes included, so a one-rank process group still runs
    its backend), none on a one-rank mesh without a process group; an
    emulated mesh with an axis of more than one coordinate is refused."""
    if mesh.device_mesh is not None:
        return tuple(axes)
    need = 1
    for a in axes:
        need *= mesh.shape[a]
    if need > 1:
        raise ValueError(
            f"the collectives over {tuple(axes)} need {need} ranks of an "
            f"initialised process group (launch.mesh.make_mesh); {mesh!r} "
            "places its logical devices on this rank alone")
    return ()


def all_gather_rows(mesh: Mesh, t: torch.Tensor,
                    axes: Sequence[str]) -> torch.Tensor:
    """Every rank's ``t`` (rows on dim 0) concatenated in coordinate order
    over ``axes``, the first axis major: the rank at coordinates (a, b)
    holds rows block a·|b| + b."""
    import torch.distributed as dist
    for axis in reversed(_live_axes(mesh, axes)):
        parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=mesh.group(axis))
        t = torch.cat(parts)
    return t


def all_reduce_sum(mesh: Mesh, t: torch.Tensor,
                   axes: Sequence[str]) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``axes``, on every rank (in
    place when ``t`` is contiguous)."""
    import torch.distributed as dist
    for axis in _live_axes(mesh, axes):
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return t


def _axes(axis: Optional[str]) -> Tuple[str, ...]:
    return () if axis is None else (axis,)


def sharded_gram_cross(mesh: Mesh, u_shard: torch.Tensor,
                       g_shard: torch.Tensor, data_axis: str = "data",
                       model_axis: Optional[str] = "model"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This cohort's update slice ``u_shard (n_m,)`` and the global-
    gradient-estimate slice ``g_shard (n_m,)`` of this model shard →
    ``G (K, K)`` and ``c (K,)`` in f32, the same on every rank."""
    U_all = all_gather_rows(mesh, u_shard.float()[None], (data_axis,))
    G, c = gram_and_cross(U_all, g_shard.float())
    G = all_reduce_sum(mesh, G, _axes(model_axis))
    c = all_reduce_sum(mesh, c, _axes(model_axis))
    return G, c


def sharded_combine(mesh: Mesh, u_shard: torch.Tensor, alpha: torch.Tensor,
                    data_axis: str = "data") -> torch.Tensor:
    """Σ_k α_k u_k over ``data_axis``, on every rank."""
    k = mesh.coordinate(data_axis)
    return all_reduce_sum(mesh, alpha[k].to(u_shard.dtype) * u_shard,
                          (data_axis,))


def contextual_combine_sharded(mesh: Mesh, u_shard: torch.Tensor,
                               g_shard: torch.Tensor, beta: float,
                               ridge: float = 1e-6, data_axis: str = "data",
                               model_axis: Optional[str] = "model",
                               gram_u_shard: Optional[torch.Tensor] = None,
                               gram_g_shard: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gram → K×K solve (the same on every rank) → weighted combine.  With
    ``gram_u_shard`` / ``gram_g_shard`` the α solve uses those (the
    paper's last-layer slice) while the combine applies α to ``u_shard``.
    Returns ``(combined_update_shard, alpha)``."""
    gu = u_shard if gram_u_shard is None else gram_u_shard
    gg = g_shard if gram_g_shard is None else gram_g_shard
    G, c = sharded_gram_cross(mesh, gu, gg, data_axis, model_axis)
    alpha = solve_alpha_simple(G, c, beta, ridge)
    return sharded_combine(mesh, u_shard, alpha, data_axis), alpha


def hierarchical_contextual_combine(mesh: Mesh, u_shard: torch.Tensor,
                                    g_shard: torch.Tensor, beta: float,
                                    ridge: float = 1e-6,
                                    pod_axis: str = "pod",
                                    data_axis: str = "data",
                                    model_axis: Optional[str] = "model"
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Two stages for a multi-pod mesh: a contextual combine within each
    pod over ``data`` (K cohorts), then one across pods over ``pod`` (P
    pod updates) with the pod-mean gradient estimate.  Returns
    ``(combined_update_shard, alpha_intra (K,), alpha_pods (P,))``."""
    intra, alpha_intra = contextual_combine_sharded(
        mesh, u_shard, g_shard, beta, ridge, data_axis, model_axis)
    g_global = all_reduce_sum(mesh, g_shard.float().clone(),
                              (pod_axis,)) / mesh.shape[pod_axis]
    G2, c2 = sharded_gram_cross(mesh, intra.float(), g_global,
                                data_axis=pod_axis, model_axis=model_axis)
    alpha_pods = solve_alpha_simple(G2, c2, beta, ridge)
    combined = sharded_combine(mesh, intra, alpha_pods, pod_axis)
    return combined, alpha_intra, alpha_pods
