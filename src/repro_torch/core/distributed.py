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

The placed train step (``launch.steps``) splits one cohort's forward and
backward over the ``model`` axis, Megatron-style, with the autograd
collectives below.  Inside :func:`model_parallel` the models read
:func:`model_shard` and run on the local shards of their weights:

  * :func:`copy_to_model` (identity forward, all-reduce backward) where a
    tensor every rank holds whole enters a computation each rank does a
    part of, and :func:`reduce_from_model` (all-reduce forward, identity
    backward) where the parts are summed back: so every replicated leaf's
    grad is whole and the same on every rank;
  * :func:`gather_from_model` (all-gather of the last dim; backward: this
    rank's slice) for a column-parallel output that the whole stream reads;
  * :func:`cols_to_rows` / :func:`rows_to_cols` (all-to-all) to trade a
    column shard of every row for every column of a row shard,
    :func:`gather_for_rows` (all-gather of the last dim; backward:
    reduce-scatter) for a tensor that each rank's part reads whole, and
    :func:`sum_for_parts` (all-reduce both ways) for a sum each part
    reads.

The placed serve steps run the same model-parallel code without grads,
and hold a seq block of every KV cache (``model_parallel(mesh, cache=)``,
:class:`CacheShard`): a decode step's attention runs ``flash_decode`` on
this rank's block, and :func:`merge_decode_partials` merges the (o, lse)
partials of every block over the cache's seq axes.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch

from ..kernels.ops import gram_and_cross, lse_merge
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


def _gather_into(t: torch.Tensor, ways: int, group) -> torch.Tensor:
    """(ways, *t.shape): every rank's ``t`` (at least 1-D) of ``group`` in
    rank order, one collective into one tensor (no list of parts to copy
    together)."""
    import torch.distributed as dist
    # torch 2.13 names it all_gather_single and deprecates the old name;
    # torch 2.11 has only all_gather_into_tensor
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    out = torch.empty((ways * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    gather(out, t.contiguous(), group=group)
    return out.view((ways,) + tuple(t.shape))


def all_gather_rows(mesh: Mesh, t: torch.Tensor,
                    axes: Sequence[str]) -> torch.Tensor:
    """Every rank's ``t`` (rows on dim 0) concatenated in coordinate order
    over ``axes``, the first axis major: the rank at coordinates (a, b)
    holds rows block a·|b| + b."""
    for axis in reversed(_live_axes(mesh, axes)):
        t = _gather_into(t, mesh.shape[axis], mesh.group(axis)).flatten(0, 1)
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


def all_gather_dim(mesh: Mesh, t: torch.Tensor, dim: int,
                   axes: Sequence[str]) -> torch.Tensor:
    """:func:`all_gather_rows` along ``dim``: every rank's block of that
    dim, in coordinate order over ``axes``."""
    return all_gather_rows(mesh, t.movedim(dim, 0), axes).movedim(0, dim)


def all_gather_windows(mesh: Mesh, t: torch.Tensor, wide: int,
                       axes: Sequence[str], out: torch.Tensor) -> torch.Tensor:
    """Every rank's window of ``out``'s rows, written into ``out``: the
    rank at place r (coordinate order over ``axes``, the first axis major)
    holds rows ``[r·wide, (r+1)·wide)`` of ``out`` in ``t``, cut at its
    end (the last nonempty window short, any after it empty).  Each window
    is padded to ``wide`` rows for one gather, whose first ``len(out)``
    rows are ``out`` in order; ``t`` may be ``out``'s own window."""
    if t.shape[0] < wide:
        t = torch.cat([t, t.new_zeros((wide - t.shape[0],)
                                      + tuple(t.shape[1:]))])
    return out.copy_(all_gather_rows(mesh, t, axes)[:out.shape[0]])


def reduce_scatter_dim(mesh: Mesh, t: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``t``, this rank's block of
    ``dim`` only (the inverse placement of :func:`all_gather_dim`)."""
    import torch.distributed as dist
    if not _live_axes(mesh, (axis,)):
        return t
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // mesh.shape[axis],)
                      + tuple(moved.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, moved, group=mesh.group(axis))
    return out.movedim(0, dim)


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


# ---------------------------------------------------- tensor parallelism

@dataclass(frozen=True)
class ModelShard:
    """This rank's place on the ``model`` axis of a placed step: the
    axis's process group, its size and this rank's coordinate."""
    group: Any
    size: int
    rank: int


@dataclass(frozen=True)
class CacheShard:
    """Where this rank's block of a placed serve step's cache lies (the
    rules of ``sharding.cache_pspecs``): ``kv_axes``, the mesh axes that
    split the seq dim of every KV leaf, ``state_axes``, those that split
    the head dim of every recurrent state, and ``cross_axes``, those that
    split the rows of an encoder-decoder's cross K/V, each major first and
    ending with ``model`` (``()``: the dim is whole on every rank)."""
    mesh: Mesh
    kv_axes: Tuple[str, ...] = ()
    state_axes: Tuple[str, ...] = ()
    cross_axes: Tuple[str, ...] = ()

    def ways(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block of a dim split over ``axes`` (major first)."""
        at = 0
        for a in axes:
            at = at * self.mesh.shape[a] + self.mesh.coordinate(a)
        return at

    def kv_start(self, rows: int) -> int:
        """The global seq position of the first row of this rank's KV
        block of ``rows`` rows."""
        return self.index(self.kv_axes) * rows


# module globals, not context variables: autograd's device threads read
# them when they recompute a checkpointed layer in the backward pass
_MODEL_SHARD: Optional[ModelShard] = None
_CACHE_SHARD: Optional[CacheShard] = None


@contextlib.contextmanager
def model_parallel(mesh: Mesh, axis: str = "model",
                   cache: Optional[CacheShard] = None
                   ) -> Iterator[ModelShard]:
    """Run the models on this rank's shards of ``axis`` (a mesh of ranks)
    inside the block; :func:`model_shard` reads it.  ``cache`` places the
    serve steps' caches (:func:`cache_shard` reads it): without one a
    model's cache is whole on every rank."""
    global _MODEL_SHARD, _CACHE_SHARD
    if mesh.device_mesh is None:
        raise ValueError(f"model_parallel needs a mesh of ranks, not {mesh!r}")
    prev = _MODEL_SHARD, _CACHE_SHARD
    _MODEL_SHARD = ModelShard(mesh.group(axis), mesh.shape[axis],
                              mesh.coordinate(axis))
    _CACHE_SHARD = cache if cache is not None else CacheShard(mesh)
    try:
        yield _MODEL_SHARD
    finally:
        _MODEL_SHARD, _CACHE_SHARD = prev


def model_shard() -> Optional[ModelShard]:
    """The active :class:`ModelShard` (None outside :func:`model_parallel`:
    the models run on whole weights)."""
    return _MODEL_SHARD


def cache_shard() -> Optional[CacheShard]:
    """The active :class:`CacheShard` (None outside
    :func:`model_parallel`)."""
    return _CACHE_SHARD


def merge_decode_partials(mesh: Mesh, o: torch.Tensor, lse: torch.Tensor,
                          axes: Sequence[str]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``flash_decode`` partials of every seq block over ``axes`` —
    o (B, KV, G, hd) and lse (B, KV, G, 1) f32 on each rank — merged into
    the whole cache's, on every rank: the (B, KV, G, hd + 1) partials are
    all-gathered and summed by ``lse_merge``.  A block with no live row
    (o = 0, lse <= -1e30) weighs 0.  ``axes`` empty: ``(o, lse)``."""
    if not axes:
        return o, lse
    hd = o.shape[-1]
    parts = all_gather_rows(mesh, torch.cat([o, lse], dim=-1)[None], axes)
    return lse_merge(parts[..., :hd], parts[..., hd:])


def all_to_all_model(t: torch.Tensor) -> torch.Tensor:
    """(m, ...) → (m, ...): block j of the result is rank j's block of
    this rank's index along ``model`` (no grad)."""
    return _all_to_all(t, _MODEL_SHARD)


def _summed(t: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return out


def _gather_last(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """(..., c) on every rank → (..., m·c), rank order along the last dim."""
    got = _gather_into(t, shard.size, shard.group)        # (m, ..., c)
    return got.movedim(0, -2).reshape(*t.shape[:-1], shard.size * t.shape[-1])


def _scatter_last(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """(..., m·c) on every rank → (..., c): the sum over ranks of each
    rank's slice ``shard.rank`` (a reduce-scatter of the last dim)."""
    import torch.distributed as dist
    m = shard.size
    c = t.shape[-1] // m
    lead = t.shape[:-1]
    chunks = t.reshape(-1, m, c).transpose(0, 1).contiguous()  # (m, R, c)
    out = torch.empty(chunks.shape[1:], dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, chunks.view(-1, c), group=shard.group)
    return out.reshape(*lead, c)


def _all_to_all(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    import torch.distributed as dist
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=shard.group)
    return out


def _cols_to_rows(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    m = shard.size
    R, c = t.shape
    got = _all_to_all(t, shard).view(m, R // m, c)    # block j: rank j's cols
    return got.transpose(0, 1).reshape(R // m, m * c)


def _rows_to_cols(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    m = shard.size
    r, mc = t.shape
    c = mc // m
    sent = t.view(r, m, c).transpose(0, 1).contiguous()  # block j: j's cols
    return _all_to_all(sent, shard).view(m * r, c)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.shard.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _summed(x, shard.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.c = shard, x.shape[-1]
        return _gather_last(x, shard)

    @staticmethod
    def backward(ctx, g):
        r = ctx.shard.rank
        return g[..., r * ctx.c:(r + 1) * ctx.c].contiguous(), None


class _GatherForRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _gather_last(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _scatter_last(g, ctx.shard), None


class _SumForParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _summed(x, shard.group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.shard.group), None


class _ColsToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _cols_to_rows(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _rows_to_cols(g, ctx.shard), None


class _RowsToCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _rows_to_cols(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _cols_to_rows(g, ctx.shard), None


def _through(fn, x: torch.Tensor) -> torch.Tensor:
    shard = _MODEL_SHARD
    return x if shard is None else fn.apply(x, shard)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (whole on every rank) entering a per-rank part: identity
    forward, its grads summed over ``model`` backward."""
    return _through(_CopyToModel, x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Every rank's part summed over ``model``; identity backward."""
    return _through(_ReduceFromModel, x)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """A column shard (..., c) → the whole (..., m·c) that every rank then
    reads alike; backward keeps this rank's columns of the grad."""
    return _through(_GatherFromModel, x)


def gather_for_rows(x: torch.Tensor) -> torch.Tensor:
    """A column shard (..., c) → the whole (..., m·c) that each rank's row
    shard reads differently; backward sums every rank's grad of this
    rank's columns (a reduce-scatter)."""
    return _through(_GatherForRows, x)


def sum_for_parts(x: torch.Tensor) -> torch.Tensor:
    """Every rank's part summed over ``model`` for a per-rank computation
    that reads the sum (a norm over a split dim): its grads summed too."""
    return _through(_SumForParts, x)


def cols_to_rows(x: torch.Tensor) -> torch.Tensor:
    """(R, c): this rank's columns of every row → (R/m, m·c): every column
    of this rank's block of R/m rows (an all-to-all)."""
    return _through(_ColsToRows, x)


def rows_to_cols(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`cols_to_rows`: (R/m, m·c) → (R, c)."""
    return _through(_RowsToCols, x)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over ``model`` (no grad: a shift)."""
    import torch.distributed as dist
    shard = _MODEL_SHARD
    x = x.detach()
    return x if shard is None else _summed(x, shard.group,
                                           dist.ReduceOp.MAX)
