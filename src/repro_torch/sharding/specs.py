"""Partition-spec rules of the port (``repro.sharding.specs``).

Strategy per tensor class (mesh axes: optional 'pod', 'data', 'model'):

  * large 2-D projection weights — tensor-parallel on the contraction-free
    dim over 'model'; for ≥ ``FSDP_THRESHOLD`` params also the other dim
    over 'data';
  * expert tensors (E, d, ff) — expert-parallel: E over 'model';
  * embeddings (V, d) — vocab over 'model' (+ d over 'data' when FSDP);
  * norms / biases / small vectors — replicated;
  * activations: batch over 'data' ('pod', 'data' when multi-pod);
  * KV caches: batch over 'data', seq over 'model'; batch-1 decode: seq
    over ('data', 'model').

Every axis assignment is guarded by divisibility; a non-dividing axis is
dropped (replicated).  The rules are data: a :class:`PartitionSpec` is a
tuple of axis names (``None``, a name or a tuple of names per tensor dim),
compared as tuples against the reference's.  :func:`named` turns them into
``torch.distributed.tensor`` placements on the mesh's ``DeviceMesh``.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..kernels.cross import GRANULE
from ..launch.mesh import Mesh, make_mesh, world_size
from ..models.config import ArchConfig

Pytree = Any

FSDP_THRESHOLD = 7_000_000_000   # params; ≥7B also shards over 'data'


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), an axis name or a tuple of
    axis names (sharded over them, major first)."""

    def __new__(cls, *names):
        return tuple.__new__(cls, names)

    def __repr__(self) -> str:
        return "PartitionSpec" + (tuple.__repr__(self) if len(self) != 1
                                  else f"({self[0]!r},)")


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its ``Shard(d)`` /
    ``Replicate()`` per mesh axis, in the mesh's axis order, for a
    ``DTensor`` on ``mesh.device_mesh``."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dim = next((d for d, name in enumerate(self.spec)
                        if name == axis or (isinstance(name, tuple)
                                            and axis in name)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)


# ------------------------------------------------------------- tree walking

def _children(tree) -> Optional[list]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                         PartitionSpec):
        return [(str(i), t) for i, t in enumerate(tree)]
    return None


def map_with_path(tree, fn: Callable, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; paths join
    dict keys and NamedTuple fields with '/', as the reference's
    ``_path_str``; ``None`` stays ``None`` (an empty subtree)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [map_with_path(sub, fn, f"{prefix}/{key}" if prefix else key)
            for key, sub in kids]
    if isinstance(tree, dict):
        return dict(zip([k for k, _ in kids], vals))
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def spec_leaves(tree) -> list:
    """``[(path, leaf)]`` of a tree of specs (or shardings, or tensors), in
    flattening order, ``None`` subtrees skipped."""
    out = []
    map_with_path(tree, lambda path, leaf: out.append((path, leaf)))
    return out


# ------------------------------------------------------------------- rules

def _axis_size(mesh: Mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def _fits(dim: int, mesh: Mesh, name) -> bool:
    return dim % _axis_size(mesh, name) == 0


def _guard(spec: Tuple, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Drop axis assignments that don't divide the corresponding dim."""
    return P(*(name if name is not None and _fits(dim, mesh, name) else None
               for dim, name in zip(shape, spec)))


def spec_for_leaf(path_str: str, shape: Tuple[int, ...], mesh: Mesh,
                  fsdp: bool) -> P:
    """Rule table: first match wins.  ``shape`` includes any leading stacked
    layer axes (left unsharded)."""
    spec = _rule_spec(path_str, shape, fsdp)
    return P() if spec is None else _guard(spec, shape, mesh)


def _rule_spec(path_str: str, shape: Tuple[int, ...],
               fsdp: bool) -> Optional[Tuple]:
    """The first matching rule's spec before the divisibility guard (None:
    no rule, replicated)."""
    d_axis = "data" if fsdp else None
    rules = [
        # --- MoE expert tensors (L, E, d, ff) / (E, d, ff)
        (r"moe/w_(up|gate|down)$", lambda s: ("model", d_axis, None)),
        (r"moe/router$", lambda s: (None, None)),
        # --- embeddings / unembeddings
        (r"(^|/)embed$", lambda s: ("model", d_axis)),
        (r"(^|/)lm_head$", lambda s: (d_axis, "model")),
        (r"img_proj$", lambda s: (None, "model")),
        # --- attention projections (column-parallel qkv, row-parallel o)
        (r"attn/w[qkv]$|cross/w[qkv]$", lambda s: (d_axis, "model")),
        (r"attn/wo$|cross/wo$", lambda s: ("model", d_axis)),
        (r"attn/b[qkv]$|cross/b[qkv]$", lambda s: ("model",)),
        # --- dense MLP (column-parallel up/gate, row-parallel down)
        (r"mlp/w_(up|gate)$|shared/w_(up|gate)$", lambda s: (d_axis, "model")),
        (r"mlp/w_down$|shared/w_down$", lambda s: ("model", d_axis)),
        # --- mamba2
        (r"mamba/in_proj$", lambda s: (d_axis, "model")),
        (r"mamba/out_proj$", lambda s: ("model", d_axis)),
        (r"mamba/conv_[wb]$", lambda s: (None,) * len(s)),
        # --- rwkv6
        (r"rwkv/(wr|wk|wv|wg|ffn_k|ffn_r|w_A)$", lambda s: (d_axis, "model")),
        (r"rwkv/(wo|ffn_v|w_B)$", lambda s: ("model", d_axis)),
    ]
    for pat, builder in rules:
        if re.search(pat, path_str):
            spec = builder(shape)
            return (None,) * (len(shape) - len(spec)) + tuple(spec)
    return None   # replicate (norms, scalars, small vectors)


def dropped_axes(cfg: ArchConfig, params_shape: Pytree,
                 mesh: Mesh) -> list:
    """``[(path, dim, axis)]`` for each axis a rule assigns that the mesh's
    size does not divide (``_guard`` replicates that dim instead)."""
    fsdp = cfg.param_count_estimate() >= FSDP_THRESHOLD
    out = []
    for path, leaf in spec_leaves(params_shape):
        shape = tuple(leaf.shape)
        raw = _rule_spec(path, shape, fsdp) or ()
        for dim, (size, name) in enumerate(zip(shape, raw)):
            if name is not None and not _fits(size, mesh, name):
                out.append((path, dim, name))
    return out


def param_pspecs(cfg: ArchConfig, params_shape: Pytree, mesh: Mesh,
                 mode: str = "tp") -> Pytree:
    """The tree of :class:`PartitionSpec` for a tree of tensors (meta
    tensors included).  ``mode='tp'``: tensor/expert-parallel over 'model'
    (+FSDP ≥ 7B); ``mode='dp'``: every leaf replicated."""
    if mode == "dp":
        return map_with_path(params_shape, lambda path, leaf: P())
    fsdp = cfg.param_count_estimate() >= FSDP_THRESHOLD
    return map_with_path(params_shape, lambda path, leaf: spec_for_leaf(
        path, tuple(leaf.shape), mesh, fsdp))


def batch_pspec(mesh: Mesh, batch_size: int) -> P:
    """Sharding for the leading batch axis of inputs."""
    axes = [a for a in ("pod", "data") if a in mesh.shape]
    name = tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)
    if name is None or batch_size % _axis_size(mesh, name) != 0:
        # try data only, else replicate (long_500k batch=1)
        if "data" in mesh.shape and batch_size % mesh.shape["data"] == 0:
            return P("data")
        return P(None)
    return P(name)


def cache_pspecs(cfg: ArchConfig, cache_shape: Pytree, mesh: Mesh,
                 batch_size: int) -> Pytree:
    """KV caches: (L, B, S, KV, hd) → batch@data, seq@model; batch-1 decode
    shards seq over ('data', 'model').  Recurrent states: batch@data, the
    heads of a stacked 5-D state ((L, B, H, P, P) wkv, (L, B, H, P, N)
    SSM) under the first ``ndim == 5`` rule, the KV caches' seq axis: over
    'model', or ('data', 'model') at batch 1, as the reference's.  A host
    int (``LMCache.position``) is replicated."""
    bspec = batch_pspec(mesh, batch_size)
    batch_axis = bspec[0] if len(bspec) else None
    seq_axes = ("model",) if batch_axis is not None else \
        tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    seq_axis = seq_axes if len(seq_axes) > 1 else seq_axes[0]

    def leaf_spec(name, leaf):
        if not torch.is_tensor(leaf) or leaf.ndim == 0 or "position" in name:
            return P()
        shape = tuple(leaf.shape)
        if leaf.ndim == 5:      # (L, B, S, KV, hd) stacked KV cache
            return _guard((None, batch_axis, seq_axis, None, None), shape,
                          mesh)
        if leaf.ndim == 4 and "wkv" in name:
            return _guard((None, batch_axis, "model", None), shape, mesh)
        if leaf.ndim == 5 and "ssm" in name:    # the reference's; unreached
            return _guard((None, batch_axis, "model", None, None), shape,
                          mesh)
        if leaf.ndim == 4:      # (L, B, W, C) conv state or (B, S, KV, hd)
            return _guard((None, batch_axis, None, None), shape, mesh)
        if leaf.ndim == 3:
            return _guard((None, batch_axis, None), shape, mesh)
        if leaf.ndim == 2:
            return _guard((None, batch_axis), shape, mesh)
        return P()

    return map_with_path(cache_shape, leaf_spec)


# ---------------------------------------------------------- local shards

def _dim_axes(spec: PartitionSpec, ndim: int) -> list:
    """Per dim the tuple of axis names that shard it (major first)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [() if n is None else ((n,) if isinstance(n, str) else tuple(n))
            for n in spec]


def shard_shape(shape: Tuple[int, ...], spec: PartitionSpec,
                mesh: Mesh) -> Tuple[int, ...]:
    """The shape of the block ``spec`` puts on one device (each sharded
    dim cut by the product of its axes, rounded up)."""
    return tuple(-(-int(dim) // math.prod(mesh.shape[a] for a in names))
                 for dim, names in zip(shape, _dim_axes(spec, len(shape))))


def local_shard(t: torch.Tensor, spec: PartitionSpec,
                mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a copy, so ``t`` can be
    freed): along each sharded dim the slice at this rank's coordinate
    over that dim's axes (major first)."""
    for dim, names in enumerate(_dim_axes(spec, t.ndim)):
        if not names:
            continue
        ways, at = 1, 0
        for a in names:
            ways *= mesh.shape[a]
            at = at * mesh.shape[a] + mesh.coordinate(a)
        n = t.shape[dim] // ways
        t = t.narrow(dim, at * n, n)
    return t.clone(memory_format=torch.contiguous_format)


def dim_axes(spec: PartitionSpec, dim: int) -> Tuple[str, ...]:
    """The mesh axes that split dim ``dim`` of a leaf under ``spec``,
    major first (``()``: the dim is whole on every rank)."""
    return tuple(_dim_axes(spec, dim + 1)[dim])


def place_cache(mesh: Mesh, cache: Pytree, specs: Pytree) -> Pytree:
    """Each tensor leaf of a whole cache as this rank's block under its
    spec of ``specs`` (``cache_pspecs``); a host int (``position``) kept."""
    flat = iter([s for _, s in spec_leaves(specs)])

    def leaf(path, t):
        spec = next(flat)
        return local_shard(t, spec, mesh) if torch.is_tensor(t) else t
    return map_with_path(cache, leaf)


def cache_block(cache_shape: Pytree, specs: Pytree, mesh: Mesh,
                device=None) -> Pytree:
    """This rank's block of a cache, zeros, allocated alone: each tensor
    leaf of ``cache_shape`` (the whole cache's shapes, ``meta`` tensors)
    as zeros of its block's shape under ``specs`` on ``device`` (a whole
    ``decode_32k`` cache is terabytes; a block is what one card holds).
    Host ints are kept."""
    flat = iter([s for _, s in spec_leaves(specs)])

    def leaf(path, t):
        spec = next(flat)
        if not torch.is_tensor(t):
            return t
        return torch.zeros(shard_shape(tuple(t.shape), spec, mesh),
                           dtype=t.dtype, device=device)
    return map_with_path(cache_shape, leaf)


def place_params(mesh: Mesh, params: Pytree, specs: Pytree) -> Pytree:
    """Each leaf of ``params`` as this rank's block under its spec of
    ``specs`` (a tree of the same structure)."""
    flat = iter([s for _, s in spec_leaves(specs)])
    return map_with_path(params, lambda path, t: local_shard(
        t, next(flat), mesh))


def place_batch(mesh: Mesh, batch: dict) -> dict:
    """Each input of a global batch as this rank's rows under
    :func:`batch_pspec`: its cohort's rows.  Raises when the rows do not
    divide over the cohort axes (``pod`` and ``data``), where the spec
    would hand a rank other cohorts' rows."""
    C = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
    for name, x in batch.items():
        if x.shape[0] % C:
            raise ValueError(f"batch input {name!r} of {x.shape[0]} rows "
                             f"does not divide into {C} cohorts")
    return {name: local_shard(x, batch_pspec(mesh, x.shape[0]), mesh)
            for name, x in batch.items()}


def local_bytes(params_shape: Pytree, specs: Pytree, mesh: Mesh) -> dict:
    """``{path: bytes}`` of each leaf's block on one rank."""
    flat = iter([s for _, s in spec_leaves(specs)])
    return {path: math.prod(shard_shape(tuple(t.shape), next(flat), mesh))
            * t.element_size() for path, t in spec_leaves(params_shape)}


def named(mesh: Mesh, tree_of_specs: Pytree) -> Pytree:
    """Each spec of the tree as a :class:`NamedSharding` on ``mesh``."""
    return map_with_path(tree_of_specs, lambda path, s: NamedSharding(mesh, s))


# -------------------------------------------------------------- fleet axis

def stream_column_shardings(mesh: Mesh, stacked: Pytree) -> Pytree:
    """Shardings for a stacked round tree (leading P device axis per leaf)
    that split the streamed engine's column axis: the trailing dim of every
    ≥ 2-D leaf over every available mesh axis, guarded by divisibility."""
    axes = [a for a in ("pod", "data", "model") if a in mesh.shape]
    name = tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)

    def leaf_sharding(path, leaf):
        shape = tuple(leaf.shape)
        if name is None or len(shape) < 2:
            return NamedSharding(mesh, P())
        spec = (None,) * (len(shape) - 1) + (name,)
        return NamedSharding(mesh, _guard(spec, shape, mesh))

    return map_with_path(stacked, leaf_sharding)


def stream_round_shardings(mesh: Mesh, stacked: Pytree) -> Pytree:
    """:func:`stream_column_shardings` plus, with a ``'fleet'`` axis, the
    leading P (device) dim of every leaf over it (each rank holds its own
    row block); without one, exactly :func:`stream_column_shardings`."""
    if "fleet" not in mesh.shape:
        return stream_column_shardings(mesh, stacked)
    col_axes = [a for a in ("pod", "data", "model") if a in mesh.shape]
    col = tuple(col_axes) if len(col_axes) > 1 else \
        (col_axes[0] if col_axes else None)

    def leaf_sharding(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        if len(shape) == 1:
            return NamedSharding(mesh, _guard(("fleet",), shape, mesh))
        spec = ("fleet",) + (None,) * (len(shape) - 2) + (col,)
        return NamedSharding(mesh, _guard(spec, shape, mesh))

    return map_with_path(stacked, leaf_sharding)


_STREAM_ORDER = ("fleet", "pod", "data", "model")


def stream_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Every axis of ``mesh`` in the streamed engine's rank order:
    ``'fleet'`` major, then ``pod``, ``data``, ``model``, then any other
    axis in the mesh's order."""
    return (tuple(a for a in _STREAM_ORDER if a in mesh.shape)
            + tuple(a for a in mesh.axis_names if a not in _STREAM_ORDER))


def window_width(width: int, ranks: int) -> int:
    """Columns of each window of :func:`column_windows` but the last
    nonempty one: ceil(width / ranks), rounded up to a multiple of
    ``kernels.cross.GRANULE`` (256; so a bf16 window of a 16-byte aligned
    slab keeps 16-byte aligned rows)."""
    per = -(-width // ranks)
    return -(-per // GRANULE) * GRANULE


def column_windows(width: int, ranks: int) -> list:
    """``[(start, stop)]`` of each of ``ranks`` places over ``width``
    columns: one contiguous window each, in place order, ``window_width``
    columns wide, the last nonempty window short and any after it
    empty."""
    per = window_width(width, ranks)
    return [(min(r * per, width), min((r + 1) * per, width))
            for r in range(ranks)]


def stream_windows(mesh: Mesh, width: int) -> Tuple[int, int]:
    """This rank's ``(start, stop)`` column window of a slab of ``width``
    flattened columns, the port's placement of the streamed round: its
    place is its coordinates in :func:`stream_axes`' order.

    The reference (:func:`stream_round_shardings`) splits the trailing dim
    of every >= 2-D leaf, guarded by divisibility, and with ``'fleet'``
    the leading P dim too.  A trailing-dim block of a (P, a, b) leaf is no
    2-D view with one row stride, and the kernels would need a copy of it;
    a window of the leaf's flattened (P, width) slab is such a view.  The
    cohort's rows are already on every rank (``shard_cohort_fn``
    all-gathers them), so the ``'fleet'`` axis splits the columns too."""
    place = 0
    for a in stream_axes(mesh):
        place = place * mesh.shape[a] + mesh.coordinate(a)
    per = window_width(width, mesh.size)
    return min(place * per, width), min((place + 1) * per, width)


def fleet_mesh() -> Mesh:
    """One-axis ``'fleet'`` mesh over the process group's ranks (one rank
    without a process group)."""
    return make_mesh((world_size(),), ("fleet",))


def shard_cohort_fn(mesh: Mesh, cohort_fn: Callable,
                    num_stacked_args: int) -> Callable:
    """``cohort_fn(params, *args) -> tree`` split over the ``'fleet'`` axis:
    params replicated, the first ``num_stacked_args`` args split on their
    leading cohort axis — rank r runs rows [r·b, (r+1)·b) — and every output
    leaf all-gathered in rank order, so every rank holds the whole result.
    Cohorts that do not divide the axis are padded with the first row and
    sliced back.  On a one-rank (or emulated) mesh it is ``cohort_fn``."""
    from ..core.distributed import all_gather_rows
    from ..core.flatten import tree_map
    axis = mesh.shape["fleet"]
    if axis == 1 or mesh.device_mesh is None:
        return cohort_fn

    def wrapped(params, *args):
        stacked, rest = args[:num_stacked_args], args[num_stacked_args:]
        B = stacked[0].shape[0]
        pad = (-B) % axis
        if pad:
            stacked = [torch.cat([a, a[:1].expand(pad, *a.shape[1:])])
                       for a in stacked]
        per, r = (B + pad) // axis, mesh.coordinate("fleet")
        out = cohort_fn(params, *(a[r * per:(r + 1) * per] for a in stacked),
                        *rest)
        return tree_map(lambda t: all_gather_rows(mesh, t, ("fleet",))[:B],
                        out)

    return wrapped
