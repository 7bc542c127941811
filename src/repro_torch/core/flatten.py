"""Parameter-tree <-> flat-vector utilities used by the aggregation math.

Trees are nested ``dict`` / ``list`` / ``tuple`` containers of tensors.
Leaves are visited in ``jax.tree_util`` order — dict keys **sorted**, list
and tuple items in order — so ``{"w": ..., "b": ...}`` flattens as b then w,
whatever the dict's insertion order.  That keeps every flat vector, update
matrix and α-weighted combine laid out exactly as in ``repro.core.flatten``.

``select_scope`` implements the paper's "last layer" efficiency scoping
(§III-B): only a named subset of the tree takes part in the Gram/solve,
while the combine applies the resulting α to the full update.

``ChunkedFlatView`` and ``mix_rows`` are the streamed engine's view of a
stacked tree: leaf slabs in flat-vector order, and the per-leaf α-weighted
row sum through the ``combine`` kernel, with no f32 copy of the leaf.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from ..kernels.ops import weighted_combine

Tree = Any


def _children(tree: Tree) -> Optional[List[Tuple[str, Tree]]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), t) for i, t in enumerate(tree)]
    return None


def tree_leaves_with_path(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in flattening order; paths join keys with '/'."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in kids:
        out.extend(tree_leaves_with_path(sub, f"{prefix}/{key}" if prefix else key))
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_unflatten(like: Tree, leaves: Sequence[Any]) -> Tree:
    """A tree shaped like ``like`` holding ``leaves`` in flattening order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template tree has")
    return out


def tree_to_vector(tree: Tree, dtype: Optional[torch.dtype] = torch.float32
                   ) -> torch.Tensor:
    """Flatten a tree of tensors into a single 1-D vector."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype or torch.float32)
    parts = [x.reshape(-1) if dtype is None else x.reshape(-1).to(dtype)
             for x in leaves]
    return torch.cat(parts)


def vector_to_tree(vec: torch.Tensor, like: Tree) -> Tree:
    """Inverse of :func:`tree_to_vector` given a structural template."""
    out, offset = [], 0
    for leaf in tree_leaves(like):
        size = leaf.numel()
        out.append(vec[offset:offset + size].reshape(leaf.shape).to(leaf.dtype))
        offset += size
    return tree_unflatten(like, out)


def tree_size(tree: Tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def select_scope(tree: Tree, scope: str | Sequence[str] | None) -> Tree:
    """Return a tree whose leaves outside ``scope`` are zero-size tensors.

    ``scope`` semantics (as ``repro.core.flatten.select_scope``):
      * ``None`` or ``"full"``   -> the whole tree (identity).
      * ``"last_layer"``        -> leaves whose path matches common head names
        (``lm_head``, ``head``, ``out_proj``, ``final``, ``unembed``,
        ``logits``); falls back to the lexicographically last top-level key
        if nothing matches.
      * a regex string or list of regex strings -> leaves whose '/'-joined
        path matches any pattern.
    """
    if scope is None or scope == "full":
        return tree
    flat = tree_leaves_with_path(tree)
    if scope == "last_layer":
        patterns = [r"(^|/)(lm_head|head|out_proj|final|unembed|logits)(/|$)"]
        if not any(re.search(patterns[0], path) for path, _ in flat):
            keys = sorted({path.split("/")[0] for path, _ in flat})
            patterns = [r"^" + re.escape(keys[-1]) + r"(/|$)"]
    elif isinstance(scope, str):
        patterns = [scope]
    else:
        patterns = list(scope)

    def keep(path: str) -> bool:
        return any(re.search(p, path) for p in patterns)

    new_leaves = [leaf if keep(path) else
                  torch.zeros((0,), dtype=leaf.dtype, device=leaf.device)
                  for path, leaf in flat]
    return tree_unflatten(tree, new_leaves)


def scope_vector(tree: Tree, scope: str | Sequence[str] | None,
                 dtype: Optional[torch.dtype] = torch.float32) -> torch.Tensor:
    """Flatten only the scoped subset of ``tree``."""
    return tree_to_vector(select_scope(tree, scope), dtype=dtype)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


@dataclass(frozen=True)
class LeafSlab:
    """One tree leaf as a column slab of the flat ``(K, n)`` row-major view:
    ``matrix`` is ``leaf.reshape(K, -1)`` (a view of a contiguous leaf,
    never a cross-leaf concatenation), occupying flat columns
    ``[offset, offset + width)`` in ``tree_to_vector`` order."""
    index: int              # leaf position in flattening order
    offset: int             # first flat column
    width: int              # columns (= leaf.numel() / K)
    in_scope: bool          # takes part in the Gram scope
    matrix: torch.Tensor    # (K, width) view of the stacked leaf


class ChunkedFlatView:
    """Leaf-aligned column view of a *stacked* tree (leading K axis per
    leaf), as ``repro.core.flatten.ChunkedFlatView``: the streaming
    alternative to concatenating the leaves into one (K, n) matrix.

    The flat column order matches :func:`tree_to_vector` (leaf order,
    row-major per leaf), so a consumer that sweeps the slabs, or
    :meth:`chunks`, left to right sees the (K, n) matrix the dense path
    builds without holding it.  Scope is leaf-granular (``select_scope``
    keeps or drops whole leaves), so scoped reductions skip the
    ``in_scope=False`` slabs.
    """

    def __init__(self, stacked: Tree,
                 scope: str | Sequence[str] | None = None):
        leaves = tree_leaves(stacked)
        if not leaves:
            raise ValueError("cannot build a flat view of an empty tree")
        self.K = int(leaves[0].shape[0])
        bad = [tuple(l.shape) for l in leaves
               if l.dim() < 1 or l.shape[0] != self.K]
        if bad:
            raise ValueError(f"stacked tree leaves must share the leading "
                             f"K={self.K} axis; offending shapes: {bad}")
        kept = [l.numel() > 0 for l in tree_leaves(select_scope(stacked,
                                                                 scope))]
        self.slabs: List[LeafSlab] = []
        offset = 0
        for i, (leaf, keep) in enumerate(zip(leaves, kept)):
            width = leaf.numel() // self.K
            self.slabs.append(LeafSlab(
                index=i, offset=offset, width=width, in_scope=bool(keep),
                matrix=leaf.reshape(self.K, width)))
            offset += width
        self.n = offset

    @property
    def scoped_slabs(self) -> List[LeafSlab]:
        return [s for s in self.slabs if s.in_scope]

    @property
    def n_scoped(self) -> int:
        return sum(s.width for s in self.scoped_slabs)

    def chunks(self, chunk_cols: int, scoped_only: bool = False
               ) -> Iterator[Tuple[int, bool, torch.Tensor]]:
        """Yield ``(offset, in_scope, (K, w) view)`` column chunks with
        ``w <= chunk_cols`` that never cross a leaf boundary.  Offsets are
        flat columns of the full view."""
        if chunk_cols < 1:
            raise ValueError(f"chunk_cols must be >= 1, got {chunk_cols}")
        for slab in self.slabs:
            if scoped_only and not slab.in_scope:
                continue
            for start in range(0, slab.width, chunk_cols):
                yield (slab.offset + start, slab.in_scope,
                       slab.matrix[:, start:start + chunk_cols])

    def materialize(self, dtype: Optional[torch.dtype] = torch.float32
                    ) -> torch.Tensor:
        """Dense (K, n) matrix — tests and small models only."""
        return torch.cat([s.matrix if dtype is None else s.matrix.to(dtype)
                          for s in self.slabs], dim=1)


def mix_rows(weights: torch.Tensor, leaf: torch.Tensor, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Σ_k w_k · leaf[k]`` over the leading axis, flattened to the leaf's
    (width,) columns as f32 — the per-leaf primitive of the streamed
    combine, as ``repro.core.flatten.mix_rows``.

    Each weight is first rounded to the leaf's dtype, as the reference
    does (for bf16 leaves that keeps 8 mantissa bits of each f32 solve
    weight); the sum runs in f32 through the ``combine`` kernel over a zero
    base, which reads the leaf in its own dtype: on the card no f32 copy of
    the leaf is made.  ``out``, an f32 (width,) tensor, receives the result
    (its contents are overwritten)."""
    m = leaf.reshape(leaf.shape[0], -1)
    if out is None:
        out = torch.zeros(m.shape[1], dtype=torch.float32, device=m.device)
    else:
        out.zero_()
    return weighted_combine(out, m, weights.to(m.dtype).float(), out=out)


def stacked_weighted_sum(stacked: Tree, weights: torch.Tensor) -> Tree:
    """``Σ_k weights[k] · leaf[k]`` per leaf of a stacked tree (leading K
    axis), through :func:`mix_rows` (weights rounded to the leaf's dtype,
    f32 accumulation), each result in its leaf's dtype."""
    def comb(leaf):
        return mix_rows(weights, leaf).reshape(leaf.shape[1:]).to(leaf.dtype)
    return tree_map(comb, stacked)
