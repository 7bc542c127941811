"""Parameter-tree <-> flat-vector utilities used by the aggregation math.

Trees are nested ``dict`` / ``list`` / ``tuple`` containers of tensors.
Leaves are visited in ``jax.tree_util`` order — dict keys **sorted**, list
and tuple items in order — so ``{"w": ..., "b": ...}`` flattens as b then w,
whatever the dict's insertion order.  That keeps every flat vector, update
matrix and α-weighted combine laid out exactly as in ``repro.core.flatten``.

``select_scope`` implements the paper's "last layer" efficiency scoping
(§III-B): only a named subset of the tree takes part in the Gram/solve,
while the combine applies the resulting α to the full update.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

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


def stacked_weighted_sum(stacked: Tree, weights: torch.Tensor) -> Tree:
    """``Σ_k weights[k] · leaf[k]`` per leaf of a stacked tree (leading K
    axis), f32 accumulation, each result in its leaf's dtype.  The plain
    tree form of the combine; the aggregators run the flat combine kernel
    (``kernels.ops.weighted_combine``) instead."""
    def comb(leaf):
        m = leaf.reshape(leaf.shape[0], -1).float()
        return (weights.float() @ m).reshape(leaf.shape[1:]).to(leaf.dtype)
    return tree_map(comb, stacked)
