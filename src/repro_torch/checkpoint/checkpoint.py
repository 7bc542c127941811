"""Tree checkpointing (npz payload + JSON header), as ``repro.checkpoint``.

Works for any tree of tensors (params, optimizer state, FL server state):
nested ``dict`` / ``list`` / ``tuple`` / ``NamedTuple`` containers.  Leaves
are copied to the host before writing; on restore each tensor goes to the
device of the template leaf it replaces.

Layout:  <dir>/<step:08d>.ckpt.npz  +  <dir>/<step:08d>.ckpt.json (step,
leaf names, dtypes, shapes, meta)

The leaf names and their order are the reference's — ``jax.tree_util``
key paths such as ``['opt']['m']``, ``[0]`` or ``.params``, dict keys
sorted — so a checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

# numpy's savez stores these as they are; any other dtype (bfloat16) is
# written upcast to f32 and cast back to the template's dtype on restore
_NATIVE = ("float32", "float64", "int32", "int64", "uint8", "int8",
           "uint16", "int16", "uint32", "uint64", "bool", "float16")


def _children(tree: Tree) -> Optional[List[Tuple[str, Tree]]]:
    """``[(key string, subtree)]`` in ``jax.tree_util`` order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", t) for i, t in enumerate(tree)]
    return None


def _flatten_with_names(tree: Tree, prefix: str = ""
                        ) -> Tuple[List[str], List[Any]]:
    kids = _children(tree)
    if kids is None:
        return [prefix], [tree]
    names, leaves = [], []
    for key, sub in kids:
        n, l = _flatten_with_names(sub, prefix + key)
        names += n
        leaves += l
    return names, leaves


def _unflatten(like: Tree, it) -> Tree:
    kids = _children(like)
    if kids is None:
        return next(it)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    values = [_unflatten(sub, it) for _, sub in kids]
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def _host(leaf) -> Tuple[str, np.ndarray]:
    """A leaf's dtype name and its storable host copy."""
    t = torch.as_tensor(leaf).detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    return name, (t if name in _NATIVE else t.float()).numpy()


def save_checkpoint(directory: str, step: int, tree: Tree,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    names, leaves = _flatten_with_names(tree)
    host = [_host(x) for x in leaves]
    base = os.path.join(directory, f"{step:08d}.ckpt")
    np.savez(base + ".npz", **{f"leaf_{i}": a for i, (_, a) in enumerate(host)})
    with open(base + ".json", "w") as f:
        json.dump({"step": step, "names": names,
                   "dtypes": [name for name, _ in host],
                   "shapes": [list(a.shape) for _, a in host],
                   "meta": meta or {}}, f)
    return base + ".npz"


def load_checkpoint(directory: str, step: int, like: Tree
                    ) -> Tuple[Tree, Dict[str, Any]]:
    """The checkpoint at ``step``, shaped like ``like``: each leaf in the
    dtype and on the device of the template tensor it replaces."""
    base = os.path.join(directory, f"{step:08d}.ckpt")
    with open(base + ".json") as f:
        header = json.load(f)
    names, tmpl_leaves = _flatten_with_names(like)
    if names != header["names"]:
        raise ValueError("checkpoint structure mismatch: "
                         f"{set(names) ^ set(header['names'])}")
    with np.load(base + ".npz") as payload:
        restored = [torch.from_numpy(payload[f"leaf_{i}"]).to(
            device=t.device, dtype=t.dtype) for i, t in enumerate(tmpl_leaves)]
    return _unflatten(like, iter(restored)), header["meta"]


def restore_latest(directory: str, like: Tree
                   ) -> Optional[Tuple[int, Tree, Dict[str, Any]]]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(int(m.group(1)) for f in os.listdir(directory)
                   if (m := re.match(r"^(\d+)\.ckpt\.npz$", f)))
    if not steps:
        return None
    tree, meta = load_checkpoint(directory, steps[-1], like)
    return steps[-1], tree, meta
