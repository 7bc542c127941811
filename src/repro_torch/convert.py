"""Carry parameters over from the reference package.

``jax.random`` initialisation cannot be reproduced in torch, so parity
checks start both packages from the same weights: the reference's
parameter tree, as numpy arrays, becomes the port's tree of tensors with the
same keys and nesting.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.flatten import tree_map
from .device import DeviceLike, resolve_device


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":        # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree_of_numpy: Any, device: DeviceLike = "cuda") -> Any:
    """Nested dict/list/tuple of arrays → the same nesting of tensors on
    ``device`` (dtypes kept, bfloat16 included)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree_of_numpy)
