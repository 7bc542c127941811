"""The ``device=`` rule shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``; a CUDA device without a usable card
    raises instead of falling back to the CPU (pass ``device="cpu"``).
    ``meta`` is taken too: the device of a shape-only trace
    (``launch.dryrun``), on which nothing runs."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' "
                         "or 'cpu'")
    return dev
