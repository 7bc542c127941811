"""Kernel dispatch of the port: one implementation per (op, backend).

Backends:

  * ``cuda``  — the hand-written Hopper kernel (``csrc/*.cu``), for CUDA
    tensors.
  * ``torch`` — the plain PyTorch version (``kernels.ref``), for CPU tensors
    and as the yardstick tests and ``chip_smoke.py`` hold the kernel against.

Selection follows the tensors' device: a CUDA tensor launches ``cuda``, a
CPU tensor runs ``torch``.  The plain version is never chosen for a CUDA
tensor unless the caller forces it (``backend="torch"`` at the call, or
``with force_backend("torch"):``).  There is no autotune and no environment
override: with one kernel per op the only other candidate is the plain
version, and choosing it would hide the kernel.

Every (op, backend) keeps a plain integer launch counter, bumped by the
implementation where it launches (``count_launch``) and read with
``launch_counts()``, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_DEVICE_BACKEND = {"cuda": "cuda", "cpu": "torch"}


@dataclass(frozen=True)
class KernelImpl:
    """One (op, backend) implementation."""
    op: str
    backend: str
    fn: Callable


_IMPLS: Dict[str, Dict[str, KernelImpl]] = {}
_FORCED: List[Tuple[Optional[str], str]] = []   # (op or None, backend) stack
_COUNTS: Dict[Tuple[str, str], int] = {}


def register_impl(op: str, backend: str, fn: Callable, *,
                  overwrite: bool = False) -> None:
    impls = _IMPLS.setdefault(op, {})
    if backend in impls and not overwrite:
        raise KeyError(f"kernel impl '{op}/{backend}' already registered")
    impls[backend] = KernelImpl(op, backend, fn)
    _COUNTS.setdefault((op, backend), 0)


def available_ops() -> Tuple[str, ...]:
    return tuple(sorted(_IMPLS))


def backends(op: str) -> Tuple[str, ...]:
    if op not in _IMPLS:
        raise KeyError(f"unknown kernel op '{op}'; have {available_ops()}")
    return tuple(sorted(_IMPLS[op]))


class force_backend:
    """Context manager pinning dispatch to one backend (optionally one op)."""

    def __init__(self, backend: str, op: Optional[str] = None):
        self.entry = (op, backend)

    def __enter__(self):
        _FORCED.append(self.entry)
        return self

    def __exit__(self, *exc):
        _FORCED.remove(self.entry)
        return False


def _forced_backend(op: str) -> Optional[str]:
    for forced_op, backend in reversed(_FORCED):
        if forced_op is None or forced_op == op:
            return backend
    return None


def _device_of(args: Tuple) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("kernel dispatch needs at least one tensor argument")


def select_impl(op: str, *args: Any) -> KernelImpl:
    """The implementation :func:`dispatch` runs for these arguments."""
    backend = _forced_backend(op)
    if backend is None:
        dev = _device_of(args)
        if dev.type not in _DEVICE_BACKEND:
            raise ValueError(f"no kernel backend for device '{dev}' "
                             f"(op '{op}')")
        backend = _DEVICE_BACKEND[dev.type]
    return _impl(op, backend)


def _impl(op: str, backend: str) -> KernelImpl:
    if op not in _IMPLS:
        raise KeyError(f"unknown kernel op '{op}'; have {available_ops()}")
    if backend not in _IMPLS[op]:
        raise KeyError(f"backend '{backend}' not registered for '{op}' "
                       f"(have {backends(op)})")
    return _IMPLS[op][backend]


def dispatch(op: str, *args: Any, backend: Optional[str] = None,
             **kw: Any) -> Any:
    """Run ``op`` on ``backend`` if given, else on the forced backend, else
    on the backend of the tensors' device."""
    impl = _impl(op, backend) if backend is not None else select_impl(op, *args)
    return impl.fn(*args, **kw)


def count_launch(op: str, backend: str) -> None:
    """Add one launch to (op, backend) — called by an implementation where
    it launches, and nowhere else."""
    _COUNTS[(op, backend)] += 1


def launch_counts() -> Dict[str, int]:
    """``{"op/backend": launches}`` for every registered implementation."""
    return {f"{op}/{be}": n for (op, be), n in sorted(_COUNTS.items())}


def reset_launch_counts() -> None:
    for key in _COUNTS:
        _COUNTS[key] = 0
