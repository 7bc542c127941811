"""PyTorch/CUDA port of the contextual federated-aggregation system.

``repro`` (JAX) is the reference; this package mirrors its module layout so
each counterpart is found under the same name.  It imports neither JAX nor
``repro``.  Every entry point takes ``device=`` (default ``"cuda"``) and
raises when no CUDA device is available unless the caller passes
``device="cpu"`` — nothing silently falls back to the CPU.  On a CUDA tensor
the kernels in :mod:`repro_torch.kernels` launch hand-written Hopper code;
on a CPU tensor they run their plain PyTorch versions.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
