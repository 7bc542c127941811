"""Assigned input shapes and shape-only stand-ins (``repro.launch.shapes``).

The reference's ``jax.ShapeDtypeStruct`` becomes a :class:`TensorSpec`: a
tensor on the ``meta`` device (shape and dtype, no storage) with its
:class:`~repro_torch.sharding.specs.NamedSharding`.  Parameter and cache
trees are built by running the real init (or prefill) under
``FakeTensorMode`` and moving each leaf to ``meta``: nothing is allocated.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..models.config import ArchConfig
from ..models.registry import get_model
from ..sharding.specs import (NamedSharding, PartitionSpec, batch_pspec,
                              map_with_path)
from .mesh import Mesh

Pytree = Any


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   InputShape("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class TensorSpec:
    """A ``meta`` tensor and its sharding on a mesh."""
    tensor: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self):
        return self.tensor.shape

    @property
    def dtype(self):
        return self.tensor.dtype


def arch_for_shape(cfg: ArchConfig, shape: InputShape
                   ) -> Optional[ArchConfig]:
    """Shape-specific config adjustments; None skips the pair.

    * long_500k: whisper skipped (decoder context 448); full-attention
      archs get the sliding-window variant (window 8192).
    * whisper decode_32k runs as a stress config (self-attention cache 32k,
      cross-attention 1500)."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return None
        if cfg.family in ("dense", "moe", "vlm") and cfg.sliding_window is None:
            return cfg.with_overrides(sliding_window=8192)
    return cfg


def to_meta(tree: Pytree) -> Pytree:
    """Each tensor leaf as an empty ``meta`` tensor of its shape and dtype
    (other leaves, such as a cache's host-int position, as they are)."""
    return map_with_path(tree, lambda path, a: torch.empty(
        a.shape, dtype=a.dtype, device="meta") if torch.is_tensor(a) else a)


def _clear_model_tables() -> None:
    from ..models.layers import rope_frequencies, sinusoidal_positions
    rope_frequencies.cache_clear()
    sinusoidal_positions.cache_clear()


@contextlib.contextmanager
def fake_mode():
    """A ``FakeTensorMode``: the ops run on shapes alone.  The models'
    cached tables (RoPE frequencies, sinusoidal positions) are emptied on
    entry and on exit, so no real table is read under it and no fake one
    outlives it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _clear_model_tables()
    try:
        with FakeTensorMode() as mode:
            yield mode
    finally:
        _clear_model_tables()


def meta_params(cfg: ArchConfig) -> Pytree:
    """The model's parameter tree as ``meta`` tensors (the real init, run
    under :func:`fake_mode`)."""
    gen = torch.Generator(device="cpu")
    with fake_mode():
        params = get_model(cfg).init(gen, device="cpu")
    return to_meta(params)


def input_specs(cfg: ArchConfig, shape: InputShape, mesh: Mesh) -> Dict:
    """``{name: TensorSpec}`` for every model input of this shape, batch
    sharded by :func:`batch_pspec`."""
    bundle = get_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    bspec = batch_pspec(mesh, B)
    if shape.kind in ("train", "prefill"):
        out = {}
        for name, (shp, dt) in bundle.batch_spec(B, S).items():
            pspec = PartitionSpec(*(tuple(bspec) + (None,) * (len(shp) - 1)))
            out[name] = TensorSpec(torch.empty(shp, dtype=dt, device="meta"),
                                   NamedSharding(mesh, pspec))
        return out
    # decode: one token per sequence
    return {"token": TensorSpec(torch.empty((B,), dtype=torch.int32,
                                            device="meta"),
                                NamedSharding(mesh, bspec))}
