"""Mesh builders of the port (``repro.launch.mesh``).

The port's :class:`Mesh` is the ordered axis sizes (``.shape``, a dict as
a JAX mesh's) plus a ``torch.distributed`` ``DeviceMesh`` over the process
group's ranks when the group has that many.  The reference places one
device of a JAX mesh on each coordinate; here each coordinate is one rank
of the process group, which the caller initialises
(``torch.distributed.init_process_group`` with its own address, world size
and rank: nothing here discovers a cluster).

:func:`emulated_mesh` describes a mesh whose logical devices all live on
this rank: the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``.  The spec rules,
``launch.steps.num_cohorts`` / ``cohort_axes`` and ``build_train_step``
accept it (the step then computes every cohort on this rank); the
collectives of ``core.distributed`` refuse it.

Builders are functions, never module-level constants, so importing this
module touches no process group and no device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple


class Mesh:
    """Named axis sizes, in order, and the ``DeviceMesh`` that lays them
    over the process group's ranks (None on a one-rank mesh without a
    process group, and on an emulated mesh)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_mesh=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.shape: Dict[str, int] = {a: int(s) for a, s in zip(axes, shape)}
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coordinate(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 without a
        ``DeviceMesh``)."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinates, ordered by their coordinate along ``axis``."""
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        kind = ("ranks" if self.device_mesh is not None else
                "one rank" if self.size == 1 else "emulated")
        return f"Mesh({self.shape}, {kind})"


def world_size() -> int:
    """Ranks of the initialised default process group (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> Mesh:
    """A mesh over the process group, whose world size must be the product
    of ``shape`` (as ``jax.make_mesh`` needs that many devices).  Without a
    process group only a one-rank mesh can be made, with no
    ``DeviceMesh``.  ``device_type`` defaults to ``"cuda"`` on an NCCL
    group, else ``"cpu"``."""
    import torch.distributed as dist
    need, world = math.prod(shape), world_size()
    if world != need:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks, the process "
            f"group has {world}" + ("" if world > 1 or need == 1 else
                                    " (no process group is initialised)")
            + "; emulated_mesh describes a mesh on this rank alone")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape, axes)
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, axes, init_device_mesh(
        device_type, tuple(int(s) for s in shape),
        mesh_dim_names=tuple(axes)))


def emulated_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh whose ``prod(shape)`` logical devices all live on this rank:
    its rules and its cohorts are the real mesh's, and it runs no
    collective."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout: ('data', 'model') 16×16, or
    ('pod', 'data', 'model') 2×16×16 with ``multi_pod``.  Raises
    ``RuntimeError`` when the process group has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), world_size()
    if have < need:
        raise RuntimeError(
            f"production mesh needs {need} devices, have {have} — describe "
            f"it on one rank with emulated_mesh({shape}, {axes})")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """Every rank of the process group as a 1×N ('data', 'model') mesh:
    (1, 1) without a process group."""
    return make_mesh((1, world_size()), ("data", "model"))
