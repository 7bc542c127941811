"""The card's roofline constants and a step's counts from a trace
(``repro.launch.hlo_analysis``).

The reference reads XLA's compiled module: ``cost_analysis()`` for FLOPs and
bytes, ``memory_analysis()`` for the fit, and the HLO text for the
collective bytes.  The port compiles nothing, so there is no HLO.  In its
place :class:`TraceCost` runs one step eagerly on fake tensors
(``FakeTensorMode`` over ``meta`` tensors: shapes only, nothing allocated)
and counts what the eager program dispatches:

  * ``flops`` — ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``: matmuls, convolutions,
    attention) on each dispatched op, plus each kernel op's own count,
    which its ``meta`` backend reports (``kernels.meta``);
  * ``bytes accessed`` — each dispatched op's tensor inputs read once and
    its outputs written once; views, metadata ops and bare allocations count
    nothing.  This is what the port's eager program moves, unfused;
  * ``peak_bytes`` — ``torch.distributed._tools.mem_tracker.MemTracker``,
    with the step's arguments (params, batch, caches written in place)
    resident from the start;
  * the collectives — the result bytes of each ``c10d`` op the step issues
    (``allgather_``, ``allreduce_``, ``reduce_scatter_``, ``alltoall_``, and
    send / recv as ``collective-permute``), under the reference's keys.

An eager trace dispatches every layer and every block of a loop, so, unlike
the reference's ``cost_analysis`` (a while-loop body counted once,
``repro/launch/analytic.py:4-14``), its counts need no calibration detour.

Not ported: ``collective_bytes(hlo_text)`` and ``_shape_bytes`` parse XLA
HLO text, and ``cost_analysis_dict`` normalises a compiled XLA executable;
nothing in the port produces either.

Constants: the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense, at the 700 W power limit) — 989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s f32, 3.35 TB/s of HBM3, 80 GB of it, and NVLink 4 at 450 GB/s
in one direction (900 GB/s both ways), which takes the place of the
reference's ``ICI_BW`` × 4 links.  A 16-wide ``'model'`` axis spans two
8-GPU nodes, whose link is slower than NVLink, so the collective term there
is a lower bound.  No number in this module was measured.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Optional

import torch

PEAK_FLOPS = 989e12          # bf16 on the tensor cores, per card
PEAK_FLOPS_F32 = 67e12       # f32 off the tensor cores
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink 4, bytes/s in one direction
HBM_CAPACITY = 80e9          # bytes (the data sheet's 80 GB)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_C10D_KIND = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute"}
# ops that allocate without writing, or only describe a tensor
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_contiguous", "lift_fresh")


def tensor_leaves(tree) -> list:
    """The tensor leaves of a tree of dicts, lists, tuples and NamedTuples."""
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tensor_bytes(tree) -> int:
    """Σ ``numel · element_size`` over the tensor leaves of ``tree``."""
    return sum(t.numel() * t.element_size() for t in tensor_leaves(tree))


def empty_collectives() -> Dict[str, int]:
    out = {k: 0 for k in _COLLECTIVES}
    out.update(count=0, total=0)
    return out


@dataclass
class RooflineTerms:
    flops: float                 # per-device flops of the trace
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def to_dict(self):
        return asdict(self)


def roofline(cost: Dict, coll: Dict[str, int],
             model_flops_total: Optional[float] = None,
             num_chips: int = 256) -> RooflineTerms:
    """The three roofline terms of one device's step from its counts.

    ``cost`` = :attr:`TraceCost.cost` (PER-DEVICE: this rank's program);
    ``model_flops_total`` = 6·N·D for the GLOBAL batch — divided by chips
    here so the useful ratio compares per-device quantities."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0))
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    coll_s = cb / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    mf = uratio = None
    if model_flops_total:
        mf = model_flops_total / num_chips
        uratio = mf / flops if flops else None
    return RooflineTerms(flops, hbm, cb, compute_s, memory_s, coll_s,
                         bottleneck, mf, uratio)


def _dispatch_counter():
    """A ``TorchDispatchMode`` adding each op's FLOPs (``FlopCounterMode``'s
    formulas, without its module tracking), its bytes and each collective's
    result bytes to its ``flops``, ``bytes`` and ``collectives``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.ops = 0
            self.collectives = empty_collectives()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.ops += 1
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            ns, name = func.namespace, func._schema.name.split("::")[-1]
            if ns == "c10d":
                kind = _C10D_KIND.get(name)
                if kind is not None:
                    # send and alltoall_base_ return no tensor: their
                    # payload is the sent tensor, the filled output
                    moved = (args if name == "send" else args[0]
                             if name == "alltoall_base_" else out)
                    nbytes = tensor_bytes(moved)
                    self.collectives[kind] += nbytes
                    self.collectives["count"] += 1
                    self.collectives["total"] += nbytes
            elif not (func.is_view or ns == "prim" or name in _NO_BYTES):
                self.bytes += tensor_bytes((args, kwargs)) + tensor_bytes(out)
            return out

    return _Counter()


class TraceCost:
    """Counts one step run inside it on fake tensors (the counterpart of
    ``cost_analysis_dict``, ``memory_analysis`` and ``collective_bytes``).

    Enter it inside the ``FakeTensorMode`` that made the step's arguments,
    handing it those arguments (``resident``: tensors on the device before
    the step starts, counted in the peak); after the block, read
    :attr:`cost`, :attr:`collectives` and :attr:`peak_bytes`."""

    def __init__(self, resident: Iterable = ()):
        self.resident = tensor_leaves(list(resident))
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self._stack = None

    def _on_kernel(self, op: str, flops: float, nbytes: float) -> None:
        self.kernel_flops += flops
        self.kernel_bytes += nbytes

    def __enter__(self) -> "TraceCost":
        import contextlib

        from torch.distributed._tools.mem_tracker import MemTracker

        from ..kernels.meta import cost_sink
        self._mem = MemTracker()
        self._mem.track_external(*self.resident)
        self._counter = _dispatch_counter()
        self._stack = contextlib.ExitStack()
        for ctx in (cost_sink(self._on_kernel), self._mem, self._counter):
            self._stack.enter_context(ctx)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    @property
    def cost(self) -> Dict[str, float]:
        """``{"flops", "bytes accessed"}`` of the step, kernel ops included."""
        return {"flops": float(self._counter.flops) + self.kernel_flops,
                "bytes accessed": float(self._counter.bytes)
                + self.kernel_bytes}

    @property
    def ops(self) -> int:
        """Ops dispatched by the step (views and collectives included)."""
        return self._counter.ops

    @property
    def collectives(self) -> Dict[str, int]:
        return dict(self._counter.collectives)

    @property
    def peak_bytes(self) -> int:
        """The most bytes live at once, the resident arguments included."""
        snap = self._mem.get_tracker_snapshot("peak")
        return int(sum(dev["Total"] for dev in snap.values()))
