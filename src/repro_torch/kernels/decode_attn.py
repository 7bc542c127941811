"""``flash_decode``: single-token GQA attention against a KV cache — the
Hopper kernel.

Replaces ``repro.kernels.decode_attn.flash_decode_pallas``.  It has three
bodies, chosen from the inputs alone: a call with q, k and v all bf16, hd
64 or 128, G <= 16 and 16-byte aligned pointers (:func:`_mma_eligible`)
runs on the bf16 tensor cores in one launch
(``csrc/decode_attn_cluster.cu``, ``"cluster"``): the splits of a head are
one thread-block cluster and merge through distributed shared memory,
their plan anchored at each row's live window and capped at the largest
cluster of which the card co-schedules one a head
(:func:`decode_cluster_splits`, :func:`cluster_cap`).  Every other call
(f32 caches, f32 q against a bf16 cache, hd 256) runs on the CUDA cores
(``csrc/decode_attn.cu``, ``"cuda_core"``), its splits tiling the whole
cache (:func:`decode_splits`) and merged by a second launch.
``body="mma"`` runs an eligible call on the tensor-core body of two
launches (``csrc/decode_attn_mma.cu``, :func:`decode_mma_splits`), and
``body="cuda_core"`` on the CUDA cores, to compare bodies on one input.
No f32 operand is rounded to bf16 to reach a tensor core.  Each source says
what bounds it on the H100 and how the work is laid out.

The host path: one validation pass that reads only dtypes, shapes,
strides, pointers and ``get_device()`` (:func:`_validate`); a plan cached
per shapes, dtypes, strides, window, cap, body and device (:func:`_plan`:
the splits, the launch function and its per-plan arguments; the cluster
body's as one ``ClusterPlan`` passed by pointer); one ``torch.empty`` that
holds o, lse and any split scratch; the launch on the current stream
without synchronising.  ``body_launches()`` tallies the launches by body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from .registry import count_launch

HEAD_DIMS = (64, 128, 256)
MAX_G = 16                 # query rows per KV head (12 for starcoder2)
MAX_G_X_HD = 2048          # G · hd: the registers of a lane's accumulators
SPLIT_GRANULE = 64         # a split's rows are a multiple of this
MAX_SPLITS = 4096          # the merge keeps one weight per split in 16 KB
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MMA_HEAD_DIMS = (64, 128)  # the tensor-core bodies' instances
MMA_TILE_ROWS = 64         # rows of their staged tiles; their splits' multiple
PORTABLE_CLUSTER = 8       # blocks of a cluster every sm_90 card schedules
MAX_CLUSTER = 16           # with the non-portable size opted in
BODIES = ("cluster", "mma", "cuda_core")
_BODY_LAUNCHES = {body: 0 for body in BODIES}


def _mma_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a call takes a tensor-core body: q, k and v all bf16,
    hd in (64, 128), 1 <= G <= 16, q contiguous, k and v with a contiguous
    last dim and strides of whole 16-byte units, and all three
    ``data_ptr()`` 16-byte aligned.  Reads only dtypes, shapes, strides and
    pointers."""
    return (q.dim() == 4 and k.dim() == 4 and v.dim() == 4
            and all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and k.shape[3] in MMA_HEAD_DIMS and 1 <= q.shape[2] <= MAX_G
            and q.is_contiguous() and q.data_ptr() % 16 == 0
            and all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
                    and all(s % 8 == 0 for s in t.stride()[:3])
                    for t in (k, v)))


def body_launches() -> Dict[str, int]:
    """``{"cluster": launches, "mma": launches, "cuda_core": launches}``
    since the last reset."""
    return dict(_BODY_LAUNCHES)


def reset_body_launches() -> None:
    for key in _BODY_LAUNCHES:
        _BODY_LAUNCHES[key] = 0


def decode_mma_splits(B: int, S: int, KV: int, resident: int,
                      window: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, rows per split)`` of the tensor-core body, from the shapes
    alone: the rows a query can see, ``live`` = min(S, window) (S without a
    window), are cut into whole ``MMA_TILE_ROWS``-row splits so that
    B·KV·splits blocks fill one wave of the ``resident`` blocks the card
    holds (one split a head when B·KV alone fills it).  The kernel anchors
    split j of batch row b at its own window: rows [lo_b + j·rows,
    min(lo_b + (j+1)·rows, len_b)), lo_b = max(0, len_b - window)."""
    return decode_cluster_splits(B, S, KV, resident, None, window)


def decode_cluster_splits(B: int, S: int, KV: int, resident: int,
                          cap: Optional[int],
                          window: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, rows per split)`` of the cluster body: the rule of
    :func:`decode_mma_splits` (each row's live window, whole 64-row
    splits, one wave of the ``resident`` blocks) with the splits of a head
    at most ``cap``, the largest cluster of which the card co-schedules
    one a head (:func:`cluster_cap`); ``cap=None`` caps nothing.  Where
    the cap does not bind, the two plans are equal."""
    live = min(S, window) if window else S
    per_row = max(1, resident // (B * KV))
    if cap is not None:
        per_row = min(per_row, cap)
    splits = max(1, min(per_row, -(-live // MMA_TILE_ROWS)))
    rows = -(-live // splits)
    rows = -(-rows // MMA_TILE_ROWS) * MMA_TILE_ROWS
    return -(-live // rows), rows


def decode_splits(B: int, S: int, KV: int, resident: int,
                  window: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, rows per split)`` of the seq axis, from the shapes alone —
    never from the lengths, so a slot's output depends only on its own rows
    and not on what the other slots hold.  ``resident`` is how many blocks
    the card holds at once (blocks per SM × SMs): the rows a query can see
    (all S, or the last ``window``) are cut so that the blocks with live
    rows fill one wave, in whole ``SPLIT_GRANULE``-row splits, at most
    ``MAX_SPLITS`` of them."""
    live = min(S, window) if window else S
    per_row = max(1, resident // (B * KV))
    live_splits = max(1, min(per_row, -(-live // SPLIT_GRANULE)))
    rows = max(-(-live // live_splits), -(-S // MAX_SPLITS))
    rows = -(-rows // SPLIT_GRANULE) * SPLIT_GRANULE
    return -(-S // rows), rows


@functools.lru_cache(maxsize=None)
def resident_blocks(hd: int, G: int, bf16: bool, device_index: int) -> int:
    """Blocks of the partial kernel the card holds at once for this head
    shape and cache type (the occupancy query × the SMs)."""
    lib = _build.load_library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.flash_decode_launch_config(hd, G, int(bf16),
                                            ctypes.byref(per_sm))
    _build.check(lib, rc, "flash_decode occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"flash_decode: the kernel cannot be resident for "
                           f"hd={hd}, G={G}")
    return per_sm.value * _build.sm_count(device_index)


@functools.lru_cache(maxsize=None)
def mma_resident_blocks(hd: int, device_index: int) -> int:
    """Blocks of the tensor-core body's partial kernel the card holds at
    once at head dim ``hd`` (the occupancy query × the SMs)."""
    lib = _build.load_library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.flash_decode_mma_launch_config(hd, ctypes.byref(per_sm))
    _build.check(lib, rc, "flash_decode_mma occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"flash_decode: the tensor-core body cannot be "
                           f"resident for hd={hd}")
    return per_sm.value * _build.sm_count(device_index)


@functools.lru_cache(maxsize=None)
def cluster_launch_config(hd: int, size: int,
                          device_index: int) -> Tuple[int, int]:
    """``(blocks resident, clusters co-scheduled)`` of the cluster body at
    head dim ``hd`` for clusters of ``size`` blocks: the occupancy query ×
    the SMs, and ``cudaOccupancyMaxActiveClusters`` (0 past 8 blocks where
    the non-portable size is refused)."""
    lib = _build.load_library()
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.flash_decode_cluster_launch_config(
            hd, size, ctypes.byref(per_sm), ctypes.byref(clusters))
    _build.check(lib, rc, "flash_decode_cluster occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"flash_decode: the cluster body cannot be "
                           f"resident for hd={hd}")
    return per_sm.value * _build.sm_count(device_index), clusters.value


def cluster_cap(hd: int, heads: int, device_index: int) -> int:
    """The most splits a head takes on the cluster body in a call of
    ``heads`` (batch row, kv head) pairs: the largest cluster, up to 16
    where the card grants the non-portable size (else 8), of which it
    co-schedules one for every head (``cudaOccupancyMaxActiveClusters``),
    so that the call's clusters run in one wave; 1 (no cluster) where not
    even clusters of 2 fit."""
    top = (MAX_CLUSTER if cluster_launch_config(hd, MAX_CLUSTER,
                                                device_index)[1] >= 1
           else PORTABLE_CLUSTER)
    for size in range(top, 1, -1):
        if cluster_launch_config(hd, size, device_index)[1] >= heads:
            return size
    return 1


class ClusterPlan(ctypes.Structure):
    """The per-plan constants of ``flash_decode_cluster_launch``, field for
    field ``csrc/decode_attn_cluster.cu``'s ``ClusterPlan``."""
    _fields_ = [("ks_b", ctypes.c_longlong), ("ks_s", ctypes.c_longlong),
                ("ks_h", ctypes.c_longlong), ("vs_b", ctypes.c_longlong),
                ("vs_s", ctypes.c_longlong), ("vs_h", ctypes.c_longlong),
                ("lse_offset", ctypes.c_longlong),
                ("B", ctypes.c_int), ("S", ctypes.c_int),
                ("KV", ctypes.c_int), ("G", ctypes.c_int),
                ("hd", ctypes.c_int), ("splits", ctypes.c_int),
                ("split_rows", ctypes.c_int), ("has_window", ctypes.c_int),
                ("window", ctypes.c_int), ("has_cap", ctypes.c_int),
                ("scale", ctypes.c_float), ("cap", ctypes.c_float)]


def _refuse(what: str, exc=ValueError):
    raise exc(f"flash_decode_cuda: {what}")


def _refuse_devices(q, k, v, lengths) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_cuda:
            _refuse(f"needs CUDA tensors; {name} is on {t.device}")
        if t.device != k.device:
            _refuse(f"{name} on {t.device}, k on {k.device}")
    _refuse("needs CUDA tensors on one device")


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor, window: Optional[int],
              softcap: Optional[float]) -> Tuple[int, bool]:
    """One pass over dtypes, shapes, strides, pointers and ``get_device()``
    that raises where the kernels cannot take a call, and returns ``(device
    index, whether the tensor-core bodies take it)``: :func:`_mma_eligible`
    on inputs that pass the rest."""
    idx = k.get_device()
    if idx < 0 or q.get_device() != idx or v.get_device() != idx \
            or lengths.get_device() != idx:
        _refuse_devices(q, k, v, lengths)
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks:
        _refuse(f"want q (B, KV, G, hd) and k, v (B, S, KV, hd); got "
                f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    B, S, KV, hd = ks
    if qs[0] != B or qs[1] != KV or qs[3] != hd:
        _refuse(f"q {tuple(qs)} does not match k {tuple(ks)}")
    G = qs[2]
    if hd not in HEAD_DIMS:
        _refuse(f"head_dim {hd} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_G or G * hd > MAX_G_X_HD:
        _refuse(f"G={G} with head_dim {hd}; want G <= {MAX_G} and G*hd <= "
                f"{MAX_G_X_HD}")
    if B < 1 or S < 1 or B > 65535 or KV > 65535:
        _refuse(f"B={B}, S={S}, KV={KV} outside the grid")
    qd, kd = q.dtype, k.dtype
    if qd not in SUPPORTED_DTYPES or kd not in SUPPORTED_DTYPES:
        _refuse(f"q {qd}, k {kd}; want {SUPPORTED_DTYPES}", TypeError)
    if v.dtype != kd:
        _refuse(f"k is {kd}, v {v.dtype}", TypeError)
    if not q.is_contiguous():
        _refuse("q must be contiguous")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        _refuse(f"lengths must be a contiguous (B,) int32 tensor; got "
                f"{lengths.dtype} {tuple(lengths.shape)}")
    # each lane reads 16 aligned bytes of a row: rows in place, any stride
    # of whole 16-byte units
    bf16 = kd == torch.bfloat16
    unit = 8 if bf16 else 4
    for name, t in (("k", k), ("v", v)):
        st = t.stride()
        if st[3] != 1 or st[0] % unit or st[1] % unit or st[2] % unit \
                or t.data_ptr() % 16:
            _refuse(f"{name} needs a contiguous last dim, 16-byte aligned "
                    f"rows and strides of whole 16-byte units; strides {st}")
    if window is not None and window < 1:
        _refuse(f"window {window} < 1")
    if softcap is not None and not softcap > 0:
        _refuse(f"softcap {softcap} <= 0")
    return idx, (bf16 and qd == torch.bfloat16 and hd in MMA_HEAD_DIMS
                 and q.data_ptr() % 16 == 0)


class _Plan(NamedTuple):
    """A call's launch, fixed by its key: ``fn`` the library's launch
    function, ``floats`` the output buffer's size (o, lse, then any split
    scratch), o's and lse's views of it, the byte offsets of the split
    partials (o and lse themselves with one split; unused by the cluster
    body), and ``consts``, the arguments that do not change between calls
    (the cluster body: the address of ``plan``, kept alive here)."""
    splits: int
    rows: int
    floats: int
    o_view: Tuple[Tuple[int, ...], Tuple[int, ...]]
    lse_view: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    part_offsets: Tuple[int, int]
    lib: ctypes.CDLL
    fn: object
    consts: tuple
    plan: Optional[ClusterPlan]


@functools.lru_cache(maxsize=4096)
def _plan(body: str, B: int, S: int, KV: int, G: int, hd: int, q_bf16: bool,
          kv_bf16: bool, kst: Tuple[int, ...], vst: Tuple[int, ...],
          window: Optional[int], softcap: Optional[float],
          device_index: int) -> _Plan:
    """The launch of a validated call on ``body``, from its key."""
    lib = _build.load_library()
    n_o, n_lse = B * KV * G * hd, B * KV * G
    flags = (int(window is not None), window or 0, int(softcap is not None),
             softcap or 0.0)
    scale = hd ** -0.5
    plan = None
    if body == "cluster":
        resident = cluster_launch_config(hd, 1, device_index)[0]
        splits, rows = decode_cluster_splits(
            B, S, KV, resident, cluster_cap(hd, B * KV, device_index), window)
        plan = ClusterPlan(*kst[:3], *vst[:3], n_o, B, S, KV, G, hd, splits,
                           rows, *flags[:3], scale, flags[3])
        fn, consts, scratch = (lib.flash_decode_cluster_launch,
                               (ctypes.addressof(plan),), 0)
    else:
        if body == "mma":
            splits, rows = decode_mma_splits(
                B, S, KV, mma_resident_blocks(hd, device_index), window)
            fn = lib.flash_decode_mma_launch
        else:
            splits, rows = decode_splits(
                B, S, KV, resident_blocks(hd, G, kv_bf16, device_index),
                window)
            fn = lib.flash_decode_launch
        consts = (B, S, KV, G, hd, *kst[:3], *vst[:3], splits, rows, scale,
                  *flags)
        # the partials from a 256-byte boundary past lse
        at = -(-(n_o + n_lse) // 64) * 64
        scratch = (at - n_o - n_lse + splits * (n_o + n_lse) if splits > 1
                   else 0)
    parts = ((4 * at, 4 * (at + splits * n_o)) if scratch else (0, 4 * n_o))
    return _Plan(splits, rows, n_o + n_lse + scratch,
                 ((B, KV, G, hd), (KV * G * hd, G * hd, hd, 1)),
                 ((B, KV, G, 1), (KV * G, G, 1, 1), n_o), parts, lib, fn,
                 consts, plan)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, *, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      body: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, KV, G, hd) contiguous; k, v (B, S, KV, hd) strided views (each
    row's hd entries contiguous); lengths (B,) int32 → ``(o (B, KV, G,
    hd) f32, lse (B, KV, G, 1) f32)``, two views of one buffer.  Only live
    rows are read: rows t with max(0, length - window) <= t < min(length,
    S).  A block of a seq-split cache passes local lengths (position + 1 -
    the block's first global row): any int; a row with no live key in the
    block (length <= 0, or a window that ends before the block) gives o = 0
    and lse = -1e30 from every body, and weighs 0 in the split merge and in
    ``ops.lse_merge``.  The body is ``"cluster"`` when the tensor cores take
    the call (:func:`_mma_eligible`) and ``"cuda_core"`` otherwise;
    ``body="mma"`` or ``"cuda_core"`` runs an eligible call on that body
    instead, to compare bodies on one input (a tensor-core body on an
    ineligible call raises)."""
    idx, tc = _validate(q, k, v, lengths, window, softcap)
    if body not in (None,) + BODIES:
        raise ValueError(f"flash_decode_cuda: body {body!r} not in {BODIES}")
    if body is None:
        body = "cluster" if tc else "cuda_core"
    elif body != "cuda_core" and not tc:
        raise ValueError("flash_decode_cuda: the tensor-core body takes bf16 "
                         f"q, k, v with hd in {MMA_HEAD_DIMS}, G <= {MAX_G} "
                         "and 16-byte aligned rows")
    B, S, KV, hd = k.shape
    p = _plan(body, B, S, KV, q.shape[2], hd, q.dtype == torch.bfloat16,
              k.dtype == torch.bfloat16, k.stride(), v.stride(), window,
              softcap, idx)
    out = torch.empty(p.floats, dtype=torch.float32, device=k.device)
    o, lse = out.as_strided(*p.o_view), out.as_strided(*p.lse_view)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    base = out.data_ptr()
    if body == "cluster":
        args = (*p.consts, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), base, stream)
    elif body == "mma":
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                base, base + 4 * p.lse_view[2], base + p.part_offsets[0],
                base + p.part_offsets[1], *p.consts, stream)
    else:
        args = (q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
                v.data_ptr(), int(k.dtype == torch.bfloat16),
                lengths.data_ptr(), base, base + 4 * p.lse_view[2],
                base + p.part_offsets[0], base + p.part_offsets[1],
                *p.consts, stream)
    if idx == torch._C._cuda_getDevice():
        rc = p.fn(*args)
    else:
        with torch.cuda.device(idx):
            rc = p.fn(*args)
    if rc:
        _build.check(p.lib, rc, "flash_decode")
    count_launch("flash_decode", "cuda")
    _BODY_LAUNCHES[body] += 1
    return o, lse
