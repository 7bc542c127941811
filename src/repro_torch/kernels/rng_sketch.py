"""``sign_sketch`` and its adjoint: U Rᵀ/√m and Rᵀ s/√m with the ±1 matrix R
generated from counters inside the kernel — the Hopper kernels.

Replace ``repro.kernels.rng_sketch.rng_sketch_pallas`` and
``rng_sketch_adjoint_xla``.  Two bodies, chosen from the inputs alone
(:func:`choose_body`): every call runs ``csrc/rng_sketch_col.cu`` (``col``:
the hash's column half computed once, one launch per chunk of 8 rows of U,
the splits added in a cluster, the adjoint's rows split across warps); a
call with ``body="first"`` runs ``csrc/rng_sketch.cu`` (hash in
``csrc/rng_hash.cuh``) on the same inputs, to compare the two.  Each source
says what bounds it on the H100 and how its pass is laid out; the plans
(:func:`col_plan`, :func:`adjoint_plan`) are plain Python.  This module
checks the inputs, allocates the output with ``torch.empty`` (the first
body also its scratch) and launches on the current stream without
synchronising.  ``body_launches()`` tallies the launches by op and body.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .registry import count_launch

ROWS_PER_BLOCK = 128          # first body: rows of R per block (kRowsPerBlock)
COL_TILE = 256                # first body: columns staged per step (kColTile)
BLOCKS_PER_SM = 16
MAX_KC = 8                    # rows of U one pass accumulates (kMaxKC)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_SEED = (1 << 32) - 1
# the col body (csrc/rng_sketch_col.cu)
COL_WARPS = 8                 # warps of a sketch block
COL_RANKS = (8, 16)           # blocks of a cluster: the column ranges
COL_CHUNK = 32                # columns a warp stages at a time
COL_MIN_BLOCKS_PER_SM = 2     # RI grows only while the grid keeps this many
ADJ_WARPS = 16                # warps of an adjoint block
ADJ_ROW_TILE = 2048           # rows of R1 and s staged at a time
ADJ_SLICES = (1, 2, 4, 8, 16)
ADJ_COLS = (4, 2, 1)          # columns a lane, largest first
ADJ_MIN_WARPS_PER_SM = 16     # WR doubles until the grid has this many
BODIES = ("col", "first")
OPS = ("sign_sketch", "sign_sketch_adjoint")
_BODY_LAUNCHES = {op: {body: 0 for body in BODIES} for op in OPS}


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed <= MAX_SEED:
        raise ValueError(f"seed {seed} is not a uint32")
    return seed


def choose_body(body: Optional[str] = None) -> str:
    """The body a call runs: ``col`` for every call the wrappers accept
    (f32 or bf16 U, any K, n, m >= 1: nothing in the inputs keeps a call
    off it), ``first`` only when asked for by name."""
    if body not in (None,) + BODIES:
        raise ValueError(f"sign_sketch: body {body!r} not in {BODIES}")
    return body or "col"


def body_launches() -> Dict[str, Dict[str, int]]:
    """``{op: {"col": launches, "first": launches}}`` for ``sign_sketch``
    and ``sign_sketch_adjoint`` since the last reset."""
    return {op: dict(t) for op, t in _BODY_LAUNCHES.items()}


def reset_body_launches() -> None:
    for tally in _BODY_LAUNCHES.values():
        for body in tally:
            tally[body] = 0


def chunk_rows(K: int) -> int:
    """Rows of U a launch sums (KC): 1, 2, 4 or 8; K > 8 in chunks of 8."""
    return 1 if K <= 1 else 2 if K <= 2 else 4 if K <= 4 else MAX_KC


def grid(K: int, n: int, m: int, sm_count: int) -> Tuple[int, int, int]:
    """The first body's ``(n_splits, cols_per_split, rows per pass)``:
    enough (row tile, column range) blocks to fill the card even at K = 1."""
    m_tiles = -(-m // ROWS_PER_BLOCK)
    splits = max(1, min(-(-BLOCKS_PER_SM * sm_count // m_tiles),
                        -(-n // COL_TILE)))
    cols = -(-n // splits)
    return -(-n // cols), cols, chunk_rows(K)


class ColPlan(NamedTuple):
    """A ``sign_sketch_col`` call: ``launches`` chunks of ``kc`` rows of U,
    each a grid of ``blocks`` = ``row_tiles`` x ``ranks`` cluster ranks; a
    block owns ``rows`` = 32·``ri`` rows of R and rank ρ the columns
    [ρ·``cols_per_rank``, (ρ+1)·``cols_per_rank``) ∩ [0, n)."""
    kc: int
    ri: int
    rows: int
    row_tiles: int
    ranks: int
    blocks: int
    cols_per_rank: int
    launches: int


def col_row_choices(kc: int) -> Tuple[int, ...]:
    """The rows a lane (RI) the kernel is built for, at a chunk of kc rows
    of U (4 and 8 rows keep to 2: their accumulators fill the registers)."""
    return (1, 2, 4) if kc <= 2 else (1, 2)


@functools.lru_cache(maxsize=4096)
def col_plan(K: int, n: int, m: int, sms: int) -> ColPlan:
    """The col body's layout from the shapes: a lane owns the most rows of
    R (RI; each shared-memory broadcast then serves RI rows) that still
    leave every SM ``COL_MIN_BLOCKS_PER_SM`` blocks of 8 ranks; where one
    row a lane does not (the paths' m = 981, and m = 1 024), clusters of
    16 split the columns 16 ways."""
    kc = chunk_rows(K)
    want = COL_MIN_BLOCKS_PER_SM * sms
    ri = max((r for r in col_row_choices(kc)
              if -(-m // (32 * r)) * COL_RANKS[0] >= want), default=1)
    rows = 32 * ri
    tiles = -(-m // rows)
    ranks = COL_RANKS[tiles * COL_RANKS[0] < want]
    return ColPlan(kc, ri, rows, tiles, ranks, tiles * ranks, -(-n // ranks),
                   -(-K // kc))


def col_warp_columns(n: int, cols_per_rank: int, rank: int
                     ) -> List[List[Tuple[int, int]]]:
    """For each warp of a block of cluster rank ``rank``, the columns
    [lo, hi) it sums into one chunk sum, chunk by chunk: the rank's columns
    dealt evenly to the 8 warps in multiples of 4, then cut into chunks of
    32 (the kernel adds a warp's chunk sums in order, then the warps' sums
    in warp order, then the ranks' in rank order)."""
    c0 = rank * cols_per_rank
    c1 = min(c0 + cols_per_rank, n)
    per_warp = (-(-(c1 - c0) // COL_WARPS) + 3) & ~3
    out: List[List[Tuple[int, int]]] = []
    for warp in range(COL_WARPS):
        w0 = c0 + warp * per_warp
        w1 = min(w0 + per_warp, c1)
        out.append([(b, min(b + COL_CHUNK, w1))
                    for b in range(w0, w1, COL_CHUNK)])
    return out


class AdjPlan(NamedTuple):
    """A ``sign_sketch_adjoint_col`` launch: ``blocks`` blocks of
    ``cols_per_block`` columns (16 / ``wr`` groups of 32·``cj``; a lane owns
    ``cj`` columns) by ``wr`` row slices."""
    wr: int
    cj: int
    blocks: int
    cols_per_block: int


@functools.lru_cache(maxsize=4096)
def adjoint_plan(m: int, n: int, sms: int) -> AdjPlan:
    """The adjoint's layout from the shapes: a lane owns the most columns
    (CJ; each shared-memory broadcast then serves CJ columns) that still
    leave every SM two blocks of whole columns; where one column a lane
    does not fill the card, WR doubles from 1 while the grid has fewer than
    ``ADJ_MIN_WARPS_PER_SM`` warps an SM and every slice of the doubled
    split still gets 32 rows of m (WR = 16, CJ = 1 at the paths' n = 7 850;
    WR = 1, CJ = 4 at model widths)."""
    def blocks(wr, cj):
        return -(-n // (32 * cj * ADJ_WARPS // wr))
    cj = next((c for c in ADJ_COLS if blocks(1, c) >= 2 * sms), 1)
    wr = 1
    while (wr < ADJ_SLICES[-1]
           and blocks(wr, cj) * ADJ_WARPS < ADJ_MIN_WARPS_PER_SM * sms
           and 32 * 2 * wr <= m):
        wr *= 2
    return AdjPlan(wr, cj, blocks(wr, cj), 32 * cj * ADJ_WARPS // wr)


def adjoint_slice_rows(m: int, wr: int) -> List[List[Tuple[int, int]]]:
    """For each row slice, the rows [lo, hi) it sums, tile by tile: each
    2 048-row tile dealt evenly to the slices in multiples of 4 (a column's
    slice sums are then added in slice order)."""
    out: List[List[Tuple[int, int]]] = [[] for _ in range(wr)]
    for base in range(0, m, ADJ_ROW_TILE):
        h = min(m - base, ADJ_ROW_TILE)
        per = (-(-h // wr) + 3) & ~3
        for q in range(wr):
            lo, hi = base + q * per, base + min((q + 1) * per, h)
            if lo < hi:
                out[q].append((lo, hi))
    return out


@functools.lru_cache(maxsize=None)
def _launchers(device_index: int):
    """``(lib, col sketch, col adjoint, SMs)`` of a device, looked up
    once."""
    lib = _build.load_library()
    return (lib, lib.sign_sketch_col_launch, lib.sign_sketch_adjoint_col_launch,
            _build.sm_count(device_index))


def _launch(fn, args: tuple, dev: torch.device):
    # the current stream's handle, without building a torch.cuda.Stream
    # object on every call; the device guard only off the current device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def sign_sketch_cuda(updates: torch.Tensor, seed: int, m: int, *,
                     body: Optional[str] = None) -> torch.Tensor:
    """``updates (K, n)`` f32 or bf16, contiguous on a CUDA device, uint32
    ``seed``, ``m`` ≥ 1 → ``U Rᵀ/√m (K, m)`` f32, on the ``col`` body
    (``body="first"``: ``rng_sketch.cu``)."""
    if not updates.is_cuda:
        raise ValueError("sign_sketch_cuda needs CUDA tensors; got "
                         f"{updates.device}")
    if updates.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"sign_sketch_cuda: updates dtype {updates.dtype} "
                        f"not in {SUPPORTED_DTYPES}")
    if updates.dim() != 2 or not updates.is_contiguous():
        raise ValueError("sign_sketch_cuda: want contiguous updates (K, n), "
                         f"got shape {tuple(updates.shape)}")
    K, n = updates.shape
    if K < 1 or n < 1 or m < 1:
        raise ValueError(f"sign_sketch_cuda: K={K}, n={n}, m={m} must be "
                         ">= 1")
    seed = _check_seed(seed)
    body = choose_body(body)
    dev = updates.device
    lib, col_fn, _, sms = _launchers(dev.index)
    out = torch.empty((K, m), dtype=torch.float32, device=dev)
    bf16 = int(updates.dtype == torch.bfloat16)
    if body == "col":
        plan = col_plan(K, n, m, sms)
        fn, args = col_fn, (updates.data_ptr(), K, n, bf16, seed, m, plan.ri,
                            plan.ranks, plan.cols_per_rank, out.data_ptr())
    else:
        splits, cols, kc = grid(K, n, m, sms)
        partial = torch.empty((splits * kc * m,), dtype=torch.float32,
                              device=dev)
        fn, args = lib.sign_sketch_launch, (
            updates.data_ptr(), K, n, bf16, seed, m, partial.data_ptr(),
            partial.numel(), out.data_ptr(), splits, cols)
    _build.check(lib, _launch(fn, args, dev), "sign_sketch")
    count_launch("sign_sketch", "cuda")
    _BODY_LAUNCHES["sign_sketch"][body] += 1
    return out


def sign_sketch_adjoint_cuda(coords: torch.Tensor, seed: int, n: int, *,
                             body: Optional[str] = None) -> torch.Tensor:
    """``coords (m,)`` f32, contiguous on a CUDA device, uint32 ``seed``,
    ``n`` ≥ 1 → ``Rᵀ coords/√m (n,)`` f32, on the ``col`` body
    (``body="first"``: ``rng_sketch.cu``)."""
    if not coords.is_cuda:
        raise ValueError("sign_sketch_adjoint_cuda needs CUDA tensors; got "
                         f"{coords.device}")
    if coords.dtype != torch.float32:
        raise TypeError("sign_sketch_adjoint_cuda: coords must be float32, "
                        f"got {coords.dtype}")
    if coords.dim() != 1 or not coords.is_contiguous() or coords.numel() < 1:
        raise ValueError("sign_sketch_adjoint_cuda: want a contiguous "
                         f"non-empty (m,) vector, got {tuple(coords.shape)}")
    if n < 1:
        raise ValueError(f"sign_sketch_adjoint_cuda: n={n} must be >= 1")
    seed = _check_seed(seed)
    body = choose_body(body)
    dev = coords.device
    lib, _, adj_fn, sms = _launchers(dev.index)
    m = coords.numel()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if body == "col":
        plan = adjoint_plan(m, n, sms)
        fn, args = adj_fn, (coords.data_ptr(), m, seed, n, plan.wr, plan.cj,
                            out.data_ptr())
    else:
        fn, args = lib.sign_sketch_adjoint_launch, (
            coords.data_ptr(), m, seed, n, out.data_ptr())
    _build.check(lib, _launch(fn, args, dev), "sign_sketch_adjoint")
    count_launch("sign_sketch_adjoint", "cuda")
    _BODY_LAUNCHES["sign_sketch_adjoint"][body] += 1
    return out
