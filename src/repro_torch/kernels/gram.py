"""``gram``: G = U Uᵀ and c = U g in one pass over n, and ``gram_block``:
G_ab = U_a U_bᵀ and c_a = U_a g — the Hopper kernels.

``gram_cuda`` replaces ``repro.kernels.gram.gram_pallas``.  It has four
bodies, chosen from dtypes, shapes and pointers alone (:func:`_body`):

* ``f32`` (``csrc/gram_f32.cu``): every call with U and g both f32 — every
  launch of the paths, which flatten U to f32.  K <= 8 streams the rows
  through registers; K >= 9 runs 8 x 8 register tiles over a ``cp.async``
  ring, [U; g] in one slice up to K = 127 and one slice a pair of row blocks
  above (:func:`f32_slices`).  One launch a call: a slice whose columns one
  block owns writes G and c itself, else the blocks' partials are summed
  after one grid barrier of a cooperative launch (:func:`f32_call_plan`).
* ``mma`` (``csrc/gram_mma.cu``): U and g both bf16 with 1 <= K <= 127,
  n % 8 == 0 and 16-byte aligned pointers (:func:`_mma_eligible`), on the
  bf16 tensor cores.
* ``realign`` (``csrc/gram_realign.cu``): the other bf16 calls with
  1 <= K <= 127 (an odd n, n % 8 != 0, a pointer only 2-byte aligned), the
  same tensor-core loop (``csrc/gram_mma.cuh``) on tiles staged from the
  aligned-down 16-byte chunks of each row of [U; g] and shifted into place
  in shared memory (:func:`realign_shifts` and ``realign.realign_plan``
  mirror it), on the aligned body's grid, so bitwise equal to it wherever
  n % 8 == 0.  ``gram_cuda(..., body="realign")`` forces it on any bf16
  call with K <= 127, aligned rows too, so the card can time the
  structure's cost.
* ``cuda_core`` (``csrc/gram.cu``): the rest — mixed dtypes, and bf16 at
  K >= 128 — on the f32 CUDA cores, K up to 64 in one piece and above it
  one grid slice per pair (a, b >= a) of 64-row blocks, then a finish
  kernel.  ``gram_cuda(..., body="cuda_core")`` runs any call there, so
  the card can time it beside the other bodies.

No f32 operand is rounded to reach a tensor core.  Each source says what
bounds it on the H100 and how its deterministic reduction is laid out;
this module checks the inputs, allocates the outputs (and a scratch only
where a body needs one) with ``torch.empty``, and launches on the current
stream without synchronising.  ``body_launches()`` tallies the launches by
body, so a run can show which body its path took.

``gram_block_cuda`` replaces ``repro.kernels.gram.gram_block_pallas``.  It
has three bodies, chosen from the inputs alone (:func:`_block_body`): a
call with U_a, U_b and g all bf16, 1 <= Ka <= 64, 1 <= Kb <= 63, n % 8 ==
0, 16-byte aligned pointers and row strides that are multiples of 8 runs on
the bf16 tensor cores (``mma``, ``csrc/gram_block_mma.cu``); every call with
all three f32 — every launch of the robust path — on the f32 body of
``csrc/cross_f32.cu`` (``f32``: 8 x 8 register tiles over a ``cp.async``
ring, one launch a call; its planner is in ``cross.py``); the rest (mixed
dtypes, unaligned or odd-n bf16) on the cross-product body of
``csrc/cross.cuh`` (``cross``, ``csrc/gram_block.cu``), which
``gram_block_cuda(..., body="cross")`` also takes for any call, so the card
can time it beside the f32 body.  All take A = U_a and B = [U_b; g] by
pointer and row stride, so U_a and U_b may be row blocks of one matrix.
``block_body_launches()`` tallies its launches by body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import _build, cross
from .realign import realign_shift
from .registry import count_launch

MAX_K = 64                # rows of U in one piece, and in each row block above
COLS_GRANULE = 128        # a block's column range is a multiple of this
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MMA_MAX_K = 127           # the tensor-core body's K: [U; g] in 128 rows
MMA_WARPS = 8             # warps of a block of the tensor-core body
MMA_STAGE_COLS = 128      # columns of one staged tile of [U; g]
BLOCK_MMA_MAX_KA = 64     # gram_block's tensor-core body: U_a in 64 rows
BLOCK_MMA_MAX_KB = 63     # and [U_b; g] in 64
BODIES = ("mma", "realign", "f32", "cuda_core")
# the f32 body (csrc/gram_f32.cu); its planner below mirrors the source's
F32_STREAM_MAX_K = 8      # K <= 8: the register-only stream
F32_MAX_ROWS = 128        # staged rows of one side of a slice: K <= 127 whole
F32_THREADS = 256         # threads of a tile block, at most
F32_NARROW_THREADS = 192  # ... where one slice holds 10 tiles or more
F32_STAGES = 3            # the cp.async ring
F32_STAGE_BYTES = 32768   # one stage, at most
F32_GROUP = 4             # columns of a staged group: one float4 a row
# the largest K the f32 body takes: its nb(nb+1)/2 slices fit gridDim.y
# (65 535) at nb = 361 row blocks of 127
F32_MAX_K = 361 * 127
_BODY_LAUNCHES = {body: 0 for body in BODIES}
BLOCK_BODIES = ("mma", "f32", "cross")
_BLOCK_BODY_LAUNCHES = {body: 0 for body in BLOCK_BODIES}


def _mma_eligible(updates: torch.Tensor, grad: torch.Tensor) -> bool:
    """Whether a call takes the tensor-core body: U and g both bf16,
    1 <= K <= 127, n >= 1 with n % 8 == 0 and both ``data_ptr()`` 16-byte
    aligned (every row of the contiguous U then starts 16-byte aligned).
    Reads only dtypes, shapes and pointers."""
    K, n = updates.shape
    return (updates.dtype == torch.bfloat16 and grad.dtype == torch.bfloat16
            and 1 <= K <= MMA_MAX_K and n >= 1 and n % 8 == 0
            and updates.data_ptr() % 16 == 0 and grad.data_ptr() % 16 == 0)


def _realign_eligible(updates: torch.Tensor, grad: torch.Tensor) -> bool:
    """Whether the realigning tensor-core body can take a call: U and g
    both bf16, 1 <= K <= 127, n >= 1, any pointers (every ``data_ptr()`` of
    a bf16 tensor is at least 2-byte aligned)."""
    K, n = updates.shape
    return (updates.dtype == torch.bfloat16 and grad.dtype == torch.bfloat16
            and 1 <= K <= MMA_MAX_K and n >= 1)


def _body(updates: torch.Tensor, grad: torch.Tensor) -> str:
    """The body a call takes: ``mma`` where :func:`_mma_eligible` holds,
    ``realign`` for the other bf16 calls with 1 <= K <= 127, ``f32`` for U
    and g both f32, ``cuda_core`` for the rest (mixed dtypes, bf16
    K >= 128)."""
    if _mma_eligible(updates, grad):
        return "mma"
    if _realign_eligible(updates, grad):
        return "realign"
    if updates.dtype == torch.float32 and grad.dtype == torch.float32:
        return "f32"
    return "cuda_core"


def _f32_vec(updates: torch.Tensor, grad: torch.Tensor) -> bool:
    """Whether the f32 body reads 16 bytes a row at a time: every row of the
    contiguous U and g starts 16-byte aligned (n % 4 == 0, both
    ``data_ptr()`` % 16 == 0); else it reads 4 bytes at a time."""
    return (updates.shape[1] % F32_GROUP == 0
            and updates.data_ptr() % 16 == 0 and grad.data_ptr() % 16 == 0)


def body_launches() -> Dict[str, int]:
    """``{"mma": launches, "realign": launches, "f32": launches,
    "cuda_core": launches}`` since the last reset."""
    return dict(_BODY_LAUNCHES)


def reset_body_launches() -> None:
    for key in _BODY_LAUNCHES:
        _BODY_LAUNCHES[key] = 0


def mma_rows(K: int) -> int:
    """Rows Kp of the tensor-core body's [U; g], zero-padded to a multiple
    of 16 (its partial is Kp x Kp per block)."""
    return 16 * -(-(K + 1) // 16)


def mma_deal(K: int) -> List[List[Tuple[int, int]]]:
    """The (16 x 8) output tiles (i, j) of E Eᵀ, E = [U; g] in Kp rows, that
    each warp of a tensor-core block owns: the tiles with 8j + 7 >= 16i in
    row-major order, ceil(count / 8) consecutive ones a warp (as
    ``gram_mma_partial`` deals them)."""
    mt = mma_rows(K) // 16
    tiles = [(i, j) for i in range(mt) for j in range(2 * i, 2 * mt)]
    per_warp = -(-len(tiles) // MMA_WARPS)
    return [tiles[w * per_warp:(w + 1) * per_warp] for w in range(MMA_WARPS)]


def realign_shifts(updates_ptr: int, grad_ptr: int, K: int,
                   n: int) -> List[int]:
    """The shift of each row of [U; g] in the realigning body, as its
    threads find them: rows r < K at ``updates_ptr + 2·r·n`` (U contiguous),
    row K at ``grad_ptr`` (``realign.realign_shift`` of each)."""
    return ([realign_shift(updates_ptr + 2 * r * n) for r in range(K)]
            + [realign_shift(grad_ptr)])


def _block_mma_eligible(ua: torch.Tensor, ub: torch.Tensor,
                        grad: torch.Tensor) -> bool:
    """Whether a ``gram_block`` call takes the tensor-core body: U_a, U_b and
    g all bf16, 1 <= Ka <= 64, 1 <= Kb <= 63, n >= 1 with n % 8 == 0, every
    ``data_ptr()`` 16-byte aligned and both row strides multiples of 8
    entries (every row then starts 16-byte aligned).  Reads only dtypes,
    shapes, strides and pointers."""
    (Ka, n), Kb = ua.shape, ub.shape[0]
    return (all(t.dtype == torch.bfloat16 for t in (ua, ub, grad))
            and 1 <= Ka <= BLOCK_MMA_MAX_KA and 1 <= Kb <= BLOCK_MMA_MAX_KB
            and n >= 1 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (ua, ub, grad))
            and ua.stride(0) % 8 == 0 and ub.stride(0) % 8 == 0)


def _block_body(ua: torch.Tensor, ub: torch.Tensor,
                grad: torch.Tensor) -> str:
    """The body a ``gram_block`` call takes: ``mma`` where
    :func:`_block_mma_eligible` holds, ``f32`` for U_a, U_b and g all f32,
    ``cross`` for the rest.  Reads only dtypes, shapes, strides and
    pointers."""
    if _block_mma_eligible(ua, ub, grad):
        return "mma"
    if ua.dtype == ub.dtype == grad.dtype == torch.float32:
        return "f32"
    return "cross"


def block_body_launches() -> Dict[str, int]:
    """``{"mma": launches, "f32": launches, "cross": launches}`` of
    ``gram_block`` since the last reset."""
    return dict(_BLOCK_BODY_LAUNCHES)


def reset_block_body_launches() -> None:
    for key in _BLOCK_BODY_LAUNCHES:
        _BLOCK_BODY_LAUNCHES[key] = 0


def block_mma_rows(Ka: int, Kb: int) -> Tuple[int, int]:
    """Staged rows ``(RA, RB)`` of gram_block's tensor-core body: U_a
    zero-padded to a multiple of 16, [U_b; g] to a multiple of 8 (its
    partial is RA x RB per block)."""
    return 16 * -(-Ka // 16), 8 * -(-(Kb + 1) // 8)


def block_mma_deal(Ka: int, Kb: int) -> List[List[Tuple[int, int]]]:
    """The (16 x 8) output tiles (i, j) of U_a [U_b; g]ᵀ that each warp of
    a tensor-core block owns: all MA x NB tiles in row-major order,
    ceil(MA·NB / 8) consecutive ones a warp (as ``gram_block_mma_partial``
    deals them)."""
    ra, rb = block_mma_rows(Ka, Kb)
    tiles = [(i, j) for i in range(ra // 16) for j in range(rb // 8)]
    per_warp = -(-len(tiles) // MMA_WARPS)
    return [tiles[w * per_warp:(w + 1) * per_warp] for w in range(MMA_WARPS)]


def _check(updates: torch.Tensor, grad: torch.Tensor) -> None:
    if not (updates.is_cuda and grad.is_cuda):
        raise ValueError("gram_cuda needs CUDA tensors; got "
                         f"{updates.device} and {grad.device}")
    if updates.device != grad.device:
        raise ValueError(f"updates on {updates.device}, grad on {grad.device}")
    for name, t in (("updates", updates), ("grad", grad)):
        if t.dtype not in SUPPORTED_DTYPES:
            raise TypeError(f"gram_cuda: {name} dtype {t.dtype} not in "
                            f"{SUPPORTED_DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"gram_cuda: {name} must be contiguous")
    if updates.dim() != 2 or grad.dim() != 1:
        raise ValueError(f"gram_cuda: want updates (K, n) and grad (n,); got "
                         f"{tuple(updates.shape)} and {tuple(grad.shape)}")
    K, n = updates.shape
    if grad.shape[0] != n:
        raise ValueError(f"gram_cuda: updates have n={n}, grad {grad.shape[0]}")
    if K < 1:
        raise ValueError(f"gram_cuda: K={K} must be >= 1")
    if n < 1:
        raise ValueError("gram_cuda: n must be >= 1")


def grid(n: int, sm_count: int, blocks_per_sm: int,
         slices: int = 1) -> Tuple[int, int]:
    """``(num_blocks, cols_per_block)`` of each of ``slices`` grid slices:
    one resident wave of blocks in all (at most ``blocks_per_sm`` on each
    SM), each over a contiguous range of whole granules."""
    granules = -(-n // COLS_GRANULE)
    blocks = max(1, min(blocks_per_sm * sm_count // slices, granules))
    cols = -(-granules // blocks) * COLS_GRANULE
    return -(-n // cols), cols


def row_slices(K: int) -> int:
    """Grid slices: one per pair (a, b >= a) of the nb row blocks of U of up
    to ``MAX_K`` rows, nb(nb + 1)/2 (1 up to ``MAX_K``)."""
    nb = -(-K // MAX_K)
    return nb * (nb + 1) // 2


def scratch_rows(K: int) -> int:
    """Rows of the widest slice's partial: the extended matrix [U; g] padded
    to a multiple of 4 up to ``MAX_K``, else two row blocks (a cross slice,
    U_a against U_b)."""
    return (K + 1 + 3) // 4 * 4 if K <= MAX_K else 2 * MAX_K


# ------------------------------------------------ the f32 body's planner

def _round8(x: int) -> int:
    return -(-x // 8) * 8


def f32_row_blocks(K: int) -> List[Tuple[int, int]]:
    """``(first row, rows)`` of each row block of U in the f32 tile body:
    one block up to K = 127, else nb = ceil(K / 127) blocks, block a
    starting at a·K // nb (each floor or ceil(K / nb) <= 127 rows)."""
    nb = 1 if K <= F32_MAX_ROWS - 1 else -(-K // (F32_MAX_ROWS - 1))
    starts = [a * K // nb for a in range(nb + 1)]
    return [(starts[a], starts[a + 1] - starts[a]) for a in range(nb)]


def f32_budget(K: int) -> int:
    """Threads a tile block may use (``budget_of`` in the source): 192 for
    one slice of 10 tiles or more (K >= 24: 168 registers a thread), else
    256 (128 registers; the slices past K = 127 hold up to 256 tiles)."""
    one = len(f32_row_blocks(K)) == 1
    return (F32_NARROW_THREADS if one and _round8(K + 1) // 8 >= 4
            else F32_THREADS)


class F32Slice(NamedTuple):
    """One slice of the f32 tile body: side A is U_a's rows; side B is
    [U_a; g] (a diagonal slice: the upper triangle of its product) or U_b's
    rows (a cross slice: the rectangle).  Staged rows [0, rows_a) are side
    A, [rows_a, rows) side B of a cross slice, each padded with zeros to a
    multiple of 8."""
    a0: int
    Ka: int
    b0: int
    Kb: int
    diag: bool
    rows_a: int
    rows: int
    tb: int        # tile columns (a diagonal slice: T = rows / 8)
    tiles: int     # 8 x 8 tiles
    phases: int    # column phases: the thread budget // tiles

    @classmethod
    def of(cls, a0: int, Ka: int, b0: int, Kb: int,
           budget: int = F32_THREADS) -> "F32Slice":
        diag = a0 == b0
        if diag:
            rows_a = rows = _round8(Ka + 1)
            tb = rows // 8
            tiles = tb * (tb + 1) // 2
        else:
            rows_a = _round8(Ka)
            rows = rows_a + _round8(Kb)
            tb = (rows - rows_a) // 8
            tiles = rows_a // 8 * tb
        return cls(a0, Ka, b0, Kb, diag, rows_a, rows, tb, tiles,
                   budget // tiles)

    def deal(self) -> List[Tuple[int, int]]:
        """Tile (i, j) of tile index q = thread % tiles: the upper triangle
        row-major, or the rectangle row-major."""
        if self.diag:
            return [(i, j) for i in range(self.tb) for j in range(i, self.tb)]
        return [(i, j) for i in range(self.rows_a // 8)
                for j in range(self.tb)]

    def target(self, x: int, y: int):
        """Where entry (x, y) of the product goes (x: side A's staged row,
        y: side B's, from side B's first row): ``("G", row, col)`` (written
        with its mirror), ``("c", row)`` or None (padding, or below a
        diagonal slice's diagonal)."""
        if x >= self.Ka:
            return None
        if self.diag:
            if y < self.Ka and x <= y:
                return ("G", self.a0 + x, self.a0 + y)
            return ("c", self.a0 + x) if y == self.Ka else None
        return ("G", self.a0 + x, self.b0 + y) if y < self.Kb else None


def f32_slices(K: int) -> List[F32Slice]:
    """The tile body's slices (blockIdx.y), pairs (a, b >= a) of row blocks
    in row-major order."""
    blocks = f32_row_blocks(K)
    budget = f32_budget(K)
    return [F32Slice.of(*blocks[a], *blocks[b], budget)
            for a in range(len(blocks)) for b in range(a, len(blocks))]


def f32_stream_entries(K: int) -> List[Tuple]:
    """The stream body's K(K+1)/2 + K sums in register order: ``("G", i,
    j)`` for j >= i row-major, then ``("c", i)``."""
    return ([("G", i, j) for i in range(K) for j in range(i, K)]
            + [("c", i) for i in range(K)])


def f32_tile_plan(K: int) -> Dict[str, int]:
    """What a tile launch is, from K alone, as ``gram_f32.cu``'s
    ``tile_plan``: the widest slices it can hold (the tallest row block on
    every side) size a stage and the shared memory.  ``threads`` a block,
    ``groups`` of 4 columns a stage, ``slots`` (16 bytes) a staged group,
    ``max_tiles`` (a partial is 64 floats a tile of the widest slice),
    ``smem_bytes`` (ring, phase sums or the product, the largest)."""
    nb = len(f32_row_blocks(K))
    budget = f32_budget(K)
    hi = -(-K // nb)
    d_rows = _round8(hi + 1)
    d_tiles = (d_rows // 8) * (d_rows // 8 + 1) // 2
    rows, tiles, phases = d_rows, d_tiles, budget // d_tiles
    out = d_rows * (d_rows + 1)
    if nb > 1:
        ct = _round8(hi) // 8
        rows, tiles = max(rows, 16 * ct), max(tiles, ct * ct)
        phases = min(phases, budget // (ct * ct))
        out = max(out, 8 * ct * (8 * ct + 1))
        threads = budget
    else:
        threads = -(-d_tiles * phases // 32) * 32
    slots = rows + rows // 8
    groups = phases * max(1, F32_STAGE_BYTES // (phases * slots * 16))
    ring = F32_STAGES * groups * slots * 16
    return {"nb": nb, "budget": budget, "threads": threads, "groups": groups,
            "slots": slots, "max_tiles": tiles,
            "smem_bytes": max(ring, threads * 64 * 4, out * 4)}


def f32_num_slices(K: int) -> int:
    """Grid slices of the f32 body: 1 for K <= 127 (and the stream)."""
    nb = len(f32_row_blocks(K))
    return nb * (nb + 1) // 2


def f32_partial_floats(K: int) -> int:
    """Floats of one block's partial: the stream's K(K+1)/2 + K sums, or 64
    a tile of the widest slice."""
    if K <= F32_STREAM_MAX_K:
        return K * (K + 1) // 2 + K
    return 64 * f32_tile_plan(K)["max_tiles"]


def f32_scratch_floats(K: int, num_blocks: int) -> int:
    """The f32 body's scratch: none where one block owns a slice's columns
    (it writes G and c itself), else every block's partial."""
    if num_blocks == 1:
        return 0
    return f32_num_slices(K) * num_blocks * f32_partial_floats(K)


@functools.lru_cache(maxsize=None)
def _resident(config_fn: str, dims: Tuple[int, ...],
              device_index: int) -> Tuple[int, int]:
    """``(blocks resident per SM, dynamic shared memory bytes per block)``
    that the library's ``config_fn`` reports for a partial kernel."""
    lib = _build.load_library()
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = getattr(lib, config_fn)(*dims, ctypes.byref(blocks),
                                     ctypes.byref(smem))
    _build.check(lib, rc, f"{config_fn} occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"{config_fn}: the partial kernel cannot be "
                           f"resident for {dims}")
    return blocks.value, smem.value


def launch_config(K: int, u_bf16: bool, g_bf16: bool,
                  device_index: int) -> Tuple[int, int]:
    """:func:`_resident` of the gram.cu partial kernel the launch picks for
    this K and these dtypes."""
    return _resident("gram_launch_config", (K, int(u_bf16), int(g_bf16)),
                     device_index)


def mma_launch_config(K: int, device_index: int) -> Tuple[int, int]:
    """:func:`_resident` of gram's tensor-core partial kernel for this K
    (its grid is the realigning instance's too)."""
    return _resident("gram_mma_launch_config", (K,), device_index)


def realign_launch_config(K: int, device_index: int) -> Tuple[int, int]:
    """:func:`_resident` of the realigning partial kernel for this K: built
    for the aligned instance's residency, which the card checks it has."""
    return _resident("gram_realign_launch_config", (K,), device_index)


def block_mma_launch_config(Ka: int, Kb: int,
                            device_index: int) -> Tuple[int, int]:
    """:func:`_resident` of gram_block's tensor-core partial kernel for these
    Ka, Kb."""
    return _resident("gram_block_mma_launch_config", (Ka, Kb), device_index)


@functools.lru_cache(maxsize=None)
def f32_launch_config(K: int, vec: bool, device_index: int
                      ) -> Tuple[int, int, int]:
    """``(blocks resident per SM, dynamic shared memory bytes, threads a
    block)`` of the f32 body's kernel for this K (``vec``: 16-byte rows)."""
    lib = _build.load_library()
    blocks, smem, threads = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.gram_f32_launch_config(K, int(vec), ctypes.byref(blocks),
                                        ctypes.byref(smem),
                                        ctypes.byref(threads))
    _build.check(lib, rc, "gram_f32_launch_config occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"gram_f32: the kernel cannot be resident at K={K}")
    return blocks.value, smem.value, threads.value


@functools.lru_cache(maxsize=4096)
def f32_call_plan(K: int, n: int, vec: bool,
                  device_index: int) -> Tuple[int, int, int]:
    """``(num_blocks, cols_per_block, scratch floats)`` of an f32 call: the
    grid is one resident wave (``grid`` over the slices), so a split may
    take one cooperative launch; the scratch is 0 where one block owns a
    slice's columns."""
    per_sm = f32_launch_config(K, vec, device_index)[0]
    num_blocks, cols = grid(n, _build.sm_count(device_index), per_sm,
                            f32_num_slices(K))
    return num_blocks, cols, f32_scratch_floats(K, num_blocks)


@functools.lru_cache(maxsize=None)
def _launchers(device_index: int):
    """``(lib, gram_f32_launch)`` of a device, looked up once."""
    lib = _build.load_library()
    return lib, lib.gram_f32_launch


def _launch_f32(updates: torch.Tensor, grad: torch.Tensor, G: torch.Tensor,
                c: torch.Tensor) -> None:
    K, n = updates.shape
    dev = updates.device
    vec = _f32_vec(updates, grad)
    num_blocks, cols, floats = f32_call_plan(K, n, vec, dev.index)
    partial = (torch.empty((floats,), dtype=torch.float32, device=dev)
               if floats else None)
    lib, fn = _launchers(dev.index)
    args = (updates.data_ptr(), grad.data_ptr(),
            partial.data_ptr() if floats else None, floats, G.data_ptr(),
            c.data_ptr(), K, n, int(vec), num_blocks, cols,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    _build.check(lib, rc, "gram_f32")


def gram_cuda(updates: torch.Tensor, grad: torch.Tensor, *,
              body: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``updates (K, n)``, ``grad (n,)`` (f32 or bf16, contiguous, on one
    CUDA device) → ``(G (K, K) f32, c (K,) f32)``, on the body
    :func:`_body` picks; ``body=`` forces one (``"cuda_core"`` takes any
    call; ``"f32"`` wants U and g f32, ``"mma"`` an eligible call,
    ``"realign"`` bf16 U and g with K <= 127)."""
    _check(updates, grad)
    if body not in (None,) + BODIES:
        raise ValueError(f"gram_cuda: body {body!r} not in {BODIES}")
    took = _body(updates, grad)
    if body == "mma" and took != "mma":
        raise ValueError("gram_cuda: the mma body takes bf16 U and g with "
                         f"1 <= K <= {MMA_MAX_K}, n % 8 == 0 and 16-byte "
                         "aligned pointers")
    if body == "realign" and not _realign_eligible(updates, grad):
        raise ValueError("gram_cuda: the realign body takes bf16 U and g "
                         f"with 1 <= K <= {MMA_MAX_K}")
    if body == "f32" and not (updates.dtype == grad.dtype == torch.float32):
        raise ValueError("gram_cuda: the f32 body takes f32 U and g")
    took = body or took
    K, n = updates.shape
    if took == "f32" and K > F32_MAX_K:
        raise ValueError(f"gram_cuda: the f32 body takes K <= {F32_MAX_K}, "
                         f"got {K}")
    dev = updates.device
    out = torch.empty((K * K + K,), dtype=torch.float32, device=dev)
    G, c = out[:K * K].view(K, K), out[K * K:]
    if took == "f32":
        _launch_f32(updates, grad, G, c)
    else:
        _launch_two_pass(updates, grad, G, c, took)
    count_launch("gram", "cuda")
    _BODY_LAUNCHES[took] += 1
    return G, c


def _launch_two_pass(updates: torch.Tensor, grad: torch.Tensor,
                     G: torch.Tensor, c: torch.Tensor, body: str) -> None:
    """gram_mma.cu, gram_realign.cu or gram.cu: a partial kernel over one
    wave of blocks, then a finish kernel over their partials.  Both
    tensor-core instances take the aligned one's grid."""
    K, n = updates.shape
    dev = updates.device
    u_bf16 = updates.dtype == torch.bfloat16
    g_bf16 = grad.dtype == torch.bfloat16
    tc = body in ("mma", "realign")
    if tc:
        per_sm, _ = mma_launch_config(K, dev.index)
        slices, R = 1, mma_rows(K)
    else:
        per_sm, _ = launch_config(K, u_bf16, g_bf16, dev.index)
        slices, R = row_slices(K), scratch_rows(K)
    num_blocks, cols = grid(n, _build.sm_count(dev.index), per_sm, slices)
    partial = torch.empty((slices * num_blocks * R * R,), dtype=torch.float32,
                          device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if tc:
            launch = (lib.gram_mma_launch if body == "mma"
                      else lib.gram_realign_launch)
            rc = launch(
                updates.data_ptr(), grad.data_ptr(), partial.data_ptr(),
                partial.numel(), G.data_ptr(), c.data_ptr(), K, n,
                num_blocks, cols, stream)
        else:
            rc = lib.gram_launch(
                updates.data_ptr(), grad.data_ptr(), partial.data_ptr(),
                partial.numel(), G.data_ptr(), c.data_ptr(), K, n,
                int(u_bf16), int(g_bf16), num_blocks, cols, stream)
    _build.check(lib, rc, f"gram ({body})")


def gram_block_cuda(ua: torch.Tensor, ub: torch.Tensor, grad: torch.Tensor,
                    *, body: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ua (Ka, n)``, ``ub (Kb, n)`` (any row stride, unit-strided columns)
    and ``grad (n,)``, f32 or bf16 each, on one CUDA device →
    ``(G_ab (Ka, Kb), c_a (Ka,))`` f32, on the body :func:`_block_body`
    picks; ``body=`` forces one (``"cross"`` takes any call; ``"f32"``
    wants all three f32, ``"mma"`` an eligible call)."""
    dev = ua.device
    lda = cross.row_stride("gram_block_cuda", "ua", ua, dev)
    ldb = cross.row_stride("gram_block_cuda", "ub", ub, dev)
    cross.vector_check("gram_block_cuda", "grad", grad, dev)
    (Ka, n), (Kb, nb) = ua.shape, ub.shape
    if nb != n or grad.shape[0] != n:
        raise ValueError(f"gram_block_cuda: operands disagree on n: {n}, {nb} "
                         f"and {grad.shape[0]}")
    if Ka < 1 or Kb < 1:
        raise ValueError(f"gram_block_cuda: Ka={Ka} and Kb={Kb} must be >= 1")
    if body not in (None,) + BLOCK_BODIES:
        raise ValueError(f"gram_block_cuda: body {body!r} not in "
                         f"{BLOCK_BODIES}")
    took = _block_body(ua, ub, grad)
    if body == "mma" and took != "mma":
        raise ValueError("gram_block_cuda: the mma body takes bf16 U_a, U_b "
                         f"and g with Ka <= {BLOCK_MMA_MAX_KA}, Kb <= "
                         f"{BLOCK_MMA_MAX_KB}, n % 8 == 0 and aligned rows")
    if body == "f32" and took != "f32":
        raise ValueError("gram_block_cuda: the f32 body takes f32 U_a, U_b "
                         "and g")
    took = body or took
    out = torch.empty((Ka * Kb + Ka,), dtype=torch.float32, device=dev)
    G, c = out[:Ka * Kb].view(Ka, Kb), out[Ka * Kb:]
    if n == 0:
        out.zero_()
        return G, c
    if took == "f32":
        cross.launch_f32("gram_block", ua, Ka, lda, ub, Kb, ldb, grad, 1, 0,
                         False, n, G, Kb, c, 1, False)
    else:
        lib = _build.load_library()
        if took == "mma":
            per_sm, _ = block_mma_launch_config(Ka, Kb, dev.index)
            num_blocks, cols = grid(n, _build.sm_count(dev.index), per_sm)
            ra, rb = block_mma_rows(Ka, Kb)
            partial = torch.empty((num_blocks * ra * rb,),
                                  dtype=torch.float32, device=dev)
            with torch.cuda.device(dev):
                rc = lib.gram_block_mma_launch(
                    ua.data_ptr(), lda, Ka, ub.data_ptr(), ldb, Kb,
                    grad.data_ptr(), n, partial.data_ptr(), partial.numel(),
                    num_blocks, cols, G.data_ptr(), c.data_ptr(),
                    cross.stream_of(dev))
        else:
            partial, num_blocks, cols = cross.scratch(
                "gram_block_launch_config", (Ka, Kb), n, dev)
            bf16 = torch.bfloat16
            with torch.cuda.device(dev):
                rc = lib.gram_block_launch(
                    ua.data_ptr(), lda, int(ua.dtype == bf16), Ka,
                    ub.data_ptr(), ldb, int(ub.dtype == bf16), Kb,
                    grad.data_ptr(), int(grad.dtype == bf16), n,
                    partial.data_ptr(), partial.numel(), num_blocks, cols,
                    G.data_ptr(), c.data_ptr(), cross.stream_of(dev))
        _build.check(lib, rc, "gram_block")
    count_launch("gram_block", "cuda")
    _BLOCK_BODY_LAUNCHES[took] += 1
    return G, c
