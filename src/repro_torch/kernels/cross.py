"""Launch plumbing shared by the cross-product kernels — ``stream_stats``,
``gram_block`` and ``sketch`` — and the planner of their f32 body.

Each of them computes a product A Bᵀ of row sets over n columns, A one row
source and B the rows of B1 followed by those of B2.  Two device bodies
serve it on the f32 CUDA cores:

* ``csrc/cross.cuh`` (every body's first): a grid of (A row block, B row
  block) slices times a split of the columns, then a finish pass that sums
  the per-block partials in order.  ``sketch`` takes it for mixed calls
  and bf16 K > 64, ``stream_stats`` and ``gram_block`` for mixed or
  unaligned bf16 calls, each also when forced (``body="cross"``).
* ``csrc/cross_f32.cu``: every ``gram_block``, ``stream_stats`` and
  ``sketch`` call whose row sources are all f32 (``sketch``: A = U against
  B1 = R, no B2).  8 x 8 register tiles over a ``cp.async``
  ring sized to the block's column range, one launch a call (a cooperative
  launch with one grid barrier where a slice's columns are split).  Its
  planner below (``F32Cuts``, ``F32Slice``, :func:`f32_plan`,
  :func:`f32_level`, :func:`f32_call_plan`) mirrors the source, so the CPU
  tests hold the slices, the tile deal, each entry's target, the grid and
  the scratch.

This module checks a row-source tensor (its row stride goes to the kernel,
so a strided (P, width) view of a stacked leaf is taken as it lies), asks
the library for a kernel's occupancy and slice count, and sizes the grid and
the partial scratch.  Each kernel's own module (``stream.py``, ``gram.py``,
``sketch.py``) allocates its outputs, launches and counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import torch

from . import _build

GRANULE = 256                 # a block's column range is a multiple of this
PARTIAL_FLOATS = 64 * 64      # one block's partial: 64-row blocks of A and B
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def row_stride(op: str, name: str, t: torch.Tensor,
               device: torch.device) -> int:
    """The row stride (elements) of a 2-D row-source tensor on ``device``
    with unit-strided columns; raises on anything the kernel cannot read."""
    if not t.is_cuda:
        raise ValueError(f"{op} needs CUDA tensors; {name} is on {t.device}")
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if t.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"{op}: {name} dtype {t.dtype} not in "
                        f"{SUPPORTED_DTYPES}")
    if t.dim() != 2:
        raise ValueError(f"{op}: {name} must be 2-D, got shape "
                         f"{tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{op}: {name}'s columns must be unit-strided "
                         f"(strides {t.stride()})")
    return int(t.stride(0))


def vector_check(op: str, name: str, t: torch.Tensor,
                 device: torch.device) -> None:
    """Raises unless ``t`` is a unit-strided 1-D f32 or bf16 vector on
    ``device`` (the B2 row of gram_block: g)."""
    if not t.is_cuda:
        raise ValueError(f"{op} needs CUDA tensors; {name} is on {t.device}")
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if t.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"{op}: {name} dtype {t.dtype} not in "
                        f"{SUPPORTED_DTYPES}")
    if t.dim() != 1:
        raise ValueError(f"{op}: {name} must be 1-D, got shape "
                         f"{tuple(t.shape)}")
    if t.shape[0] > 1 and t.stride(0) != 1:
        raise ValueError(f"{op}: {name} must be unit-strided (stride "
                         f"{t.stride(0)})")


def grid(n: int, sm_count: int, blocks_per_sm: int,
         slices: int) -> Tuple[int, int]:
    """``(num_blocks, cols_per_block)`` of each slice: one resident wave of
    blocks over all slices, each over a contiguous range of whole granules."""
    granules = -(-n // GRANULE)
    blocks = max(1, min(blocks_per_sm * sm_count // slices, granules))
    cols = -(-granules // blocks) * GRANULE
    return -(-n // cols), cols


@functools.lru_cache(maxsize=None)
def launch_config(config_fn: str, dims: Tuple[int, ...],
                  device_index: int) -> Tuple[int, int]:
    """``(blocks resident per SM, slices)`` of a kernel's partial pass for
    its row counts ``dims``."""
    lib = _build.load_library()
    blocks, slices = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        rc = getattr(lib, config_fn)(*dims, ctypes.byref(blocks),
                                     ctypes.byref(slices))
    _build.check(lib, rc, f"{config_fn} occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"{config_fn}: the partial kernel cannot be "
                           f"resident for rows {dims}")
    return blocks.value, slices.value


def scratch(config_fn: str, dims: Tuple[int, ...], n: int,
            device: torch.device) -> Tuple[torch.Tensor, int, int]:
    """``(partial, num_blocks, cols_per_block)`` for one launch over n
    columns: the grid and an uninitialised f32 scratch of one 64 x 64
    partial per (slice, column block)."""
    per_sm, slices = launch_config(config_fn, dims, device.index)
    num_blocks, cols = grid(n, _build.sm_count(device.index), per_sm, slices)
    partial = torch.empty((slices * num_blocks * PARTIAL_FLOATS,),
                          dtype=torch.float32, device=device)
    return partial, num_blocks, cols


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------ the f32 body's planner
# (csrc/cross_f32.cu; every function here mirrors the source's)

F32_THREADS = 256         # a block's threads, at most
F32_NARROW_THREADS = 192  # ... where the widest slice holds 10-192 tiles
F32_SIDE_TILES = 16       # 8-row tiles of one side of a slice, at most
F32_STAGES = 3            # the cp.async ring, at most
F32_STAGE_BYTES = 32768   # one stage, at most ...
F32_LINE_GROUPS = 16      # ... or 16 groups (256 bytes a row) in a ring of 2
F32_GROUP = 4             # columns of a staged group: one float4 a row
F32_GRANULE = 128         # a block's column range is a multiple of this
F32_MAX_SLICES = 65535    # gridDim.y


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class F32Cuts(NamedTuple):
    """A's 8-row tiles cut into ``na`` balanced groups (group a from tile
    a·ta // na), B's index rows ([B1; B2], B2 right after B1) into ``nb``;
    under ``sym`` B's first ``ta`` tiles are cut as A's and the other
    tb - ta into ``nb2`` groups.  At level k each side has its base count
    (a group at most 16 tiles; under sym B2's at most 8) times k groups, at
    most one tile each."""
    ma: int
    m1: int
    mb: int
    sym: bool
    ta: int
    tb: int
    na: int
    nb: int
    nb2: int

    @classmethod
    def of(cls, ma: int, m1: int, m2: int, sym: bool,
           level: int = 1) -> "F32Cuts":
        ta, tb = _cdiv(ma, 8), _cdiv(m1 + m2, 8)
        na = min(ta, _cdiv(ta, F32_SIDE_TILES) * level)
        if sym:
            rest = tb - ta
            nb2 = (min(rest, 2 * _cdiv(rest, F32_SIDE_TILES) * level) if rest
                   else 0)
            nb = na + nb2
        else:
            nb2, nb = 0, min(tb, _cdiv(tb, F32_SIDE_TILES) * level)
        return cls(ma, m1, m1 + m2, bool(sym), ta, tb, na, nb, nb2)

    def a_tile(self, a: int) -> int:
        return a * self.ta // self.na

    def b_tile(self, b: int) -> int:
        if not self.sym:
            return b * self.tb // self.nb
        if b <= self.na:
            return self.a_tile(b)
        return self.ta + (b - self.na) * (self.tb - self.ta) // self.nb2

    def slices(self) -> int:
        if not self.sym:
            return self.na * self.nb
        return self.na * (self.na + 1) // 2 + self.na * self.nb2

    def pairs(self) -> List[Tuple[int, int]]:
        """(a, b) of each slice, in slice order: row-major, and under sym
        row a holds b = a .. na - 1 (B1's groups on or above the diagonal),
        then B2's groups."""
        if not self.sym:
            return [(a, b) for a in range(self.na) for b in range(self.nb)]
        return [(a, b) for a in range(self.na)
                for b in list(range(a, self.na))
                + list(range(self.na, self.nb))]

    def saturated(self) -> bool:
        """Every group is one tile: a higher level cuts nothing more."""
        return self.na == self.ta and (self.nb2 == self.tb - self.ta
                                       if self.sym else self.nb == self.tb)


class F32Slice(NamedTuple):
    """One slice: A rows [a0, a0 + ka) against B index rows [b0, b0 + kb).
    Staged rows [0, rows_a) are A's, then B's; a diagonal slice (``shared``:
    sym, a = b) stages B's alone and reads A's tiles from its first rows."""
    a0: int
    ka: int
    b0: int
    kb: int
    ta: int
    tb: int
    shared: bool
    rows_a: int
    rows: int
    tiles: int

    @classmethod
    def of(cls, cuts: F32Cuts, a: int, b: int) -> "F32Slice":
        t0, t1 = cuts.a_tile(a), cuts.a_tile(a + 1)
        u0, u1 = cuts.b_tile(b), cuts.b_tile(b + 1)
        shared = cuts.sym and a == b
        ta, tb = t1 - t0, u1 - u0
        rows_a = 0 if shared else 8 * ta
        return cls(8 * t0, min(cuts.ma, 8 * t1) - 8 * t0, 8 * u0,
                   min(cuts.mb, 8 * u1) - 8 * u0, ta, tb, shared, rows_a,
                   rows_a + 8 * tb,
                   ta * (ta + 1) // 2 if shared else ta * tb)

    def deal(self) -> List[Tuple[int, int]]:
        """Tile (i, j) of tile index q = thread % tiles: the upper triangle
        (i <= j) of a diagonal slice, else the rectangle, row-major."""
        if self.shared:
            return [(i, j) for i in range(self.ta) for j in range(i, self.ta)]
        return [(i, j) for i in range(self.ta) for j in range(self.tb)]

    def entry(self, q: int, e: int) -> Tuple[int, int]:
        """``(x, y)`` of entry e (of 64) of tile q: x A's row from a0, y
        B's from b0."""
        i, j = self.deal()[q]
        return 8 * i + e // 8, 8 * j + e % 8

    def row(self, x: int, m1: int):
        """What staged row x holds: ``("a", row)``, ``("b1", row)``,
        ``("b2", row)`` or None (padding)."""
        if x < self.rows_a:
            return ("a", self.a0 + x) if x < self.ka else None
        y = x - self.rows_a
        if y >= self.kb:
            return None
        Y = self.b0 + y
        return ("b1", Y) if Y < m1 else ("b2", Y - m1)

    def target(self, x: int, y: int, m1: int, sym: bool):
        """Where entry (x, y) goes (x: A's row from a0, y: B's from b0):
        ``("out1", X, Y, mirrored)``, ``("out2", X, Y - m1)`` or None
        (padding, or under sym below the diagonal)."""
        if x >= self.ka or y >= self.kb:
            return None
        X, Y = self.a0 + x, self.b0 + y
        if Y < m1:
            if sym and Y < X:
                return None
            return ("out1", X, Y, sym and X != Y)
        return ("out2", X, Y - m1)


def f32_slices(cuts: F32Cuts) -> List[F32Slice]:
    return [F32Slice.of(cuts, a, b) for a, b in cuts.pairs()]


def f32_tile_counts(cuts: F32Cuts) -> List[int]:
    """The tile counts a slice can have, as the source's ``tile_counts``:
    balanced groups hold the floor or the ceiling of T / n tiles."""
    a_s = (cuts.ta // cuts.na, _cdiv(cuts.ta, cuts.na))
    if not cuts.sym:
        b_s = (cuts.tb // cuts.nb, _cdiv(cuts.tb, cuts.nb))
    elif cuts.nb2:
        rest = cuts.tb - cuts.ta
        b_s = (rest // cuts.nb2, _cdiv(rest, cuts.nb2))
    else:
        b_s = (0, 0)
    out = []
    for x in a_s:
        if not x:
            continue
        if cuts.sym:
            out.append(x * (x + 1) // 2)
            if cuts.na > 1:
                out += [x * y for y in a_s if y]
        out += [x * y for y in b_s if y]
    return out


def f32_max_rows(cuts: F32Cuts) -> int:
    """Staged rows of the widest slice (a diagonal one stages one side)."""
    a_hi = _cdiv(cuts.ta, cuts.na)
    if not cuts.sym:
        return 8 * (a_hi + _cdiv(cuts.tb, cuts.nb))
    rows = 16 * a_hi if cuts.na > 1 else 8 * a_hi
    if cuts.nb2:
        rows = max(rows, 8 * (a_hi + _cdiv(cuts.tb - cuts.ta, cuts.nb2)))
    return rows


def f32_phases(budget: int, tiles: int, groups: int) -> int:
    """Column phases of a slice of ``tiles`` tiles over a block's ``groups``
    groups of 4 columns: the thread budget over the tiles, but at least 4
    groups a phase (the source's ``phases_of``)."""
    return max(1, min(budget // tiles, groups // 4))


def f32_line_stages(slots: int) -> bool:
    """Whether a plan of ``slots`` 16-byte slots a staged group takes two
    stages of F32_LINE_GROUPS groups (256 bytes of each row) instead of up
    to three of 32 KB: where 16 groups pass 32 KB but two such stages fit
    the same 96 KB (the source's rule)."""
    stage = F32_LINE_GROUPS * slots * 16
    return stage > F32_STAGE_BYTES and 2 * stage <= F32_STAGES * F32_STAGE_BYTES


def f32_plan(cuts: F32Cuts, block_groups: int = 0) -> Dict[str, int]:
    """A launch of these cuts, as the source's ``plan_of``: ``budget``
    threads a block (192 where the widest slice holds 10-192 tiles, else
    256), ``slots`` (16 bytes) a staged group, ``groups`` of 4 columns a
    stage (32 KB at most, a multiple of the widest slice's phases, or 16
    where :func:`f32_line_stages` holds, or the block's ``block_groups``),
    ``ring`` stages (3 at most, 2 under :func:`f32_line_stages`, or the
    block's stages), ``max_tiles`` and ``smem_bytes`` (the ring, or the
    tiles' sums by phase, the larger).  ``block_groups`` 0: the widest
    ring, which the occupancy query takes."""
    counts = f32_tile_counts(cuts)
    max_tiles = max(counts)
    budget = (F32_NARROW_THREADS if 10 <= max_tiles <= F32_NARROW_THREADS
              else F32_THREADS)
    rows = f32_max_rows(cuts)
    slots = rows + rows // 8
    full = max(1, F32_STAGE_BYTES // (slots * 16))
    wide_phases = max(1, budget // max_tiles)
    stage = full // wide_phases * wide_phases if full >= wide_phases else full
    max_ring = F32_STAGES
    if f32_line_stages(slots):
        stage, max_ring = F32_LINE_GROUPS, 2
    bg = block_groups if block_groups > 0 else 1 << 30
    groups = min(stage, bg)
    ring = min(max_ring, _cdiv(bg, groups)) if block_groups > 0 \
        else max_ring
    red = max(64 * (f32_phases(budget, t, bg) * t + 1) for t in counts)
    return {"budget": budget, "slots": slots, "groups": groups, "ring": ring,
            "max_tiles": max_tiles,
            "smem_bytes": max(ring * groups * slots * 16, 4 * red)}


def f32_grid(n: int, sm_count: int, blocks_per_sm: int,
             slices: int) -> Tuple[int, int]:
    """``(num_blocks, cols_per_block)`` of each slice: one resident wave of
    blocks over all slices, each over a contiguous range of whole 128-column
    granules."""
    granules = _cdiv(n, F32_GRANULE)
    blocks = max(1, min(blocks_per_sm * sm_count // slices, granules))
    cols = _cdiv(granules, blocks) * F32_GRANULE
    return _cdiv(n, cols), cols


def f32_level(ma: int, m1: int, m2: int, sym: bool, n: int,
              sm_count: int) -> int:
    """The level of the cut: 1 where the columns alone give about 2 blocks
    an SM (granules x slices >= 2 x SMs); else the k whose busiest SM costs
    least, at 2 blocks an SM: its blocks (all slices' blocks over the SMs)
    times a block's cost — its granules times (6 x its tiles + its staged
    rows), a granule's FMAs (256 clocks a tile at half the FFMA rate)
    beside its copies (43 clocks a row from L2), plus 40 for what a block
    costs whatever its work (measured on the H100: Ka = Kb = 10 at
    n = 7 850 ran 8.7 us on one slice and 9.3 on four) — the lowest k on a
    tie."""
    granules = _cdiv(n, F32_GRANULE)
    if granules * F32Cuts.of(ma, m1, m2, sym, 1).slices() >= 2 * sm_count:
        return 1
    best, best_cost, k = 1, None, 1
    while True:
        cuts = F32Cuts.of(ma, m1, m2, sym, k)
        s = cuts.slices()
        if s > F32_MAX_SLICES:
            break
        blocks = max(1, min(granules, 2 * sm_count // s))
        block = (_cdiv(granules, blocks)
                 * (6 * f32_plan(cuts)["max_tiles"] + f32_max_rows(cuts))
                 + 40)
        cost = _cdiv(s * blocks, sm_count) * block
        if best_cost is None or cost < best_cost:
            best, best_cost = k, cost
        if cuts.saturated():
            break
        k += 1
    return best


def f32_shape_ok(ma: int, m1: int, m2: int, sym: bool) -> bool:
    """Whether the f32 body takes these rows: its base cut fits gridDim.y
    (any realistic shape; A and B past ~32 000 rows each do not)."""
    return F32Cuts.of(ma, m1, m2, sym, 1).slices() <= F32_MAX_SLICES


def f32_vec(n: int, pa: int, lda: int, ma: int, pb1: int, ldb1: int,
            m1: int, pb2: int, ldb2: int, m2: int) -> bool:
    """Whether the f32 body copies 16 bytes at a time: n % 4 == 0 and every
    source (pointer, row stride, rows) 16-byte aligned with a row stride
    that is a multiple of 4 where it has more than one row; else each row
    as its start allows."""
    return (n % F32_GROUP == 0 and (pa | pb1 | pb2) % 16 == 0
            and ((lda if ma > 1 else 0) | (ldb1 if m1 > 1 else 0)
                 | (ldb2 if m2 > 1 else 0)) % F32_GROUP == 0)


def f32_scratch_floats(cuts: F32Cuts, num_blocks: int) -> int:
    """The f32 body's scratch: none where one block owns a slice's columns
    (it writes the outputs itself), else every block's partial, 64 entries
    of one slot a thread (a thread's phase sums as they are where a full
    block has at most 8 phases)."""
    if num_blocks == 1:
        return 0
    return cuts.slices() * num_blocks * 64 * f32_plan(cuts)["budget"]


@functools.lru_cache(maxsize=None)
def f32_launch_config(ma: int, m1: int, m2: int, sym: bool, level: int,
                      vec: bool, device_index: int) -> Tuple[int, int, int]:
    """``(blocks resident per SM, slices, floats of a block's partial: 64 a
    thread)`` of the f32 body for these rows at this level, from the
    library."""
    lib = _build.load_library()
    blocks, slices, floats = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.cross_f32_launch_config(
            ma, m1, m2, int(sym), level, int(vec), ctypes.byref(blocks),
            ctypes.byref(slices), ctypes.byref(floats))
    _build.check(lib, rc, "cross_f32_launch_config occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"cross_f32: the kernel cannot be resident for "
                           f"rows {(ma, m1, m2)}")
    return blocks.value, slices.value, floats.value


@functools.lru_cache(maxsize=4096)
def f32_call_plan(ma: int, m1: int, m2: int, sym: bool, n: int, vec: bool,
                  device_index: int) -> Tuple[int, int, int, int]:
    """``(level, num_blocks, cols_per_block, scratch floats)`` of an f32
    call: the grid is one resident wave over the slices, so a split may
    take one cooperative launch; the scratch is 0 where one block owns a
    slice's columns.  Raises where the rows' slices do not fit the grid."""
    if not f32_shape_ok(ma, m1, m2, sym):
        raise ValueError(f"cross_f32: the slices of rows {(ma, m1, m2)} do "
                         f"not fit the grid")
    sms = _build.sm_count(device_index)
    level = f32_level(ma, m1, m2, sym, n, sms)
    per_sm, slices, block_floats = f32_launch_config(ma, m1, m2, sym, level,
                                                     vec, device_index)
    num_blocks, cols = f32_grid(n, sms, per_sm, slices)
    return (level, num_blocks, cols,
            0 if num_blocks == 1 else slices * num_blocks * block_floats)


@functools.lru_cache(maxsize=None)
def _f32_launcher(device_index: int):
    """``(lib, cross_f32_launch)`` of a device, looked up once."""
    lib = _build.load_library()
    return lib, lib.cross_f32_launch


def launch_f32(what: str, a: torch.Tensor, ma: int, lda: int,
               b1: torch.Tensor, m1: int, ldb1: int, b2: torch.Tensor,
               m2: int, ldb2: int, sym: bool, n: int, out1: torch.Tensor,
               ld1: int, out2: torch.Tensor, ld2: int,
               accumulate: bool) -> None:
    """One launch of the f32 body on the current stream: A = ``a``'s ``ma``
    rows against [``b1``'s m1; ``b2``'s m2], rows ``lda`` / ``ldb1`` /
    ``ldb2`` elements apart, into ``out1`` / ``out2`` with row strides
    ld1 / ld2.  The caller checked the inputs (f32, one device,
    unit-strided columns); here only pointers and strides are read (16-byte
    copies: :func:`f32_vec`'s rule)."""
    dev = a.device
    idx = dev.index
    pa, pb1, pb2 = a.data_ptr(), b1.data_ptr(), b2.data_ptr()
    vec = f32_vec(n, pa, lda, ma, pb1, ldb1, m1, pb2, ldb2, m2)
    level, num_blocks, cols, floats = f32_call_plan(ma, m1, m2, sym, n, vec,
                                                    idx)
    partial = (torch.empty((floats,), dtype=torch.float32, device=dev)
               if floats else None)
    lib, fn = _f32_launcher(idx)
    args = (pa, lda, ma, pb1, ldb1, m1, pb2, ldb2, m2, int(sym), n, level,
            int(vec), partial.data_ptr() if floats else None, floats,
            num_blocks, cols, out1.data_ptr(), ld1, out2.data_ptr(), ld2,
            int(accumulate), torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc:
        _build.check(lib, rc, what)
