"""The sign sketch's second body (``csrc/rng_sketch_col.cu``, ``col``) on the
CPU: what can be checked without the card.

* The factored hash: the sign of R[i, j] from the column's half
  cc_j = j ^ (j >> 16) and the row's half R1_i = rh_i ^ (rh_i >> 16),
  rh_i = mix32(i ^ seed), then ·M1, ^ >> 13, ·M2 and the top bit, modelled
  in numpy, equals ``repro.kernels.rng_sketch.sign_tile`` bitwise: on the
  whole path matrices, and on random counters across 2¹⁶ column
  boundaries and near 2³² - 1, for seeds 0, 1 and 0xFFFFFFFF.
* The body's f32 arithmetic, modelled in numpy from the plan functions
  (u·(±1) added to a running f32 sum, chunk sums added in order, then the
  warps' and the cluster ranks' sums in order, / √m), is within 1e-5
  (relative to max(1, max |plain|), the kernels' tolerance) of the plain
  versions ``ref.rng_sketch_ref`` / ``ref.rng_sketch_adjoint_ref``.
* The plans cover every (row, column) exactly once, in a fixed order, at
  the paths', ragged and model shapes; the adjoint's fills the card at the
  paths' n = 7 850.
* The body rule, and the source's launchers against ``_build``'s ctypes
  signatures.

The kernels themselves run on the card in ``tests/test_torch_cuda.py``.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rng_sketch as jrng
from repro_torch.kernels import _build, ref
from repro_torch.kernels import rng_sketch as rs

torch.set_num_threads(1)

SMS = 132                                  # an H100's SMs
TOL = 1e-5
M1, M2 = np.uint32(0x85EBCA6B), np.uint32(0xC2B2AE35)
SEEDS = (0, 1, 0xFFFFFFFF)
PATH = [(1, 7850, 1962), (1, 7850, 981)]
RAGGED = [(1, 1, 1), (3, 130, 17), (8, 4097, 300), (11, 1000, 129)]
MODEL = [(K, (1 << 20) + 3, m) for K in (1, 8) for m in (1024, 8192)]


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * M1
    x = x ^ (x >> np.uint32(13))
    x = x * M2
    return x ^ (x >> np.uint32(16))


def _row_half(rows, seed):
    rh = _mix32(rows.astype(np.uint32) ^ np.uint32(seed))
    return rh ^ (rh >> np.uint32(16))


def _col_half(cols):
    cols = cols.astype(np.uint32)
    return cols ^ (cols >> np.uint32(16))


def _factored_signs(rows, cols, seed):
    """±1 f32 (len(rows), len(cols)) from the two halves, as the kernel's
    ``sign_of(cc_j ^ R1_i)``."""
    y = (_col_half(cols)[None, :] ^ _row_half(rows, seed)[:, None]) * M1
    y = y ^ (y >> np.uint32(13))
    y = y * M2
    return np.float32(1.0) - np.float32(2.0) * (y >> np.uint32(31)).astype(
        np.float32)


def _sign_tile(seed, row0, col0, rows, cols):
    return np.asarray(jrng.sign_tile(jnp.uint32(seed), jnp.uint32(row0),
                                     jnp.uint32(col0), rows, cols))


def _counters(start, count):
    """``count`` uint32 counters from ``start``, wrapping at 2³²."""
    return (np.arange(count, dtype=np.uint64) + start).astype(np.uint32)


# ------------------------------------------------------- the factored hash

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m,n", [(m, n) for _, n, m in PATH])
def test_factored_hash_matches_sign_tile_on_path_matrices(m, n, seed):
    got = _factored_signs(_counters(0, m), _counters(0, n), seed)
    assert np.array_equal(got, _sign_tile(seed, 0, 0, m, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_factored_hash_matches_sign_tile_on_random_counters(seed):
    rng = np.random.RandomState(seed & 0xFFFF)
    col0s = [(1 << 16) - 100, 3 * (1 << 16) - 50, (1 << 20) - 7,
             (1 << 32) - 150, (1 << 32) - 1,
             *rng.randint(0, 1 << 32, size=6, dtype=np.uint64)]
    for col0 in col0s:
        row0 = int(rng.randint(0, 1 << 32, dtype=np.uint64))
        rows, cols = 9, 300
        got = _factored_signs(_counters(row0, rows), _counters(col0, cols),
                              seed)
        assert np.array_equal(got, _sign_tile(seed, row0, int(col0), rows,
                                              cols)), (row0, col0)


# ------------------------------------------------- the body's arithmetic

def _col_model(U, seed, m, sms=SMS):
    """The col sketch's f32 sums in the kernel's order: per rank, per warp,
    per chunk of ≤ 32 columns a chunk sum of u·(±1) in column order, added
    to the warp's sum; the warps' sums in warp order; the ranks' in rank
    order; / √m (√m rounded once to f32)."""
    K, n = U.shape
    plan = rs.col_plan(K, n, m, sms)
    signs = _factored_signs(_counters(0, m), _counters(0, n), seed)
    total = None
    for rank in range(plan.ranks):
        block = None
        for chunks in rs.col_warp_columns(n, plan.cols_per_rank, rank):
            acc = np.zeros((K, m), np.float32)
            for lo, hi in chunks:
                tacc = np.zeros((K, m), np.float32)
                for j in range(lo, hi):
                    tacc = tacc + U[:, j, None] * signs[None, :, j]
                acc = acc + tacc
            block = acc if block is None else block + acc
        total = block if total is None else total + block
    return total / np.sqrt(np.float32(m))


def _adjoint_model(s, seed, n, sms=SMS):
    """The col adjoint's f32 sums in the kernel's order: per row slice, per
    tile a sum of s_i·(±1) in row order, added to the slice's sum; the
    slices' sums in slice order; / √m."""
    m = s.shape[0]
    plan = rs.adjoint_plan(m, n, sms)
    signs = _factored_signs(_counters(0, m), _counters(0, n), seed)
    total = None
    for ranges in rs.adjoint_slice_rows(m, plan.wr):
        acc = np.zeros((n,), np.float32)
        for lo, hi in ranges:
            tacc = np.zeros((n,), np.float32)
            for i in range(lo, hi):
                tacc = tacc + s[i] * signs[i]
            acc = acc + tacc
        total = acc if total is None else total + acc
    return total / np.sqrt(np.float32(m))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("K,n,m", RAGGED)
def test_col_sketch_arithmetic_matches_plain(K, n, m):
    rng = np.random.RandomState(K * 7919 + n + m)
    U = rng.randn(K, n).astype(np.float32)
    seed = (0x9E3779B1 * (K + m) + n) & 0xFFFFFFFF
    got = _col_model(U, seed, m)
    assert got.dtype == np.float32 and got.shape == (K, m)
    want = ref.rng_sketch_ref(torch.from_numpy(U), seed, m).numpy()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("m,n", [(m, n) for _, n, m in RAGGED])
def test_col_adjoint_arithmetic_matches_plain(m, n):
    rng = np.random.RandomState(m * 31 + n)
    s = rng.randn(m).astype(np.float32)
    seed = (0x85EBCA6B * m + n) & 0xFFFFFFFF
    got = _adjoint_model(s, seed, n)
    assert got.dtype == np.float32 and got.shape == (n,)
    want = ref.rng_sketch_adjoint_ref(torch.from_numpy(s), seed, n).numpy()
    assert _rel(got, want) <= TOL


# ------------------------------------------------------------- the plans

@pytest.mark.parametrize("K,n,m", PATH + RAGGED + MODEL)
def test_col_plan_covers_every_entry_once_in_order(K, n, m):
    plan = rs.col_plan(K, n, m, SMS)
    assert plan.kc == rs.chunk_rows(K) and plan.launches * plan.kc >= K
    assert plan.ri in rs.col_row_choices(plan.kc)
    assert plan.rows == 32 * plan.ri
    # row tile t owns rows [t·rows, (t+1)·rows): every row once
    assert (plan.row_tiles - 1) * plan.rows < m <= plan.row_tiles * plan.rows
    assert plan.ranks in rs.COL_RANKS
    assert plan.blocks == plan.row_tiles * plan.ranks
    assert plan.ranks * plan.cols_per_rank >= n
    # the columns, in the kernel's order of adding them (rank, warp,
    # chunk), are [0, n) cut into consecutive pieces of at most 32
    pieces = [piece for rank in range(plan.ranks)
              for chunks in rs.col_warp_columns(n, plan.cols_per_rank, rank)
              for piece in chunks]
    assert pieces[0][0] == 0 and pieces[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert all(0 < hi - lo <= rs.COL_CHUNK for lo, hi in pieces)
    assert pieces == [piece for rank in range(plan.ranks) for chunks in
                      rs.col_warp_columns(n, plan.cols_per_rank, rank)
                      for piece in chunks]


@pytest.mark.parametrize("K,n,m,ri,ranks", [
    (1, 7850, 1962, 1, 8), (1, 7850, 981, 1, 16),
    (1, (1 << 20) + 3, 1024, 1, 16), (1, (1 << 20) + 3, 8192, 4, 8),
    (8, (1 << 20) + 3, 1024, 1, 16), (8, (1 << 20) + 3, 8192, 2, 8)])
def test_col_plan_rows_a_lane_and_cluster_size(K, n, m, ri, ranks):
    """RI: the most rows a lane that leave every SM two blocks of 8 ranks;
    16 ranks where 8 leave fewer."""
    plan = rs.col_plan(K, n, m, SMS)
    assert (plan.ri, plan.ranks) == (ri, ranks)
    assert plan.blocks >= 2 * SMS or plan.ri == 1


@pytest.mark.parametrize("m,n", [(m, n) for _, n, m in PATH + RAGGED + MODEL])
def test_adjoint_plan_covers_every_entry_once_in_order(m, n):
    plan = rs.adjoint_plan(m, n, SMS)
    assert plan.wr in rs.ADJ_SLICES and plan.cj in rs.ADJ_COLS
    assert plan.cols_per_block == 32 * plan.cj * rs.ADJ_WARPS // plan.wr
    assert (plan.blocks - 1) * plan.cols_per_block < n \
        <= plan.blocks * plan.cols_per_block
    slices = rs.adjoint_slice_rows(m, plan.wr)
    assert len(slices) == plan.wr
    # tile by tile, the slices' rows in slice order are the tile's rows
    pieces = sorted(p for ranges in slices for p in ranges)
    assert pieces[0][0] == 0 and pieces[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert all(lo % 4 == 0 for lo, _ in pieces)


@pytest.mark.parametrize("m", [981, 1962])
def test_adjoint_plan_fills_the_card_at_the_path_width(m):
    plan = rs.adjoint_plan(m, 7850, SMS)
    assert (plan.wr, plan.cj) == (16, 1)
    assert plan.blocks * rs.ADJ_WARPS / SMS >= 16


def test_adjoint_plan_takes_four_columns_a_lane_at_model_width():
    assert rs.adjoint_plan(8192, (1 << 20) + 3, SMS)[:2] == (1, 4)


# ---------------------------------------------------------- the body rule

def test_every_call_takes_the_col_body_unless_asked():
    assert rs.choose_body() == "col"
    assert rs.choose_body(None) == "col"
    assert rs.choose_body("col") == "col"
    assert rs.choose_body("first") == "first"
    with pytest.raises(ValueError, match="body"):
        rs.choose_body("cross")


def test_body_tally_counts_by_op_and_body():
    rs.reset_body_launches()
    tally = rs.body_launches()
    assert tally == {op: {"col": 0, "first": 0} for op in rs.OPS}
    tally["sign_sketch"]["col"] = 5          # a copy: the tally is unchanged
    assert rs.body_launches()["sign_sketch"]["col"] == 0


def test_cpu_tensors_run_the_plain_version():
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     sign_sketch, sign_sketch_adjoint)
    reset_launch_counts()
    rs.reset_body_launches()
    U = torch.ones(1, 10)
    sign_sketch(U, 3, 4)
    sign_sketch_adjoint(torch.ones(4), 3, 10)
    counts = launch_counts()
    assert counts["sign_sketch/torch"] == 1
    assert counts["sign_sketch_adjoint/torch"] == 1
    assert counts["sign_sketch/cuda"] == counts["sign_sketch_adjoint/cuda"] == 0
    assert rs.body_launches() == {op: {"col": 0, "first": 0} for op in rs.OPS}
    with pytest.raises(ValueError, match="CUDA tensors"):
        rs.sign_sketch_cuda(U, 3, 4, body="first")


# ------------------------------------------------------ built and bound

def test_col_body_is_built_and_bound():
    """``rng_sketch_col.cu`` is among the sources the build compiles,
    defines the two launchers the wrapper binds with the argument counts
    and types ``_build`` gives them, reduces in a cluster through
    distributed shared memory (no float atomics) and hashes through
    rng_hash.cuh's row hash; ``rng_sketch.cu`` keeps the first body."""
    src = _build.CSRC / "rng_sketch_col.cu"
    assert src in _build.sources()
    text = src.read_text()
    sig = _build._SIGNATURES
    I, LL, VP, U32 = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, \
        ctypes.c_uint
    assert ('extern "C" int sign_sketch_col_launch(const void* U, int K, '
            'long long n,' in text)
    assert "int u_bf16, unsigned seed, int m, int ri," in text
    assert "int ranks, long long cols_per_rank, void* out," in text
    # U, K, n, u_bf16, seed, m, ri, ranks, cols_per_rank, out, stream
    assert sig["sign_sketch_col_launch"] == [VP, I, LL, I, U32, I, I, I, LL,
                                             VP, VP]
    assert 'extern "C" int sign_sketch_adjoint_col_launch(const void* s, int m,' \
        in text
    assert "int wr, int cj, void* out," in text
    # s, m, seed, n, wr, cj, out, stream
    assert sig["sign_sketch_adjoint_col_launch"] == [VP, I, U32, LL, I, I, VP,
                                                     VP]
    assert '#include "rng_hash.cuh"' in text and "row_hash(" in text
    assert "cudaLaunchAttributeClusterDimension" in text
    assert "map_shared_rank(" in text and "cluster.sync()" in text
    assert "atomicAdd" not in text
    first = (_build.CSRC / "rng_sketch.cu").read_text()
    assert 'extern "C" int sign_sketch_launch(' in first
    assert 'extern "C" int sign_sketch_adjoint_launch(' in first
