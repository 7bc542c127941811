"""The f32 body of gram_block and stream_stats (``csrc/cross_f32.cu``): its
planner in ``kernels/cross.py``.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); here
the CPU holds what the wrappers decide from dtypes, shapes and pointers —
which body a call takes, the cut into slices, the tile deal and each entry's
target, the grid and the scratch — and an emulation in numpy of the body's
data flow (rows staged a slice at a time, padding rows that hold NaN,
8 x 8 tiles, each entry written through its target with its mirror, column
blocks' partials summed in block order, ``accumulate``) against
``repro.kernels.gram.gram_block_pallas`` and
``repro.kernels.stream.stream_stats_pallas`` in interpret mode at the
reference's f32 tolerance (1e-4 of max(1, max |x|)).
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram import gram_block_pallas
from repro.kernels.stream import stream_stats_pallas
from repro_torch.kernels import _build, cross, gram, stream

torch.set_num_threads(1)

BLOCK_K = [1, 7, 8, 9, 10, 25, 32, 63, 64, 65, 100, 127, 128, 200]
STREAM_P = [1, 3, 16, 65, 100, 128]
F32, BF16 = torch.float32, torch.bfloat16


def _rows(rows, n, dtype=F32, start=0, stride=None):
    """A (rows, n) view starting ``start`` entries into a fresh buffer (a
    buffer's own start is 64-byte aligned), rows ``stride`` apart."""
    stride = stride or n
    buf = torch.zeros(rows * stride + start, dtype=dtype)
    return buf[start:].as_strided((rows, n), (stride, 1))


_BLOCK_CASES = {
    "f32": ((_rows(10, 1024), _rows(10, 1024), _rows(1, 1024)[0]), "f32"),
    "f32 at odd n": ((_rows(10, 7850), _rows(10, 7850), _rows(1, 7850)[0]),
                     "f32"),
    "f32, U_a 4 bytes in": ((_rows(10, 1024, start=1), _rows(5, 1024),
                             _rows(1, 1024)[0]), "f32"),
    "f32, Ka = 200": ((_rows(200, 64), _rows(128, 64), _rows(1, 64)[0]),
                      "f32"),
    "bf16 eligible": ((_rows(10, 1024, BF16), _rows(5, 1024, BF16),
                       _rows(1, 1024, BF16)[0]), "mma"),
    "mixed f32 U_a": ((_rows(10, 1024), _rows(5, 1024, BF16),
                       _rows(1, 1024, BF16)[0]), "cross"),
    "mixed f32 g": ((_rows(10, 1024, BF16), _rows(5, 1024, BF16),
                     _rows(1, 1024)[0]), "cross"),
    "bf16 at odd n": ((_rows(10, 1001, BF16), _rows(5, 1001, BF16),
                       _rows(1, 1001, BF16)[0]), "cross"),
    "bf16, U_a 2 bytes in": ((_rows(10, 1024, BF16, start=1),
                              _rows(5, 1024, BF16),
                              _rows(1, 1024, BF16)[0]), "cross"),
    "bf16, Ka = 65": ((_rows(65, 1024, BF16), _rows(5, 1024, BF16),
                       _rows(1, 1024, BF16)[0]), "cross"),
}

_STREAM_CASES = {
    "f32": ((_rows(100, 7840), _rows(100, 7840)), "f32"),
    "f32 window, row stride 400": ((_rows(5, 300, stride=400, start=5),
                                    _rows(5, 300, stride=400, start=90)),
                                   "f32"),
    "f32, P = 128": ((_rows(128, 64), _rows(128, 64)), "f32"),
    "bf16 eligible": ((_rows(16, 1024, BF16), _rows(16, 1024, BF16)), "mma"),
    "mixed f32/bf16": ((_rows(16, 1000), _rows(16, 1000, BF16)), "cross"),
    "mixed bf16/f32": ((_rows(16, 1000, BF16), _rows(16, 1000)), "cross"),
    "bf16, 2 bytes in": ((_rows(16, 1000, BF16, start=1, stride=1024),
                          _rows(16, 1000, BF16, start=1, stride=1024)),
                         "cross"),
    "bf16, P = 33": ((_rows(33, 1000, BF16), _rows(33, 1000, BF16)),
                     "cross"),
}


@pytest.mark.parametrize("case", list(_BLOCK_CASES))
def test_gram_block_body_choice(case):
    """f32/f32/f32 -> ``f32``; eligible bf16 -> ``mma``; mixed, misaligned,
    odd-n or too-tall bf16 -> ``cross``; read from dtypes, shapes and
    pointers alone."""
    (ua, ub, g), want = _BLOCK_CASES[case]
    assert gram._block_body(ua, ub, g) == want


@pytest.mark.parametrize("case", list(_STREAM_CASES))
def test_stream_stats_body_choice(case):
    """f32/f32 -> ``f32``; eligible bf16 -> ``mma``; mixed, misaligned or
    P > 32 bf16 -> ``cross``."""
    (D, GM), want = _STREAM_CASES[case]
    assert stream._body(D, GM) == want


@pytest.mark.parametrize("case", [("aligned", 1024, 0, 1024, True),
                                  ("odd n", 7850, 0, 7850, False),
                                  ("4 bytes in", 1024, 1, 1024, False),
                                  ("row stride 1026", 1024, 0, 1026, False),
                                  ("16 bytes in, stride 1028", 1024, 4, 1028,
                                   True)])
def test_f32_vec_rule(case):
    """16-byte copies where every staged row starts 16-byte aligned: n % 4
    == 0, each pointer aligned and each row stride a multiple of 4 (a
    one-row source's stride does not count); else 4-byte copies."""
    _, n, start, stride, want = case
    a, b = _rows(6, n, start=start, stride=stride), _rows(3, n)
    g = _rows(1, n)[0]

    def vec(a, ma, b, m1, g, m2):
        return cross.f32_vec(n, a.data_ptr(), a.stride(0), ma, b.data_ptr(),
                             b.stride(0), m1, g.data_ptr(), g.stride(0), m2)

    assert vec(a, 6, b, 3, g, 1) is want
    assert vec(_rows(6, n), 6, b, 3, g, 1) is (n % 4 == 0)
    assert vec(b, 3, b, 3, a[:1], 1) is (n % 4 == 0 and start % 4 == 0)


def test_bodies_are_forced_and_checked():
    """``body=`` names one of three bodies for both ops; the tallies have an
    ``f32`` key; the wrappers want CUDA tensors before any launch."""
    assert gram.BLOCK_BODIES == stream.BODIES == ("mma", "f32", "cross")
    gram.reset_block_body_launches()
    stream.reset_body_launches()
    assert gram.block_body_launches() == {"mma": 0, "f32": 0, "cross": 0}
    assert stream.body_launches() == {"mma": 0, "f32": 0, "cross": 0}
    ua, ub, g = _BLOCK_CASES["f32"][0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram.gram_block_cuda(ua, ub, g, body="cross")
    with pytest.raises(ValueError, match="CUDA tensors"):
        stream.stream_stats_cuda(*_STREAM_CASES["f32"][0], body="f32")


def _levels(ma, m1, m2, sym):
    """Level 1, the level a path's n = 7 850 gets on a 132-SM card, and the
    level where every group is one tile."""
    k, cuts = 1, cross.F32Cuts.of(ma, m1, m2, sym, 1)
    while not cuts.saturated():
        k += 1
        cuts = cross.F32Cuts.of(ma, m1, m2, sym, k)
    return sorted({1, cross.f32_level(ma, m1, m2, sym, 7850, 132), k})


def _coverage(ma, m1, m2, sym, level):
    """Every output entry the slices' tiles write, counted: ("out1", X, Y)
    (a mirrored write counts once, under its upper-triangle entry) or
    ("out2", X, Y); each entry's staged rows inside the slice."""
    cuts = cross.F32Cuts.of(ma, m1, m2, sym, level)
    slices = cross.f32_slices(cuts)
    assert len(slices) == cuts.slices() == len(set(cuts.pairs()))
    seen = Counter()
    for sl in slices:
        tiles = sl.deal()
        assert len(tiles) == sl.tiles == len(set(tiles))
        assert sl.ta <= cross.F32_SIDE_TILES and sl.tb <= cross.F32_SIDE_TILES
        if sl.shared:
            assert (sl.a0, sl.ta) == (sl.b0, sl.tb) and sl.rows_a == 0
        for q in range(sl.tiles):
            for e in range(64):
                x, y = sl.entry(q, e)
                assert x < (sl.rows if sl.shared else sl.rows_a)
                assert sl.rows_a + y < sl.rows
                t = sl.target(x, y, m1, sym)
                if t is not None:
                    seen[t[:3]] += 1
                    if sym:
                        assert t[0] == "out2" or t[3] == (t[1] != t[2])
    return seen


def _want(ma, m1, m2, sym):
    out1 = [("out1", x, y) for x in range(ma) for y in range(m1)
            if not sym or y >= x]
    return Counter(out1 + [("out2", x, y) for x in range(ma)
                           for y in range(m2)])


@pytest.mark.parametrize("Kb", BLOCK_K)
@pytest.mark.parametrize("Ka", BLOCK_K)
def test_gram_block_deal_covers_every_entry_once(Ka, Kb):
    """At level 1, at the path's level and with every group one tile, the
    slices' tiles reach every entry of G_ab and c_a exactly once."""
    for level in _levels(Ka, Kb, 1, False):
        assert _coverage(Ka, Kb, 1, False, level) == _want(Ka, Kb, 1, False)


@pytest.mark.parametrize("P", STREAM_P)
def test_stream_stats_deal_covers_every_entry_once(P):
    """Under sym the slices reach every entry of G's upper triangle once (its
    mirror written beside it) and every entry of C once, at every level."""
    cuts = cross.F32Cuts.of(P, P, P, True, 1)
    k = 1
    while True:
        assert _coverage(P, P, P, True, k) == _want(P, P, P, True)
        if cuts.saturated():
            break
        k += 1
        cuts = cross.F32Cuts.of(P, P, P, True, k)


@pytest.mark.parametrize("rows", [(100, 100, 1, False), (64, 32, 1, False),
                                  (10, 10, 1, False), (200, 128, 1, False),
                                  (64, 8, 1, False), (128, 64, 1, False),
                                  (100, 100, 100, True), (3, 3, 3, True),
                                  (128, 128, 128, True)])
def test_plan_fits_every_slice(rows):
    """At every level: each slice's staged rows and tiles fit the plan's
    slots, its tiles the block's threads; a ring holds 3 stages of at most
    32 KB for a long column range, or 2 stages of 16 groups where 16 groups
    pass 32 KB and two such stages fit 96 KB, and one stage for a range the
    stage holds; the shared memory fits an H100 block; the source's tile
    counts hold every slice's."""
    ma, m1, m2, sym = rows
    k = 1
    while True:
        cuts = cross.F32Cuts.of(ma, m1, m2, sym, k)
        counts = cross.f32_tile_counts(cuts)
        for bg in (0, 1, 3, 32, 64, 1 << 20):
            plan = cross.f32_plan(cuts, bg)
            for sl in cross.f32_slices(cuts):
                assert sl.tiles in counts
                assert sl.rows + sl.rows // 8 <= plan["slots"]
                assert sl.tiles <= plan["max_tiles"] <= plan["budget"]
            assert plan["budget"] in (192, 256)
            assert plan["smem_bytes"] <= 128 * 1024
            assert 1 <= plan["ring"] <= 3
            line = 16 * 16 * plan["slots"]
            assert cross.f32_line_stages(plan["slots"]) is (
                line > cross.F32_STAGE_BYTES
                and 2 * line <= 3 * cross.F32_STAGE_BYTES)
            if (bg == 0 or bg == 1 << 20) and cross.f32_line_stages(
                    plan["slots"]):
                assert plan["ring"] == 2 and plan["groups"] == 16
            elif bg == 0 or bg == 1 << 20:
                wide = plan["budget"] // plan["max_tiles"]
                assert plan["ring"] == 3
                assert (16 * plan["groups"] * plan["slots"]
                        <= cross.F32_STAGE_BYTES or plan["groups"] == 1)
                assert plan["groups"] % wide == 0 or plan["groups"] < wide
            elif bg <= plan["groups"]:
                assert plan["ring"] == 1 and plan["groups"] == bg
        if cuts.saturated():
            break
        k += 1


def test_levels_at_the_path_shapes():
    """The paths' shapes on a 132-SM card: where 62 column blocks of 128
    cannot give 2 blocks an SM, the rows are cut further where that lowers
    the busiest SM's cost (Ka = Kb = 25 and 100 at n = 7 850: level 2, four
    slices); Ka = Kb = 10 and P = 100 at 7 840 keep level 1 (P = 100: the
    diagonal slice and GM's columns in two slices of half the size); the model
    width keeps one slice of 40 tiles; the bias slab (n = 10, one block a
    slice) is cut into slices of at most 4 tiles."""
    level = cross.f32_level
    assert level(10, 10, 1, False, 7850, 132) == 1
    for K in (25, 100):
        assert level(K, K, 1, False, 7850, 132) == 2
        assert cross.F32Cuts.of(K, K, 1, False, 2).slices() == 4
    assert level(100, 100, 100, True, 7840, 132) == 1
    # the diagonal slice (91 tiles) and GM's 12 tile columns in two halves
    assert sorted(sl.tiles for sl in cross.f32_slices(
        cross.F32Cuts.of(100, 100, 100, True, 1))) == [78, 78, 91]
    assert level(64, 32, 1, False, 1 << 24, 132) == 1
    cuts = cross.F32Cuts.of(64, 32, 1, False, 1)
    assert cuts.slices() == 1
    (sl,) = cross.f32_slices(cuts)
    assert sl.tiles == 40 and cross.f32_plan(cuts)["budget"] == 192
    k = level(100, 100, 100, True, 10, 132)
    assert k > 1 and all(sl.tiles <= 4 for sl in cross.f32_slices(
        cross.F32Cuts.of(100, 100, 100, True, k)))


def test_largest_shapes_fit_the_grid():
    """The base cut fits gridDim.y far past every path's rows; the
    wrappers refuse a shape past it before a launch."""
    assert cross.f32_shape_ok(4000, 4000, 1, False)
    assert cross.f32_shape_ok(4000, 4000, 4000, True)
    assert not cross.f32_shape_ok(40000, 40000, 1, False)


@pytest.mark.parametrize("n", [1, 10, 128, 130, 7840, 7850, (1 << 20) + 3,
                               1 << 24])
@pytest.mark.parametrize("rows", [(10, 10, 1, False), (100, 100, 1, False),
                                  (64, 32, 1, False), (100, 100, 100, True),
                                  (3, 3, 3, True)])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_grid_covers_every_column_and_scratch(rows, n, per_sm):
    """The grid's column ranges (whole 128-column granules, whole groups)
    cover n; the blocks of all slices are one wave of ``per_sm`` on 132
    SMs wherever a slice has more than one, as the cooperative launch
    needs; the scratch is zero where one block owns a slice, else every
    block's partial of 64 floats a thread."""
    ma, m1, m2, sym = rows
    cuts = cross.F32Cuts.of(ma, m1, m2, sym,
                            cross.f32_level(ma, m1, m2, sym, n, 132))
    blocks, cols = cross.f32_grid(n, 132, per_sm, cuts.slices())
    assert cols % 128 == 0 and cols % cross.F32_GROUP == 0
    assert blocks * cols >= n > (blocks - 1) * cols
    if blocks > 1:
        assert blocks * cuts.slices() <= per_sm * 132
    floats = cross.f32_scratch_floats(cuts, blocks)
    if blocks == 1:
        assert floats == 0
    else:
        assert floats == (cuts.slices() * blocks * 64
                          * cross.f32_plan(cuts)["budget"])
    if n <= 128:
        assert blocks == 1 and floats == 0


def _emulate(A, B1, B2, sym, sms, per_sm, out=None):
    """The f32 body's data flow in numpy (f64 sums): the level and grid the
    planner gives a ``sms``-SM card, per column block each slice's staged
    rows (padding rows NaN), its tiles' 8 x 8 products (a diagonal slice's
    A rows read from B's stage), then the blocks' partials summed in block
    order and written (or added, with ``out``) through each entry's target,
    G's mirror from the same sum."""
    ma, n = A.shape
    m1, m2 = B1.shape[0], B2.shape[0]
    level = cross.f32_level(ma, m1, m2, sym, n, sms)
    cuts = cross.F32Cuts.of(ma, m1, m2, sym, level)
    blocks, cols = cross.f32_grid(n, sms, per_sm, cuts.slices())
    if out is None:
        out1, out2 = np.full((ma, m1), np.nan), np.full((ma, m2), np.nan)
    else:
        out1, out2 = (o.astype(np.float64).copy() for o in out)
    srcs = {"a": A, "b1": B1, "b2": B2}
    for sl in cross.f32_slices(cuts):
        stage = np.full((sl.rows, n), np.nan)
        for x in range(sl.rows):
            src = sl.row(x, m1)
            if src is not None:
                stage[x] = srcs[src[0]][src[1]]
        side_a = stage if sl.shared else stage[:sl.rows_a]
        side_b = stage[sl.rows_a:]
        ents = [(q, e, sl.entry(q, e)) for q in range(sl.tiles)
                for e in range(64)]
        total = np.zeros(len(ents))
        for b in range(blocks):
            cs = slice(b * cols, (b + 1) * cols)
            total = total + np.array([side_a[x, cs] @ side_b[y, cs]
                                      for _, _, (x, y) in ents])
        for v, (_, _, (x, y)) in zip(total, ents):
            t = sl.target(x, y, m1, sym)
            if t is None:
                continue
            dst = out1 if t[0] == "out1" else out2
            if out is not None:
                v = dst[t[1], t[2]] + v
            dst[t[1], t[2]] = v
            if t[0] == "out1" and t[3]:
                out1[t[2], t[1]] = v
    return out1, out2, level, blocks


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale <= 1e-4


@pytest.mark.parametrize("Ka,Kb,n,sms,per_sm", [
    (1, 1, 1, 4, 1), (7, 9, 300, 4, 2), (10, 10, 785, 132, 2),
    (25, 25, 785, 16, 2), (8, 64, 257, 4, 1), (65, 63, 130, 2, 3),
    (100, 100, 640, 8, 2), (128, 130, 300, 4, 1), (200, 3, 68, 4, 2),
    (64, 32, 300, 4, 1), (48, 16, 129, 2, 2), (128, 120, 200, 8, 1)])
def test_emulated_gram_block_matches_pallas(Ka, Kb, n, sms, per_sm):
    """The emulated data flow over the planner's level, slices, tiles,
    targets and column blocks (small cards, so n of a few hundred splits
    both ways) within the reference's tolerance of ``gram_block_pallas``;
    every entry written, no padding row reaching one."""
    rng = np.random.RandomState(Ka * 131 + Kb * 7 + n)
    ua = rng.randn(Ka, n).astype(np.float32)
    ub = rng.randn(Kb, n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    G, c, level, blocks = _emulate(ua, ub, g[None, :], False, sms, per_sm)
    assert not np.isnan(G).any() and not np.isnan(c).any()
    Gj, cj = gram_block_pallas(jnp.asarray(ua), jnp.asarray(ub),
                               jnp.asarray(g), block_n=128, interpret=True)
    assert _close(G, np.asarray(Gj)) and _close(c[:, 0], np.asarray(cj))


@pytest.mark.parametrize("P,n,sms,per_sm", [
    (1, 7, 4, 1), (3, 129, 4, 2), (16, 300, 8, 1), (65, 1000, 16, 2),
    (100, 784, 132, 2), (100, 10, 132, 2), (128, 260, 4, 3)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_emulated_stream_stats_matches_pallas(P, n, sms, per_sm, accumulate):
    """The emulated data flow under sym (the upper triangle of D Dᵀ, its
    mirror from the same sum, C = D GMᵀ) within the reference's tolerance
    of ``stream_stats_pallas``; G exactly symmetric; with ``accumulate``
    the statistics added to running (G, C)."""
    rng = np.random.RandomState(P * 17 + n)
    D = rng.randn(P, n).astype(np.float32)
    GM = rng.randn(P, n).astype(np.float32)
    start = None
    if accumulate:
        S = rng.randn(P, P).astype(np.float32)
        start = (S + S.T, rng.randn(P, P).astype(np.float32))
    G, C, _, _ = _emulate(D, D, GM, True, sms, per_sm, out=start)
    assert not np.isnan(G).any() and not np.isnan(C).any()
    np.testing.assert_array_equal(G, G.T)
    Gj, Cj = stream_stats_pallas(jnp.asarray(D), jnp.asarray(GM),
                                 block_n=128, interpret=True)
    Gj, Cj = np.asarray(Gj, np.float64), np.asarray(Cj, np.float64)
    if accumulate:
        Gj, Cj = Gj + start[0], Cj + start[1]
    assert _close(G, Gj) and _close(C, Cj)


def test_f32_body_is_built_and_bound():
    """``cross_f32.cu`` is among the sources the build compiles, defines the
    two launchers the wrappers bind with the argument counts ``_build``
    gives them, names the TPU kernels it replaces, stages with ``cp.async``
    and sums across blocks after one grid barrier of a cooperative launch,
    with no float atomics; ``cross.cuh`` still serves the other calls."""
    src = _build.CSRC / "cross_f32.cu"
    assert src in _build.sources()
    text = src.read_text()
    sig = _build._SIGNATURES
    assert 'extern "C" int cross_f32_launch_config(int ma, int m1, int m2,' \
        in text
    assert len(sig["cross_f32_launch_config"]) == 9
    assert 'extern "C" int cross_f32_launch(const void* a, long long lda,' \
        in text
    assert len(sig["cross_f32_launch"]) == 23
    assert "repro/kernels/gram.py:60 gram_block_pallas" in text
    assert "repro/kernels/stream.py:102 stream_stats_pallas" in text
    assert "cp_async16(" in text and "cp_async4(" in text
    assert "cudaLaunchCooperativeKernel(" in text
    assert "cg::this_grid().sync()" in text
    assert "atomicAdd" not in text
    for name in ("kSideTiles = 16", "kStages = 3", "kNarrowThreads = 192",
                 "kStageBytes = 32768", "kThreads = 256", "kGranule = 128"):
        assert f"constexpr int {name};" in text
    assert '#include "cross.cuh"' in (_build.CSRC / "sketch.cu").read_text()
