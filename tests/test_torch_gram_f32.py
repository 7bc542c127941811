"""gram's f32 body (``csrc/gram_f32.cu``): its planner in ``kernels/gram.py``.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); here
the CPU holds what the wrapper decides from dtypes, shapes and pointers —
which body a call takes, the slices and the tile deal, the grid and the
scratch — and an emulation in numpy of the body's data flow (E = [U; g]
staged a slice at a time, padded with zero rows, 8 x 8 tiles, each entry
written through its target with its mirror, column blocks' partials summed
in block order) against ``repro.kernels.gram.gram_pallas`` in interpret
mode at the reference's tolerance (1e-4 of max(1, max |x|)).
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram import gram_pallas
from repro_torch.kernels import _build, gram

torch.set_num_threads(1)

PLAN_K = list(range(1, 10)) + [63, 64, 65, 100, 126, 127, 128, 500, 2000]


def _pair(K, n, dtype=torch.float32, g_dtype=None, u_in=0, g_in=0):
    """U (K, n) and g (n,), each starting ``u_in`` / ``g_in`` entries into a
    fresh buffer (a buffer's own start is 64-byte aligned)."""
    U = torch.zeros(K * n + u_in, dtype=dtype)[u_in:].view(K, n)
    g = torch.zeros(n + g_in, dtype=g_dtype or dtype)[g_in:]
    return U, g


_BODY_CASES = {
    "f32": (_pair(10, 1024), "f32"),
    "f32 at odd n": (_pair(10, 7850), "f32"),
    "f32, U 4 bytes in": (_pair(10, 1024, u_in=1), "f32"),
    "f32, K = 2 000": (_pair(2000, 68), "f32"),
    "mixed f32/bf16": (_pair(10, 1024, torch.float32, torch.bfloat16),
                       "cuda_core"),
    "mixed bf16/f32": (_pair(10, 1024, torch.bfloat16, torch.float32),
                       "cuda_core"),
    "bf16 eligible": (_pair(10, 1024, torch.bfloat16), "mma"),
    "bf16 at odd n": (_pair(10, 1001, torch.bfloat16), "realign"),
    "bf16, K = 128": (_pair(128, 64, torch.bfloat16), "cuda_core"),
    "bf16, U 2 bytes in": (_pair(10, 1024, torch.bfloat16, u_in=1),
                           "realign"),
}


@pytest.mark.parametrize("case", list(_BODY_CASES))
def test_body_choice(case):
    """f32/f32 -> ``f32``; eligible bf16 -> ``mma``; the other bf16 calls
    with K <= 127 -> ``realign``; the rest -> ``cuda_core``; read from
    dtypes, shapes and pointers alone."""
    (U, g), want = _BODY_CASES[case]
    assert gram._body(U, g) == want


@pytest.mark.parametrize("case", [("f32", 0, 0, True), ("odd n", 0, 0, False),
                                  ("U 4 bytes in", 1, 0, False),
                                  ("g 4 bytes in", 0, 1, False),
                                  ("U 16 bytes in", 4, 4, True)])
def test_f32_vec_rule(case):
    """The f32 body reads 16 bytes a row where every row starts 16-byte
    aligned (n % 4 == 0 and both pointers aligned), else 4 bytes."""
    name, u_in, g_in, want = case
    U, g = _pair(6, 7850 if name == "odd n" else 1024, u_in=u_in, g_in=g_in)
    assert gram._f32_vec(U, g) is want


def test_body_is_forced_and_checked():
    """``body=`` forces a body; a body the inputs cannot take raises, on the
    CPU before any launch (the wrapper wants CUDA tensors first)."""
    U, g = _pair(4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram.gram_cuda(U, g, body="cuda_core")
    assert gram.BODIES == ("mma", "realign", "f32", "cuda_core")
    gram.reset_body_launches()
    assert gram.body_launches() == {"mma": 0, "realign": 0, "f32": 0,
                                    "cuda_core": 0}


def _targets(K):
    """Every output the body writes, as counted entries: ("G", i, j), i <= j
    (a mirrored write counts once), or ("c", i)."""
    seen = Counter()
    if K <= gram.F32_STREAM_MAX_K:
        for t in gram.f32_stream_entries(K):
            seen[t] += 1
        return seen
    for sl in gram.f32_slices(K):
        tiles = sl.deal()
        assert len(tiles) == sl.tiles and len(set(tiles)) == sl.tiles
        for i, j in tiles:
            for r in range(8):
                for k in range(8):
                    x, y = 8 * i + r, 8 * j + k
                    assert x < sl.rows_a and y < sl.rows - (0 if sl.diag
                                                           else sl.rows_a)
                    t = sl.target(x, y)
                    if t is not None:
                        seen[("G", min(t[1:]), max(t[1:])) if t[0] == "G"
                             else t] += 1
    return seen


@pytest.mark.parametrize("K", PLAN_K)
def test_deal_and_slices_cover_every_entry_once(K):
    """The stream's sums (K <= 8), or the slices' tiles (K >= 9), reach every
    entry of G's upper triangle and of c exactly once."""
    seen = _targets(K)
    want = Counter([("G", i, j) for i in range(K) for j in range(i, K)]
                   + [("c", i) for i in range(K)])
    assert seen == want


@pytest.mark.parametrize("K", PLAN_K)
def test_slices_and_plan(K):
    """Up to K = 127 one slice holds [U; g]; above it nb = ceil(K / 127) row
    blocks of at most 127 rows, one slice a pair (K = 500: 10, 2 000: 136);
    every slice's staged rows and tiles fit the plan's, its phases fit the
    block's threads, and the shared memory fits an H100 block."""
    blocks = gram.f32_row_blocks(K)
    assert sum(r for _, r in blocks) == K
    assert all(1 <= r <= 127 for _, r in blocks)
    assert [a0 for a0, _ in blocks] == [sum(r for _, r in blocks[:a])
                                        for a in range(len(blocks))]
    slices = gram.f32_slices(K)
    assert len(slices) == gram.f32_num_slices(K)
    if K <= 127:
        assert len(slices) == 1
    assert {500: 10, 2000: 136}.get(K, len(slices)) == len(slices)
    if K <= gram.F32_STREAM_MAX_K:
        assert gram.f32_partial_floats(K) == K * (K + 3) // 2
        return
    plan = gram.f32_tile_plan(K)
    assert plan["budget"] == (192 if K in (63, 64, 65, 100, 126, 127)
                              else 256)
    for sl in slices:
        assert sl.rows + sl.rows // 8 <= plan["slots"]
        assert sl.tiles <= plan["max_tiles"]
        assert sl.tiles * sl.phases <= plan["threads"] <= plan["budget"]
        assert sl.rows_a <= gram.F32_MAX_ROWS
        assert sl.rows - (0 if sl.diag else sl.rows_a) <= gram.F32_MAX_ROWS
    assert plan["threads"] % 32 == 0
    assert plan["groups"] % min(sl.phases for sl in slices) == 0
    assert 16 * plan["groups"] * plan["slots"] <= gram.F32_STAGE_BYTES or \
        plan["groups"] == min(sl.phases for sl in slices)
    assert plan["smem_bytes"] <= 128 * 1024
    if K == 100:      # the K = 100 deal: 91 tiles at Kp = 104, 2 phases
        assert slices[0].rows == 104 and slices[0].tiles == 91
        assert plan["threads"] == 192 and slices[0].phases == 2


def test_largest_k_fits_the_grid():
    """``F32_MAX_K``: the last K whose nb(nb+1)/2 slices fit gridDim.y, as
    the source's ``k_ok``; the wrapper refuses K past it before a launch."""
    K = gram.F32_MAX_K
    assert gram.f32_num_slices(K) <= 65535 < gram.f32_num_slices(K + 1)


@pytest.mark.parametrize("n", [1, 68, 128, 130, 7850, (1 << 20) + 3, 6440960,
                               103024640])
@pytest.mark.parametrize("K", [1, 9, 16, 100, 128, 500, 2000])
@pytest.mark.parametrize("per_sm", [1, 2, 8])
def test_grid_covers_every_column_and_scratch(K, n, per_sm):
    """The grid's column ranges (whole 128-column granules, a multiple of a
    16-byte group) cover n; the blocks of all slices are one wave of
    ``per_sm`` on 132 SMs wherever a slice has more than one, as the
    cooperative launch needs; the scratch is zero where one block owns a
    slice, else every block's partial."""
    slices = gram.f32_num_slices(K)
    blocks, cols = gram.grid(n, 132, per_sm, slices)
    assert cols % 128 == 0 and cols % gram.F32_GROUP == 0
    assert blocks * cols >= n > (blocks - 1) * cols
    if blocks > 1:
        assert blocks * slices <= per_sm * 132
    floats = gram.f32_scratch_floats(K, blocks)
    if blocks == 1:
        assert floats == 0
    else:
        assert floats == slices * blocks * gram.f32_partial_floats(K)
    if n <= 128:
        assert blocks == 1 and floats == 0      # the fleet's n = 68


def _emulate(U, g, num_blocks, cols):
    """The f32 body's data flow in numpy (f64 sums): per column block, each
    slice's staged rows (zero padded), its tiles' 8 x 8 products, then the
    blocks' partials summed in block order and written through each entry's
    target (G mirrored)."""
    K, n = U.shape
    G = np.full((K, K), np.nan)
    c = np.full((K,), np.nan)
    E = np.concatenate([U, g[None, :]], 0).astype(np.float64)
    if K <= gram.F32_STREAM_MAX_K:
        parts = [E[:, b * cols:(b + 1) * cols] for b in range(num_blocks)]
        sums = sum(p @ p.T for p in parts)
        for t in gram.f32_stream_entries(K):
            if t[0] == "G":
                G[t[1], t[2]] = G[t[2], t[1]] = sums[t[1], t[2]]
            else:
                c[t[1]] = sums[t[1], K]
        return G, c
    for sl in gram.f32_slices(K):
        stage = np.zeros((sl.rows, n))
        stage[:sl.Ka] = U[sl.a0:sl.a0 + sl.Ka]
        if sl.diag:
            stage[sl.Ka] = g
        else:
            stage[sl.rows_a:sl.rows_a + sl.Kb] = U[sl.b0:sl.b0 + sl.Kb]
        side_b = stage if sl.diag else stage[sl.rows_a:]
        partial = np.zeros((num_blocks, sl.tiles, 8, 8))
        for b in range(num_blocks):
            cs = slice(b * cols, (b + 1) * cols)
            for q, (i, j) in enumerate(sl.deal()):
                partial[b, q] = (stage[8 * i:8 * i + 8, cs]
                                 @ side_b[8 * j:8 * j + 8, cs].T)
        total = partial.sum(0)
        for q, (i, j) in enumerate(sl.deal()):
            for r in range(8):
                for k in range(8):
                    t = sl.target(8 * i + r, 8 * j + k)
                    if t is None:
                        continue
                    if t[0] == "G":
                        G[t[1], t[2]] = G[t[2], t[1]] = total[q, r, k]
                    else:
                        c[t[1]] = total[q, r, k]
    return G, c


@pytest.mark.parametrize("K,n,per_sm", [(1, 300, 1), (5, 1001, 2),
                                        (8, 7, 1), (9, 513, 1),
                                        (17, 300, 2), (64, 257, 1),
                                        (100, 130, 3), (127, 64, 1),
                                        (128, 300, 1), (200, 68, 1)])
def test_emulated_body_matches_pallas(K, n, per_sm):
    """The emulated data flow over the planner's slices, tiles, targets and
    column blocks (a 4-SM card, so n of a few hundred splits) within the
    reference's tolerance of ``gram_pallas``; G exactly symmetric and
    every entry written."""
    rng = np.random.RandomState(K * 31 + n)
    U = rng.randn(K, n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    blocks, cols = gram.grid(n, 4, per_sm, gram.f32_num_slices(K))
    G, c = _emulate(U, g, blocks, cols)
    assert not np.isnan(G).any() and not np.isnan(c).any()
    np.testing.assert_array_equal(G, G.T)
    Gj, cj = gram_pallas(jnp.asarray(U), jnp.asarray(g), block_n=128,
                         interpret=True)
    Gj, cj = np.asarray(Gj), np.asarray(cj)
    for got, want in ((G, Gj), (c, cj)):
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) / scale <= 1e-4


def test_f32_body_is_built_and_bound():
    """``gram_f32.cu`` is among the sources the build compiles, defines the
    two launchers the wrapper binds with the argument counts ``_build``
    gives them, stages with ``cp.async`` and sums across blocks after one
    grid barrier of a cooperative launch, with no float atomics."""
    src = _build.CSRC / "gram_f32.cu"
    assert src in _build.sources()
    text = src.read_text()
    sig = _build._SIGNATURES
    assert 'extern "C" int gram_f32_launch_config(int K, int vec,' in text
    assert len(sig["gram_f32_launch_config"]) == 5
    assert 'extern "C" int gram_f32_launch(const void* U, const void* g,' \
        in text
    assert len(sig["gram_f32_launch"]) == 12
    assert sig["gram_f32_launch"][6] == sig["gram_f32_launch"][8] \
        == sig["gram_f32_launch"][9] == __import__("ctypes").c_int
    assert "cp_async16(" in text and "cp_async4(" in text
    assert "cudaLaunchCooperativeKernel(" in text
    assert "cg::this_grid().sync()" in text
    assert "atomicAdd" not in text
    for name in ("kStreamMaxK = 8", "kMaxRows = 128", "kStages = 3",
                 "kNarrowThreads = 192",
                 "kStageBytes = 32768", "kTileThreads = 256"):
        assert f"constexpr int {name};" in text
