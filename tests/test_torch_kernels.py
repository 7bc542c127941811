"""The port's kernels (``repro_torch.kernels``) against the JAX reference.

On the CPU the ops run their plain PyTorch versions; these are held against
``gram_pallas`` / ``gram_block_pallas`` / ``sketch_apply_pallas`` /
``combine_pallas`` and ``flash_decode_pallas`` in interpret mode at the
tolerances of ``tests/test_kernels.py`` (1e-4 f32 and 2e-2 bf16 for the
products, 1e-5 f32 and 3e-2 bf16 for combine, 2e-4 f32 and 3e-2 bf16 for
flash_decode, 1e-4 for lse_merge over seq shards).  The arithmetic of
flash_decode's tensor-core body (``csrc/decode_attn_mma.cu``) is emulated
here in f32 and held to 1e-4 of ``flash_decode_pallas`` and to the plain
f32 version's distance from an f64 attention; its splits and routing are
checked from the shapes.  ``stream_stats`` is held against the
reference in ``tests/test_torch_streamed.py``.  The CUDA kernels themselves are tested on the card
by ``tests/test_torch_cuda.py``.
"""
import ctypes
import itertools
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.combine import combine_pallas
from repro.kernels.decode_attn import flash_decode_pallas
from repro.kernels.gram import gram_block_pallas, gram_pallas
from repro.kernels.sketch import sketch_apply_pallas
from repro_torch.kernels import (_build, backends, flash_decode,
                                 force_backend, gram_and_cross,
                                 gram_block_and_cross, launch_counts,
                                 lse_merge, register_impl, registry,
                                 reset_launch_counts, sketch_apply,
                                 weighted_combine)
from repro_torch.kernels import ref
from repro_torch.kernels.combine import combine_cuda
from repro_torch.kernels.cross import grid as cross_grid
from repro_torch.kernels.decode_attn import (_mma_eligible, decode_mma_splits,
                                            decode_splits)
from repro_torch.kernels.gram import gram_cuda, grid, row_slices, scratch_rows
from repro_torch.kernels.rng_sketch import grid as sketch_grid
from repro_torch.kernels.topk import SMALL_MAX_N, single_block
from repro_torch.kernels.topk import grid as topk_grid

torch.set_num_threads(1)

GRAM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
COMBINE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _jnp_dtype(name):
    return jnp.bfloat16 if name == "bfloat16" else jnp.float32


def _torch_dtype(name):
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _pair(arr, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, jnp.float32).astype(_jnp_dtype(dtype))
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(_torch_dtype(dtype))
    return j, t


# ----------------------------------------------------------------- gram

@pytest.mark.parametrize("K,n,dtype", [
    (1, 1, "float32"), (3, 130, "bfloat16"), (10, 7850, "float32"),
    (10, 1001, "bfloat16"), (64, 257, "float32"), (64, 257, "bfloat16")])
def test_gram_plain_matches_pallas(K, n, dtype):
    rng = np.random.RandomState(K * 1000 + n)
    Uj, Ut = _pair(rng.randn(K, n) * 0.5, dtype)
    gj, gt = _pair(rng.randn(n), dtype)
    Gj, cj = gram_pallas(Uj, gj, block_n=128, interpret=True)
    G, c = gram_and_cross(Ut, gt)
    assert G.dtype == torch.float32 and c.dtype == torch.float32
    assert tuple(G.shape) == (K, K) and tuple(c.shape) == (K,)
    tol = GRAM_TOL[dtype]
    Gj, cj = np.asarray(Gj), np.asarray(cj)
    np.testing.assert_allclose(G.numpy(), Gj, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(Gj).max())))
    np.testing.assert_allclose(c.numpy(), cj, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(cj).max())))


def test_gram_zero_padding_exact():
    """Shapes off any tile boundary give exact sums (the reference pads with
    zero columns; the port must not change the result either way)."""
    G, c = gram_and_cross(torch.ones(3, 130), torch.ones(130))
    np.testing.assert_array_equal(G.numpy(), np.full((3, 3), 130.0))
    np.testing.assert_array_equal(c.numpy(), np.full((3,), 130.0))
    Gj, cj = gram_pallas(jnp.ones((3, 130)), jnp.ones((130,)), block_n=128,
                         interpret=True)
    np.testing.assert_array_equal(G.numpy(), np.asarray(Gj))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))


# --------------------------------------------------------------- combine

@pytest.mark.parametrize("K,n,dtype", [
    (1, 1, "float32"), (3, 999, "bfloat16"), (10, 7850, "float32"),
    (64, 513, "float32"), (64, 513, "bfloat16")])
def test_combine_plain_matches_pallas(K, n, dtype):
    rng = np.random.RandomState(K * 7 + n)
    Uj, Ut = _pair(rng.randn(K, n) * 0.3, dtype)
    wj, wt = _pair(rng.randn(n), dtype)
    a = rng.randn(K).astype(np.float32)
    out_j = combine_pallas(wj, Uj, jnp.asarray(a), block_n=512, interpret=True)
    out = weighted_combine(wt, Ut, torch.from_numpy(a))
    assert out.dtype == wt.dtype and tuple(out.shape) == (n,)
    tol = COMBINE_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_j, np.float32), rtol=tol, atol=tol)


def test_combine_zero_alpha_identity():
    w = torch.arange(300, dtype=torch.float32)
    out = weighted_combine(w, torch.ones(4, 300), torch.zeros(4))
    np.testing.assert_array_equal(out.numpy(), w.numpy())


# -------------------------------------------------------------- dispatch

def test_cpu_tensors_take_the_plain_version_and_count():
    reset_launch_counts()
    gram_and_cross(torch.ones(2, 5), torch.ones(5))
    weighted_combine(torch.ones(5), torch.ones(2, 5), torch.ones(2))
    weighted_combine(torch.ones(5), torch.ones(2, 5), torch.ones(2))
    counts = launch_counts()
    ops = ("combine", "flash_decode", "gram", "gram_block", "sign_sketch",
           "sign_sketch_adjoint", "sketch", "stream_stats", "topk")
    want = {f"{op}/{be}": 0 for op in ops for be in ("cuda", "meta", "torch")}
    want.update({"combine/torch": 2, "gram/torch": 1})
    assert counts == want
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_registry_misuse_raises():
    for op in ("gram", "combine", "topk", "sign_sketch",
               "sign_sketch_adjoint", "stream_stats", "gram_block", "sketch",
               "flash_decode"):
        assert backends(op) == ("cuda", "meta", "torch")
    with pytest.raises(KeyError, match="unknown kernel op"):
        registry.dispatch("bogus_op", torch.ones(1))
    with pytest.raises(KeyError, match="not registered"):
        gram_and_cross(torch.ones(2, 3), torch.ones(3), backend="bogus")
    with pytest.raises(KeyError, match="already registered"):
        register_impl("gram", "torch", ref.gram_ref)


def test_cuda_kernels_never_take_cpu_tensors():
    """Forcing the CUDA backend onto CPU tensors raises: the wrappers never
    fall back to the plain version, and never run a kernel off the card."""
    with force_backend("cuda"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            gram_and_cross(torch.ones(2, 3), torch.ones(3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        weighted_combine(torch.ones(3), torch.ones(2, 3), torch.ones(2),
                         backend="cuda")
    with pytest.raises(ValueError):
        gram_cuda(torch.ones(2, 3), torch.ones(3))
    with pytest.raises(ValueError):
        combine_cuda(torch.ones(3), torch.ones(2, 3), torch.ones(2))
    for op, args in (("topk", (torch.ones(3), 2)),
                     ("sign_sketch", (torch.ones(1, 3), 0, 2)),
                     ("sign_sketch_adjoint", (torch.ones(2), 0, 3)),
                     ("stream_stats", (torch.ones(2, 3), torch.ones(2, 3))),
                     ("gram_block", (torch.ones(2, 3), torch.ones(1, 3),
                                     torch.ones(3))),
                     ("sketch", (torch.ones(2, 3), torch.ones(4, 3)))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            registry.dispatch(op, *args, backend="cuda")
    assert all(n == 0 for key, n in launch_counts().items()
               if key.endswith("/cuda"))


def test_force_backend_pins_the_plain_version():
    reset_launch_counts()
    with force_backend("torch", op="gram"):
        gram_and_cross(torch.ones(2, 3), torch.ones(3))
    assert launch_counts()["gram/torch"] == 1
    assert registry._FORCED == []


@pytest.mark.parametrize("n", [1, 127, 128, 7850, (1 << 20) + 3, 1 << 24])
@pytest.mark.parametrize("sm_count,per_sm", [(1, 3), (132, 3), (132, 2)])
def test_gram_grid_covers_every_column(n, sm_count, per_sm):
    blocks, cols = grid(n, sm_count, per_sm)
    assert cols % 128 == 0
    assert 1 <= blocks <= per_sm * sm_count
    assert blocks * cols >= n > (blocks - 1) * cols


@pytest.mark.parametrize("K,slices,rows", [(1, 1, 4), (25, 1, 28),
                                            (64, 1, 68), (65, 3, 128),
                                            (100, 3, 128), (130, 6, 128)])
def test_gram_row_pairs_above_64(K, slices, rows):
    """Above 64 rows the kernel runs one grid slice per pair (a, b >= a) of
    64-row blocks: a diagonal slice stages one block and the g row, a cross
    slice two blocks, so a partial has at most 128 rows."""
    assert row_slices(K) == slices
    assert scratch_rows(K) == rows
    blocks, cols = grid(7850, 132, 3, slices)
    assert blocks * slices <= max(3 * 132, slices)
    assert blocks * cols >= 7850


@pytest.mark.parametrize("n", [1, 1000, 7850, (1 << 20) + 3])
def test_topk_and_sketch_grids_cover_every_entry(n):
    blocks, chunk = topk_grid(n, 132)
    assert blocks * chunk >= n > (blocks - 1) * chunk
    for K, m in ((1, 981), (8, 8192)):
        splits, cols, kc = sketch_grid(K, n, m, 132)
        assert splits * cols >= n > (splits - 1) * cols
        assert kc == K


# (n, k, one block?): the paper paths' summaries at n = 7 850 (k = 1 731,
# 577, 490), the smoke's ragged and tied shapes, the cap and one past it,
# and the model widths, which keep the multi-block radix select
@pytest.mark.parametrize("n,k,one_block", [
    (7850, 1731, True), (7850, 577, True), (7850, 490, True),
    *[(n, k, True) for n in (1, 130, 7850) for k in sorted({1, 17, n})
      if k <= n],
    (SMALL_MAX_N, 1, True), (SMALL_MAX_N, SMALL_MAX_N, True),
    (SMALL_MAX_N + 1, 1731, False), (SMALL_MAX_N + 1, SMALL_MAX_N + 1, False),
    ((1 << 20) + 3, ((1 << 20) + 3) // 16, False), ((1 << 20) + 3, 2048, False),
    (1 << 24, 1 << 20, False), (1 << 24, 2048, False)])
def test_topk_single_block_rule(n, k, one_block):
    assert single_block(n, k) is one_block


def test_topk_single_block_kernel_is_built_and_bound():
    """``csrc/topk.cu`` is among the sources the build compiles, defines the
    one-block launcher the wrapper binds, and caps n where the wrapper
    does."""
    src = _build.CSRC / "topk.cu"
    assert src in _build.sources()
    text = src.read_text()
    assert 'extern "C" int topk_small_launch(' in text
    assert f"constexpr int kSmallMaxN = {SMALL_MAX_N};" in text
    assert len(_build._SIGNATURES["topk_small_launch"]) == 6


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_key_covers_every_source():
    names = {p.name for p in _build.sources()}
    assert {"gram.cu", "combine.cu", "combine_vec.cu", "topk.cu",
            "rng_sketch.cu", "stream_stats.cu", "gram_block.cu",
            "sketch.cu", "sketch_mma.cu", "sketch_realign.cu",
            "cross_f32.cu", "gram_mma.cu", "gram_realign.cu"} <= names
    # a header edit rebuilds too (the hash covers every .cuh)
    assert (_build.CSRC / "rng_hash.cuh").is_file()
    assert (_build.CSRC / "cross.cuh").is_file()
    assert (_build.CSRC / "sketch_mma.cuh").is_file()
    assert (_build.CSRC / "gram_mma.cuh").is_file()
    assert (_build.CSRC / "realign.cuh").is_file()
    assert len(_build.source_hash()) == 16
    assert _build.build_dir().parent == _build.BUILD_ROOT


# ------------------------------------------ gram_block, sketch, combine out

@pytest.mark.parametrize("Ka,Kb,n,dtype", [(5, 7, 333, "float32"),
                                           (1, 1, 1, "float32"),
                                           (64, 32, 500, "float32"),
                                           (3, 65, 129, "bfloat16")])
def test_gram_block_plain_matches_pallas(Ka, Kb, n, dtype):
    rng = np.random.RandomState(Ka * 100 + Kb + n)
    uaj, uat = _pair(rng.randn(Ka, n), dtype)
    ubj, ubt = _pair(rng.randn(Kb, n), dtype)
    gj, gt = _pair(rng.randn(n), dtype)
    Gj, cj = gram_block_pallas(uaj, ubj, gj, block_n=128, interpret=True)
    reset_launch_counts()
    G, c = gram_block_and_cross(uat, ubt, gt)
    assert launch_counts()["gram_block/torch"] == 1
    assert G.dtype == torch.float32 and tuple(G.shape) == (Ka, Kb)
    assert tuple(c.shape) == (Ka,)
    tol = GRAM_TOL[dtype]
    np.testing.assert_allclose(G.numpy(), np.asarray(Gj), rtol=tol,
                               atol=tol * max(1.0, float(np.abs(Gj).max())))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=tol,
                               atol=tol * max(1.0, float(np.abs(cj).max())))


@pytest.mark.parametrize("K,m,n,dtype", [(5, 11, 333, "float32"),
                                         (1, 1, 7, "float32"),
                                         (8, 130, 1000, "bfloat16"),
                                         (8, 1024, 256, "bfloat16"),
                                         (8, 129, 1001, "bfloat16"),
                                         (3, 17, 1003, "bfloat16"),
                                         (8, 64, 4103, "float32")])
def test_sketch_apply_plain_matches_pallas(K, m, n, dtype):
    rng = np.random.RandomState(K + m + n)
    Uj, Ut = _pair(rng.randn(K, n), dtype)
    Rj, Rt = _pair(rng.randn(m, n), dtype)
    want = sketch_apply_pallas(Uj, Rj, block_n=128, interpret=True)
    reset_launch_counts()
    got = sketch_apply(Ut, Rt)
    assert launch_counts()["sketch/torch"] == 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (K, m)
    tol = GRAM_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))
    with pytest.raises(ValueError, match="disagree on n"):
        sketch_apply(Ut, Rt[:, :n - 1] if n > 1 else Rt[:, :0])
    with pytest.raises(ValueError, match="disagree on n"):
        sketch_apply_pallas(Uj, Rj[:, :n - 1] if n > 1 else Rj[:, :0],
                            interpret=True)


def test_combine_writes_into_out_and_may_update_in_place():
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(300).astype(np.float32))
    U = torch.from_numpy(rng.randn(4, 300).astype(np.float32))
    a = torch.from_numpy(rng.randn(4).astype(np.float32))
    want = weighted_combine(w, U, a)
    out = torch.empty(300)
    assert weighted_combine(w, U, a, out=out) is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    base = w.clone()
    assert weighted_combine(base, U, a, out=base) is base
    torch.testing.assert_close(base, want, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 255, 256, 7850, (1 << 20) + 3])
@pytest.mark.parametrize("slices", [1, 7, 16, 500])
def test_cross_grid_covers_every_column(n, slices):
    blocks, cols = cross_grid(n, 132, 2, slices)
    assert cols % 256 == 0
    assert 1 <= blocks and blocks * slices <= max(2 * 132, slices)
    assert blocks * cols >= n > (blocks - 1) * cols


def _bf16(P, width):
    return torch.zeros((P, width), dtype=torch.bfloat16)


_WIDE = _bf16(16, 1024)
_MMA_CASES = {
    "bf16 aligned": (_WIDE, _WIDE, True),
    "column view of aligned rows": (_WIDE[:, :1000], _WIDE[:, :1000], True),
    "offset view 16 bytes in": (_WIDE[:, 8:], _WIDE[:, 8:], True),
    "one column": (_WIDE[:, :1], _WIDE[:, :1], True),
    "f32": (_WIDE.float(), _WIDE.float(), False),
    "mixed f32/bf16": (_WIDE.float(), _WIDE, False),
    "mixed bf16/f32": (_WIDE, _WIDE.float(), False),
    "f16": (_WIDE.half(), _WIDE.half(), False),
    "P = 1": (_bf16(1, 32), _bf16(1, 32), True),
    "P = 32": (_bf16(32, 64), _bf16(32, 64), True),
    "P = 33": (_bf16(33, 64), _bf16(33, 64), False),
    "row stride 1 020 (% 8 = 4)": (_bf16(4, 1020), _bf16(4, 1020), False),
    "grads' row stride % 8 != 0": (_bf16(4, 1024)[:, :1020],
                                   _bf16(4, 1020), False),
    "data_ptr 2 bytes in": (_WIDE[:, 1:], _WIDE[:, 1:], False),
    "grads' data_ptr 2 bytes in": (_WIDE[:, 8:], _WIDE[:, 1:1017], False),
    "n = 0": (_WIDE[:, :0], _WIDE[:, :0], False),
}


@pytest.mark.parametrize("case", list(_MMA_CASES))
def test_mma_eligible_rule(case):
    """The tensor-core body takes bf16 D and GM with 1 <= P <= 32, n >= 1,
    row strides that are multiples of 8 elements and 16-byte aligned
    pointers; every other call keeps cross.cuh's body."""
    from repro_torch.kernels.stream import MMA_MAX_ROWS, _mma_eligible
    D, GM, want = _MMA_CASES[case]
    assert MMA_MAX_ROWS == 32
    assert _mma_eligible(D, GM) is want


def test_stream_stats_mma_body_is_built_and_bound():
    """``stream_stats.cu`` defines the tensor-core launcher the wrapper binds
    and issues bf16 ``mma.sync`` with f32 accumulators; the launch-config
    query takes the body as its second argument; ``cross.cuh`` still
    serves the other calls."""
    text = (_build.CSRC / "stream_stats.cu").read_text()
    sig = _build._SIGNATURES
    assert sig["stream_stats_launch_config"][:2] == [ctypes.c_int,
                                                     ctypes.c_int]
    assert len(sig["stream_stats_launch_config"]) == 4
    assert ('extern "C" int stream_stats_launch_config(int P, int mma,'
            in text)
    assert 'extern "C" int stream_stats_mma_launch(' in text
    assert len(sig["stream_stats_mma_launch"]) == 14
    # the bf16 mma.sync helper lives in mma.cuh, which both tensor-core
    # bodies include
    assert '#include "mma.cuh"' in text and "mma_bf16(" in text
    mma = (_build.CSRC / "mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert '#include "cross.cuh"' in text and "cross_finish<<<" in text


def _gram_pair(K, n, dtype=torch.bfloat16, g_dtype=None, u_in=0, g_in=0):
    """U (K, n) and g (n,), each starting ``u_in`` / ``g_in`` entries into a
    fresh buffer (a buffer's own start is 64-byte aligned)."""
    U = torch.zeros(K * n + u_in, dtype=dtype)[u_in:].view(K, n)
    g = torch.zeros(n + g_in, dtype=g_dtype or dtype)[g_in:]
    return U, g


_GRAM_MMA_CASES = {
    "bf16 aligned": (_gram_pair(10, 1024), True),
    "K = 1": (_gram_pair(1, 64), True),
    "K = 127": (_gram_pair(127, 64), True),
    "K = 128": (_gram_pair(128, 64), False),
    "n = 8": (_gram_pair(10, 8), True),
    "n = 7 850 (% 8 = 2)": (_gram_pair(10, 7850), False),
    "n = 2^20 + 3": (_gram_pair(1, (1 << 20) + 3), False),
    "f32": (_gram_pair(10, 1024, torch.float32), False),
    "mixed f32/bf16": (_gram_pair(10, 1024, torch.float32, torch.bfloat16),
                       False),
    "mixed bf16/f32": (_gram_pair(10, 1024, torch.bfloat16, torch.float32),
                       False),
    "f16": (_gram_pair(10, 1024, torch.float16), False),
    "data_ptr 16 bytes in": (_gram_pair(10, 1024, u_in=8, g_in=8), True),
    "data_ptr 2 bytes in": (_gram_pair(10, 1024, u_in=1), False),
    "grad's data_ptr 2 bytes in": (_gram_pair(10, 1024, g_in=1), False),
    "n = 0": (_gram_pair(10, 0), False),
}


@pytest.mark.parametrize("case", list(_GRAM_MMA_CASES))
def test_gram_mma_eligible_rule(case):
    """gram's tensor-core body takes U and g both bf16 with 1 <= K <= 127,
    n >= 1, n % 8 == 0 and 16-byte aligned pointers; every other call keeps
    gram.cu's body."""
    from repro_torch.kernels.gram import MMA_MAX_K, _mma_eligible
    (U, g), want = _GRAM_MMA_CASES[case]
    assert MMA_MAX_K == 127
    assert _mma_eligible(U, g) is want


def test_gram_mma_body_is_built_and_bound():
    """``gram_mma.cu`` defines the two launchers the wrapper binds, with the
    argument counts ``_build`` gives them; its body (in ``gram_mma.cuh``,
    which it includes, and ``realign.cuh``'s landing) stages with
    ``cp.async``, loads fragments with ``ldmatrix`` and multiplies through
    mma.cuh's bf16 ``mma.sync`` (the three PTX helpers live in mma.cuh);
    ``stream_stats.cu`` includes the same header."""
    src = _build.CSRC / "gram_mma.cu"
    assert src in _build.sources()
    assert '#include "gram_mma.cuh"' in src.read_text()
    # the body lives in gram_mma.cuh, which gram_realign.cu includes too,
    # its landing of 16-byte chunks in realign.cuh (shared with sketch)
    text = "".join((_build.CSRC / name).read_text() for name in
                   ("gram_mma.cu", "gram_mma.cuh", "realign.cuh"))
    sig = _build._SIGNATURES
    assert 'extern "C" int gram_mma_launch_config(int K, int* blocks_per_sm,' \
        in text
    assert sig["gram_mma_launch_config"] == [ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_int)]
    assert 'extern "C" int gram_mma_launch(const void* U, const void* g,' \
        in text
    assert len(sig["gram_mma_launch"]) == 11
    assert sig["gram_mma_launch"][6] == ctypes.c_int            # K
    assert sig["gram_mma_launch"][7] == ctypes.c_longlong       # n
    assert '#include "mma.cuh"' in text and "mma_bf16(" in text
    assert "ldmatrix_x4(" in text and "cp_async16(" in text
    mma = (_build.CSRC / "mma.cuh").read_text()
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in mma
    assert "cp.async.cg.shared.global" in mma
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert '#include "mma.cuh"' in (_build.CSRC / "stream_stats.cu").read_text()


@pytest.mark.parametrize("mt", range(1, 9))
def test_gram_mma_scratch_and_grid_cover_every_column_and_tile(mt):
    """For every K of one 16-row tile count MT (K = 1 .. 127 over the eight
    cases): the warps' tiles are disjoint, lie in the Kp x Kp partial, and
    cover every entry (i, j >= i) of [G | c]; the one-wave grid's column
    ranges are whole staged tiles and cover n."""
    from repro_torch.kernels.gram import (MMA_MAX_K, MMA_STAGE_COLS,
                                          MMA_WARPS, mma_deal, mma_rows)
    for K in range(max(1, 16 * mt - 16), min(16 * mt, MMA_MAX_K + 1)):
        Kp = mma_rows(K)
        assert Kp == 16 * mt and K + 1 <= Kp <= 128
        deal = mma_deal(K)
        assert len(deal) == MMA_WARPS
        tiles = [tile for warp in deal for tile in warp]
        assert len(tiles) == len(set(tiles)) == mt * (mt + 1)
        assert max(len(w) for w in deal) == -(-mt * (mt + 1) // MMA_WARPS)
        owner = {}
        for i, j in tiles:
            assert 0 <= 16 * i < Kp and 0 <= 8 * j < Kp and 8 * j + 7 >= 16 * i
            for r in range(16 * i, 16 * i + 16):
                for c in range(8 * j, 8 * j + 8):
                    owner[(r, c)] = (i, j)
        assert all((r, c) in owner for r in range(K) for c in range(r, K + 1))
        for n in (8, 72, 4104, 7856, 1 << 24):
            for per_sm in (1, 2, 4, 8):
                blocks, cols = grid(n, 132, per_sm)
                assert cols % MMA_STAGE_COLS == 0
                assert 1 <= blocks <= per_sm * 132
                assert blocks * cols >= n > (blocks - 1) * cols
                assert blocks * Kp * Kp * 4 <= 8 * 132 * 128 * 128 * 4


_GRAM_BODY_CASES = {
    "bf16 aligned": (_gram_pair(10, 1024), "mma"),
    "bf16, K = 1": (_gram_pair(1, 64), "mma"),
    "bf16, K = 127": (_gram_pair(127, 64), "mma"),
    "data_ptrs 16 bytes in": (_gram_pair(10, 1024, u_in=8, g_in=8), "mma"),
    "odd n (1 001)": (_gram_pair(10, 1001), "realign"),
    "n = 7 850 (% 8 = 2)": (_gram_pair(10, 7850), "realign"),
    "n = 2^20 + 3, K = 64": (_gram_pair(64, (1 << 20) + 3), "realign"),
    "n = 1": (_gram_pair(3, 1), "realign"),
    "K = 127, odd n": (_gram_pair(127, 65), "realign"),
    "U 2 bytes in": (_gram_pair(10, 1024, u_in=1), "realign"),
    "g 2 bytes in": (_gram_pair(10, 1024, g_in=1), "realign"),
    "U 14 bytes in": (_gram_pair(10, 1024, u_in=7), "realign"),
    "bf16, K = 128": (_gram_pair(128, 64), "cuda_core"),
    "bf16, K = 128, odd n": (_gram_pair(128, 65), "cuda_core"),
    "mixed f32/bf16": (_gram_pair(10, 1024, torch.float32, torch.bfloat16),
                       "cuda_core"),
    "mixed bf16/f32": (_gram_pair(10, 1024, torch.bfloat16, torch.float32),
                       "cuda_core"),
    "mixed bf16/f32, odd n": (_gram_pair(10, 1001, torch.bfloat16,
                                         torch.float32), "cuda_core"),
    "f32": (_gram_pair(10, 1024, torch.float32), "f32"),
    "f32, odd n": (_gram_pair(10, 1001, torch.float32), "f32"),
}


@pytest.mark.parametrize("case", list(_GRAM_BODY_CASES))
def test_gram_body_rule(case):
    """Each gram call names its body from dtypes, shapes and pointers:
    ``mma`` (gram_mma.cu) for aligned bf16 rows with K <= 127 and
    n % 8 == 0, ``realign`` (gram_realign.cu) for every other bf16 call
    with 1 <= K <= 127 and n >= 1 (odd n, U or g 2 bytes in), ``f32``
    (gram_f32.cu) for f32 U and g, ``cuda_core`` (gram.cu) for mixed dtypes
    and bf16 K >= 128."""
    from repro_torch.kernels import gram
    (U, g), body = _GRAM_BODY_CASES[case]
    assert gram.BODIES == ("mma", "realign", "f32", "cuda_core")
    assert gram._body(U, g) == body
    assert gram._mma_eligible(U, g) is (body == "mma")
    assert gram._realign_eligible(U, g) is (body in ("mma", "realign"))


def test_gram_bodies_are_tallied_and_refused_off_the_card():
    """``body_launches()`` has a key for each of the four bodies; the
    wrapper wants CUDA tensors before it reads ``body=``."""
    from repro_torch.kernels import gram
    gram.reset_body_launches()
    assert gram.body_launches() == {"mma": 0, "realign": 0, "f32": 0,
                                    "cuda_core": 0}
    U, g = _gram_pair(10, 1001)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram_cuda(U, g, body="realign")
    assert gram.body_launches() == {"mma": 0, "realign": 0, "f32": 0,
                                    "cuda_core": 0}


@pytest.mark.parametrize("n", [1, 7, 8, 130, 1001, 4103])
def test_gram_realign_stages_every_column_once(n):
    """The realigning body's staging over gram's own grid, mirrored
    (``gram.realign_shifts``, ``realign.realign_plan``): each of the K
    rows of U and g has its own shift, and over U and g at every offset
    into their buffers every shift 0-7 occurs (n >= 8); for every row,
    every block range of the one-wave grid at 1-4 blocks an SM (ragged last
    tiles included) and every tile, each landed chunk starts on a 16-byte
    boundary inside or after the granule of the row's first entry and is
    read only if it starts before the block's last column col1 (so no read
    starts past the row's last entry: U's last row and g end at their
    allocation); each entry takes the landed entry of its own column, the
    entries at or past col1 are zero, and over the blocks every column of
    every row is staged exactly once."""
    from repro_torch.kernels.gram import (MMA_MAX_K, MMA_STAGE_COLS,
                                          realign_shifts)
    from repro_torch.kernels.realign import realign_plan, realign_shift
    K = 10
    seen = set()
    for u_in, g_in in itertools.product(range(8), (0, 3, 5)):
        shifts = realign_shifts(1024 + 2 * u_in, 4096 + 2 * g_in, K, n)
        assert len(shifts) == K + 1 <= MMA_MAX_K + 1
        assert shifts[0] == u_in and shifts[K] == (g_in % 8)
        assert shifts == [realign_shift(1024 + 2 * (u_in + r * n))
                          for r in range(K)] + [realign_shift(4096 + 2 * g_in)]
        seen.update(shifts)
    assert seen == set(range(8)) or n < 8
    for per_sm, sms in itertools.product((1, 2, 3, 4), (2, 132)):
        blocks, cols = grid(n, sms, per_sm)
        assert cols % MMA_STAGE_COLS == 0
        for s in range(8):
            staged = Counter()
            for b in range(blocks):
                col0, col1 = b * cols, min(b * cols + cols, n)
                for base in range(col0, col1, MMA_STAGE_COLS):
                    chunks, entries, shifted = realign_plan(s, base, col1)
                    assert len(chunks) == 16 + (s != 0)
                    for col, read in chunks:
                        assert (col + s) % 8 == 0 and col >= -s
                        assert read is (col < col1 <= n)
                    for j, e in enumerate(entries):
                        if base + j >= col1:
                            assert e is None
                            continue
                        c, lane = e
                        assert chunks[c][1] and chunks[c][0] + lane == base + j
                        staged[base + j] += 1
                    assert shifted is (s != 0
                                       or col1 - base < MMA_STAGE_COLS)
            assert staged == Counter(range(n))


def test_gram_realign_body_is_built_and_bound():
    """``gram_realign.cu`` is built, defines the two launchers the wrapper
    binds with the argument counts and types ``_build`` gives them (the
    same as ``gram_mma.cu``'s), and runs the shared body of
    ``gram_mma.cuh`` with the realigned staging of ``realign.cuh``, which
    ``sketch_mma.cuh`` includes too."""
    src = _build.CSRC / "gram_realign.cu"
    assert src in _build.sources()
    text = src.read_text()
    sig = _build._SIGNATURES
    I, LL, VP = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    assert ('extern "C" int gram_realign_launch_config(int K, '
            'int* blocks_per_sm,' in text)
    assert sig["gram_realign_launch_config"] == \
        sig["gram_mma_launch_config"] == [I, ctypes.POINTER(I),
                                          ctypes.POINTER(I)]
    assert 'extern "C" int gram_realign_launch(const void* U, ' in text
    # U, g, partial, partial_floats, G, c, K, n, num_blocks,
    # cols_per_block, stream
    assert sig["gram_realign_launch"] == sig["gram_mma_launch"] == [
        VP, VP, VP, LL, VP, VP, I, LL, I, LL, VP]
    assert '#include "gram_mma.cuh"' in text
    assert "tc_launch<true>(" in text and "tc_launch_config<true>(" in text
    body = (_build.CSRC / "gram_mma.cuh").read_text()
    assert "template <int MT, bool kRealign>" in body
    assert '#include "realign.cuh"' in body
    assert "land_chunk<true>(" in body and "realign_rows<kIters>(" in body
    assert "tc_launch<false>(" in (_build.CSRC / "gram_mma.cu").read_text()
    shared = (_build.CSRC / "realign.cuh").read_text()
    assert "__funnelshift_r(" in shared and "__syncwarp()" in shared
    assert '#include "realign.cuh"' in (_build.CSRC
                                        / "sketch_mma.cuh").read_text()


def _rows(K, n, ld, dtype, skip):
    """A (K, n) view with rows ``ld`` entries apart (default n), starting
    ``skip`` entries into a fresh buffer (a buffer's own start is 64-byte
    aligned)."""
    ld = ld or n
    return torch.zeros(K * ld + skip, dtype=dtype)[skip:].as_strided(
        (K, n), (ld, 1))


def _block_triple(Ka, Kb, n, dtypes=(torch.bfloat16,) * 3, a_in=0, b_in=0,
                  g_in=0, lda=None, ldb=None):
    """U_a (Ka, n), U_b (Kb, n) and g (n,), each starting ``*_in`` entries
    into a fresh buffer, U_a and U_b with rows ``lda`` / ``ldb`` entries
    apart (default n)."""
    return (_rows(Ka, n, lda, dtypes[0], a_in),
            _rows(Kb, n, ldb, dtypes[1], b_in),
            torch.zeros(n + g_in, dtype=dtypes[2])[g_in:])


def _row_blocks(Ka, Kb, n):
    U = torch.zeros((Ka + Kb, n), dtype=torch.bfloat16)
    return U[:Ka], U[Ka:], torch.zeros(n, dtype=torch.bfloat16)


_F32, _BF16 = torch.float32, torch.bfloat16
_BLOCK_MMA_CASES = {
    "bf16, separate tensors": (_block_triple(64, 32, 1024), True),
    "bf16, row blocks of one matrix": (_row_blocks(64, 32, 1024), True),
    "row blocks, n = 8": (_row_blocks(5, 3, 8), True),
    "Ka = 1": (_block_triple(1, 5, 64), True),
    "Ka = 64": (_block_triple(64, 5, 64), True),
    "Ka = 65": (_block_triple(65, 5, 64), False),
    "Kb = 1": (_block_triple(10, 1, 64), True),
    "Kb = 63": (_block_triple(10, 63, 64), True),
    "Kb = 64": (_block_triple(10, 64, 64), False),
    "n = 7 850 (% 8 = 2)": (_block_triple(10, 5, 7850), False),
    "n = 2^20 + 3": (_block_triple(1, 1, (1 << 20) + 3), False),
    "n = 0": (_block_triple(10, 5, 0), False),
    "f32": (_block_triple(10, 5, 1024, (_F32,) * 3), False),
    "U_a f32": (_block_triple(10, 5, 1024, (_F32, _BF16, _BF16)), False),
    "U_b f32": (_block_triple(10, 5, 1024, (_BF16, _F32, _BF16)), False),
    "g f32": (_block_triple(10, 5, 1024, (_BF16, _BF16, _F32)), False),
    "f16": (_block_triple(10, 5, 1024, (torch.float16,) * 3), False),
    "row strides 1 032 (% 8 = 0)": (_block_triple(10, 5, 1024, lda=1032,
                                                  ldb=1032), True),
    "U_a's row stride 1 025 (odd)": (_block_triple(10, 5, 1024, lda=1025),
                                     False),
    "U_b's row stride 1 028 (% 8 = 4)": (_block_triple(10, 5, 1024,
                                                       ldb=1028), False),
    "data_ptrs 16 bytes in": (_block_triple(10, 5, 1024, a_in=8, b_in=8,
                                            g_in=8), True),
    "U_a's data_ptr 2 bytes in": (_block_triple(10, 5, 1024, a_in=1), False),
    "U_b's data_ptr 2 bytes in": (_block_triple(10, 5, 1024, b_in=1), False),
    "g's data_ptr 2 bytes in": (_block_triple(10, 5, 1024, g_in=1), False),
}


@pytest.mark.parametrize("case", list(_BLOCK_MMA_CASES))
def test_gram_block_mma_eligible_rule(case):
    """gram_block's tensor-core body takes U_a, U_b and g all bf16 with
    1 <= Ka <= 64, 1 <= Kb <= 63, n >= 1, n % 8 == 0, 16-byte aligned
    pointers and row strides that are multiples of 8; every other call
    keeps cross.cuh's body (gram_block.cu)."""
    from repro_torch.kernels.gram import (BLOCK_MMA_MAX_KA, BLOCK_MMA_MAX_KB,
                                          _block_mma_eligible)
    (ua, ub, g), want = _BLOCK_MMA_CASES[case]
    assert (BLOCK_MMA_MAX_KA, BLOCK_MMA_MAX_KB) == (64, 63)
    assert _block_mma_eligible(ua, ub, g) is want


@pytest.mark.parametrize("nb", range(1, 9))
@pytest.mark.parametrize("ma", range(1, 5))
def test_gram_block_mma_deal_covers_every_tile(ma, nb):
    """For every (Ka, Kb) of one instance (MA, NB): the warps own every
    (16 x 8) tile (i, j) of the (16·MA x 8·NB) partial exactly once, at
    most ceil(MA·NB / 8) a warp, so every entry of [G_ab | c_a] is written;
    the one-wave grid's column ranges are whole staged tiles and cover n."""
    from repro_torch.kernels.gram import (MMA_STAGE_COLS, MMA_WARPS,
                                          block_mma_deal, block_mma_rows)
    for Ka in range(16 * ma - 15, 16 * ma + 1):
        for Kb in range(max(1, 8 * nb - 8), 8 * nb):
            assert block_mma_rows(Ka, Kb) == (16 * ma, 8 * nb)
            deal = block_mma_deal(Ka, Kb)
            assert len(deal) == MMA_WARPS
            tiles = [tile for warp in deal for tile in warp]
            assert sorted(tiles) == [(i, j) for i in range(ma)
                                     for j in range(nb)]
            assert max(len(w) for w in deal) == -(-ma * nb // MMA_WARPS)
            covered = {(16 * i + r, 8 * j + c) for i, j in tiles
                       for r in range(16) for c in range(8)}
            assert all((r, c) in covered for r in range(Ka)
                       for c in range(Kb + 1))
    for n in (8, 72, 4104, 1 << 24):
        for per_sm in (1, 2, 4, 8):
            blocks, cols = grid(n, 132, per_sm)
            assert cols % MMA_STAGE_COLS == 0
            assert 1 <= blocks <= per_sm * 132
            assert blocks * cols >= n > (blocks - 1) * cols


def test_gram_block_mma_body_is_built_and_bound():
    """``gram_block_mma.cu`` defines the two launchers the wrapper binds,
    with the argument counts and types ``_build`` gives them, stages with
    ``cp.async``, loads fragments with ``ldmatrix`` and multiplies through
    mma.cuh's bf16 ``mma.sync``; ``gram_block.cu`` still runs cross.cuh."""
    src = _build.CSRC / "gram_block_mma.cu"
    assert src in _build.sources()
    text = src.read_text()
    sig = _build._SIGNATURES
    I, LL, VP = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    assert ('extern "C" int gram_block_mma_launch_config(int Ka, int Kb, '
            'int* blocks_per_sm,' in text)
    assert sig["gram_block_mma_launch_config"] == [
        I, I, ctypes.POINTER(I), ctypes.POINTER(I)]
    assert ('extern "C" int gram_block_mma_launch(const void* Ua, '
            'long long lda, int Ka,' in text)
    # Ua, lda, Ka, Ub, ldb, Kb, g, n, partial, partial_floats, num_blocks,
    # cols_per_block, G, c, stream
    assert sig["gram_block_mma_launch"] == [VP, LL, I, VP, LL, I, VP, LL, VP,
                                            LL, I, LL, VP, VP, VP]
    assert '#include "mma.cuh"' in text and "mma_bf16(" in text
    assert "ldmatrix_x4(" in text and "ldmatrix_x2(" in text
    assert "cp_async16(" in text and "for_warp(" in text
    mma = (_build.CSRC / "mma.cuh").read_text()
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in mma
    assert "cp.async.cg.shared.global" in mma
    assert '#include "cross.cuh"' in (_build.CSRC / "gram_block.cu").read_text()


# ------------------------------------------- sketch's tensor-core body

def _sketch_pair(K, m, n, dtypes=(_BF16, _BF16), u_in=0, r_in=0, ldu=None,
                 ldr=None):
    """U (K, n) and R (m, n), each starting ``*_in`` entries into a fresh
    buffer, with rows ``ldu`` / ``ldr`` entries apart (default n)."""
    return (_rows(K, n, ldu, dtypes[0], u_in),
            _rows(m, n, ldr, dtypes[1], r_in))


def _sketch_row_blocks(K, m, n):
    M = torch.zeros((K + m, n), dtype=_BF16)
    return M[:K], M[K:]


_SKETCH_MMA_CASES = {
    "bf16, separate tensors": (_sketch_pair(8, 1024, 1024), "mma"),
    "bf16, row blocks of one matrix": (_sketch_row_blocks(8, 129, 1024),
                                       "mma"),
    "row blocks, n = 1 001": (_sketch_row_blocks(8, 129, 1001), "realign"),
    "K = 1": (_sketch_pair(1, 129, 64), "mma"),
    "K = 64": (_sketch_pair(64, 129, 64), "mma"),
    "K = 65": (_sketch_pair(65, 129, 64), "cross"),
    "m = 1": (_sketch_pair(8, 1, 64), "mma"),
    "m = 1 025": (_sketch_pair(8, 1025, 1024), "mma"),
    "n = 8": (_sketch_pair(8, 129, 8), "mma"),
    "n = 7 850 (% 8 = 2)": (_sketch_pair(8, 129, 7850), "realign"),
    "n = 2^20 + 3": (_sketch_pair(1, 1, (1 << 20) + 3), "realign"),
    "n = 0": (_sketch_pair(8, 129, 0), "cross"),
    "f32": (_sketch_pair(8, 129, 1024, (_F32, _F32)), "f32"),
    "U f32, R bf16": (_sketch_pair(8, 129, 1024, (_F32, _BF16)), "cross"),
    "U bf16, R f32": (_sketch_pair(8, 129, 1024, (_BF16, _F32)), "cross"),
    "f16": (_sketch_pair(8, 129, 1024, (torch.float16,) * 2), "cross"),
    "row strides 1 032 (% 8 = 0)": (_sketch_pair(8, 129, 1024, ldu=1032,
                                                 ldr=1032), "mma"),
    "U's row stride 1 028 (% 8 = 4)": (_sketch_pair(8, 129, 1024, ldu=1028),
                                       "realign"),
    "R's row stride 1 025 (odd)": (_sketch_pair(8, 129, 1024, ldr=1025),
                                   "realign"),
    "data_ptrs 16 bytes in": (_sketch_pair(8, 129, 1024, u_in=8, r_in=8),
                              "mma"),
    "U's data_ptr 2 bytes in": (_sketch_pair(8, 129, 1024, u_in=1),
                                "realign"),
    "R's data_ptr 2 bytes in": (_sketch_pair(8, 129, 1024, r_in=1),
                                "realign"),
    "odd n (1 001), separate tensors": (_sketch_pair(8, 129, 1001),
                                        "realign"),
    "row strides 1 028": (_sketch_pair(8, 129, 1024, ldu=1028, ldr=1028),
                          "realign"),
    "K = 65, odd n": (_sketch_pair(65, 129, 1001), "cross"),
    "f32, K = 65": (_sketch_pair(65, 129, 1024, (_F32, _F32)), "f32"),
    "f32, odd n, row stride 1 025": (_sketch_pair(8, 129, 1001, (_F32, _F32),
                                                  ldr=1025), "f32"),
}


@pytest.mark.parametrize("case", list(_SKETCH_MMA_CASES))
def test_sketch_mma_eligible_rule(case):
    """sketch's tensor-core body takes U and R both bf16 with 1 <= K <= 64,
    any m, n >= 1, n % 8 == 0, 16-byte aligned pointers and row strides
    that are multiples of 8; every other call takes another body
    (:func:`test_sketch_body_rule`)."""
    from repro_torch.kernels.sketch import SKETCH_MMA_MAX_K, _mma_eligible
    (U, R), body = _SKETCH_MMA_CASES[case]
    assert SKETCH_MMA_MAX_K == 64
    assert _mma_eligible(U, R) is (body == "mma")


@pytest.mark.parametrize("case", list(_SKETCH_MMA_CASES))
def test_sketch_body_rule(case):
    """Each call names its body from dtypes, shapes, strides and pointers:
    ``mma`` (sketch_mma.cu) for aligned bf16 rows with K <= 64 and
    n % 8 == 0, ``realign`` (sketch_realign.cu) for the other bf16 calls
    with 1 <= K <= 64 and n >= 1, ``f32`` (cross_f32.cu) for f32 U and R,
    ``cross`` (sketch.cu) for the rest: mixed dtypes, K > 64 in bf16."""
    from repro_torch.kernels import sketch
    (U, R), body = _SKETCH_MMA_CASES[case]
    assert sketch.BODIES == ("mma", "realign", "f32", "cross")
    assert sketch._body(U, R) == body
    assert sketch._realign_eligible(U, R) is (body in ("mma", "realign"))


def test_sketch_bodies_are_tallied_and_refused_off_the_card():
    """``body_launches()`` has a key for each of the four bodies; the
    wrapper wants CUDA tensors before it reads ``body=``."""
    from repro_torch.kernels import sketch
    sketch.reset_body_launches()
    assert sketch.body_launches() == {"mma": 0, "realign": 0, "f32": 0,
                                      "cross": 0}
    U, R = _sketch_pair(8, 129, 1001)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sketch.sketch_apply_cuda(U, R, body="realign")


def _realign_rows(n, ld, start):
    """Shifts of 9 rows ``ld`` entries apart whose first starts ``start``
    entries past a 16-byte boundary."""
    from repro_torch.kernels.sketch import realign_shift
    return [realign_shift(1024 + 2 * (start + r * ld)) for r in range(9)]


@pytest.mark.parametrize("n", [1, 7, 8, 1001, 4103])
def test_sketch_realign_stages_every_entry_once(n):
    """The realign body's staging, mirrored (``sketch.realign_plan``): for
    every shift 0-7 and every block range of the one-wave grid (ragged
    last tiles included), each landed chunk starts on a 16-byte boundary,
    inside the 16-byte granule of the row's first entry or after it, and
    before the block's last column (so no read starts past the row's last
    entry); each entry of a tile takes the landed entry of its own column,
    from a chunk that was read; the entries past the range are zero; and
    over the blocks every column of the row is staged exactly once.  A row
    with shift 0 whose tile ends inside the range is not rewritten."""
    from repro_torch.kernels.sketch import (MMA_STAGE_COLS, mma_grid,
                                            realign_plan, realign_shift)
    assert [realign_shift(16 * 7 + 2 * k) for k in range(10)] == \
        [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]
    shifts = set()
    for ld, start in ((n, 0), (n, 3), (1028, 1), (n + 1, 5)):
        shifts.update(_realign_rows(n, ld, start))
    assert shifts == set(range(8)) or n < 8
    for s, per_sm, sms in itertools.product(range(8), (1, 2), (2, 132)):
        _, blocks, cols = mma_grid(n, 129, sms, per_sm)
        staged = Counter()
        for b in range(blocks):
            col0, col1 = b * cols, min(b * cols + cols, n)
            for base in range(col0, col1, MMA_STAGE_COLS):
                chunks, entries, shifted = realign_plan(s, base, col1)
                assert len(chunks) == 16 + (s != 0)
                for col, read in chunks:
                    assert (col + s) % 8 == 0 and col >= -s
                    assert read is (col < col1)
                for j, e in enumerate(entries):
                    if base + j >= col1:
                        assert e is None
                        continue
                    c, lane = e
                    assert chunks[c][1] and chunks[c][0] + lane == base + j
                    staged[base + j] += 1
                assert shifted is (s != 0 or col1 - base < MMA_STAGE_COLS)
                if not shifted:
                    assert entries == [divmod(j, 8) for j in range(128)]
        assert staged == Counter(range(n))


@pytest.mark.parametrize("K,m", [(8, 1024), (1, 1), (3, 17), (8, 129),
                                 (100, 65), (65, 1025)])
def test_sketch_f32_plan_covers_every_entry(K, m):
    """sketch's f32 calls on cross_f32.cu: A = U (K rows) against B1 = R (m
    rows), no B2.  Every slice's tiles reach each entry of S (K, m) exactly
    once as ("out1", k, j), at level 1 and with every group one tile; at
    the model shape (K = 8, m = 1 024) 8 slices of 1 x 16 tiles, a
    192-thread budget, 12 phases and two 16-group stages."""
    from repro_torch.kernels import cross
    assert cross.f32_shape_ok(K, m, 0, False)
    levels, cuts = [1], cross.F32Cuts.of(K, m, 0, False, 1)
    while not cuts.saturated():
        levels.append(levels[-1] + 1)
        cuts = cross.F32Cuts.of(K, m, 0, False, levels[-1])
    for level in (levels[0], levels[-1]):
        seen = Counter()
        for sl in cross.f32_slices(cross.F32Cuts.of(K, m, 0, False, level)):
            for q in range(sl.tiles):
                for e in range(64):
                    t = sl.target(*sl.entry(q, e), m, False)
                    if t is not None:
                        assert t[0] == "out1" and not t[3]
                        seen[t[1:3]] += 1
        assert seen == Counter((k, j) for k in range(K) for j in range(m))
    if (K, m) == (8, 1024):
        cuts = cross.F32Cuts.of(8, 1024, 0, False, 1)
        sl = cross.f32_slices(cuts)
        assert cuts.slices() == 8 and {(s.ta, s.tb) for s in sl} == {(1, 16)}
        plan = cross.f32_plan(cuts)
        assert plan["budget"] == 192 and plan["max_tiles"] == 16
        assert cross.f32_phases(plan["budget"], 16, 1 << 20) == 12
        # 136 staged rows in 153 slots: two stages of 16 groups, 256 bytes
        # of each row, in the 96 KB three 32 KB stages would take
        assert plan["slots"] == 153 and cross.f32_line_stages(153)
        assert (plan["groups"], plan["ring"]) == (16, 2)
        assert plan["smem_bytes"] == 2 * 16 * 153 * 16


@pytest.mark.parametrize("nb", range(1, 9))
def test_sketch_mma_deal_covers_every_tile(nb):
    """For every K of one instance NB: the warps own every (16 x 8) tile
    (i, j) of a slice's (128 x 8·NB) partial exactly once, warp w the row
    tile w; for m across the slice boundaries every entry of S_U is one
    partial entry of one slice; the one-wave grid's column ranges are whole
    staged tiles that cover n."""
    from repro_torch.kernels.sketch import (MMA_SLICE_ROWS, MMA_STAGE_COLS,
                                            MMA_WARPS, mma_deal, mma_grid,
                                            mma_rows, mma_slices)
    assert MMA_SLICE_ROWS == 16 * MMA_WARPS
    for K in range(8 * nb - 7, 8 * nb + 1):
        assert mma_rows(K) == 8 * nb
        deal = mma_deal(K)
        assert len(deal) == MMA_WARPS
        assert all(len(w) == nb and {i for i, _ in w} == {row}
                   for row, w in enumerate(deal))
        tiles = [tile for warp in deal for tile in warp]
        assert sorted(tiles) == [(i, j) for i in range(MMA_SLICE_ROWS // 16)
                                 for j in range(nb)]
        covered = {(16 * i + r, 8 * j + c) for i, j in tiles
                   for r in range(16) for c in range(8)}
        assert all((r, k) in covered for r in range(MMA_SLICE_ROWS)
                   for k in range(K))
        for m in (1, 15, 16, 17, 127, 128, 129, 255, 256, 1024, 1025):
            slices = mma_slices(m)
            assert (slices - 1) * MMA_SLICE_ROWS < m <= slices * MMA_SLICE_ROWS
            # column j of S_U is row j % 128 of slice j // 128's partial
            entries = {(j // MMA_SLICE_ROWS, j % MMA_SLICE_ROWS, k)
                       for j in range(m) for k in range(K)}
            assert len(entries) == K * m
            for per_sm in (1, 2):
                for n in (8, 72, 4104, 1 << 20, 1 << 22):
                    s, blocks, cols = mma_grid(n, m, 132, per_sm)
                    assert s == slices
                    assert cols % MMA_STAGE_COLS == 0
                    assert 1 <= blocks and s * blocks <= max(per_sm * 132, s)
                    assert blocks * cols >= n > (blocks - 1) * cols
    assert mma_grid(1 << 20, 1024, 132, 2) == (8, 33, 249 * 128)


def test_sketch_mma_body_is_built_and_bound():
    """``sketch_mma.cu`` defines the two launchers the wrapper binds, with
    the argument counts and types ``_build`` gives them; its body (in
    ``sketch_mma.cuh``, which it includes, and ``realign.cuh``'s landing)
    stages with ``cp.async``, loads fragments with ``ldmatrix`` and
    multiplies through mma.cuh's bf16 ``mma.sync``; ``sketch.cu`` still
    runs cross.cuh."""
    src = _build.CSRC / "sketch_mma.cu"
    assert src in _build.sources()
    assert '#include "sketch_mma.cuh"' in src.read_text()
    # its landing of 16-byte chunks lives in realign.cuh (shared with gram)
    text = "".join((_build.CSRC / name).read_text() for name in
                   ("sketch_mma.cu", "sketch_mma.cuh", "realign.cuh"))
    sig = _build._SIGNATURES
    I, LL, VP = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    assert ('extern "C" int sketch_mma_launch_config(int K, int m, '
            'int* blocks_per_sm,' in text)
    assert "long long* slices)" in text
    assert sig["sketch_mma_launch_config"] == [I, I, ctypes.POINTER(I),
                                               ctypes.POINTER(LL)]
    assert ('extern "C" int sketch_mma_launch(const void* U, long long ldu, '
            'int K,' in text)
    # U, ldu, K, R, ldr, m, n, partial, partial_floats, num_blocks,
    # cols_per_block, S, stream
    assert sig["sketch_mma_launch"] == [VP, LL, I, VP, LL, I, LL, VP, LL, I,
                                        LL, VP, VP]
    assert '#include "mma.cuh"' in text and "mma_bf16(" in text
    assert "ldmatrix_x4(" in text and "ldmatrix_x2(" in text
    assert "cp_async16(" in text
    assert '#include "cross.cuh"' not in text
    sketch_cu = (_build.CSRC / "sketch.cu").read_text()
    assert '#include "cross.cuh"' in sketch_cu
    assert "mma_bf16(" not in sketch_cu


def test_sketch_realign_body_is_built_and_bound():
    """``sketch_realign.cu`` is built, defines the two launchers the wrapper
    binds with the argument counts and types ``_build`` gives them (the
    same as ``sketch_mma.cu``'s), and runs the shared body of
    ``sketch_mma.cuh`` with its realigned staging (``realign.cuh``):
    aligned-down 16-byte ``cp.async`` chunks, a funnel shift between warp
    syncs."""
    src = _build.CSRC / "sketch_realign.cu"
    assert src in _build.sources()
    text = src.read_text()
    sig = _build._SIGNATURES
    I, LL, VP = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    assert ('extern "C" int sketch_realign_launch_config(int K, int m, '
            'int* blocks_per_sm,' in text)
    assert "long long* slices)" in text
    assert sig["sketch_realign_launch_config"] == [I, I, ctypes.POINTER(I),
                                                   ctypes.POINTER(LL)]
    assert ('extern "C" int sketch_realign_launch(const void* U, '
            'long long ldu, int K,' in text)
    # U, ldu, K, R, ldr, m, n, partial, partial_floats, num_blocks,
    # cols_per_block, S, stream
    assert sig["sketch_realign_launch"] == sig["sketch_mma_launch"] == [
        VP, LL, I, VP, LL, I, LL, VP, LL, I, LL, VP, VP]
    assert '#include "sketch_mma.cuh"' in text
    assert "tc_launch<true>(" in text and "tc_launch_config<true>(" in text
    body = (_build.CSRC / "sketch_mma.cuh").read_text()
    # the realigned staging's helpers live in realign.cuh, shared with gram
    assert '#include "realign.cuh"' in body
    body += (_build.CSRC / "realign.cuh").read_text()
    assert "template <int NB, bool kRealign>" in body
    assert "__funnelshift_r(" in body and "__syncwarp()" in body
    assert "if constexpr (kRealign)" in body
    assert "tc_launch<false>(" in (_build.CSRC / "sketch_mma.cu").read_text()


# ------------------------------------------------- combine's vec body

def _vec_case(K, n, u_dt=torch.float32, w_dt=None,
              u_in=0, w_in=0, out_in=None):
    """w (n,), U (K, n) and out (n,) or None, each starting ``*_in``
    entries into a fresh buffer (``out_in`` None: no out; "w": out is w)."""
    U = _rows(K, n, None, u_dt, u_in)
    w = torch.zeros(n + w_in, dtype=w_dt or u_dt)[w_in:]
    out = (None if out_in is None else w if out_in == "w"
           else torch.zeros(n + out_in, dtype=w.dtype)[out_in:])
    return w, U, out


_VEC_CASES = {
    "f32, n % 4 == 0": (_vec_case(3, 7840), True),
    "bf16, n % 8 == 0": (_vec_case(3, 4104, torch.bfloat16), True),
    "bf16 U into f32 w (the big-model slabs)": (
        _vec_case(16, 1024, torch.bfloat16, torch.float32), True),
    "f32 U into bf16 w": (_vec_case(16, 1024, torch.float32,
                                    torch.bfloat16), True),
    "f32, n = 7 850 (% 4 = 2: the sync path)": (_vec_case(10, 7850), False),
    "f32, n = 10 (the bias leaf)": (_vec_case(100, 10), False),
    "bf16, n = 4 (% 8 = 4)": (_vec_case(3, 4, torch.bfloat16), False),
    "bf16, n = 2^20 + 3": (_vec_case(1, (1 << 20) + 3, torch.bfloat16),
                           False),
    "f32, n = 4 100 (% 8 = 4, but % 4 = 0)": (_vec_case(2, 4100), True),
    "U 4 f32 entries in": (_vec_case(3, 1024, u_in=4), True),
    "U 1 f32 entry in": (_vec_case(3, 1024, u_in=1), False),
    "U 8 bf16 entries in": (_vec_case(3, 1024, torch.bfloat16, u_in=8),
                            True),
    "U 2 bf16 entries in": (_vec_case(3, 1024, torch.bfloat16, u_in=2),
                            False),
    "w 2 f32 entries in": (_vec_case(3, 1024, w_in=2), False),
    "out 4 f32 entries in": (_vec_case(3, 1024, out_in=4), True),
    "out 3 f32 entries in": (_vec_case(3, 1024, out_in=3), False),
    "out aliasing w": (_vec_case(3, 1024, out_in="w"), True),
    "out aliasing w, both 2 entries in": (_vec_case(3, 1024, w_in=2,
                                                    out_in="w"), False),
    "f16 U": (_vec_case(3, 1024, torch.float16, torch.float32), False),
    "f64 w": (_vec_case(3, 1024, torch.float32, torch.float64), False),
    "bf16 U a 256-column window of an 8 192-wide slab": (
        (torch.zeros(256), torch.zeros(16, 8192, dtype=torch.bfloat16)[
            :, 512:768], None), True),
    "f32 U a window of a 1 028-wide slab (rows 4 112 bytes apart)": (
        (torch.zeros(256), torch.zeros(3, 1028)[:, 256:512], None), True),
    "f32 U a window of a 1 030-wide slab (rows 4 120 bytes apart)": (
        (torch.zeros(256), torch.zeros(3, 1030)[:, 256:512], None), False),
    "f32 U the short last window (n = 6) of a 262-wide slab": (
        (torch.zeros(6), torch.zeros(3, 262)[:, 256:], None), False),
    "K = 4 096": (_vec_case(4096, 8), True),
    "K = 4 097": (_vec_case(4097, 8), False),
}


@pytest.mark.parametrize("case", list(_VEC_CASES))
def test_combine_vec_eligible_rule(case):
    """combine_vec.cu takes w and U each f32 or bf16, 1 <= K <= 4 096,
    every row of U 16-byte aligned (data_ptr, n · element size and the row
    stride · element size: a window of a wider slab qualifies where its
    slab's rows do), and w and out 16-byte aligned (out may be w); every
    other call keeps combine.cu."""
    from repro_torch.kernels.combine import _vec_eligible
    (w, U, out), want = _VEC_CASES[case]
    assert _vec_eligible(w, U, out) is want


@pytest.mark.parametrize("K,n,elem,want", [
    (100, 7840, 4, 8),                       # the streamed apply: 62 blocks
    (16, 1024, 2, 4),                        # a big-model layer-norm leaf
    (8, 4104, 2, 2),                         # a slice keeps >= 4 rows
    (3, 4104, 2, 1),                         # too few rows to split
    (10, 1 << 24, 4, 1), (10, 1 << 24, 2, 1),  # model widths
    (64, 1 << 24, 4, 1), (64, 1 << 24, 2, 1),
    (16, 8192 * 1024, 2, 1),                 # the big-model slabs
    (16, 1024 * 4096, 2, 1), (16, 1024 * 1024, 2, 1)])
def test_combine_vec_split(K, n, elem, want):
    """W_k is 1 where whole columns give every SM two blocks (every model
    width and big-model slab); it doubles where they do not, while each
    slice keeps four rows; the slices cover the rows in order."""
    from repro_torch.kernels.combine import (combine_vec_split, vec_grid,
                                             vec_row_slices)
    wk = combine_vec_split(K, n, elem, 132)
    assert wk == want
    slices = vec_row_slices(K, wk)
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert wk == 1 or all(k1 - k0 >= 4 for k0, k1 in slices)
    blocks, chunks = vec_grid(n, elem, wk, 8 * 132)
    if wk == 1 and K >= 8:      # whole columns fill the card
        assert chunks >= 2 * 132
    if (K, n) == (100, 7840):
        assert (blocks, chunks) == (62, 62)
    if (K, n, elem) == (64, 1 << 24, 4):      # 16 384 chunks over 528 slots
        assert vec_grid(n, elem, wk, 4 * 132) == (512, 16384)


def test_combine_vec_split_always_divides_the_block():
    """For any shape W_k is one of the instances (1, 2, 4, 8), each block's
    chunks cover n, and the blocks' chunk counts differ by at most one."""
    from repro_torch.kernels.combine import (VEC_SPLITS, combine_vec_split,
                                             vec_cols, vec_grid)
    rng = np.random.RandomState(0)
    for _ in range(300):
        K = int(rng.randint(1, 4097))
        elem = int(rng.choice([2, 4]))
        n = int(rng.randint(1, 1 << 22)) // vec_cols(elem) * vec_cols(elem)
        n = max(n, vec_cols(elem))
        sms = int(rng.choice([1, 66, 132]))
        wk = combine_vec_split(K, n, elem, sms)
        assert wk in VEC_SPLITS and 8 % wk == 0
        resident = int(rng.randint(1, 9)) * sms
        blocks, chunks = vec_grid(n, elem, wk, resident)
        cols = 8 // wk * 32 * vec_cols(elem)
        assert (chunks - 1) * cols < n <= chunks * cols
        assert 1 <= blocks <= min(chunks, resident)
        per_block = [len(range(b, chunks, blocks)) for b in range(blocks)]
        assert max(per_block) - min(per_block) <= 1
        assert max(per_block) == -(-chunks // resident)   # one wave's rounds


def _emulate_vec(w, U, a, wk):
    """combine_vec.cu's arithmetic in numpy: each row slice sums its rows
    in ascending k with one f32 fma a row (the product exact in f64, then
    one rounding), the slices' partials are added in order in f32, then w,
    then the result is rounded to w's dtype."""
    from repro_torch.kernels.combine import vec_row_slices
    U64 = U.float().double().numpy()
    a64 = a.double().numpy()
    parts = []
    for k0, k1 in vec_row_slices(U.shape[0], wk):
        acc = np.zeros(U.shape[1], np.float32)
        for k in range(k0, k1):
            acc = (a64[k] * U64[k] + acc.astype(np.float64)).astype(np.float32)
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    res = w.float().numpy() + total
    return torch.from_numpy(res).to(w.dtype)


@pytest.mark.parametrize("K,n,u_dt,w_dt", [
    (100, 7840, torch.float32, torch.float32),   # W_k = 8
    (16, 1024, torch.bfloat16, torch.float32),   # W_k = 4
    (8, 4104, torch.bfloat16, torch.float32)])   # W_k = 2
def test_combine_vec_split_order_matches_f64(K, n, u_dt, w_dt):
    """The split body's summation order, emulated on the CPU, is within
    1e-6 of an f64 sum (relative to max(1, max |out|)) and of the plain
    version, at the three splits the paths and tests reach."""
    from repro_torch.kernels.combine import combine_vec_split
    rng = np.random.RandomState(K + n)
    U = torch.from_numpy(rng.randn(K, n).astype(np.float32)).to(u_dt)
    w = torch.from_numpy(rng.randn(n).astype(np.float32)).to(w_dt)
    a = torch.from_numpy((rng.randn(K) / K).astype(np.float32))
    wk = combine_vec_split(K, n, U.element_size(), 132)
    assert wk > 1
    got = _emulate_vec(w, U, a, wk).double()
    f64 = w.double() + a.double() @ U.double()
    scale = max(1.0, float(f64.abs().max()))
    assert float((got - f64).abs().max()) / scale <= 1e-6
    plain = weighted_combine(w, U, a).double()
    assert float((got - plain).abs().max()) / scale <= 1e-6


def test_combine_vec_body_is_built_and_bound():
    """``combine_vec.cu`` defines the two launchers the wrapper binds, with
    the argument counts and types ``_build`` gives them, an instance for
    each (U dtype, w dtype, W_k) and 16-byte read-only loads of U;
    ``combine.cu`` is untouched by it."""
    from repro_torch.kernels.combine import VEC_SPLITS
    src = _build.CSRC / "combine_vec.cu"
    assert src in _build.sources()
    text = src.read_text()
    sig = _build._SIGNATURES
    I, LL, VP = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    assert ('extern "C" int combine_vec_launch_config(int u_bf16, int w_bf16, '
            'int wk, int K,' in text)
    assert sig["combine_vec_launch_config"] == [I, I, I, I,
                                                ctypes.POINTER(I)]
    assert ('extern "C" int combine_vec_launch(const void* w, const void* U, '
            'const void* alpha,' in text)
    # w, U, alpha, out, K, n, ld, u_bf16, w_bf16, wk, blocks, stream
    assert sig["combine_vec_launch"] == [VP, VP, VP, VP, I, LL, LL, I, I, I,
                                         I, VP]
    for wk in VEC_SPLITS:
        assert f"case {wk}: return reinterpret_cast<const void*>(" \
               f"combine_vec_kernel<TU, TW, {wk}>);" in text
    assert "ld.global.nc.L1::no_allocate.v4.u32" in text
    assert "atomicAdd" not in text
    assert "combine_vec" not in (_build.CSRC / "combine.cu").read_text()


def test_combine_cuda_body_choice_is_checked_before_launch():
    """A body name outside ("vec", "scalar") raises before anything is
    launched; CPU tensors raise as they always did."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        combine_cuda(torch.ones(8), torch.ones(2, 8), torch.ones(2),
                     body="vec")
    from repro_torch.kernels import combine
    assert combine.BODIES == ("vec", "scalar")
    combine.reset_body_launches()
    assert combine.body_launches() == {"vec": 0, "scalar": 0}


# --------------------------------------------------------- flash_decode

DECODE_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _decode_inputs(B, S, KV, G, hd, dtype, seed, lengths=None):
    rng = np.random.RandomState(seed)
    q = _pair(rng.randn(B, KV, G, hd), dtype)
    k = _pair(rng.randn(B, S, KV, hd), dtype)
    v = _pair(rng.randn(B, S, KV, hd), dtype)
    if lengths is None:
        lengths = rng.randint(1, S + 1, size=B)
    lengths = np.asarray(lengths, np.int32)
    return q, k, v, (jnp.asarray(lengths), torch.from_numpy(lengths))


def _assert_decode_close(got, want, dtype):
    tol = DECODE_TOL[dtype]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("G", [1, 3, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (37, None),
                                            (None, 5.0), (64, 30.0)])
def test_flash_decode_plain_matches_pallas(G, dtype, window, softcap):
    B, S, KV, hd = 3, 300, 2, 64
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(
        B, S, KV, G, hd, dtype, seed=G * 7 + len(dtype),
        lengths=[1, 173, S])
    reset_launch_counts()
    got = flash_decode(qt, kt, vt, lt, window=window, softcap=softcap)
    assert launch_counts()["flash_decode/torch"] == 1
    assert got[0].shape == (B, KV, G, hd) and got[1].shape == (B, KV, G, 1)
    assert got[0].dtype == got[1].dtype == torch.float32
    pallas = flash_decode_pallas(qj, kj, vj, lj, block_s=128, window=window,
                                 softcap=softcap, interpret=True)
    _assert_decode_close(got, pallas, dtype)
    _assert_decode_close(got, jref.flash_decode_ref(
        qj, kj, vj, lj, window=window, softcap=softcap), dtype)


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_lse_merge_over_seq_shards_matches_whole_cache(parts):
    """Shard the cache's seq axis, decode each shard, merge: the whole
    cache's (o, lse), as the reference's merge gives."""
    B, KV, G, hd = 2, 2, 3, 32
    S = 128 * parts
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(
        B, S, KV, G, hd, "float32", seed=parts, lengths=[S - 37, S])
    shard = S // parts
    os_, ls_, jos, jls = [], [], [], []
    for p in range(parts):
        lo = p * shard
        local = torch.clamp(lt - lo, 0, shard).to(torch.int32)
        o, lse = flash_decode(qt, kt[:, lo:lo + shard], vt[:, lo:lo + shard],
                              local)
        os_.append(o)
        ls_.append(lse)
        oj, lsej = jref.flash_decode_ref(
            qj, kj[:, lo:lo + shard], vj[:, lo:lo + shard],
            jnp.clip(lj - lo, 0, shard))
        jos.append(oj)
        jls.append(lsej)
    om, lm = lse_merge(torch.stack(os_), torch.stack(ls_))
    whole = flash_decode(qt, kt, vt, lt)
    ref_merged = jref.lse_merge_ref(jnp.stack(jos), jnp.stack(jls))
    for got, want in ((om, whole[0]), (lm, whole[1])):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for got, want in zip((om, lm), ref_merged):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_flash_decode_cuda_refuses_cpu_tensors():
    from repro_torch.kernels.decode_attn import flash_decode_cuda
    q = torch.zeros(1, 1, 1, 64)
    k = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode_cuda(q, k, k, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("B,S,KV,window", [
    (4, 256, 8, None), (8, 32768, 8, None), (4, 8192, 16, None),
    (4, 16384, 4, 4096), (1, 1, 1, None), (3, 97, 2, 30), (64, 100, 64, None),
    (2, 5000, 2, 10000), (1, 1 << 20, 1, 64)])
@pytest.mark.parametrize("resident", [132, 396, 1188])
def test_decode_splits_cover_the_rows(B, S, KV, window, resident):
    """The seq split comes from the shapes alone and covers every row once
    in whole multiples of 64 rows; the splits that can hold a query's rows
    (all S, or the last ``window``) fit one wave of resident blocks."""
    splits, rows = decode_splits(B, S, KV, resident, window)
    assert rows % 64 == 0 and 1 <= splits <= 4096
    assert (splits - 1) * rows < S <= splits * rows
    live = min(S, window) if window else S
    live_splits = -(-live // rows)
    assert B * KV * live_splits <= max(resident, B * KV)


# ------------------------------------- flash_decode's tensor-core body

def mma_split_rows(length, S, window, split, rows):
    """``[start, end)``: the cache rows that split ``split`` of a batch row
    of ``length`` reads in the tensor-core body, as ``decode_mma_partial``
    (``csrc/decode_attn_mma.cu``) computes them on the device (empty when
    start >= end)."""
    hi = min(length, S)
    lo = max(0, length - window) if window else 0
    start = lo + split * rows
    return start, min(hi, start + rows)


def _split_lengths(S, window):
    """Lengths 1..S, sampled: the ends, the 64-row edges, the window's
    edges and a spread between."""
    cand = {1, 2, 63, 64, 65, 127, 128, 129, S // 2, S - 1, S}
    if window:
        cand |= {window - 1, window, window + 1}
    cand |= set(np.linspace(1, S, 17).astype(int).tolist())
    return sorted(x for x in cand if 1 <= x <= S)


@pytest.mark.parametrize("B,S,KV,window", [
    (4, 256, 8, None), (8, 32768, 8, None), (4, 8192, 16, None),
    (4, 16384, 4, 4096), (1, 1, 1, None), (3, 97, 2, 30), (64, 100, 64, None),
    (2, 5000, 2, 10000), (1, 1 << 20, 1, 64)])
@pytest.mark.parametrize("resident", [132, 396, 1188])
def test_decode_mma_splits_cover_each_rows_live_window(B, S, KV, window,
                                                       resident):
    """The tensor-core body's splits come from the shapes alone, in whole
    64-row multiples, fill at most one wave (or one split a head), and for
    every length anchor at the row's own window: split j reads
    [lo + j·rows, min(lo + (j+1)·rows, len)), and together they read the
    live rows [lo, len) exactly once and nothing else."""
    splits, rows = decode_mma_splits(B, S, KV, resident, window)
    live = min(S, window) if window else S
    assert rows % 64 == 0 and splits >= 1
    assert (splits - 1) * rows < live <= splits * rows
    assert B * KV * splits <= max(resident, B * KV)
    for length in _split_lengths(S, window):
        lo = max(0, length - window) if window else 0
        ranges = [mma_split_rows(length, S, window, j, rows)
                  for j in range(splits)]
        at = lo
        for j, (start, end) in enumerate(ranges):
            assert start == lo + j * rows
            if start < end:             # contiguous, each row once
                assert start == at
                at = end
        assert at == length, (length, ranges)


def test_decode_mma_splits_shrink_starcoder2s_grid():
    """At starcoder2-15b's row (B=4, KV=4, window 4 096 of S=16 384) on the
    resident blocks of two blocks an SM of 132, the grid holds the 16
    splits of 256 rows a full window needs; the CUDA-core body's tiling of
    the whole cache holds 64."""
    assert decode_mma_splits(4, 16384, 4, 264, 4096) == (16, 256)
    assert decode_splits(4, 16384, 4, 264, 4096)[0] == 64


def _decode_view(shape, dtype, hd_pad=0, shift=0):
    """A (B, S, KV, hd) tensor of ``dtype``, optionally a view of a wider
    last dim (row stride hd + hd_pad) or starting ``shift`` entries into
    its buffer."""
    B, S, KV, hd = shape
    full = torch.zeros(B * S * KV * (hd + hd_pad) + shift, dtype=dtype)
    return full[shift:].view(B, S, KV, hd + hd_pad)[..., :hd]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", list(range(1, 17)))
def test_mma_eligible_routes_bf16_heads_to_the_tensor_cores(hd, G):
    bf16 = torch.bfloat16
    q = torch.zeros(2, 4, G, hd, dtype=bf16)
    k, v = (_decode_view((2, 33, 4, hd), bf16) for _ in range(2))
    assert _mma_eligible(q, k, v)
    # a layer of a stacked cache, and a view of every other head
    stacked = torch.zeros(3, 2, 33, 4, hd, dtype=bf16)
    assert _mma_eligible(q, stacked[1], stacked[2])
    wide = torch.zeros(2, 33, 8, hd, dtype=bf16)[:, :, 4:]
    assert _mma_eligible(q, wide, wide)


@pytest.mark.parametrize("case", ["f32", "f32_q", "f32_cache", "hd256",
                                  "G17", "k_stride", "v_shift", "q_shift",
                                  "q_view"])
def test_mma_eligible_keeps_the_rest_on_the_cuda_cores(case):
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, KV, G, hd = 2, 33, 4, 5, 128
    q = torch.zeros(B, KV, G, hd, dtype=bf16)
    k = v = _decode_view((B, S, KV, hd), bf16)
    if case == "f32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "f32_q":                       # no f32 operand is rounded
        q = q.float()
    elif case == "f32_cache":
        k = v = _decode_view((B, S, KV, hd), f32)
    elif case == "hd256":
        q = torch.zeros(B, KV, G, 256, dtype=bf16)
        k = v = _decode_view((B, S, KV, 256), bf16)
    elif case == "G17":
        q = torch.zeros(B, KV, 17, hd, dtype=bf16)
    elif case == "k_stride":                   # rows 2 bytes off 16
        k = _decode_view((B, S, KV, hd), bf16, hd_pad=1)
    elif case == "v_shift":
        v = _decode_view((B, S, KV, hd), bf16, shift=4)
    elif case == "q_shift":
        q = torch.zeros(B * KV * G * hd + 1, dtype=bf16)[1:].view(B, KV, G, hd)
    else:                                       # q not contiguous
        q = torch.zeros(B, KV, G, 2 * hd, dtype=bf16)[..., :hd]
    assert not _mma_eligible(q, k, v)


def _mma_body_emulation(q, k, v, lengths, window, softcap, resident,
                        parts=3):
    """The tensor-core body's arithmetic on the CPU in f32: splits anchored
    at each row's window (``decode_mma_splits``, ``mma_split_rows``), each
    split's 64-row tiles dealt 16 rows a warp to 4 warps, S = Q Kᵀ (exact
    bf16 products, f32 sums) times hd^-1/2, the cap, an online softmax per
    warp, P into O as ``parts`` bf16 parts (each the rest of p after the
    ones before, rounded; the kernel's 3, or 1: P rounded once), the warps
    merged in order, then the splits with the lse_merge arithmetic.
    q (B, KV, G, hd), k, v (B, S, KV, hd) bf16 tensors."""
    B, S, KV, hd = k.shape
    G = q.shape[2]
    splits, rows = decode_mma_splits(B, S, KV, resident, window)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    o = torch.zeros(B, KV, G, hd)
    lse = torch.zeros(B, KV, G, 1)
    for b in range(B):
        qf = q[b].float()                                   # (KV, G, hd)
        o_parts, l_parts = [], []
        for j in range(splits):
            s0, s1 = mma_split_rows(int(lengths[b]), S, window, j, rows)
            warps = []
            for w in range(4):
                m = torch.full((KV, G), -1e30)
                l = torch.zeros(KV, G)
                acc = torch.zeros(KV, G, hd)
                for t0 in range(s0 + 16 * w, s1, 64):
                    t1 = min(t0 + 16, s1)
                    kk = k[b, t0:t1].float().transpose(0, 1)   # (KV, n, hd)
                    vv = v[b, t0:t1].float().transpose(0, 1)
                    sc = (qf @ kk.transpose(1, 2)) * scale
                    if softcap is not None:
                        sc = torch.tanh(sc / softcap) * softcap
                    mx = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp(m - mx)
                    p = torch.exp(sc - mx[..., None])
                    l = l * corr + p.sum(-1)
                    rest, pv = p, []
                    for _ in range(parts):
                        part = rest.bfloat16().float()
                        rest = rest - part
                        pv.append(part @ vv)
                    acc = acc * corr[..., None] + sum(reversed(pv))
                    m = mx
                warps.append((m, l, acc))
            M = torch.stack([w_[0] for w_ in warps]).amax(0)
            L = sum(w_[1] * torch.exp(w_[0] - M) for w_ in warps)
            A = sum(w_[2] * torch.exp(w_[0] - M)[..., None] for w_ in warps)
            Lc = L.clamp(min=1e-30)
            o_parts.append(A / Lc[..., None])
            l_parts.append((M + torch.log(Lc))[..., None])
        if splits == 1:
            o[b], lse[b] = o_parts[0], l_parts[0]
        else:
            o[b], lse[b] = ref.lse_merge_ref(torch.stack(o_parts),
                                             torch.stack(l_parts))
    return o, lse


def _flash_decode_f64(q, k, v, lengths, window=None, softcap=None):
    """The plain version's arithmetic in f64 (``ref.flash_decode_ref``
    computes in f32 whatever its inputs)."""
    S, hd = k.shape[1], k.shape[3]
    s = torch.einsum("bkgd,bskd->bkgs", q.double() * hd ** -0.5, k.double())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S)[None, None, None, :]
    length = lengths.to(torch.int64)[:, None, None, None]
    ok = kpos < length
    if window is not None:
        ok = ok & (kpos > length - 1 - window)
    s = s.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    return (torch.einsum("bkgs,bskd->bkgd", torch.exp(s - lse), v.double()),
            lse)


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|), as the card tests gate."""
    want = torch.as_tensor(np.asarray(want, np.float64))
    scale = max(1.0, float(want.abs().max()))
    return float((got.double() - want).abs().max()) / scale


# the card's gate on the kernel against the plain version
MMA_DECODE_TOL = 1e-4


@pytest.mark.parametrize("name,B,S,KV,G,hd,window,softcap,lengths", [
    ("serve_path", 4, 256, 8, 5, 128, None, None, [1, 97, 200, 256]),
    ("window_g12", 3, 1000, 2, 12, 128, 300, None, [1, 1000, 301]),
    ("softcap", 2, 600, 2, 3, 64, None, 30.0, [600, 130])])
def test_mma_body_emulation_matches_pallas_and_f64(name, B, S, KV, G, hd,
                                                   window, softcap, lengths):
    """The tensor-core body's arithmetic, emulated, against
    ``flash_decode_pallas`` in interpret mode at the card's 1e-4, and
    against an f64 attention: with P in three bf16 parts it is as close to
    f64 as the plain f32 version (within 1.5x).  The errors of fewer parts
    are reported beside it: P rounded once to bf16 fails the 1e-4 gate, and
    two parts leave it farther from f64 than the plain version (which, on
    the card, took a full-width bf16 decode step's logits past the serve
    gate)."""
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(
        B, S, KV, G, hd, "bfloat16", seed=S + G, lengths=lengths)
    resident = 264                      # two blocks an SM of an H100's 132
    pallas = flash_decode_pallas(qj, kj, vj, lj, block_s=128, window=window,
                                 softcap=softcap, interpret=True)
    f64 = _flash_decode_f64(qt, kt, vt, lt, window=window, softcap=softcap)
    plain = ref.flash_decode_ref(qt, kt, vt, lt, window=window,
                                 softcap=softcap)
    errs = {"plain": max(_rel_err(a, b) for a, b in zip(plain, f64))}
    for parts in (3, 2, 1):
        got = _mma_body_emulation(qt, kt, vt, lt, window, softcap, resident,
                                  parts=parts)
        errs[parts] = max(_rel_err(a, b) for a, b in zip(got, f64))
        if parts == 3:
            errs["pallas"] = max(_rel_err(a, b) for a, b in zip(got, pallas))
    print(f"{name} off f64: plain f32 {errs['plain']:.3e}; P in 3 bf16 parts "
          f"{errs[3]:.3e} ({errs['pallas']:.3e} off pallas), 2 parts "
          f"{errs[2]:.3e}, 1 part {errs[1]:.3e}")
    assert errs["pallas"] <= MMA_DECODE_TOL
    assert errs[3] <= 1.5 * errs["plain"]
    assert errs[2] > 1.5 * errs["plain"]
    assert errs[1] > MMA_DECODE_TOL
