"""The port's CUDA kernels on the card (``@pytest.mark.cuda``).

Every test here decides inside itself (through the ``cuda_device`` fixture)
whether a CUDA device exists and skips without one, so every worker collects
the same tests.  The file imports torch and ``repro_torch`` only — no JAX —
so it runs on a machine that has just PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are relative to max(1, max |plain|): gram 1e-4 (f32 and bf16
inputs both accumulate in f32, so the kernel and ``torch.matmul`` differ in
summation order only); combine 1e-5 in f32 and 3e-2 for a bf16 output (one
bf16 rounding), as the reference's kernel tests, and its 16-byte body
(``combine_vec.cu``) bitwise equal to ``combine.cu`` wherever it does not
split the rows (W_k = 1: the same fmaf per row in k order) and bitwise
repeatable where it does; sign_sketch and its adjoint
1e-5 (f32 sums in another order), their col body (``rng_sketch_col.cu``)
also within 1e-5 of the first body (``rng_sketch.cu``); stream_stats, gram_block and sketch 1e-5
(the same products in f32, summed in another order; gram_block's and
sketch's tensor-core sweeps against an f64 product, where the plain f32
version of a short cancelling dot product is no oracle).  topk is held
exactly: the same values and indices as the plain version on the same
tensor.  The robust aggregators on the card against the same call on the
CPU at 1e-4 (the solve amplifies the kernels' summation-order
differences), krum's selection exactly.  flash_decode 1e-4 on o and lse (f32 sums in another order, and the
kernel's fast exp); the serving engine's greedy tokens exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.compress import CompressConfig
from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.edge import uniform_fleet
from repro_torch.fl import ServerConfig, run_hier_simulation, run_simulation
from repro_torch.hier import HierConfig, star_topology, two_tier_topology
from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_map
from repro_torch.kernels import (flash_decode, gram_and_cross,
                                 gram_block_and_cross, launch_counts,
                                 reset_launch_counts,
                                 sign_sketch, sign_sketch_adjoint,
                                 sketch_apply, stream_stats, topk_select,
                                 weighted_combine)
from repro_torch.kernels import decode_attn, ref, rng_sketch
from repro_torch.kernels.combine import combine_cuda
from repro_torch.kernels.gram import gram_block_cuda, gram_cuda
from repro_torch.kernels.rng_sketch import (sign_sketch_adjoint_cuda,
                                            sign_sketch_cuda)
from repro_torch.kernels.sketch import sketch_apply_cuda
from repro_torch.kernels.topk import SMALL_MAX_N, single_block, topk_cuda
from repro_torch.models.config import ArchConfig
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)
from repro_torch.serve import DecodeEngine, ModelBus

COMBINE_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want) -> float:
    scale = max(1.0, float(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) / scale


@pytest.mark.parametrize("K,n", [(1, 1), (3, 130), (10, 7850), (23, 7850),
                                 (25, 7850), (64, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_matches_plain(cuda_device, K, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K + n)
    U = torch.randn(K, n, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
    reset_launch_counts()
    G, c = gram_and_cross(U, g)
    G2, c2 = gram_and_cross(U, g)
    assert launch_counts()["gram/cuda"] == 2
    assert launch_counts()["gram/torch"] == 0
    assert torch.equal(G, G2) and torch.equal(c, c2)      # no float atomics
    Gr, cr = ref.gram_ref(U, g)
    assert torch.equal(G, G.T)
    assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4


def test_gram_kernel_mixed_input_dtypes(cuda_device):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    U = torch.randn(5, 1001, generator=gen, device=cuda_device)
    g = torch.randn(1001, generator=gen, device=cuda_device)
    for u, gg in ((U.bfloat16(), g), (U, g.bfloat16())):
        G, c = gram_and_cross(u, gg)
        Gr, cr = ref.gram_ref(u, gg)
        assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4


@pytest.mark.parametrize("K,n", [(1, 1), (3, 1023), (10, 7850), (64, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernel_matches_plain(cuda_device, K, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * n)
    U = torch.randn(K, n, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
    a = torch.randn(K, generator=gen, device=cuda_device)
    reset_launch_counts()
    out = weighted_combine(w, U, a)
    assert launch_counts()["combine/cuda"] == 1
    assert out.dtype == dtype and out.shape == (n,)
    assert _rel_err(out, ref.combine_ref(w, U, a)) <= COMBINE_TOL[dtype]


def test_combine_kernel_grid_stride(cuda_device):
    """More columns than one pass of the capped grid covers."""
    n = 132 * 8 * 1024 * 2 + 5
    U = torch.ones(2, n, device=cuda_device)
    w = torch.arange(n, device=cuda_device, dtype=torch.float32)
    out = weighted_combine(w, U, torch.tensor([0.5, 0.25], device=cuda_device))
    assert torch.equal(out, w + 0.75)


# combine_vec.cu: shapes at every W_k (100 x 7 840 splits 8 ways, 16 x 1 024
# 4, 8 x 4 104 2, the rest 1), with ragged last chunks, and all four
# (U, w) dtype pairs
COMBINE_VEC_SHAPES = [(1, 8), (3, 136), (100, 7840), (16, 1024), (8, 4104),
                      (17, 2056), (10, 1 << 20), (64, (1 << 20) + 8),
                      (5, 132 * 8 * 2048 * 2 + 8)]
DTYPE_PAIRS = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16)]


def _combine_case(gen, device, K, n, u_dt, w_dt):
    U = torch.randn(K, n, generator=gen, device=device).to(u_dt)
    w = torch.randn(n, generator=gen, device=device).to(w_dt)
    a = torch.randn(K, generator=gen, device=device) / K
    return w, U, a


@pytest.mark.parametrize("K,n", COMBINE_VEC_SHAPES)
@pytest.mark.parametrize("u_dt,w_dt", DTYPE_PAIRS)
def test_combine_vec_body_matches_plain_and_first_body(cuda_device, K, n,
                                                      u_dt, w_dt):
    """The 16-byte body within COMBINE_TOL of the plain version, two calls
    bitwise equal, and bitwise equal to combine.cu wherever W_k = 1 (the
    same fmaf per row in k order, then w); the tally counts each body."""
    from repro_torch.kernels import combine
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K + n)
    w, U, a = _combine_case(gen, cuda_device, K, n, u_dt, w_dt)
    assert combine._vec_eligible(w, U)
    wk = combine.combine_vec_split(K, n, U.element_size(),
                                   torch.cuda.get_device_properties(
                                       cuda_device).multi_processor_count)
    combine.reset_body_launches()
    reset_launch_counts()
    got = combine_cuda(w, U, a)
    again = weighted_combine(w, U, a)
    first = combine_cuda(w, U, a, body="scalar")
    assert combine.body_launches() == {"vec": 2, "scalar": 1}
    assert launch_counts()["combine/cuda"] == 3
    assert got.dtype == w_dt and got.shape == (n,)
    assert torch.equal(got, again)
    assert _rel_err(got, ref.combine_ref(w, U, a)) <= COMBINE_TOL[w_dt]
    assert _rel_err(first, ref.combine_ref(w, U, a)) <= COMBINE_TOL[w_dt]
    if wk == 1:
        assert torch.equal(got, first)


@pytest.mark.parametrize("K,n", [(100, 7840), (16, 1024), (10, 1 << 20)])
@pytest.mark.parametrize("u_dt,w_dt", DTYPE_PAIRS)
def test_combine_vec_body_in_place_and_ragged_tail(cuda_device, K, n, u_dt,
                                                   w_dt):
    """out = w in place gives the out-of-place result; into an out that
    is the head of a longer buffer, nothing past n is written."""
    from repro_torch.kernels import combine
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3 * K + n)
    w, U, a = _combine_case(gen, cuda_device, K, n, u_dt, w_dt)
    want = combine_cuda(w, U, a)
    combine.reset_body_launches()
    base = w.clone()
    ptr = base.data_ptr()
    assert combine_cuda(base, U, a, out=base) is base
    assert base.data_ptr() == ptr and torch.equal(base, want)
    buf = torch.full((n + 4096,), 7.0, device=cuda_device).to(w_dt)
    assert combine_cuda(w, U, a, out=buf[:n]).data_ptr() == buf.data_ptr()
    assert combine.body_launches() == {"vec": 2, "scalar": 0}
    assert torch.equal(buf[:n], want)
    assert bool((buf[n:] == 7.0).all())


def test_combine_vec_body_takes_aligned_views(cuda_device):
    """Row blocks of a stacked matrix and views 16 bytes into a buffer take
    the 16-byte body; views 4 bytes in keep combine.cu; both agree."""
    from repro_torch.kernels import combine
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    big = torch.randn(8 * 1024 + 4, generator=gen, device=cuda_device)
    a = torch.randn(3, generator=gen, device=cuda_device)
    w = torch.randn(1024, generator=gen, device=cuda_device)
    blocks = big[:8 * 1024].view(8, 1024)[2:5]
    shifted4 = big[4:3 * 1024 + 4].view(3, 1024)
    shifted1 = big[1:3 * 1024 + 1].view(3, 1024)
    combine.reset_body_launches()
    outs = [combine_cuda(w, U, a) for U in (blocks, shifted4, shifted1)]
    assert combine.body_launches() == {"vec": 2, "scalar": 1}
    for U, out in zip((blocks, shifted4, shifted1), outs):
        assert _rel_err(out, ref.combine_ref(w, U, a)) <= 1e-5


def test_combine_body_choice_is_checked(cuda_device):
    from repro_torch.kernels import combine
    U = torch.ones(2, 10, device=cuda_device)       # 40-byte rows
    w = torch.ones(10, device=cuda_device)
    a = torch.ones(2, device=cuda_device)
    assert not combine._vec_eligible(w, U)
    with pytest.raises(ValueError, match="vec body"):
        combine_cuda(w, U, a, body="vec")
    with pytest.raises(ValueError, match="body"):
        combine_cuda(w, U, a, body="wide")
    combine.reset_body_launches()
    assert torch.equal(combine_cuda(w, U, a), w + 2)
    assert torch.equal(combine_cuda(w, U, a, body="scalar"), w + 2)
    assert combine.body_launches() == {"vec": 0, "scalar": 2}


@pytest.mark.parametrize("K", [65, 100, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_past_64_rows(cuda_device, K, dtype):
    """K > 64 runs as one grid slice per pair (a, b >= a) of 64-row blocks
    (gram.cu's body; bf16 K = 65 and 100 at n = 7 850 too, since
    n % 8 != 0); each slice writes only its own entries of G and c, and the
    result stays bitwise repeatable."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K)
    U = torch.randn(K, 7850, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn(7850, generator=gen, device=cuda_device).to(dtype)
    reset_launch_counts()
    G, c = gram_and_cross(U, g)
    G2, c2 = gram_and_cross(U, g)
    assert launch_counts()["gram/cuda"] == 2
    assert torch.equal(G, G2) and torch.equal(c, c2)
    assert torch.equal(G, G.T)
    Gr, cr = ref.gram_ref(U, g)
    assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4


def _gram_f64(U, g):
    u = U.double()
    return u @ u.T, u @ g.double()


def _check_gram_mma(U, g):
    """Two calls of gram's tensor-core body: bitwise equal, G symmetric,
    within 1e-4 of the plain version and of an f64 product."""
    from repro_torch.kernels import gram
    gram.reset_body_launches()
    reset_launch_counts()
    G, c = gram_and_cross(U, g)
    G2, c2 = gram_and_cross(U, g)
    assert launch_counts()["gram/cuda"] == 2
    assert launch_counts()["gram/torch"] == 0
    assert gram.body_launches() == {"mma": 2, "cuda_core": 0}
    assert torch.equal(G, G2) and torch.equal(c, c2)      # no float atomics
    assert torch.equal(G, G.T)
    Gr, cr = ref.gram_ref(U, g)
    assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4
    G64, c64 = _gram_f64(U, g)
    assert _rel_err(G.double(), G64) <= 1e-4
    assert _rel_err(c.double(), c64) <= 1e-4
    return G, c


# every 16-row tile count MT = 1..8 of [U; g], its edges (K + 1 = 16, 17,
# 32, 33, ...), and n with a ragged last staged tile (n % 64 != 0)
GRAM_MMA_K = [1, 15, 16, 17, 31, 32, 63, 64, 65, 100, 127]
GRAM_MMA_N = [8, 64, 72, 4104, 65600]


@pytest.mark.parametrize("n", GRAM_MMA_N)
@pytest.mark.parametrize("K", GRAM_MMA_K)
def test_gram_mma_body(cuda_device, K, n):
    """U and g both bf16 with K <= 127, n % 8 == 0 and aligned pointers take
    the tensor-core body (csrc/gram_mma.cu)."""
    from repro_torch.kernels.gram import _mma_eligible
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 1009 + n)
    U = _randn(gen, (K, n), torch.bfloat16, cuda_device)
    g = _randn(gen, (n,), torch.bfloat16, cuda_device)
    assert _mma_eligible(U, g)
    _check_gram_mma(U, g)


def test_gram_mma_body_against_f64_at_model_width(cuda_device):
    """K = 100, n = 2^22 bf16: the tensor-core body and the plain f32
    version, each against an f64 product (the kernel within 1e-4)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(100)
    U = _randn(gen, (100, 1 << 22), torch.bfloat16, cuda_device)
    g = _randn(gen, (1 << 22,), torch.bfloat16, cuda_device)
    G, c = _check_gram_mma(U, g)
    G64, c64 = _gram_f64(U, g)
    Gr, cr = ref.gram_ref(U, g)
    kernel = max(_rel_err(G.double(), G64), _rel_err(c.double(), c64))
    plain = max(_rel_err(Gr.double(), G64), _rel_err(cr.double(), c64))
    print(f"gram K=100 n=2^22 bf16 against f64: kernel {kernel:.3e}, "
          f"plain {plain:.3e}")
    assert kernel <= 1e-4


def test_gram_other_calls_keep_the_cuda_core_body(cuda_device):
    """bf16 K = 128, bf16 with n % 8 != 0, mixed dtypes either way, f32,
    and a bf16 U starting 2 bytes into its buffer keep gram.cu's body."""
    from repro_torch.kernels import gram
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(128)
    bf16 = torch.bfloat16
    shifted = _randn(gen, (10 * 1024 + 1,), bf16, cuda_device)[1:]
    g1024 = _randn(gen, (1024,), bf16, cuda_device)
    cases = [(_randn(gen, (128, 1024), bf16, cuda_device), g1024),
             (_randn(gen, (10, 1001), bf16, cuda_device),
              _randn(gen, (1001,), bf16, cuda_device)),
             (_randn(gen, (10, 1024), torch.float32, cuda_device), g1024),
             (_randn(gen, (10, 1024), bf16, cuda_device), g1024.float()),
             (_randn(gen, (10, 1024), torch.float32, cuda_device),
              g1024.float()),
             (shifted.view(10, 1024), g1024)]
    for U, g in cases:
        assert not gram._mma_eligible(U, g)
        gram.reset_body_launches()
        G, c = gram_and_cross(U, g)
        assert gram.body_launches() == {"mma": 0, "cuda_core": 1}
        Gr, cr = ref.gram_ref(U, g)
        assert torch.equal(G, G.T)
        assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4


def _tie_vectors(device, n=130):
    ar = torch.arange(n, device=device)
    return {
        "all_equal": torch.full((n,), 2.5, device=device)
        * torch.where(ar % 3 == 0, -1.0, 1.0),
        "zeros": torch.zeros(n, device=device),
        "signed_zeros": torch.where(ar % 2 == 0, 0.0, -0.0),
        "few_values": (ar % 4).float() - 1.5,
        "infs": torch.where(ar % 5 == 0, float("inf"),
                            torch.where(ar % 7 == 0, float("-inf"),
                                        (ar % 11).float() - 5.0)),
    }


def _assert_topk_equal(got, want):
    assert torch.equal(got[1], want[1])
    # values bitwise (keeps the sign of -0.0)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


# n: ragged, the paths' 7 850, the one-block cap and one past it (the
# multi-block radix select), and a model width
TOPK_N = [1, 130, 7850, SMALL_MAX_N, SMALL_MAX_N + 1, (1 << 20) + 3]


@pytest.mark.parametrize("n", TOPK_N)
@pytest.mark.parametrize("k", [1, 17, 1731, "n"])
def test_topk_kernel_matches_plain(cuda_device, n, k):
    k = n if k == "n" else min(k, n)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n + k)
    v = torch.randn(n, generator=gen, device=cuda_device)
    reset_launch_counts()
    got = topk_select(v, k)
    assert launch_counts()["topk/cuda"] == 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_topk_equal(got, ref.topk_ref(v, k))
    again = topk_select(v, k)
    assert launch_counts()["topk/cuda"] == 2
    _assert_topk_equal(again, got)                     # bitwise repeatable


@pytest.mark.parametrize("case", ["all_equal", "zeros", "signed_zeros",
                                  "few_values", "infs"])
@pytest.mark.parametrize("n", [130, 7850, SMALL_MAX_N, SMALL_MAX_N + 1])
@pytest.mark.parametrize("k", [1, 17, 130, 1731, "n"])
def test_topk_kernel_ties(cuda_device, case, n, k):
    k = n if k == "n" else min(k, n)
    v = _tie_vectors(cuda_device, n)[case]
    _assert_topk_equal(topk_cuda(v, k), ref.topk_ref(v, k))


@pytest.mark.parametrize("n,k", [(7850, 1731), (7850, 577), (7850, 490),
                                 (SMALL_MAX_N, SMALL_MAX_N)])
def test_topk_single_block_is_one_launch(cuda_device, n, k):
    """At the paths' shapes a call is one kernel on the card (the one-block
    select-and-order), counted once."""
    from torch.profiler import ProfilerActivity, profile
    assert single_block(n, k)
    v = torch.randn(n, device=cuda_device)
    topk_cuda(v, k)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        topk_cuda(v, k)
        torch.cuda.synchronize()
    assert launch_counts()["topk/cuda"] == 1
    on_card = [(e.key, e.count) for e in prof.key_averages()
               if e.self_device_time_total > 0
               and not e.key.startswith(("aten::", "cuda"))]
    assert len(on_card) == 1 and on_card[0][1] == 1, on_card
    assert "topk_small" in on_card[0][0], on_card


@pytest.mark.parametrize("K,n,m", [(1, 7850, 981), (1, 7850, 1962),
                                   (3, 130, 17), (8, 4097, 300),
                                   (11, 1000, 129), (1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sign_sketch_kernel_matches_plain(cuda_device, K, n, m, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * n + m)
    U = torch.randn(K, n, generator=gen, device=cuda_device).to(dtype)
    seed = 0x9E3779B1 ^ (K * 7919 + m)
    reset_launch_counts()
    S = sign_sketch(U, seed, m)
    S2 = sign_sketch(U, seed, m)
    assert launch_counts()["sign_sketch/cuda"] == 2
    assert S.shape == (K, m) and S.dtype == torch.float32
    assert torch.equal(S, S2)                          # no float atomics
    assert _rel_err(S, ref.rng_sketch_ref(U, seed, m)) <= 1e-5


@pytest.mark.parametrize("m,n", [(981, 7850), (1962, 7850), (17, 130),
                                 (300, 4097), (1, 1)])
def test_sign_sketch_adjoint_kernel_matches_plain(cuda_device, m, n):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m + n)
    s = torch.randn(m, generator=gen, device=cuda_device)
    reset_launch_counts()
    out = sign_sketch_adjoint(s, 12345, n)
    assert launch_counts()["sign_sketch_adjoint/cuda"] == 1
    assert torch.equal(out, sign_sketch_adjoint(s, 12345, n))
    assert _rel_err(out, ref.rng_sketch_adjoint_ref(s, 12345, n)) <= 1e-5


# the col body (csrc/rng_sketch_col.cu) at the shapes above and past 2^16
# columns, against the plain version and the first body (rng_sketch.cu)
SIGN_COL_SHAPES = [(1, 7850, 981), (1, 7850, 1962), (3, 130, 17),
                   (8, 4097, 300), (11, 1000, 129), (1, 1, 1), (1, 65539, 77),
                   (8, 65539, 300), (2, 65539, 4100)]


@pytest.mark.parametrize("K,n,m", SIGN_COL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sign_sketch_col_body_matches_plain_and_first(cuda_device, K, n, m,
                                                      dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * n + m + 1)
    U = torch.randn(K, n, generator=gen, device=cuda_device).to(dtype)
    seed = 0x9E3779B1 ^ (K * 7919 + m)
    rng_sketch.reset_body_launches()
    S = sign_sketch(U, seed, m)
    S2 = sign_sketch(U, seed, m)
    first = sign_sketch_cuda(U, seed, m, body="first")
    assert rng_sketch.body_launches()["sign_sketch"] == {"col": 2, "first": 1}
    assert torch.equal(S, S2)                          # no float atomics
    plain = ref.rng_sketch_ref(U, seed, m)
    assert _rel_err(S, plain) <= 1e-5
    assert _rel_err(S, first) <= 1e-5


@pytest.mark.parametrize("m,n", [(m, n) for _, n, m in SIGN_COL_SHAPES]
                         + [(8192, (1 << 20) + 3)])
def test_sign_sketch_adjoint_col_body_matches_plain_and_first(cuda_device, m,
                                                              n):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m * 3 + n)
    s = torch.randn(m, generator=gen, device=cuda_device)
    rng_sketch.reset_body_launches()
    out = sign_sketch_adjoint(s, 777, n)
    out2 = sign_sketch_adjoint(s, 777, n)
    first = sign_sketch_adjoint_cuda(s, 777, n, body="first")
    assert rng_sketch.body_launches()["sign_sketch_adjoint"] == {
        "col": 2, "first": 1}
    assert torch.equal(out, out2)
    assert _rel_err(out, ref.rng_sketch_adjoint_ref(s, 777, n)) <= 1e-5
    assert _rel_err(out, first) <= 1e-5


@pytest.mark.parametrize("K", [1, 3, 8])
def test_sign_sketch_col_is_one_launch(cuda_device, K):
    """Up to 8 rows of U, a call is one kernel on the card (the splits are
    added inside the launch, in a cluster), counted once."""
    from torch.profiler import ProfilerActivity, profile
    U = torch.randn(K, 7850, device=cuda_device)
    sign_sketch(U, 5, 1962)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sign_sketch(U, 5, 1962)
        torch.cuda.synchronize()
    assert launch_counts()["sign_sketch/cuda"] == 3
    on_card = [(e.key, e.count) for e in prof.key_averages()
               if e.self_device_time_total > 0
               and not e.key.startswith(("aten::", "cuda"))]
    # a profiler window may lose its first launches, never add one
    assert len(on_card) == 1 and 1 <= on_card[0][1] <= 3, on_card
    assert "sign_sketch_col" in on_card[0][0], on_card


def test_sign_matrix_same_on_card_and_cpu(cuda_device):
    for seed in (0, 1, 0xFFFFFFFF):
        cpu = ref.rng_sign_matrix(seed, 33, 500, col0=4000)
        card = ref.rng_sign_matrix(seed, 33, 500, col0=4000,
                                   device=cuda_device)
        assert torch.equal(card.cpu(), cpu)


def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    U = torch.ones(65, 8, device=cuda_device)
    with pytest.raises(ValueError, match="K=0"):
        gram_cuda(U[:0], torch.ones(8, device=cuda_device))
    with pytest.raises(TypeError):
        gram_cuda(U[:2].double(), torch.ones(8, device=cuda_device).double())
    with pytest.raises(ValueError, match="contiguous"):
        gram_cuda(torch.ones(8, 2, device=cuda_device).T,
                  torch.ones(8, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gram_cuda(U[:2], torch.ones(8))
    with pytest.raises(TypeError, match="alpha"):
        combine_cuda(torch.ones(8, device=cuda_device), U[:2],
                     torch.ones(2, device=cuda_device).half())
    v = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        topk_cuda(torch.ones(8), 2)
    with pytest.raises(TypeError, match="float32"):
        topk_cuda(v.double(), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sign_sketch_cuda(torch.ones(1, 8), 0, 4)
    with pytest.raises(TypeError):
        sign_sketch_cuda(U[:1].half(), 0, 4)
    with pytest.raises(ValueError, match="uint32"):
        sign_sketch_cuda(U[:1], -1, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sign_sketch_adjoint_cuda(torch.ones(4), 0, 8)
    with pytest.raises(TypeError, match="float32"):
        sign_sketch_adjoint_cuda(v.bfloat16(), 0, 8)


def test_path_runs_through_the_cuda_kernels(cuda_device):
    xs, ys = make_synthetic(1.0, 1.0, num_devices=12, samples_per_device=30,
                            dim=20, seed=1)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 20)[:100], ys.reshape(-1)[:100], 10)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=20, num_classes=10), 0)
    cfg = ServerConfig(aggregator="contextual", num_devices=12,
                       clients_per_round=5, lr=0.1, batch_size=10,
                       max_epochs=3)
    reset_launch_counts()
    res = run_simulation("cuda", logistic_loss, logistic_apply, params, ds,
                         cfg, num_rounds=3)
    counts = launch_counts()
    assert counts["gram/cuda"] == 3 and counts["combine/cuda"] == 3
    assert counts["gram/torch"] == 0 and counts["combine/torch"] == 0
    assert np.isfinite(res.train_loss).all()


@pytest.mark.parametrize("scheme,topo", [("topk", "two_tier"),
                                         ("sign_sketch", "two_tier"),
                                         (None, "star")])
def test_hier_path_runs_through_the_cuda_kernels(cuda_device, scheme, topo):
    xs, ys = make_synthetic(1.0, 1.0, num_devices=12, samples_per_device=30,
                            dim=20, seed=5)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 20)[:150], ys.reshape(-1)[:150], 10)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=20, num_classes=10), 0)
    fleet = uniform_fleet(12, dropout=0.0)
    topology = (star_topology(fleet) if topo == "star"
                else two_tier_topology(fleet, 3))
    kw = dict(lr=0.2, batch_size=10, min_epochs=1, max_epochs=4)
    if scheme is None:
        cfg = HierConfig(**kw)
    else:
        cfg = HierConfig(aggregator="hier_contextual_sketch",
                         compress=CompressConfig(scheme=scheme, ratio=4.0),
                         **kw)
    reset_launch_counts()
    res = run_hier_simulation("cuda", logistic_loss, logistic_apply, params,
                              ds, cfg, topology, num_rounds=3)
    counts = launch_counts()
    assert np.isfinite(res.train_loss).all()
    assert counts["gram/cuda"] >= 3
    if scheme == "topk":
        assert counts["topk/cuda"] >= 3 * 3 * 2     # 3 gateways x (u, g)
    if scheme == "sign_sketch":
        assert counts["sign_sketch/cuda"] >= 3 * 3 * 2
        assert counts["sign_sketch_adjoint/cuda"] >= 3 * 3 * 2
    assert all(v == 0 for key, v in counts.items() if key.endswith("/torch"))


# ------------------------------------- stream_stats, gram_block, sketch

CROSS_TOL = 1e-5     # f32 sums in another order than torch.matmul


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("P,n", [(1, 7), (3, 129), (65, 1000), (16, 4097),
                                 (100, 7850), (100, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_stats_kernel_matches_plain(cuda_device, P, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(P * 7 + n)
    D = _randn(gen, (P, n), dtype, cuda_device)
    GM = _randn(gen, (P, n), dtype, cuda_device)
    reset_launch_counts()
    G, C = stream_stats(D, GM)
    G2, C2 = stream_stats(D, GM)
    assert launch_counts()["stream_stats/cuda"] == 2
    assert launch_counts()["stream_stats/torch"] == 0
    assert torch.equal(G, G2) and torch.equal(C, C2)     # no float atomics
    assert torch.equal(G, G.T)
    Gr, Cr = ref.stream_stats_ref(D, GM)
    assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(C, Cr) <= CROSS_TOL
    out = (G.clone(), C.clone())
    assert stream_stats(D, GM, out=out) is out           # adds into out
    assert _rel_err(out[0], 2 * Gr) <= CROSS_TOL
    assert _rel_err(out[1], 2 * Cr) <= CROSS_TOL


def test_stream_stats_takes_slab_views_without_a_copy(cuda_device):
    """A (P, width) view of a stacked leaf goes in as it lies: the kernel
    reads its row stride, and allocates only its outputs and scratch (an
    f32 copy of this slab would be 64 MiB)."""
    from repro_torch.kernels import cross
    from repro_torch.kernels.stream import stream_stats_cuda
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    leaf = _randn(gen, (16, 1024, 1024), torch.bfloat16, cuda_device)
    gleaf = _randn(gen, (16, 1024, 1024), torch.bfloat16, cuda_device)
    slab, gslab = leaf.reshape(16, -1), gleaf.reshape(16, -1)
    assert slab.data_ptr() == leaf.data_ptr()
    per_sm, slices = cross.launch_config("stream_stats_launch_config",
                                         (16, 1), cuda_device.index or 0)
    blocks, _ = cross.grid(slab.shape[1], torch.cuda.get_device_properties(
        cuda_device).multi_processor_count, per_sm, slices)
    expect = 2 * 16 * 16 * 4 + slices * blocks * 64 * 64 * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    G, C = stream_stats_cuda(slab, gslab)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(cuda_device) - base
    assert rise <= expect + 4096, (rise, expect)
    Gr, Cr = ref.stream_stats_ref(slab, gslab)
    assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(C, Cr) <= CROSS_TOL
    # a strided column window of a wider matrix (row stride 3000)
    wide = _randn(gen, (5, 3000), torch.float32, cuda_device)
    win = wide[:, 100:2100]
    assert not win.is_contiguous()
    G, C = stream_stats_cuda(win, win)
    Gr, Cr = ref.stream_stats_ref(win, win)
    assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(C, Cr) <= CROSS_TOL


def _f64_stats(D, GM):
    d = D.double()
    return d @ d.T, d @ GM.double().T


def _check_mma_body(D, GM):
    """Two calls of the tensor-core body: bitwise equal, G symmetric, within
    CROSS_TOL of the plain version and of an f64 product, and ``out=``
    adding into running sums."""
    from repro_torch.kernels import stream
    stream.reset_body_launches()
    reset_launch_counts()
    G, C = stream_stats(D, GM)
    G2, C2 = stream_stats(D, GM)
    assert launch_counts()["stream_stats/cuda"] == 2
    assert stream.body_launches() == {"mma": 2, "cross": 0}
    assert torch.equal(G, G2) and torch.equal(C, C2)     # no float atomics
    assert torch.equal(G, G.T)
    Gr, Cr = ref.stream_stats_ref(D, GM)
    assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(C, Cr) <= CROSS_TOL
    G64, C64 = _f64_stats(D, GM)
    assert _rel_err(G.double(), G64) <= CROSS_TOL
    assert _rel_err(C.double(), C64) <= CROSS_TOL
    out = (G.clone(), C.clone())
    assert stream_stats(D, GM, out=out) is out           # adds into out
    assert _rel_err(out[0].double(), 2 * G64) <= CROSS_TOL
    assert _rel_err(out[1].double(), 2 * C64) <= CROSS_TOL
    assert stream.body_launches()["mma"] == 3


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
@pytest.mark.parametrize("P", [1, 5, 16, 17, 32])
def test_stream_stats_mma_body(cuda_device, P, n):
    """bf16 D and GM with P <= 32 and 16-byte aligned rows take the
    tensor-core body: column views of 4 104-wide tensors (row stride a
    multiple of 8), ragged column tails included."""
    from repro_torch.kernels.stream import _mma_eligible
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(P * 131 + n)
    D = _randn(gen, (P, 4104), torch.bfloat16, cuda_device)[:, :n]
    GM = _randn(gen, (P, 4104), torch.bfloat16, cuda_device)[:, :n]
    assert _mma_eligible(D, GM)
    _check_mma_body(D, GM)


def test_stream_stats_mma_body_at_the_embedding_slab(cuda_device):
    """The big-model round's widest slab: P = 16, n = 8 192 x 1 024."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(8)
    D = _randn(gen, (16, 8192 * 1024), torch.bfloat16, cuda_device)
    GM = _randn(gen, (16, 8192 * 1024), torch.bfloat16, cuda_device)
    _check_mma_body(D, GM)


def test_stream_stats_other_calls_take_cross_partial(cuda_device):
    """A misaligned bf16 view, a mixed f32/bf16 pair and P = 33 keep the
    cross.cuh body, with its results unchanged."""
    from repro_torch.kernels import stream
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(33)
    wide = _randn(gen, (16, 1024), torch.bfloat16, cuda_device)
    gwide = _randn(gen, (16, 1024), torch.bfloat16, cuda_device)
    cases = [(wide[:, 1:1001], gwide[:, 1:1001]),
             (wide.float(), gwide),
             (_randn(gen, (33, 1000), torch.bfloat16, cuda_device),
              _randn(gen, (33, 1000), torch.bfloat16, cuda_device))]
    for D, GM in cases:
        assert not stream._mma_eligible(D, GM)
        stream.reset_body_launches()
        G, C = stream_stats(D, GM)
        assert stream.body_launches() == {"mma": 0, "cross": 1}
        Gr, Cr = ref.stream_stats_ref(D, GM)
        assert torch.equal(G, G.T)
        assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(C, Cr) <= CROSS_TOL


@pytest.mark.parametrize("Ka,Kb,n", [(1, 1, 1), (5, 7, 333), (64, 32, 4097),
                                     (100, 100, 7850), (3, 130, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_block_kernel_matches_plain(cuda_device, Ka, Kb, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(Ka * 31 + Kb + n)
    U = _randn(gen, (Ka + Kb, n), dtype, cuda_device)
    ua, ub = U[:Ka], U[Ka:]                   # row blocks of one matrix
    g = _randn(gen, (n,), dtype, cuda_device)
    reset_launch_counts()
    G, c = gram_block_and_cross(ua, ub, g)
    G2, c2 = gram_block_and_cross(ua, ub, g)
    assert launch_counts()["gram_block/cuda"] == 2
    assert torch.equal(G, G2) and torch.equal(c, c2)
    Gr, cr = ref.gram_block_ref(ua, ub, g)
    assert tuple(G.shape) == (Ka, Kb) and tuple(c.shape) == (Ka,)
    assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(c, cr) <= CROSS_TOL


def _gram_block_f64(ua, ub, g):
    a = ua.double()
    return a @ ub.double().T, a @ g.double()


def _check_gram_block_mma(ua, ub, g):
    """Two calls of gram_block's tensor-core body: bitwise equal and within
    CROSS_TOL of an f64 product.  The plain f32 version is measured against
    the same product (printed with ``-s``) but is no oracle here: where a
    dot product of a few thousand terms cancels to |c_a| < 1 (Ka = 1), the
    plain version itself can lie further than CROSS_TOL from it.  Returns
    the outputs and the kernel's and the plain version's error."""
    from repro_torch.kernels import gram
    assert gram._block_mma_eligible(ua, ub, g)
    gram.reset_block_body_launches()
    reset_launch_counts()
    G, c = gram_block_and_cross(ua, ub, g)
    G2, c2 = gram_block_and_cross(ua, ub, g)
    assert launch_counts()["gram_block/cuda"] == 2
    assert launch_counts()["gram_block/torch"] == 0
    assert gram.block_body_launches() == {"mma": 2, "cross": 0}
    assert torch.equal(G, G2) and torch.equal(c, c2)      # no float atomics
    (Ka, n), Kb = ua.shape, ub.shape[0]
    assert tuple(G.shape) == (Ka, Kb) and tuple(c.shape) == (Ka,)
    G64, c64 = _gram_block_f64(ua, ub, g)
    Gr, cr = ref.gram_block_ref(ua, ub, g)
    kernel = max(_rel_err(G.double(), G64), _rel_err(c.double(), c64))
    plain = max(_rel_err(Gr.double(), G64), _rel_err(cr.double(), c64))
    print(f"gram_block Ka={Ka} Kb={Kb} n={n} bf16 against f64: kernel "
          f"{kernel:.3e}, plain {plain:.3e}")
    assert kernel <= CROSS_TOL
    return G, c, Gr, cr


# the edges of every instance (MA, NB) = (ceil(Ka / 16), ceil((Kb + 1) / 8))
# of the tensor-core body, MA 1..4 by NB 1..8, and n with a ragged last
# staged tile (n % 128 != 0)
GRAM_BLOCK_MMA_KA = [1, 15, 16, 17, 31, 32, 33, 48, 63, 64]
GRAM_BLOCK_MMA_KB = [1, 7, 8, 15, 16, 31, 32, 40, 55, 63]
GRAM_BLOCK_MMA_N = [8, 72, 4104]


@pytest.mark.parametrize("n", GRAM_BLOCK_MMA_N)
@pytest.mark.parametrize("Kb", GRAM_BLOCK_MMA_KB)
@pytest.mark.parametrize("Ka", GRAM_BLOCK_MMA_KA)
def test_gram_block_mma_body(cuda_device, Ka, Kb, n):
    """U_a, U_b and g all bf16 with Ka <= 64, Kb <= 63, n % 8 == 0 and
    aligned rows take the tensor-core body (csrc/gram_block_mma.cu), as row
    blocks of one matrix and as separate tensors."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(Ka * 4099 + Kb * 131 + n)
    bf16 = torch.bfloat16
    U = _randn(gen, (Ka + Kb, n), bf16, cuda_device)
    g = _randn(gen, (n,), bf16, cuda_device)
    _check_gram_block_mma(U[:Ka], U[Ka:], g)
    _check_gram_block_mma(_randn(gen, (Ka, n), bf16, cuda_device),
                          _randn(gen, (Kb, n), bf16, cuda_device), g)


def test_gram_block_mma_body_against_f64_at_model_width(cuda_device):
    """Ka = 64, Kb = 32, n = 2^22 bf16: the tensor-core body and the plain
    f32 version, each against an f64 product, and the body within CROSS_TOL
    of both."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6432)
    U = _randn(gen, (96, 1 << 22), torch.bfloat16, cuda_device)
    g = _randn(gen, (1 << 22,), torch.bfloat16, cuda_device)
    G, c, Gr, cr = _check_gram_block_mma(U[:64], U[64:], g)
    assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(c, cr) <= CROSS_TOL


def test_gram_block_other_calls_keep_cross(cuda_device):
    """Mixed dtypes each way, Ka = 65, Kb = 64, n % 8 != 0 and a bf16 U_a
    starting 2 bytes into its buffer keep cross.cuh's body, with its results
    unchanged."""
    from repro_torch.kernels import gram
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6564)
    bf16, f32 = torch.bfloat16, torch.float32

    def r(*shape, dtype=bf16):
        return _randn(gen, shape, dtype, cuda_device)

    g = r(1024)
    shifted = r(10 * 1024 + 1)[1:].view(10, 1024)
    cases = [(r(10, 1024), r(5, 1024), g.float()),
             (r(10, 1024, dtype=f32), r(5, 1024), g),
             (r(10, 1024), r(5, 1024, dtype=f32), g),
             (r(65, 1024), r(5, 1024), g),
             (r(10, 1024), r(64, 1024), g),
             (r(10, 1001), r(5, 1001), r(1001)),
             (shifted, r(5, 1024), g)]
    for ua, ub, gg in cases:
        assert not gram._block_mma_eligible(ua, ub, gg)
        gram.reset_block_body_launches()
        G, c = gram_block_and_cross(ua, ub, gg)
        assert gram.block_body_launches() == {"mma": 0, "cross": 1}
        Gr, cr = ref.gram_block_ref(ua, ub, gg)
        assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(c, cr) <= CROSS_TOL


@pytest.mark.parametrize("K,m,n", [(1, 1, 1), (3, 17, 130), (8, 1024, 4099),
                                   (11, 129, 1000), (100, 65, 777)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sketch_kernel_matches_plain(cuda_device, K, m, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 13 + m + n)
    U = _randn(gen, (K, n), dtype, cuda_device)
    R = _randn(gen, (m, n), dtype, cuda_device)
    reset_launch_counts()
    S = sketch_apply(U, R)
    S2 = sketch_apply(U, R)
    assert launch_counts()["sketch/cuda"] == 2
    assert torch.equal(S, S2) and tuple(S.shape) == (K, m)
    assert _rel_err(S, ref.sketch_ref(U, R)) <= CROSS_TOL
    with pytest.raises(ValueError, match="disagree on n"):
        sketch_apply_cuda(U, R[:, :n - 1] if n > 1 else R[:, :0])


def _check_sketch_mma(U, R):
    """Two calls of sketch's tensor-core body: bitwise equal and within
    CROSS_TOL of an f64 product.  The plain f32 version is measured against
    the same product (printed with ``-s``) but is no oracle here, as for
    gram_block's sweep.  Returns the output and the plain version's."""
    from repro_torch.kernels import sketch
    assert sketch._mma_eligible(U, R)
    sketch.reset_body_launches()
    reset_launch_counts()
    S = sketch_apply(U, R)
    S2 = sketch_apply(U, R)
    assert launch_counts()["sketch/cuda"] == 2
    assert launch_counts()["sketch/torch"] == 0
    assert sketch.body_launches() == {"mma": 2, "cross": 0}
    assert torch.equal(S, S2)                       # no float atomics
    (K, n), m = U.shape, R.shape[0]
    assert tuple(S.shape) == (K, m) and S.dtype == torch.float32
    S64 = U.double() @ R.double().T
    Sr = ref.sketch_ref(U, R)
    kernel = _rel_err(S.double(), S64)
    plain = _rel_err(Sr.double(), S64)
    print(f"sketch K={K} m={m} n={n} bf16 against f64: kernel "
          f"{kernel:.3e}, plain {plain:.3e}")
    assert kernel <= CROSS_TOL
    return S, Sr


# the edges of every instance NB = ceil(K / 8) of the tensor-core body and of
# its 128-row slices of R, and n with a ragged last staged tile
# (n % 128 != 0)
SKETCH_MMA_K = [1, 7, 8, 9, 16, 57, 64]
SKETCH_MMA_M = [1, 15, 16, 17, 127, 128, 129, 1024]
SKETCH_MMA_N = [8, 72, 4104]


@pytest.mark.parametrize("n", SKETCH_MMA_N)
@pytest.mark.parametrize("m", SKETCH_MMA_M)
@pytest.mark.parametrize("K", SKETCH_MMA_K)
def test_sketch_mma_body(cuda_device, K, m, n):
    """U and R both bf16 with K <= 64, n % 8 == 0 and aligned rows take the
    tensor-core body (csrc/sketch_mma.cu), as row blocks of one matrix and
    as separate tensors."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 8209 + m * 131 + n)
    bf16 = torch.bfloat16
    M = _randn(gen, (K + m, n), bf16, cuda_device)
    _check_sketch_mma(M[:K], M[K:])
    _check_sketch_mma(_randn(gen, (K, n), bf16, cuda_device),
                      _randn(gen, (m, n), bf16, cuda_device))


def test_sketch_mma_body_against_f64_at_model_width(cuda_device):
    """K = 8, m = 1 024, n = 2^18 bf16: the tensor-core body and the plain
    f32 version, each against an f64 product, and the body within CROSS_TOL
    of both."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(81024)
    U = _randn(gen, (8, 1 << 18), torch.bfloat16, cuda_device)
    R = _randn(gen, (1024, 1 << 18), torch.bfloat16, cuda_device)
    S, Sr = _check_sketch_mma(U, R)
    assert _rel_err(S, Sr) <= CROSS_TOL


def test_sketch_other_calls_keep_cross(cuda_device):
    """f32 and mixed dtypes each way, K = 65, n % 8 != 0, row blocks of one
    matrix at an odd n, a row stride that is no multiple of 8, and a bf16 U
    or R starting 2 bytes into its buffer keep cross.cuh's body, with its
    results unchanged."""
    from repro_torch.kernels import sketch
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6565)
    bf16, f32 = torch.bfloat16, torch.float32

    def r(*shape, dtype=bf16):
        return _randn(gen, shape, dtype, cuda_device)

    M = r(8 + 129, 1001)
    cases = [(r(8, 1024, dtype=f32), r(129, 1024, dtype=f32)),
             (r(8, 1024, dtype=f32), r(129, 1024)),
             (r(8, 1024), r(129, 1024, dtype=f32)),
             (r(65, 1024), r(129, 1024)),
             (r(8, 1001), r(129, 1001)),
             (M[:8], M[8:]),
             (r(8, 1028)[:, :1024], r(129, 1024)),
             (r(8 * 1024 + 1)[1:].view(8, 1024), r(129, 1024)),
             (r(8, 1024), r(129 * 1024 + 1)[1:].view(129, 1024))]
    for U, R in cases:
        assert not sketch._mma_eligible(U, R)
        sketch.reset_body_launches()
        S = sketch_apply(U, R)
        assert sketch.body_launches() == {"mma": 0, "cross": 1}
        assert _rel_err(S, ref.sketch_ref(U, R)) <= CROSS_TOL


def test_cross_wrappers_reject_bad_inputs(cuda_device):
    from repro_torch.kernels.stream import stream_stats_cuda
    D = torch.ones(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        stream_stats_cuda(torch.ones(4, 8), torch.ones(4, 8))
    with pytest.raises(TypeError):
        stream_stats_cuda(D.double(), D.double())
    with pytest.raises(ValueError, match="unit-strided"):
        stream_stats_cuda(D.T, D.T)
    with pytest.raises(ValueError, match="disagree"):
        stream_stats_cuda(D, D[:, :7])
    with pytest.raises(ValueError, match="out"):
        stream_stats_cuda(D, D, out=(torch.zeros(3, 3, device=cuda_device),
                                     torch.zeros(3, 3, device=cuda_device)))
    with pytest.raises(ValueError, match="disagree on n"):
        gram_block_cuda(D, D[:, :7], torch.ones(8, device=cuda_device))
    with pytest.raises(TypeError):
        sketch_apply_cuda(D.half(), D.half())
    with pytest.raises(ValueError, match="out"):
        combine_cuda(D[0], D, torch.ones(4, device=cuda_device),
                     out=torch.ones(8, device=cuda_device).bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mix_rows_and_in_place_combine_match_plain(cuda_device, dtype):
    from repro_torch.core.flatten import mix_rows
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    leaf = _randn(gen, (16, 33, 129), dtype, cuda_device)
    w = torch.randn(16, generator=gen, device=cuda_device) * 0.3
    reset_launch_counts()
    got = mix_rows(w, leaf)
    assert launch_counts()["combine/cuda"] == 1
    want = mix_rows(w.cpu(), leaf.cpu())
    assert got.dtype == torch.float32
    assert _rel_err(got.cpu(), want) <= 1e-5
    base = _randn(gen, (33 * 129,), dtype, cuda_device)
    new = weighted_combine(base, leaf.reshape(16, -1), w)
    ptr = base.data_ptr()
    assert weighted_combine(base, leaf.reshape(16, -1), w, out=base) is base
    assert base.data_ptr() == ptr and torch.equal(base, new)


@pytest.mark.parametrize("scheme", [None, "sign_sketch"])
def test_streamed_path_runs_through_the_cuda_kernels(cuda_device, scheme):
    xs, ys = make_synthetic(1.0, 1.0, num_devices=12, samples_per_device=30,
                            dim=20, seed=5)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 20)[:150], ys.reshape(-1)[:150], 10)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=20, num_classes=10), 0)
    before = {k: v.clone() for k, v in params.items()}
    topology = two_tier_topology(uniform_fleet(12, dropout=0.0), 3)
    kw = dict(lr=0.2, batch_size=10, min_epochs=1, max_epochs=4)
    cfg = (HierConfig(**kw) if scheme is None else HierConfig(
        aggregator="hier_contextual_sketch",
        compress=CompressConfig(scheme=scheme, ratio=4.0), **kw))
    reset_launch_counts()
    res = run_hier_simulation("cuda", logistic_loss, logistic_apply, params,
                              ds, cfg, topology, num_rounds=3,
                              engine="streamed")
    counts = launch_counts()
    assert res.engine["engine_name"] == "streamed"
    assert np.isfinite(res.train_loss).all()
    assert counts["stream_stats/cuda"] == 3 * 2         # 2 leaves per round
    # the apply per leaf, or the materialized summaries per leaf
    assert counts["combine/cuda"] >= 3 * 2
    assert counts["gram/cuda"] == 0                      # no dense Gram
    assert all(v == 0 for key, v in counts.items() if key.endswith("/torch"))
    for k in params:                                     # init_params kept
        assert torch.equal(params[k], before[k])


# --------------------------------------------------------- flash_decode

DECODE_TOL = 1e-4


def _decode_case(gen, dev, B, S, KV, G, hd, dtype, lengths):
    q = _randn(gen, (B, KV, G, hd), dtype, dev)
    k = _randn(gen, (B, S, KV, hd), dtype, dev)
    v = _randn(gen, (B, S, KV, hd), dtype, dev)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _check_decode(q, k, v, lengths, **kw):
    """Two kernel calls, bitwise equal and within DECODE_TOL of the plain
    version, both on the body the inputs route to (the tensor-core body for
    bf16 q, k and v at hd 64 or 128, the CUDA-core body otherwise)."""
    body = "mma" if decode_attn._mma_eligible(q, k, v) else "cuda_core"
    reset_launch_counts()
    decode_attn.reset_body_launches()
    got = flash_decode(q, k, v, lengths, **kw)
    again = flash_decode(q, k, v, lengths, **kw)
    assert launch_counts()["flash_decode/cuda"] == 2
    assert launch_counts()["flash_decode/torch"] == 0
    assert decode_attn.body_launches()[body] == 2
    assert sum(decode_attn.body_launches().values()) == 2
    want = flash_decode(q, k, v, lengths, backend="torch", **kw)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, a)                           # no float atomics
        assert _rel_err(g, w) <= DECODE_TOL
    return got


@pytest.mark.parametrize("B,S,KV,G,hd", [
    (4, 256, 8, 5, 128),        # the qwen3-14b serve path
    (4, 200, 16, 1, 256),       # gemma-7b heads, ragged S
    (2, 333, 4, 12, 128),       # starcoder2-15b heads
    (3, 77, 4, 1, 64),          # the reduced configs
    (2, 1000, 2, 3, 64), (1, 1, 1, 8, 256), (5, 4097, 8, 16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda_device, B, S, KV, G, hd,
                                           dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(B * S + G)
    lengths = [1, S, max(1, S // 3), max(1, S - 5), 17 % S + 1][:B]
    _check_decode(*_decode_case(gen, cuda_device, B, S, KV, G, hd, dtype,
                                lengths))


@pytest.mark.parametrize("window,softcap", [(64, None), (1, None),
                                            (None, 50.0), (300, 5.0)])
def test_flash_decode_kernel_window_and_softcap(cuda_device, window, softcap):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    _check_decode(*_decode_case(gen, cuda_device, 4, 1500, 4, 12, 128,
                                torch.bfloat16, [1, 64, 700, 1500]),
                  window=window, softcap=softcap)


def test_flash_decode_kernel_reads_a_stacked_cache_in_place(cuda_device):
    """A layer's view of a stacked (L, B, S, KV, hd) cache, and a view whose
    rows are further apart (the head axis of a wider cache), are read as
    they lie: the result equals the plain version on the same views."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    L, B, S, KV, G, hd = 3, 4, 300, 8, 5, 128
    ck = _randn(gen, (L, B, S, KV, hd), torch.bfloat16, cuda_device)
    cv = _randn(gen, (L, B, S, KV, hd), torch.bfloat16, cuda_device)
    q = _randn(gen, (B, KV, G, hd), torch.bfloat16, cuda_device)
    lengths = torch.tensor([1, 300, 150, 7], dtype=torch.int32,
                           device=cuda_device)
    _check_decode(q, ck[1], cv[1], lengths)
    wide_k = _randn(gen, (B, S, 2 * KV, hd), torch.float32, cuda_device)
    wide_v = _randn(gen, (B, S, 2 * KV, hd), torch.float32, cuda_device)
    _check_decode(q.float(), wide_k[:, :, KV:], wide_v[:, :, KV:], lengths,
                  window=100)


def test_flash_decode_kernel_skips_dead_rows(cuda_device):
    """Rows at or past a row's length, and before its window, are never
    read: filling them with NaN changes nothing."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    B, S, KV, G, hd = 3, 2048, 2, 5, 128
    q, k, v, lengths = _decode_case(gen, cuda_device, B, S, KV, G, hd,
                                    torch.bfloat16, [1, 1000, 2048])
    window = 300
    clean = flash_decode(q, k, v, lengths, window=window)
    pos = torch.arange(S, device=cuda_device)[None, :]
    dead = (pos >= lengths[:, None]) | (pos < lengths[:, None] - window)
    kn = torch.where(dead[..., None, None], float("nan"), k.float()).to(k.dtype)
    vn = torch.where(dead[..., None, None], float("nan"), v.float()).to(v.dtype)
    dirty = flash_decode(q, kn, vn, lengths, window=window)
    for a, b in zip(clean, dirty):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, None),
                                            (300, 30.0), (None, 50.0)])
def test_flash_decode_mma_body_matches_plain(cuda_device, hd, G, window,
                                             softcap):
    """The tensor-core body at every G it takes, on rows whose lengths sit
    on the 64-row tiles' edges and on the window's."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(hd + G)
    S = 1000
    lengths = [1, 63, 64, 65, 299, 300, 301, S]
    q, k, v, ln = _decode_case(gen, cuda_device, len(lengths), S, 2, G, hd,
                               torch.bfloat16, lengths)
    assert decode_attn._mma_eligible(q, k, v)
    _check_decode(q, k, v, ln, window=window, softcap=softcap)


def test_flash_decode_first_body_still_serves_bf16_and_skips_dead_rows(
        cuda_device):
    """The CUDA-core body, asked for on bf16 calls the tensor-core body
    would take, agrees with the plain version and with the tensor-core body,
    and also never reads dead rows (NaN there changes nothing)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6)
    B, S, KV, G, hd = 3, 2048, 2, 12, 128
    q, k, v, lengths = _decode_case(gen, cuda_device, B, S, KV, G, hd,
                                    torch.bfloat16, [1, 1000, 2048])
    window = 300
    decode_attn.reset_body_launches()
    first = decode_attn.flash_decode_cuda(q, k, v, lengths, window=window,
                                          body="cuda_core")
    mma = decode_attn.flash_decode_cuda(q, k, v, lengths, window=window)
    assert decode_attn.body_launches() == {"mma": 1, "cuda_core": 1}
    want = flash_decode(q, k, v, lengths, window=window, backend="torch")
    for f, m, w in zip(first, mma, want):
        assert _rel_err(f, w) <= DECODE_TOL and _rel_err(m, w) <= DECODE_TOL
    pos = torch.arange(S, device=cuda_device)[None, :]
    dead = (pos >= lengths[:, None]) | (pos < lengths[:, None] - window)
    kn = torch.where(dead[..., None, None], float("nan"), k.float()).to(k.dtype)
    vn = torch.where(dead[..., None, None], float("nan"), v.float()).to(v.dtype)
    dirty = decode_attn.flash_decode_cuda(q, kn, vn, lengths, window=window,
                                          body="cuda_core")
    for a, b in zip(first, dirty):
        assert torch.equal(a, b)


def test_flash_decode_body_choice_is_checked(cuda_device):
    q = torch.zeros(1, 1, 1, 128, device=cuda_device)
    k = torch.zeros(1, 8, 1, 128, device=cuda_device)
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="tensor-core body"):
        decode_attn.flash_decode_cuda(q, k, k, one, body="mma")   # f32
    with pytest.raises(ValueError, match="body"):
        decode_attn.flash_decode_cuda(q, k, k, one, body="wgmma")


def test_flash_decode_kernel_refuses_what_it_cannot_take(cuda_device):
    q = torch.zeros(1, 1, 1, 96, device=cuda_device)
    k = torch.zeros(1, 8, 1, 96, device=cuda_device)
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode(q, k, k, one)
    k = torch.zeros(1, 8, 1, 128, device=cuda_device)
    q = torch.zeros(1, 1, 1, 128, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q, k, k, one.long())
    with pytest.raises(ValueError, match="contiguous last dim"):
        every_other = torch.zeros(1, 8, 1, 256, device=cuda_device)[..., ::2]
        flash_decode(q, every_other, k, one)


SERVE_CFG = get_config("qwen3-14b").reduced(num_layers=1, d_model=32,
                                            vocab_size=64, dtype="float32")


def test_decode_slots_leaves_inactive_rows_untouched(cuda_device):
    cfg = get_config("qwen3-14b").reduced()
    params = get_model(cfg).init(0, device=cuda_device)
    cache = ttf.init_lm_cache(cfg, 3, 64, ring=False, device=cuda_device)
    for t in cache.kv:
        t.normal_()
    before = [t.clone() for t in cache.kv]
    positions = torch.tensor([10, 63, 30], dtype=torch.int32,
                             device=cuda_device)
    active = torch.tensor([True, False, True], device=cuda_device)
    reset_launch_counts()
    logits, _ = ttf.decode_slots(cfg, params,
                                 torch.tensor([1, 2, 3], dtype=torch.int32,
                                              device=cuda_device),
                                 cache, positions, active=active)
    assert launch_counts()["flash_decode/cuda"] == cfg.num_layers
    assert torch.isfinite(logits).all()
    for new, old in zip(cache.kv, before):
        changed = (new != old).flatten(3).any(-1)          # (L, B, S)
        assert changed[:, 0, 10].all() and changed[:, 2, 30].all()
        changed[:, 0, 10] = changed[:, 2, 30] = False
        assert not changed.any()


def _serve(params, device, prompts, max_new, stagger=True):
    eng = DecodeEngine(SERVE_CFG, ModelBus(params), num_slots=3, max_seq=40,
                       scan_chunk=4, prefill_chunk_tokens=8, device=device)
    eng.submit(prompts[0], max_new[0], rid=0)
    done = eng.step() if stagger else []
    for rid in range(1, len(prompts)):
        eng.submit(prompts[rid], max_new[rid], rid=rid)
    return {c.rid: c.tokens for c in done + eng.run()}


def test_engine_batched_equals_solo_and_cpu(cuda_device):
    params = get_model(SERVE_CFG).init(0, device="cpu")
    on_card = tree_map(lambda a: a.to(cuda_device), params)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (6, 13, 9)]
    max_new = (7, 4, 9)
    reset_launch_counts()
    batched = _serve(on_card, cuda_device, prompts, max_new)
    assert launch_counts()["flash_decode/cuda"] > 0
    assert launch_counts()["flash_decode/torch"] == 0
    for rid in range(3):
        solo = _serve(on_card, cuda_device, prompts[rid:rid + 1],
                      max_new[rid:rid + 1])
        assert solo[0] == batched[rid], f"rid={rid} diverged"
    assert _serve(params, "cpu", prompts, max_new) == batched


# ------------------------------------------------------------------ robust

@pytest.mark.parametrize("name", ["contextual_mom", "contextual_clipped",
                                  "krum", "coordinate_median"])
def test_robust_aggregators_on_the_card_match_the_cpu(cuda_device, name):
    """The flat robust aggregators on the card against the same call on the
    CPU (plain versions): G from ``gram``, the cross matrix from
    ``gram_block`` (its cross.cuh body: f32 inputs), the step through
    ``combine``; krum's selection equal."""
    from repro_torch.core import AggregatorConfig, SolveConfig, aggregate
    from repro_torch.kernels import gram
    from repro_torch.robust import RobustConfig
    rng = np.random.RandomState(3)
    K, n = 10, 7850
    U = (rng.randn(K, n) * 0.01).astype(np.float32)
    U[[2, 7]] *= 25.0
    Gm = (rng.randn(K, n) * 0.01).astype(np.float32)
    params = {"b": np.zeros(10, np.float32),
              "w": (rng.randn(n - 10) * 0.1).astype(np.float32)}
    cfg = AggregatorConfig(name=name, solve=SolveConfig(beta=20.0),
                           robust=RobustConfig(clip=2.0, pool="mom"))
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        split = lambda M: {"b": torch.from_numpy(M[:, :10]).to(dev),  # noqa
                           "w": torch.from_numpy(M[:, 10:]).to(dev)}
        p = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        reset_launch_counts()
        gram.reset_block_body_launches()
        outs[dev.type] = aggregate(name)(p, split(U), split(Gm), cfg)
        counts, bodies = launch_counts(), gram.block_body_launches()
        if dev.type == "cuda":
            assert all(v == 0 for k, v in counts.items()
                       if k.endswith("/torch"))
            assert counts["combine/cuda"] == 1
            contextual = name.startswith("contextual")
            assert counts["gram_block/cuda"] == int(contextual)
            assert bodies == {"mma": 0, "cross": int(contextual)}
    (got, ginfo), (want, winfo) = outs["cuda"], outs["cpu"]
    for k in params:
        assert _rel_err(got[k].cpu(), want[k]) <= 1e-4
    assert _rel_err(ginfo["alpha"].cpu(), winfo["alpha"]) <= 1e-4
    if name == "krum":
        assert torch.equal(ginfo["alpha"].cpu(), winfo["alpha"])
        assert ginfo["alpha"][2] == 0 and ginfo["alpha"][7] == 0


@pytest.mark.parametrize("engine", ["fused", "streamed"])
def test_robust_hier_runs_through_the_cuda_kernels(cuda_device, engine):
    """Attack, churn and ``HierConfig.robust`` on the card: the fused
    engine's robust stages launch ``gram_block`` (cross body), the
    streamed engine's none; two runs bitwise equal; no plain version."""
    from repro_torch.kernels import gram
    from repro_torch.robust import (ByzantineGauss, RobustConfig,
                                    assign_adversaries, churn_schedule)
    xs, ys = make_synthetic(1.0, 1.0, num_devices=12, samples_per_device=30,
                            dim=20, seed=5)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 20)[:150], ys.reshape(-1)[:150], 10)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=20, num_classes=10), 0)
    fleet = assign_adversaries(uniform_fleet(12), 0.17, seed=3)
    cfg = HierConfig(lr=0.2, batch_size=10, min_epochs=1, max_epochs=4,
                     robust=RobustConfig(clip=2.0, pool="mom"))
    runs = []
    for _ in range(2):
        reset_launch_counts()
        gram.reset_block_body_launches()
        res = run_hier_simulation(
            "robust", logistic_loss, logistic_apply, params, ds, cfg,
            two_tier_topology(fleet, 3), num_rounds=3, engine=engine,
            attack=ByzantineGauss(scale=10.0),
            churn=churn_schedule("wave", 12, 0.06, seed=1))
        counts, bodies = launch_counts(), gram.block_body_launches()
        assert np.isfinite(res.train_loss).all()
        assert all(v == 0 for k, v in counts.items() if k.endswith("/torch"))
        if engine == "fused":       # one per gateway a round
            assert counts["gram_block/cuda"] == 3 * 3
            assert bodies == {"mma": 0, "cross": 3 * 3}
        else:
            assert counts["gram_block/cuda"] == 0
            assert counts["stream_stats/cuda"] == 3 * 2
        runs.append(res)
    assert runs[0].times == runs[1].times
    assert runs[0].train_loss == runs[1].train_loss
    assert runs[0].dropped == runs[1].dropped
