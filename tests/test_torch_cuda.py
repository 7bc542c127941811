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
kernel's fast exp); the serving engine's greedy tokens exactly.  The MoE
layer (no kernel of its own) on the card against the CPU at 1e-5 in f32,
and at olmoe width in bf16 with no host sync and bitwise repeatable.  The
recurrent families (no kernel either): the lockstep loop's greedy tokens on
the card equal to the CPU's and its logits within 1e-5 in f32, a bf16
decode step with no host sync and bitwise repeatable.
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
from repro_torch.models import moe
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


# torch.profiler on an H100 loses device activity at the edges of a window
# (its first launches, and launches whose converted time stamps fall just
# outside the window's host-clock bounds), and once counted the warm-up
# call's launch in the recorded cycle.  So a window runs one call in the
# profiler's warm-up cycle, records the next calls with PROFILE_PAD_S of
# idle inside each edge, and an incomplete window is taken again, up to
# PROFILE_ATTEMPTS in all: an attempt whose every count is a multiple of the
# calls stands, else each kernel is kept at a count that is a multiple of
# the calls where an attempt saw one, else at the most launches any attempt
# saw (as chip_smoke.py's _device_rows).
PROFILE_ATTEMPTS = 5
PROFILE_PAD_S = 0.005


def _device_kernels(fn, calls: int, match=None) -> dict:
    """``{kernel name: launches}`` of ``calls`` calls of ``fn`` on the card:
    the entries with device time of their own (kernels, copies, fills; not
    aten ops or runtime calls) the profiler saw, optionally only those
    whose name holds one of the ``match`` substrings, taken again and
    merged until every count is a multiple of ``calls``."""
    import time
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
        seen = {}
        for e in prof.key_averages():
            own_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if (own_us <= 0 or e.count < 1
                    or e.key.startswith(("aten::", "cuda", "ProfilerStep",
                                         "Activity Buffer", "Buffer Flush"))
                    or (match and not any(m in e.key for m in match))):
                continue
            seen[e.key] = e.count
        if seen and all(c % calls == 0 for c in seen.values()):
            return seen
        for key, c in seen.items():
            old = best.get(key)
            # a multiple of the calls before a count that is not, else the
            # larger
            if old is None or ((c % calls == 0, c) > (old % calls == 0, old)):
                best[key] = c
        if best and all(c % calls == 0 for c in best.values()):
            break
    return best


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


@pytest.mark.parametrize("width,body", [(4104, "vec"), (4102, "scalar")])
@pytest.mark.parametrize("u_dt,w_dt", DTYPE_PAIRS)
def test_combine_and_mix_rows_on_windows_of_a_wider_slab(cuda_device, width,
                                                         body, u_dt, w_dt):
    """combine and mix_rows on the (P, window) views of a wider slab that
    the streamed engine's split reads (``column_windows`` over 8 places):
    each window within COMBINE_TOL of the plain version on the same view,
    on combine_vec.cu where the slab's rows are 16-byte multiples and on
    combine.cu where they are not, and the windows written side by side
    within COMBINE_TOL of the whole-slab call."""
    from repro_torch.core.flatten import mix_rows
    from repro_torch.kernels import combine
    from repro_torch.sharding.specs import column_windows
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(width)
    P = 16
    U = torch.randn((P, width), generator=gen, device=cuda_device).to(u_dt)
    w = torch.randn(width, generator=gen, device=cuda_device).to(w_dt)
    a = torch.randn(P, generator=gen, device=cuda_device) / P
    windows = [(a0, b0) for a0, b0 in column_windows(width, 8) if b0 > a0]
    new = torch.empty_like(w)
    mixed = torch.empty(width, device=cuda_device)
    combine.reset_body_launches()
    for a0, b0 in windows:
        view = U[:, a0:b0]
        assert view.stride() == (width, 1)
        got = combine_cuda(w[a0:b0], view, a, out=new[a0:b0])
        assert got.data_ptr() == new[a0:b0].data_ptr()
        assert _rel_err(got, ref.combine_ref(w[a0:b0], view, a)) \
            <= COMBINE_TOL[w_dt]
        mix_rows(a, view, out=mixed[a0:b0])
        want = ref.combine_ref(torch.zeros(b0 - a0, device=cuda_device), view,
                               a.to(u_dt).float())
        assert _rel_err(mixed[a0:b0], want) <= 1e-5
    assert combine.body_launches() == {body: 2 * len(windows),
                                       ("scalar" if body == "vec" else "vec"):
                                       0}
    assert _rel_err(new, combine_cuda(w, U, a)) <= COMBINE_TOL[w_dt]
    assert _rel_err(mixed, mix_rows(a, U)) <= 1e-5


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
    assert gram.body_launches() == {"mma": 2, "realign": 0, "f32": 0,
                                    "cuda_core": 0}
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
    """bf16 K = 128 and mixed dtypes either way keep gram.cu's body; bf16
    with n % 8 != 0 and a bf16 U starting 2 bytes into its buffer take the
    realigning body (csrc/gram_realign.cu); f32 U and g take the f32 body
    (csrc/gram_f32.cu)."""
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
        f32 = U.dtype == g.dtype == torch.float32
        realign = (U.dtype == g.dtype == bf16
                   and U.shape[0] <= gram.MMA_MAX_K)
        gram.reset_body_launches()
        G, c = gram_and_cross(U, g)
        assert gram.body_launches() == {
            "mma": 0, "realign": int(realign), "f32": int(f32),
            "cuda_core": int(not (f32 or realign))}
        Gr, cr = ref.gram_ref(U, g)
        assert torch.equal(G, G.T)
        assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4


def _gram_shifted(gen, K, n, skip, device):
    """U (K, n) ``skip`` entries and g (n,) ``3·skip mod 8`` entries into
    fresh buffers (:func:`_shifted`)."""
    return (_shifted(gen, K, n, skip, device),
            _shifted(gen, 1, n, 3 * skip % 8, device)[0])


@pytest.mark.parametrize("skip", range(1, 8))
@pytest.mark.parametrize("K", GRAM_MMA_K)
def test_gram_realign_equals_mma_bitwise(cuda_device, K, skip):
    """U viewed 2·s bytes into its buffer (s = 1..7) and g at another shift
    take the realigning body (csrc/gram_realign.cu), and at n % 8 == 0 it
    equals gram_mma.cu on aligned copies of the same values bit for bit,
    for every 16-row tile count and n = 8, 72 and 4 104 (a ragged last
    staged tile); ``body="realign"`` on the aligned copies gives the same
    bits too."""
    from repro_torch.kernels import gram
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 64 + skip)
    for n in (8, 72, 4104):
        U, g = _gram_shifted(gen, K, n, skip, cuda_device)
        Ua, ga = U.clone(), g.clone()
        assert gram._body(U, g) == "realign"
        assert gram._body(Ua, ga) == "mma"
        gram.reset_body_launches()
        G, c = gram_and_cross(U, g)
        Ga, ca = gram_and_cross(Ua, ga)
        Gf, cf = gram_cuda(Ua, ga, body="realign")
        assert gram.body_launches() == {"mma": 1, "realign": 2, "f32": 0,
                                        "cuda_core": 0}
        assert torch.equal(G, Ga) and torch.equal(c, ca), (K, n)
        assert torch.equal(Gf, Ga) and torch.equal(cf, ca), (K, n)


@pytest.mark.parametrize("n", [1, 7, 1001, (1 << 20) + 3])
@pytest.mark.parametrize("K", [1, 10, 64, 100, 127])
def test_gram_realign_against_f64_at_odd_n(cuda_device, K, n):
    """bf16 U and g at an odd n (every row of U but the first starts only
    2-byte aligned) take the realigning body: two calls bitwise equal, G
    exactly symmetric, within 1e-4 of the plain version and of an f64
    product."""
    from repro_torch.kernels import gram
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 131 + n)
    U = _randn(gen, (K, n), torch.bfloat16, cuda_device)
    g = _randn(gen, (n,), torch.bfloat16, cuda_device)
    gram.reset_body_launches()
    G, c = gram_and_cross(U, g)
    G2, c2 = gram_and_cross(U, g)
    assert gram.body_launches() == {"mma": 0, "realign": 2, "f32": 0,
                                    "cuda_core": 0}
    assert torch.equal(G, G2) and torch.equal(c, c2)
    assert torch.equal(G, G.T)
    Gr, cr = ref.gram_ref(U, g)
    assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4
    G64, c64 = _gram_f64(U, g)
    assert _rel_err(G.double(), G64) <= 1e-4
    assert _rel_err(c.double(), c64) <= 1e-4


@pytest.mark.parametrize("K,n", [(10, (1 << 20) + 3), (64, 1001), (127, 7)])
def test_gram_realign_is_two_kernels_a_call(cuda_device, K, n):
    """``torch.profiler``: a call of the realigning body is its partial
    kernel (``gram_mma_partial<MT, true>``) and the finish, once each."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K + n)
    U = _randn(gen, (K, n), torch.bfloat16, cuda_device)
    g = _randn(gen, (n,), torch.bfloat16, cuda_device)
    calls = 3
    kernels = _device_kernels(lambda: gram_and_cross(U, g), calls, ("gram",))
    assert len(kernels) == 2 and sum(kernels.values()) == 2 * calls, kernels
    assert any("gram_mma_partial<" in k and ", true>" in k
               for k in kernels), kernels
    assert any("gram_mma_finish" in k for k in kernels), kernels


def test_gram_realign_has_the_mma_grid(cuda_device):
    """For every 16-row tile count the realigning partial kernel is as
    resident as the aligned one (the grid both take is sized from the
    aligned one's occupancy); its ring holds one stage more at MT = 5, 6."""
    from repro_torch.kernels import gram
    for K in (1, 15, 16, 31, 32, 47, 48, 63, 64, 79, 80, 95, 96, 111, 112,
              127):
        blocks, smem = gram.mma_launch_config(K, cuda_device.index or 0)
        got = gram.realign_launch_config(K, cuda_device.index or 0)
        mt = gram.mma_rows(K) // 16
        assert got == (blocks, smem * (4 if mt in (5, 6) else 3) // 3), K


def test_gram_realign_body_choice_is_checked(cuda_device):
    """``body="realign"`` takes any bf16 call with K <= 127 and refuses f32,
    mixed dtypes and K = 128; ``body="mma"`` refuses an odd n and a view 2
    bytes in; ``cuda_core`` takes them all, within 1e-4 of the plain
    version."""
    from repro_torch.kernels import gram
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(41)
    bf16 = torch.bfloat16
    U = _randn(gen, (10, 1001), bf16, cuda_device)
    g = _randn(gen, (1001,), bf16, cuda_device)
    with pytest.raises(ValueError, match="mma body"):
        gram_cuda(U, g, body="mma")
    shifted, g1024 = _gram_shifted(gen, 10, 1024, 1, cuda_device)
    with pytest.raises(ValueError, match="mma body"):
        gram_cuda(shifted, g1024, body="mma")
    for u, gg in ((U.float(), g.float()), (U, g.float()), (U.float(), g),
                  (_randn(gen, (128, 1001), bf16, cuda_device), g)):
        with pytest.raises(ValueError, match="realign body"):
            gram_cuda(u, gg, body="realign")
    Gr, cr = ref.gram_ref(U, g)
    for body in ("realign", "cuda_core"):
        G, c = gram_cuda(U, g, body=body)
        assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4


# gram's f32 body (csrc/gram_f32.cu): the stream's K <= 8 and its edge,
# the tile body's one slice (K + 1 = 64, 65, 66; 101; 128) and its slices
# past 127 rows; n ragged (4-byte reads) and n % 4 == 0 (16-byte reads)
GRAM_F32_K = [1, 2, 8, 9, 17, 63, 64, 65, 100, 127, 128, 129, 500]
GRAM_F32_N = [1, 3, 130, 4096, 7850, (1 << 20) + 3, 1 << 20]


def _check_gram_f32(U, g):
    """Two calls of gram's f32 body: one launch each on ``f32``, bitwise
    equal, G exactly symmetric, within 1e-4 of the plain version."""
    from repro_torch.kernels import gram
    gram.reset_body_launches()
    reset_launch_counts()
    G, c = gram_and_cross(U, g)
    G2, c2 = gram_and_cross(U, g)
    assert launch_counts()["gram/cuda"] == 2
    assert launch_counts()["gram/torch"] == 0
    assert gram.body_launches() == {"mma": 0, "realign": 0, "f32": 2,
                                    "cuda_core": 0}
    assert torch.equal(G, G2) and torch.equal(c, c2)      # no float atomics
    assert torch.equal(G, G.T)
    Gr, cr = ref.gram_ref(U, g)
    assert _rel_err(G, Gr) <= 1e-4 and _rel_err(c, cr) <= 1e-4
    return G, c


@pytest.mark.parametrize("n", GRAM_F32_N)
@pytest.mark.parametrize("K", GRAM_F32_K)
def test_gram_f32_body(cuda_device, K, n):
    """f32 U and g take the f32 body, aligned and as row views that start 4
    bytes into their buffers (4-byte reads however n falls)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 7919 + n)
    U = _randn(gen, (K, n), torch.float32, cuda_device)
    g = _randn(gen, (n,), torch.float32, cuda_device)
    _check_gram_f32(U, g)
    shifted = _randn(gen, (K * n + 1,), torch.float32, cuda_device)[1:]
    g_shifted = _randn(gen, (n + 1,), torch.float32, cuda_device)[1:]
    from repro_torch.kernels import gram
    assert not gram._f32_vec(shifted.view(K, n), g_shifted)
    _check_gram_f32(shifted.view(K, n), g_shifted)


@pytest.mark.parametrize("K,n", [(1, 1), (5, 7850), (4, 1 << 20), (9, 130),
                                 (100, 7850), (100, 1 << 20), (500, 68),
                                 (2000, 68), (129, 1 << 16)])
def test_gram_f32_body_is_one_kernel_a_call(cuda_device, K, n):
    """One device kernel a call, whether one block owns each slice (it
    writes G and c) or the blocks' partials are summed in the same launch,
    and no allocation past the outputs where one block owns a slice."""
    from repro_torch.kernels import gram
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K + n)
    U = _randn(gen, (K, n), torch.float32, cuda_device)
    g = _randn(gen, (n,), torch.float32, cuda_device)
    calls = 3
    kernels = _device_kernels(lambda: gram_and_cross(U, g), calls, ("gram",))
    assert len(kernels) == 1 and sum(kernels.values()) == calls, kernels
    assert "gram_f32" in next(iter(kernels))
    vec = gram._f32_vec(U, g)
    blocks, _, floats = gram.f32_call_plan(K, n, vec, U.device.index)
    assert (floats == 0) is (blocks == 1)
    if n <= 128:
        assert blocks == 1


def test_gram_f32_body_against_f64_at_model_width(cuda_device):
    """K = 100, n = 2^22 f32: the f32 body and the plain version, each
    against an f64 product (the kernel within 1e-4)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(101)
    U = _randn(gen, (100, 1 << 22), torch.float32, cuda_device)
    g = _randn(gen, (1 << 22,), torch.float32, cuda_device)
    G, c = _check_gram_f32(U, g)
    G64, c64 = _gram_f64(U, g)
    Gr, cr = ref.gram_ref(U, g)
    kernel = max(_rel_err(G.double(), G64), _rel_err(c.double(), c64))
    plain = max(_rel_err(Gr.double(), G64), _rel_err(cr.double(), c64))
    print(f"gram K=100 n=2^22 f32 against f64: kernel {kernel:.3e}, "
          f"plain {plain:.3e}")
    assert kernel <= 1e-4


def test_gram_body_is_forced_and_checked(cuda_device):
    """``body="cuda_core"`` runs an f32 call on gram.cu (the comparison
    body) within 1e-4 of the f32 body's; ``body="f32"`` on bf16 and
    ``body="mma"`` or ``body="realign"`` on f32 raise; an unknown body
    raises."""
    from repro_torch.kernels import gram
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    U = _randn(gen, (25, 7850), torch.float32, cuda_device)
    g = _randn(gen, (7850,), torch.float32, cuda_device)
    gram.reset_body_launches()
    G, c = gram_cuda(U, g)
    G1, c1 = gram_cuda(U, g, body="cuda_core")
    G2, c2 = gram_cuda(U, g, body="f32")
    assert gram.body_launches() == {"mma": 0, "realign": 0, "f32": 2,
                                    "cuda_core": 1}
    assert torch.equal(G, G2) and torch.equal(c, c2)
    assert _rel_err(G1, G) <= 1e-4 and _rel_err(c1, c) <= 1e-4
    with pytest.raises(ValueError, match="f32 body"):
        gram_cuda(U.bfloat16(), g.bfloat16(), body="f32")
    with pytest.raises(ValueError, match="mma body"):
        gram_cuda(U, g, body="mma")
    with pytest.raises(ValueError, match="realign body"):
        gram_cuda(U, g, body="realign")
    with pytest.raises(ValueError, match="body"):
        gram_cuda(U, g, body="wide")


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
    assert single_block(n, k)
    v = torch.randn(n, device=cuda_device)
    topk_cuda(v, k)
    torch.cuda.synchronize()
    reset_launch_counts()
    topk_cuda(v, k)
    assert launch_counts()["topk/cuda"] == 1
    on_card = list(_device_kernels(lambda: topk_cuda(v, k), 1).items())
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
    U = torch.randn(K, 7850, device=cuda_device)
    sign_sketch(U, 5, 1962)
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(3):
        sign_sketch(U, 5, 1962)
    assert launch_counts()["sign_sketch/cuda"] == 3
    on_card = list(_device_kernels(lambda: sign_sketch(U, 5, 1962),
                                   3).items())
    # a profiler window may lose launches, never add one
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
    assert stream.body_launches() == {"mma": 2, "f32": 0, "cross": 0}
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
    cross.cuh body (each the body ``_body`` gives it), with its results
    unchanged."""
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
        took = stream._body(D, GM)
        assert took == "cross"
        stream.reset_body_launches()
        G, C = stream_stats(D, GM)
        want = dict.fromkeys(stream.BODIES, 0)
        want[took] = 1
        assert stream.body_launches() == want
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
    assert gram.block_body_launches() == {"mma": 2, "f32": 0, "cross": 0}
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
    starting 2 bytes into its buffer keep cross.cuh's body (each the body
    ``_block_body`` gives it), with its results unchanged."""
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
        took = gram._block_body(ua, ub, gg)
        assert took == "cross"
        gram.reset_block_body_launches()
        G, c = gram_block_and_cross(ua, ub, gg)
        want = dict.fromkeys(gram.BLOCK_BODIES, 0)
        want[took] = 1
        assert gram.block_body_launches() == want
        Gr, cr = ref.gram_block_ref(ua, ub, gg)
        assert _rel_err(G, Gr) <= CROSS_TOL and _rel_err(c, cr) <= CROSS_TOL


# the f32 body of gram_block and stream_stats (csrc/cross_f32.cu): every
# row count's tile edges (1, 7-9, 63-65, 127-128 rows), the paths' 10, 25
# and 100, and two row groups a side past 128; n ragged (4-byte copies),
# 130 (one block a slice), the paths' 7 850 and 2^20 + 3 (split columns)
CROSS_F32_K = [1, 7, 8, 9, 10, 25, 32, 63, 64, 65, 100, 127, 128, 200]
CROSS_F32_N = [1, 3, 130, 7850, (1 << 20) + 3]
CROSS_F32_P = [1, 3, 16, 65, 100, 128]


def _joint_err(got, want) -> float:
    """max |got - want| over every output of one product, relative to
    max(1, max |want|) over all of them: the product A Bᵀ the f32 body
    forms, B = [U_b; g] (or [D; GM]), as one (Ka, Kb + 1) output, since a
    lone entry that cancels (Ka = Kb = 1 at n = 2^20 + 3: 1.45 out of terms
    of 666 000 in magnitude, the plain version itself 6e-5 off an f64
    product) is no scale for f32 sums on its own."""
    scale = max(1.0, max(float(w.float().abs().max()) for w in want))
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want)) / scale


def _check_gram_block_f32(ua, ub, g):
    """Two calls of gram_block's f32 body: one launch each on ``f32``,
    bitwise equal, within CROSS_TOL of the plain version (over (G_ab, c_a)
    as one product, :func:`_joint_err`)."""
    from repro_torch.kernels import gram
    assert gram._block_body(ua, ub, g) == "f32"
    gram.reset_block_body_launches()
    reset_launch_counts()
    G, c = gram_block_and_cross(ua, ub, g)
    G2, c2 = gram_block_and_cross(ua, ub, g)
    assert launch_counts()["gram_block/cuda"] == 2
    assert launch_counts()["gram_block/torch"] == 0
    assert gram.block_body_launches() == {"mma": 0, "f32": 2, "cross": 0}
    assert torch.equal(G, G2) and torch.equal(c, c2)      # no float atomics
    (Ka, n), Kb = ua.shape, ub.shape[0]
    assert tuple(G.shape) == (Ka, Kb) and tuple(c.shape) == (Ka,)
    assert _joint_err((G, c), ref.gram_block_ref(ua, ub, g)) <= CROSS_TOL
    return G, c


@pytest.mark.parametrize("Kb", CROSS_F32_K)
@pytest.mark.parametrize("Ka", CROSS_F32_K)
def test_gram_block_f32_body(cuda_device, Ka, Kb):
    """f32 U_a, U_b and g take the f32 body at every n of CROSS_F32_N, as
    row blocks of one matrix."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(Ka * 7919 + Kb)
    for n in CROSS_F32_N:
        U = _randn(gen, (Ka + Kb, n), torch.float32, cuda_device)
        g = _randn(gen, (n,), torch.float32, cuda_device)
        _check_gram_block_f32(U[:Ka], U[Ka:], g)


@pytest.mark.parametrize("n", [3, 130, 7840, 7850])
def test_gram_block_f32_body_on_views_and_windows(cuda_device, n):
    """Column windows of wider matrices (row strides 8 000 and 8 003, the
    16-byte copies where every row and n allow them) and a g that starts 4
    bytes into its buffer go in as they lie."""
    from repro_torch.kernels import cross
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    for width, start, g_in in ((8000, 100, 0), (8000, 101, 0),
                               (8003, 100, 1)):
        wa = _randn(gen, (25, width), torch.float32, cuda_device)
        wb = _randn(gen, (100, width), torch.float32, cuda_device)
        g = _randn(gen, (n + g_in,), torch.float32, cuda_device)[g_in:]
        ua, ub = wa[:, start:start + n], wb[:, start:start + n]
        assert not ua.is_contiguous()
        vec = cross.f32_vec(n, ua.data_ptr(), ua.stride(0), 25,
                            ub.data_ptr(), ub.stride(0), 100, g.data_ptr(),
                            1, 1)
        assert vec == (n % 4 == 0 and width % 4 == 0 and start % 4 == 0
                       and g_in == 0)
        _check_gram_block_f32(ua, ub, g)
        _check_gram_block_f32(ub, ua, g)


def _check_stream_stats_f32(D, GM):
    """Two calls of stream_stats' f32 body: one launch each on ``f32``,
    bitwise equal, G exactly symmetric, within CROSS_TOL of the plain
    version (over (G, C) as one product, :func:`_joint_err`), and ``out=``
    adding into running sums."""
    from repro_torch.kernels import stream
    assert stream._body(D, GM) == "f32"
    stream.reset_body_launches()
    reset_launch_counts()
    G, C = stream_stats(D, GM)
    G2, C2 = stream_stats(D, GM)
    assert launch_counts()["stream_stats/cuda"] == 2
    assert launch_counts()["stream_stats/torch"] == 0
    assert stream.body_launches() == {"mma": 0, "f32": 2, "cross": 0}
    assert torch.equal(G, G2) and torch.equal(C, C2)      # no float atomics
    assert torch.equal(G, G.T)
    Gr, Cr = ref.stream_stats_ref(D, GM)
    assert _joint_err((G, C), (Gr, Cr)) <= CROSS_TOL
    out = (G.clone(), C.clone())
    assert stream_stats(D, GM, out=out) is out            # adds into out
    assert torch.equal(out[0], out[0].T)
    assert _joint_err(out, (2 * Gr, 2 * Cr)) <= CROSS_TOL
    assert stream.body_launches()["f32"] == 3
    return G, C


@pytest.mark.parametrize("n", CROSS_F32_N + [7840])
@pytest.mark.parametrize("P", CROSS_F32_P)
def test_stream_stats_f32_body(cuda_device, P, n):
    """f32 D and GM take the f32 body; with ``out=`` it adds."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(P * 131 + n)
    _check_stream_stats_f32(_randn(gen, (P, n), torch.float32, cuda_device),
                            _randn(gen, (P, n), torch.float32, cuda_device))


def test_stream_stats_f32_body_on_views_and_windows(cuda_device):
    """A (P, width) view of a stacked leaf, rank windows of a slab (row
    stride 400, and 7 840 with 16-byte copies) and two slabs summed into
    running (G, C) as the streamed engine sums a round's leaves."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(400)
    leaf = _randn(gen, (100, 784, 10), torch.float32, cuda_device)
    gleaf = _randn(gen, (100, 784, 10), torch.float32, cuda_device)
    _check_stream_stats_f32(leaf.reshape(100, -1), gleaf.reshape(100, -1))
    wide = _randn(gen, (5, 400), torch.float32, cuda_device)
    _check_stream_stats_f32(wide[:, 5:305], wide[:, 90:390])
    slab = _randn(gen, (100, 7840), torch.float32, cuda_device)
    gslab = _randn(gen, (100, 7840), torch.float32, cuda_device)
    _check_stream_stats_f32(slab[:, 1960:3920], gslab[:, 3920:5880])
    bias = _randn(gen, (100, 10), torch.float32, cuda_device)
    gbias = _randn(gen, (100, 10), torch.float32, cuda_device)
    G = torch.zeros(100, 100, device=cuda_device)
    C = torch.zeros(100, 100, device=cuda_device)
    for D, GM in ((slab, gslab), (bias, gbias)):
        stream_stats(D, GM, out=(G, C))
    Gw, Cw = ref.stream_stats_ref(slab, gslab)
    Gb, Cb = ref.stream_stats_ref(bias, gbias)
    assert torch.equal(G, G.T)
    assert _rel_err(G, Gw + Gb) <= CROSS_TOL
    assert _rel_err(C, Cw + Cb) <= CROSS_TOL


@pytest.mark.parametrize("op,rows,n", [
    ("gram_block", (10, 10), 7850), ("gram_block", (25, 25), 7850),
    ("gram_block", (100, 100), 7850), ("gram_block", (64, 32), 1 << 20),
    ("gram_block", (3, 130), 130), ("stream_stats", 100, 7840),
    ("stream_stats", 100, 10), ("stream_stats", 65, 1000)])
def test_cross_f32_body_is_one_kernel_a_call(cuda_device, op, rows, n):
    """One device kernel a call, whether one block owns each slice (it
    writes the outputs) or the blocks' partials are summed in the same
    launch; no scratch where one block owns a slice."""
    from repro_torch.kernels import cross
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    if op == "gram_block":
        Ka, Kb = rows
        args = (_randn(gen, (Ka, n), torch.float32, cuda_device),
                _randn(gen, (Kb, n), torch.float32, cuda_device),
                _randn(gen, (n,), torch.float32, cuda_device))
        call, plan = gram_block_and_cross, (Ka, Kb, 1, False)
    else:
        args = (_randn(gen, (rows, n), torch.float32, cuda_device),
                _randn(gen, (rows, n), torch.float32, cuda_device))
        call, plan = stream_stats, (rows, rows, rows, True)
    calls = 3
    kernels = _device_kernels(lambda: call(*args), calls, ("cross",))
    assert len(kernels) == 1 and sum(kernels.values()) == calls, kernels
    assert "cross_f32" in next(iter(kernels))
    if op == "gram_block":
        srcs = [(t.data_ptr(), t.stride(0), t.shape[0] if t.dim() == 2 else 1)
                for t in args]
    else:
        srcs = [(t.data_ptr(), t.stride(0), rows) for t in (args[0], *args)]
    vec = cross.f32_vec(n, *(v for src in srcs for v in src))
    level, blocks, _, floats = cross.f32_call_plan(*plan, n, vec,
                                                   args[0].device.index)
    per_sm, slices, block_floats = cross.f32_launch_config(
        *plan, level, vec, args[0].device.index)
    cuts = cross.F32Cuts.of(*plan, level)
    assert slices == cuts.slices()
    assert block_floats == 64 * cross.f32_plan(cuts)["budget"]
    assert floats == cross.f32_scratch_floats(cuts, blocks)
    assert (floats == 0) is (blocks == 1)
    if n <= 128:
        assert blocks == 1


def test_cross_f32_body_against_f64_at_model_width(cuda_device):
    """gram_block at Ka = 64, Kb = 32, n = 2^22 f32: the f32 body and the
    plain version, each against an f64 product (the kernel within
    CROSS_TOL)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6432)
    U = _randn(gen, (96, 1 << 22), torch.float32, cuda_device)
    g = _randn(gen, (1 << 22,), torch.float32, cuda_device)
    G, c = _check_gram_block_f32(U[:64], U[64:], g)
    G64, c64 = _gram_block_f64(U[:64], U[64:], g)
    Gr, cr = ref.gram_block_ref(U[:64], U[64:], g)
    kernel = max(_rel_err(G.double(), G64), _rel_err(c.double(), c64))
    plain = max(_rel_err(Gr.double(), G64), _rel_err(cr.double(), c64))
    print(f"gram_block 64 x 32 n=2^22 f32 against f64: kernel {kernel:.3e}, "
          f"plain {plain:.3e}")
    assert kernel <= CROSS_TOL


def test_cross_f32_bodies_are_forced_and_checked(cuda_device):
    """``body="cross"`` runs an f32 call on cross.cuh (the comparison body)
    within CROSS_TOL of the f32 body's; ``body="f32"`` equals the default
    on f32 and raises on bf16; ``body="mma"`` on f32 raises."""
    from repro_torch.kernels import gram, stream
    from repro_torch.kernels.stream import stream_stats_cuda
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(9)
    ua = _randn(gen, (25, 7850), torch.float32, cuda_device)
    ub = _randn(gen, (25, 7850), torch.float32, cuda_device)
    g = _randn(gen, (7850,), torch.float32, cuda_device)
    gram.reset_block_body_launches()
    G, c = gram_block_cuda(ua, ub, g)
    G1, c1 = gram_block_cuda(ua, ub, g, body="cross")
    G2, c2 = gram_block_cuda(ua, ub, g, body="f32")
    assert gram.block_body_launches() == {"mma": 0, "f32": 2, "cross": 1}
    assert torch.equal(G, G2) and torch.equal(c, c2)
    assert _rel_err(G1, G) <= CROSS_TOL and _rel_err(c1, c) <= CROSS_TOL
    with pytest.raises(ValueError, match="f32 body"):
        gram_block_cuda(ua.bfloat16(), ub.bfloat16(), g.bfloat16(),
                        body="f32")
    with pytest.raises(ValueError, match="mma body"):
        gram_block_cuda(ua, ub, g, body="mma")
    D, GM = ua[:, :7840], ub[:, :7840]
    stream.reset_body_launches()
    G, C = stream_stats_cuda(D, GM)
    G1, C1 = stream_stats_cuda(D, GM, body="cross")
    assert stream.body_launches() == {"mma": 0, "f32": 1, "cross": 1}
    assert _rel_err(G1, G) <= CROSS_TOL and _rel_err(C1, C) <= CROSS_TOL
    with pytest.raises(ValueError, match="f32 body"):
        stream_stats_cuda(D.bfloat16(), GM.bfloat16(), body="f32")
    with pytest.raises(ValueError, match="body"):
        stream_stats_cuda(D, GM, body="wide")


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
    assert sketch.body_launches() == {"mma": 2, "realign": 0, "f32": 0,
                                      "cross": 0}
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
    """The calls the aligned tensor-core body does not take, each on the
    body it now takes, within CROSS_TOL of the plain version: f32 on
    cross_f32.cu (``f32``); mixed dtypes each way and K = 65 keep
    cross.cuh's body (``cross``); n % 8 != 0, row blocks of one matrix at
    an odd n, a row stride that is no multiple of 8, and a bf16 U or R
    starting 2 bytes into its buffer take the realigning tensor-core body
    (``realign``)."""
    from repro_torch.kernels import sketch
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6565)
    bf16, f32 = torch.bfloat16, torch.float32

    def r(*shape, dtype=bf16):
        return _randn(gen, shape, dtype, cuda_device)

    M = r(8 + 129, 1001)
    cases = [(r(8, 1024, dtype=f32), r(129, 1024, dtype=f32), "f32"),
             (r(8, 1024, dtype=f32), r(129, 1024), "cross"),
             (r(8, 1024), r(129, 1024, dtype=f32), "cross"),
             (r(65, 1024), r(129, 1024), "cross"),
             (r(8, 1001), r(129, 1001), "realign"),
             (M[:8], M[8:], "realign"),
             (r(8, 1028)[:, :1024], r(129, 1024), "realign"),
             (r(8 * 1024 + 1)[1:].view(8, 1024), r(129, 1024), "realign"),
             (r(8, 1024), r(129 * 1024 + 1)[1:].view(129, 1024), "realign")]
    for U, R, body in cases:
        assert not sketch._mma_eligible(U, R)
        assert sketch._body(U, R) == body
        sketch.reset_body_launches()
        S = sketch_apply(U, R)
        assert sketch.body_launches() == dict(
            {"mma": 0, "realign": 0, "f32": 0, "cross": 0}, **{body: 1})
        assert _rel_err(S, ref.sketch_ref(U, R)) <= CROSS_TOL


def _shifted(gen, rows, n, skip, device, dtype=torch.bfloat16):
    """A (rows, n) bf16 view starting ``skip`` entries into a fresh buffer:
    every row starts 2·skip bytes past a 16-byte boundary when n % 8 == 0."""
    buf = _randn(gen, (rows * n + 8,), dtype, device)
    return buf[skip:skip + rows * n].view(rows, n)


SKETCH_REALIGN_M = [1, 17, 128, 129, 1024]


@pytest.mark.parametrize("skip", range(1, 8))
@pytest.mark.parametrize("K", SKETCH_MMA_K)
def test_sketch_realign_equals_mma_bitwise(cuda_device, K, skip):
    """U and R viewed 2·s bytes into their buffers (s = 1..7; R at another
    shift) take the realigning body, and at n % 8 == 0 it equals
    sketch_mma.cu on an aligned copy of the same values bit for bit, for m
    across the slices' edges and a ragged last staged tile (n = 4 104);
    ``body="realign"`` on the aligned copy gives the same bits too."""
    from repro_torch.kernels import sketch
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 64 + skip)
    for m in SKETCH_REALIGN_M:
        for n in (8, 4104):
            U = _shifted(gen, K, n, skip, cuda_device)
            R = _shifted(gen, m, n, (3 * skip) % 8, cuda_device)
            Ua, Ra = U.clone(), R.clone()
            assert sketch._body(U, R) == "realign"
            assert sketch._body(Ua, Ra) == "mma"
            sketch.reset_body_launches()
            S = sketch_apply(U, R)
            Sa = sketch_apply(Ua, Ra)
            Sf = sketch_apply_cuda(Ua, Ra, body="realign")
            assert sketch.body_launches() == {"mma": 1, "realign": 2,
                                              "f32": 0, "cross": 0}
            assert torch.equal(S, Sa) and torch.equal(Sf, Sa), (m, n)


@pytest.mark.parametrize("K,m,n", [(1, 1, 1), (7, 5, 7), (8, 129, 1001),
                                   (3, 17, 1003), (64, 256, 4103),
                                   (9, 1025, 4097), (57, 130, 2049),
                                   (8, 1024, (1 << 20) + 3)])
def test_sketch_realign_against_f64_at_odd_n(cuda_device, K, m, n):
    """bf16 U and R at an odd n (every row but the first starts only 2-byte
    aligned) take the realigning body: two calls bitwise equal, within
    CROSS_TOL of an f64 product and of the plain version."""
    from repro_torch.kernels import sketch
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K * 131 + m + n)
    U = _randn(gen, (K, n), torch.bfloat16, cuda_device)
    R = _randn(gen, (m, n), torch.bfloat16, cuda_device)
    sketch.reset_body_launches()
    S = sketch_apply(U, R)
    S2 = sketch_apply(U, R)
    assert sketch.body_launches()["realign"] == 2
    assert torch.equal(S, S2)
    S64 = U.double() @ R.double().T
    assert _rel_err(S.double(), S64) <= CROSS_TOL
    assert _rel_err(S, ref.sketch_ref(U, R)) <= CROSS_TOL


@pytest.mark.parametrize("K,m,n", [(8, 1024, 1 << 16),
                                   (8, 1024, (1 << 20) + 3), (3, 17, 130),
                                   (100, 65, 777), (1, 1, 1), (65, 129, 1001)])
def test_sketch_f32_body_is_one_kernel_a_call(cuda_device, K, m, n):
    """f32 U and R take cross_f32.cu (``f32``): one device kernel a call
    (``torch.profiler``), two calls bitwise equal, within CROSS_TOL of
    cross.cuh's body (``body="cross"``) and of an f64 product."""
    from repro_torch.kernels import sketch
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K + m + n)
    U = _randn(gen, (K, n), torch.float32, cuda_device)
    R = _randn(gen, (m, n), torch.float32, cuda_device)
    sketch.reset_body_launches()
    S = sketch_apply(U, R)
    S2 = sketch_apply(U, R)
    X = sketch_apply_cuda(U, R, body="cross")
    assert sketch.body_launches() == {"mma": 0, "realign": 0, "f32": 2,
                                      "cross": 1}
    assert torch.equal(S, S2)
    assert _rel_err(S, X) <= CROSS_TOL
    assert _rel_err(S.double(), U.double() @ R.double().T) <= CROSS_TOL
    calls = 3
    kernels = _device_kernels(lambda: sketch_apply(U, R), calls,
                              ("cross", "sketch"))
    assert len(kernels) == 1 and sum(kernels.values()) == calls, kernels
    assert "cross_f32" in next(iter(kernels))


def test_sketch_body_choice_is_checked(cuda_device):
    """``body=`` names one of four bodies and refuses a call the body cannot
    take: ``mma`` off aligned bf16 rows, ``realign`` on f32 or K > 64,
    ``f32`` on bf16; ``cross`` takes any call, within CROSS_TOL of the
    default body."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(40)
    U = _randn(gen, (8, 1001), torch.bfloat16, cuda_device)
    R = _randn(gen, (129, 1001), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="mma body"):
        sketch_apply_cuda(U, R, body="mma")
    with pytest.raises(ValueError, match="f32 body"):
        sketch_apply_cuda(U, R, body="f32")
    with pytest.raises(ValueError, match="realign body"):
        sketch_apply_cuda(U.float(), R.float(), body="realign")
    with pytest.raises(ValueError, match="realign body"):
        sketch_apply_cuda(_randn(gen, (65, 1001), torch.bfloat16,
                                 cuda_device), R, body="realign")
    with pytest.raises(ValueError, match="body"):
        sketch_apply_cuda(U, R, body="wide")
    S = sketch_apply_cuda(U, R)
    for u, rr in ((U, R), (U.float(), R.float()), (U.float(), R)):
        X = sketch_apply_cuda(u, rr, body="cross")
        assert _rel_err(X, sketch_apply_cuda(u, rr)) <= CROSS_TOL
    assert _rel_err(sketch_apply_cuda(U, R, body="cross"), S) <= CROSS_TOL


@pytest.mark.parametrize("body", ["mma", "realign", "f32", "cross"])
def test_sketch_bodies_are_bitwise_repeatable(cuda_device, body):
    """Two calls of each body on the same inputs are bitwise equal (no
    float atomics): bf16 K = 8, m = 1 025, n = 4 104 for ``mma`` and
    ``realign`` (forced on the aligned rows too), f32 for ``f32``, mixed
    for ``cross``."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4104)
    dt = torch.float32 if body == "f32" else torch.bfloat16
    U = _randn(gen, (8, 4104), dt, cuda_device)
    R = _randn(gen, (1025, 4104), dt, cuda_device)
    if body == "cross":
        U = U.float()
    S = sketch_apply_cuda(U, R, body=body)
    assert torch.equal(S, sketch_apply_cuda(U, R, body=body))
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
    version, both on the body the inputs route to (the cluster body for
    bf16 q, k and v at hd 64 or 128, the CUDA-core body otherwise)."""
    body = "cluster" if decode_attn._mma_eligible(q, k, v) else "cuda_core"
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
    assert decode_attn.body_launches() == {"cluster": 1, "mma": 0,
                                           "cuda_core": 1}
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


@pytest.mark.parametrize("body,dtype", [("cluster", torch.bfloat16),
                                        ("mma", torch.bfloat16),
                                        ("cuda_core", torch.bfloat16),
                                        ("cuda_core", torch.float32)])
@pytest.mark.parametrize("window", [None, 100, 700])
def test_flash_decode_on_seq_blocks_merges_to_the_whole(cuda_device, body,
                                                         dtype, window):
    """Each body on 16 seq blocks of 64 rows, called with local lengths
    (position + 1 - the block's first row: <= 0 past the position, past 64
    before it): every block's partials within DECODE_TOL of the plain
    version's, a row with no live key in its block o = 0 and lse <= -1e30
    with no NaN, and the blocks merged by ``lse_merge`` within DECODE_TOL of
    one whole-cache call and of the plain version.  A window of 100 or 700
    starts inside a block and crosses block edges."""
    from repro_torch.kernels.ops import lse_merge
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(17)
    S, rows = 1024, 64
    q, k, v, lengths = _decode_case(gen, cuda_device, 4, S, 2, 5, 128, dtype,
                                    [1, 70, 640, 1024])
    whole = decode_attn.flash_decode_cuda(q, k, v, lengths, window=window,
                                          body=body)
    want = flash_decode(q, k, v, lengths, window=window, backend="torch")
    parts = []
    for j in range(S // rows):
        kb, vb = k[:, j * rows:(j + 1) * rows], v[:, j * rows:(j + 1) * rows]
        local = lengths - j * rows
        got = decode_attn.flash_decode_cuda(q, kb, vb, local, window=window,
                                            body=body)
        plain = flash_decode(q, kb, vb, local, window=window,
                             backend="torch")
        lo = (lengths - window).clamp(min=0) if window else 0 * lengths
        dead = (local <= 0) | (lo >= (j + 1) * rows)
        o, lse = got
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        assert (o[dead] == 0).all() and (lse[dead] <= -1e30).all()
        assert (plain[1][dead] <= -1e30).all()
        assert _rel_err(o, plain[0]) <= DECODE_TOL
        if (~dead).any():       # the dead rows' -1e30 would set the scale
            assert _rel_err(lse[~dead], plain[1][~dead]) <= DECODE_TOL
        parts.append(got)
    merged = lse_merge(torch.stack([o for o, _ in parts]),
                       torch.stack([lse for _, lse in parts]))
    for m, a, w in zip(merged, whole, want):
        assert _rel_err(m, a) <= DECODE_TOL and _rel_err(m, w) <= DECODE_TOL


def _plans(q, k, window=None, softcap=None):
    """``(cluster plan, mma plan)`` of a bf16 call: (splits, rows)."""
    B, S, KV, hd = k.shape
    key = (B, S, KV, q.shape[2], hd, True, True, k.stride(), k.stride(),
           window, softcap, k.device.index)
    return tuple((p.splits, p.rows) for p in (
        decode_attn._plan("cluster", *key), decode_attn._plan("mma", *key)))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, None),
                                            (300, 30.0), (None, 50.0)])
def test_flash_decode_cluster_body_is_bitwise_the_mma_body(cuda_device, hd,
                                                            G, window,
                                                            softcap):
    """The cluster body (one launch, the splits merged through distributed
    shared memory in split order) against the mma body's two launches on
    the same split plan (8 heads: the cluster cap does not bind): bitwise
    equal, o and lse; both within DECODE_TOL of plain."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7 * hd + G)
    S = 1000
    lengths = [1, 63, 64, 65, 299, 300, 301, S]
    q, k, v, ln = _decode_case(gen, cuda_device, len(lengths), S, 1, G, hd,
                               torch.bfloat16, lengths)
    kw = dict(window=window, softcap=softcap)
    cluster_plan, mma_plan = _plans(q, k, window, softcap)
    assert cluster_plan == mma_plan and cluster_plan[0] > 1
    decode_attn.reset_body_launches()
    got = decode_attn.flash_decode_cuda(q, k, v, ln, **kw)
    mma = decode_attn.flash_decode_cuda(q, k, v, ln, body="mma", **kw)
    assert decode_attn.body_launches() == {"cluster": 1, "mma": 1,
                                           "cuda_core": 0}
    want = flash_decode(q, k, v, ln, backend="torch", **kw)
    for g, m, w in zip(got, mma, want):
        assert torch.equal(g, m)
        assert _rel_err(g, w) <= DECODE_TOL


@pytest.mark.parametrize("S,KV,window", [(8192, 1, None), (20000, 2, 4096),
                                         (131072, 1, None)])
def test_flash_decode_cluster_body_at_the_cap(cuda_device, S, KV, window):
    """Few heads on a long cache: the splits of a head are capped at the
    largest cluster the card co-schedules (16 on an H100), where the
    two-launch body takes more; still within DECODE_TOL of plain, and
    bitwise repeatable."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(S + KV)
    q, k, v, ln = _decode_case(gen, cuda_device, 2, S, KV, 5, 128,
                               torch.bfloat16, [S, S // 2 + 3])
    cap = decode_attn.cluster_cap(128, 2 * KV, k.device.index)
    cluster_plan, mma_plan = _plans(q, k, window)
    assert cluster_plan[0] <= cap < mma_plan[0]
    _check_decode(q, k, v, ln, window=window)


@pytest.mark.parametrize("lengths,window", [
    ([0, -64, 1, 1000], None),         # splits of rows 0-2 have no live row
    ([-5, 3, 640, 1000], 100),         # a window inside one split
    ([0, 0, 0, 0], None), ([-1000, -1, 0, 0], 50)])   # no live key at all
def test_flash_decode_cluster_with_dead_splits_returns(cuda_device, lengths,
                                                       window):
    """Splits with no live row still reach both cluster barriers: the call
    returns, rows with no live key give o = 0 and lse = -1e30 (no NaN), and
    the live rows agree with plain and, bitwise, with the mma body."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(29)
    q, k, v, ln = _decode_case(gen, cuda_device, 4, 1000, 2, 5, 128,
                               torch.bfloat16, lengths)
    o, lse = decode_attn.flash_decode_cuda(q, k, v, ln, window=window)
    torch.cuda.synchronize()
    mma = decode_attn.flash_decode_cuda(q, k, v, ln, window=window,
                                        body="mma")
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    dead = ln <= 0
    assert (o[dead] == 0).all() and (lse[dead] <= -1e30).all()
    assert torch.equal(o, mma[0]) and torch.equal(lse, mma[1])
    if (~dead).any():
        want = flash_decode(q, k, v, ln, window=window, backend="torch")
        assert _rel_err(o[~dead], want[0][~dead]) <= DECODE_TOL
        assert _rel_err(lse[~dead], want[1][~dead]) <= DECODE_TOL


@pytest.mark.parametrize("B,S,KV,G,hd", [(4, 256, 8, 5, 128),
                                         (4, 256, 16, 1, 128),
                                         (4, 4096, 32, 1, 64)])
def test_flash_decode_cluster_is_one_kernel_a_call(cuda_device, B, S, KV, G,
                                                   hd):
    """``torch.profiler``: a call of the cluster body is one kernel, no
    ``decode_mma_merge`` and no copy or fill; the mma body's is two."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(B * S)
    q, k, v, ln = _decode_case(gen, cuda_device, B, S, KV, G, hd,
                               torch.bfloat16, [1, S // 3, S - 1, S])
    assert _plans(q, k)[0][0] > 1
    for body, want in (("cluster", ["decode_cluster"]),
                       ("mma", ["decode_mma_partial", "decode_mma_merge"])):
        names = list(_device_kernels(
            lambda body=body: decode_attn.flash_decode_cuda(q, k, v, ln,
                                                            body=body), 4))
        assert len(names) == len(want), names
        for w in want:
            assert any(w in n for n in names), names


def test_flash_decode_body_choice_is_checked(cuda_device):
    q = torch.zeros(1, 1, 1, 128, device=cuda_device)
    k = torch.zeros(1, 8, 1, 128, device=cuda_device)
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="tensor-core body"):
        decode_attn.flash_decode_cuda(q, k, k, one, body="mma")   # f32
    with pytest.raises(ValueError, match="tensor-core body"):
        decode_attn.flash_decode_cuda(q, k, k, one, body="cluster")
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


# --------------------------------------------------------------------- moe

def _moe_cfg(d, ff, E, k, shared, dtype):
    return ArchConfig(name="moe", family="moe", num_layers=1, d_model=d,
                      d_ff=ff, vocab_size=64, num_heads=16, num_kv_heads=16,
                      num_experts=E, experts_per_token=k,
                      num_shared_experts=shared, dtype=dtype)


@pytest.mark.parametrize("T", [4, 64, 320])
def test_moe_layer_never_syncs_and_repeats_bitwise(cuda_device, T):
    """An olmoe-width bf16 layer (E 64, top-8, d 2048, d_ff 1024) with a
    shared expert: no host sync under ``set_sync_debug_mode("error")`` and
    two calls bitwise equal (no float atomics), at decode, a prefill chunk
    and a T > 256 batch that drops entries."""
    cfg = _moe_cfg(2048, 1024, 64, 8, 1, "bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = moe.init_moe(cfg, gen, torch.bfloat16)
    x = torch.randn((1, T, 2048), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    first, aux = moe.moe_forward(cfg, params, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, aux2 = moe.moe_forward(cfg, params, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again) and torch.equal(aux, aux2)
    assert first.dtype == torch.bfloat16 and torch.isfinite(first).all()


@pytest.mark.parametrize("T", [4, 64, 320])
@pytest.mark.parametrize("activation,shared", [("silu", 1), ("gelu", 0)])
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, T, activation,
                                               shared):
    cfg = _moe_cfg(256, 512, 8, 2, shared, "float32").with_overrides(
        activation=activation)
    params = moe.init_moe(cfg, torch.Generator().manual_seed(1),
                          torch.float32)
    params["router"] *= 50.0         # route decisively
    x = torch.randn((1, T, 256), generator=torch.Generator().manual_seed(2))
    want, want_aux = moe.moe_forward(cfg, params, x)
    got, aux = moe.moe_forward(cfg, tree_map(
        lambda a: a.to(cuda_device), params), x.to(cuda_device))
    assert _rel_err(got.cpu(), want) <= 1e-5
    assert _rel_err(aux.cpu(), want_aux) <= 1e-5


def test_moe_engine_on_the_card_equals_the_cpu(cuda_device):
    cfg = get_config("olmoe-1b-7b").reduced(num_layers=1, vocab_size=64)
    params = get_model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (6, 13, 9)]

    def serve(p, device):
        eng = DecodeEngine(cfg, ModelBus(p), num_slots=3, max_seq=40,
                           scan_chunk=4, prefill_chunk_tokens=8,
                           device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(prompt, 5 + rid, rid=rid)
        return {c.rid: c.tokens for c in eng.run()}
    reset_launch_counts()
    on_card = serve(tree_map(lambda a: a.to(cuda_device), params),
                    cuda_device)
    assert launch_counts()["flash_decode/cuda"] > 0
    assert launch_counts()["flash_decode/torch"] == 0
    assert on_card == serve(params, "cpu")


# --------------------------------------------------------------- recurrent

_RECURRENT = {"rwkv6": ("rwkv6-1.6b", {}),
              "zamba2": ("zamba2-1.2b", {"num_layers": 5})}


@pytest.mark.parametrize("name", list(_RECURRENT))
def test_recurrent_lockstep_on_the_card_equals_the_cpu(cuda_device, name):
    """The lockstep loop on a reduced f32 RWKV6 / Zamba2 (two groups and a
    remainder layer), the same weights and prompt on the card and the CPU:
    equal greedy tokens, logits within 1e-5, and no kernel launched (the
    path has none)."""
    from repro_torch.launch.serve import lockstep, lockstep_prompt
    arch, kw = _RECURRENT[name]
    cfg = get_config(arch).reduced(**kw)
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    prompt = lockstep_prompt(cfg, 3, 45, torch.device("cpu"))
    reset_launch_counts()
    card = lockstep(bundle, tree_map(lambda a: a.to(cuda_device), params),
                    tree_map(lambda a: a.to(cuda_device), prompt), 6, 51)
    assert not any(launch_counts().values())
    cpu = lockstep(bundle, params, prompt, 6, 51)
    assert torch.equal(card.tokens.cpu(), cpu.tokens)
    assert _rel_err(card.logits.cpu(), cpu.logits) <= 1e-5


@pytest.mark.parametrize("name", list(_RECURRENT))
def test_recurrent_decode_never_syncs_and_repeats_bitwise(cuda_device, name):
    """A bf16 decode step of a reduced RWKV6 / Zamba2 on the card: no host
    sync under ``set_sync_debug_mode("error")``, and two steps from copies
    of one cache bitwise equal."""
    arch, kw = _RECURRENT[name]
    cfg = get_config(arch).reduced(dtype="bfloat16", **kw)
    bundle = get_model(cfg)
    params = bundle.init(0, device=cuda_device)
    tokens = torch.arange(3 * 45, dtype=torch.int32,
                          device=cuda_device).reshape(3, 45) % cfg.vocab_size
    _, cache = bundle.prefill(params, {"tokens": tokens}, 51)

    def copy(c):
        return c._replace(ssm=type(c.ssm)(*(t.clone() for t in c.ssm)),
                          shared_kv=None if c.shared_kv is None else
                          type(c.shared_kv)(*(t.clone()
                                              for t in c.shared_kv)))
    tok = tokens[:, -1]
    first, c1 = bundle.decode(params, tok, copy(cache))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, c2 = bundle.decode(params, tok, copy(cache))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again)
    assert all(torch.equal(a, b) for a, b in zip(c1.ssm, c2.ssm))
    assert first.dtype == torch.bfloat16 and torch.isfinite(first).all()


# ------------------------------------------------------------------ robust

@pytest.mark.parametrize("name", ["contextual_mom", "contextual_clipped",
                                  "krum", "coordinate_median"])
def test_robust_aggregators_on_the_card_match_the_cpu(cuda_device, name):
    """The flat robust aggregators on the card against the same call on the
    CPU (plain versions): G from ``gram``, the cross matrix from
    ``gram_block`` (its f32 body: f32 inputs), the step through
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
            assert bodies == {"mma": 0, "f32": int(contextual), "cross": 0}
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
    engine's robust stages launch ``gram_block`` (f32 body), the
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
            assert bodies == {"mma": 0, "f32": 3 * 3, "cross": 0}
        else:
            assert counts["gram_block/cuda"] == 0
            assert counts["stream_stats/cuda"] == 3 * 2
        runs.append(res)
    assert runs[0].times == runs[1].times
    assert runs[0].train_loss == runs[1].train_loss
    assert runs[0].dropped == runs[1].dropped


# ------------------------------------------------------------- training

def test_combine_past_int32_elements(cuda_device):
    """A bf16 leaf of 2³¹ + 8 elements (olmoe's stacked expert leaves hold
    exactly 2³¹): every element within one bf16 ulp of the f64 formula,
    taken in chunks, on both bodies."""
    from repro_torch.kernels import combine
    n, chunk = (1 << 31) + 8, 1 << 28
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    w = torch.empty(n, dtype=torch.bfloat16, device=cuda_device)
    U = torch.empty((1, n), dtype=torch.bfloat16, device=cuda_device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        w[s:s + m] = torch.randn(m, generator=gen, device=cuda_device)
        U[0, s:s + m] = 0.01 * torch.randn(m, generator=gen,
                                           device=cuda_device)
    alpha = torch.tensor([0.75], device=cuda_device)
    for body in ("vec", "scalar"):
        out = combine_cuda(w, U, alpha, body=body)
        for s in range(0, n, chunk):
            want = w[s:s + chunk].double() + 0.75 * U[0, s:s + chunk].double()
            _, e = torch.frexp(want.float())
            ulp = torch.ldexp(torch.ones_like(want), e - 8)
            assert float(((out[s:s + chunk].double() - want).abs()
                          / ulp).max()) <= 1.0, (body, s)
        del out
    assert combine.body_launches()["vec"] >= 1


def _reduced_train(name, remat, device):
    from repro_torch.launch.mesh import emulated_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batches
    cfg = get_config(name).reduced()
    bundle = get_model(cfg)
    params = tree_map(lambda a: a.to(device),
                      bundle.init(0, device="cpu"))
    batch = {k: v.to(device) for k, v in
             next(make_batches(cfg, bundle, 8, 32, 1)).items()}
    step = build_train_step(cfg, emulated_mesh((4, 1), ("data", "model")),
                            InputShape("t", "train", 32, 8), remat=remat)
    return step(params, batch)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "zamba2-1.2b",
                                  "whisper-large-v3", "chameleon-34b"])
def test_train_step_on_the_card_equals_the_cpu(cuda_device, name):
    """C = 4 cohorts of a reduced f32 config: the card's step (gram and
    combine through their kernels) equals the CPU's at 1e-5."""
    from repro_torch.core.flatten import tree_leaves
    reset_launch_counts()
    got, m = _reduced_train(name, "full", cuda_device)
    counts = launch_counts()
    assert counts["gram/cuda"] == 1 and counts["combine/cuda"] > 0
    assert all(v == 0 for k, v in counts.items() if k.endswith("/torch"))
    want, wm = _reduced_train(name, "full", "cpu")
    assert _rel_err(m["alpha"].cpu(), wm["alpha"]) <= 1e-5
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert _rel_err(a.cpu(), b) <= 1e-5


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_on_the_card_equals_no_remat(cuda_device, remat):
    from repro_torch.core.flatten import tree_leaves
    for name in ("olmoe-1b-7b", "zamba2-1.2b"):
        got, _ = _reduced_train(name, remat, cuda_device)
        want, _ = _reduced_train(name, False, cuda_device)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert _rel_err(a, b) <= 1e-5
