"""The port's CUDA kernels on the card (``@pytest.mark.cuda``).

Every test here decides inside itself (through the ``cuda_device`` fixture)
whether a CUDA device exists and skips without one, so every worker collects
the same tests.  The file imports torch and ``repro_torch`` only — no JAX —
so it runs on a machine that has just PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are relative to max(1, max |plain|): gram 1e-4 (f32 and bf16
inputs both accumulate in f32, so the kernel and ``torch.matmul`` differ in
summation order only); combine 1e-5 in f32 and 3e-2 for a bf16 output (one
bf16 rounding), as the reference's kernel tests; sign_sketch and its adjoint
1e-5 (f32 sums in another order).  topk is held exactly: the same values
and indices as the plain version on the same tensor.
"""
import numpy as np
import pytest
import torch

from repro_torch.compress import CompressConfig
from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.edge import uniform_fleet
from repro_torch.fl import ServerConfig, run_hier_simulation, run_simulation
from repro_torch.hier import HierConfig, star_topology, two_tier_topology
from repro_torch.kernels import (gram_and_cross, launch_counts,
                                 reset_launch_counts, sign_sketch,
                                 sign_sketch_adjoint, topk_select,
                                 weighted_combine)
from repro_torch.kernels import ref
from repro_torch.kernels.combine import combine_cuda
from repro_torch.kernels.gram import gram_cuda
from repro_torch.kernels.rng_sketch import (sign_sketch_adjoint_cuda,
                                            sign_sketch_cuda)
from repro_torch.kernels.topk import topk_cuda
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)

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


@pytest.mark.parametrize("K", [65, 100, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_past_64_rows(cuda_device, K, dtype):
    """K > 64 runs as one grid slice per pair (a, b >= a) of 32-row blocks;
    each slice writes only its own entries of G and c, and the result stays
    bitwise repeatable."""
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


def _tie_vectors(device):
    n = 130
    return {
        "all_equal": torch.full((n,), 2.5, device=device)
        * torch.where(torch.arange(n, device=device) % 3 == 0, -1.0, 1.0),
        "zeros": torch.zeros(n, device=device),
        "signed_zeros": torch.tensor([0.0, -0.0] * (n // 2), device=device),
        "few_values": (torch.arange(n, device=device) % 4).float() - 1.5,
    }


def _assert_topk_equal(got, want):
    assert torch.equal(got[1], want[1])
    # values bitwise (keeps the sign of -0.0)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("n", [1, 130, 7850, (1 << 20) + 3])
@pytest.mark.parametrize("k", [1, 17, "n"])
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


@pytest.mark.parametrize("case", ["all_equal", "zeros", "signed_zeros",
                                  "few_values"])
@pytest.mark.parametrize("k", [1, 17, 130])
def test_topk_kernel_ties(cuda_device, case, k):
    v = _tie_vectors(cuda_device)[case]
    _assert_topk_equal(topk_cuda(v, k), ref.topk_ref(v, k))


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
