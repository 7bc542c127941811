"""The port's CUDA kernels on the card (``@pytest.mark.cuda``).

Every test here decides inside itself (through the ``cuda_device`` fixture)
whether a CUDA device exists and skips without one, so every worker collects
the same tests.  The file imports torch and ``repro_torch`` only — no JAX —
so it runs on a machine that has just PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are relative to max(1, max |plain|): gram 1e-4 (f32 and bf16
inputs both accumulate in f32, so the kernel and ``torch.matmul`` differ in
summation order only); combine 1e-5 in f32 and 3e-2 for a bf16 output (one
bf16 rounding), as the reference's kernel tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.fl import ServerConfig, run_simulation
from repro_torch.kernels import (gram_and_cross, launch_counts,
                                 reset_launch_counts, weighted_combine)
from repro_torch.kernels import ref
from repro_torch.kernels.combine import combine_cuda
from repro_torch.kernels.gram import gram_cuda
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


@pytest.mark.parametrize("K,n", [(1, 1), (3, 130), (10, 7850), (64, 4097)])
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


def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    U = torch.ones(65, 8, device=cuda_device)
    with pytest.raises(ValueError, match="K=65"):
        gram_cuda(U, torch.ones(8, device=cuda_device))
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
