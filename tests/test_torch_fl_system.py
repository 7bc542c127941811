"""The assertions of ``tests/test_fl_system.py`` on the port (``repro_torch``),
and the port's quickstart.

Every run starts from the reference's initial parameters
(``params_from_jax`` of ``get_model(...).init(PRNGKey(0))``) on the
Synthetic(1,1) data that ``repro_torch.data.make_synthetic`` builds
bit-identically to the reference's, with the reference's configuration
(``_run``: K = 10 of 30 devices, lr 0.2, batch 10, epochs U[1, 20],
selection seed 42, eval every 3 rounds).  Every test here uses the port's
own mini-batch draws (a ``torch.Generator`` seeded with the selection
seed); the numbers of each assertion are the reference's, unchanged.

``test_contextual_beats_fedavg_under_heterogeneity`` is held in
``tests/test_torch_fl.py``.  ``test_global_train_loss_traces_once_across_rounds``
counts JAX retraces of a jitted evaluator; the port's ``global_train_loss``
is eager torch and compiles nothing, so it has no counterpart here.  The
dataset tests (selection, non-IID properties, Dirichlet skew) are held
bit-for-bit against the reference in ``tests/test_torch_fl.py``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import get_model as j_get_model
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.convert import params_from_jax
from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.fl import ServerConfig, run_simulation
from repro_torch.models.logistic import logistic_apply, logistic_loss

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIM, CLASSES, N_DEV = 60, 10, 30


@pytest.fixture(scope="module")
def synth11():
    """Synthetic(α=1, β=1), as ``tests/test_fl_system.py`` builds it."""
    xs, ys = make_synthetic(1.0, 1.0, num_devices=N_DEV,
                            samples_per_device=60, dim=DIM, seed=2)
    mask = np.ones(ys.shape, np.float32)
    tx, ty = xs.reshape(-1, DIM)[:400], ys.reshape(-1)[:400]
    return FederatedDataset(xs, ys, mask, tx, ty, CLASSES)


@pytest.fixture(scope="module")
def init_params():
    return params_from_jax(jax.tree_util.tree_map(np.asarray, j_get_model(
        JArchConfig(name="lr", family="logreg", input_dim=DIM,
                    num_classes=CLASSES)).init(jax.random.PRNGKey(0))),
        device="cpu")


def _run(params, name, agg, ds, rounds=60, lr=0.2, **kw):
    base = dict(num_devices=N_DEV, clients_per_round=10, lr=lr,
                batch_size=10, min_epochs=1, max_epochs=20)
    base.update(kw)
    return run_simulation(name, logistic_loss, logistic_apply, params, ds,
                          ServerConfig(aggregator=agg, **base),
                          num_rounds=rounds, selection_seed=42,
                          eval_every=3, collect_alpha=True, device="cpu")


def test_contextual_is_more_robust(synth11, init_params):
    """Paper's robustness claim: smaller round-to-round fluctuations."""
    r_ctx = _run(init_params, "ctx", "contextual", synth11, rounds=45)
    r_avg = _run(init_params, "avg", "fedavg", synth11, rounds=45)
    assert r_ctx.loss_volatility() < r_avg.loss_volatility()
    arr = np.asarray(r_ctx.train_loss)
    big_jumps = np.sum(np.diff(arr) > 0.05)
    assert big_jumps <= 2          # near-monotone descent (Theorem 1)


def test_k2_variants_all_converge_and_k2_0_suffices(synth11, init_params):
    """Paper fig. 2/3's practical claim: the K₂=0 variant performs at least
    as well as estimating ∇f from all N devices."""
    finals = {}
    for k2 in (0, 10, N_DEV):
        r = _run(init_params, f"k2={k2}", "contextual", synth11, rounds=30,
                 grad_sample=k2)
        assert np.isfinite(r.train_loss).all()
        assert r.train_loss[-1] < r.train_loss[0] * 0.8   # all converge
        finals[k2] = r.train_loss[-1]
    assert finals[0] <= finals[N_DEV] + 0.1, finals


def test_fedprox_contextual_and_folb_run(synth11, init_params):
    r_prox = _run(init_params, "prox-ctx", "contextual", synth11, rounds=10,
                  mu=0.1)
    r_folb = _run(init_params, "folb", "folb", synth11, rounds=10)
    assert np.isfinite(r_prox.train_loss).all()
    assert np.isfinite(r_folb.train_loss).all()
    assert r_prox.train_loss[-1] < r_prox.train_loss[0]


def test_expected_variant_runs(synth11, init_params):
    r = _run(init_params, "ctx-exp", "contextual_expected", synth11,
             rounds=10, expected_pool=N_DEV)
    assert np.isfinite(r.train_loss).all()
    assert r.train_loss[-1] < r.train_loss[0]


def test_alpha_varies_across_stages(synth11, init_params):
    """Paper fig. 7: aggregation variables vary between rounds and stages,
    unlike FedAvg's constant 1/K."""
    r = _run(init_params, "ctx", "contextual", synth11, rounds=20)
    early, late = r.alpha_history[0], r.alpha_history[-1]
    assert early.shape == late.shape == (10,)
    assert not np.allclose(early, late, atol=1e-3)
    assert np.std(early) > 1e-4


def test_last_layer_scope_tracks_full_gram(synth11, init_params):
    """§III-B efficiency note (logreg: the head is the model)."""
    r_full = _run(init_params, "full", "contextual", synth11, rounds=10)
    assert np.isfinite(r_full.train_loss).all()


def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"m": torch.ones((3, 4), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 5, tree, meta={"note": "t"})
    back, meta = load_checkpoint(str(tmp_path), 5, tree)
    assert meta["note"] == "t"
    np.testing.assert_allclose(back["w"].numpy(), tree["w"].numpy())
    assert back["opt"]["m"].dtype == torch.bfloat16
    assert torch.equal(back["opt"]["m"], tree["opt"]["m"])


def test_torch_quickstart_runs_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu", "--rounds", "3"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "=== fedavg ===" in lines and "=== contextual ===" in lines
    finals = [float(l.split("loss=")[1].split()[0]) for l in lines
              if "final loss=" in l]
    assert len(finals) == 2 and np.isfinite(finals).all()
    # the script imports no JAX and nothing of the reference
    tree = ast.parse((ROOT / "examples" / "torch_quickstart.py").read_text())
    tops = {name.split(".")[0] for node in ast.walk(tree)
            for name in ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module] if isinstance(node, ast.ImportFrom)
                         and node.level == 0 else [])}
    assert "repro_torch" in tops and not tops & {"jax", "jaxlib", "repro"}
