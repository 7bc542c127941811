"""The port's synchronous FL round (``repro_torch.fl``) against ``repro.fl``.

Host randomness (device selection, datasets) must be bit-identical.  The
mini-batch draws of ``client_update`` come from ``jax.random`` in the
reference, which torch cannot reproduce, so the round parity test replays
the reference's key stream (split per client, split per step, ``choice``
with mask probabilities) and hands the indices to the port.  Deltas, G and c
are then held at rtol 1e-5 (f32, summation order only); α and the new
parameters at rtol 1e-4, because α = −(1/β)(G + ρI)⁻¹c can amplify the
relative error of (G, c) by up to cond(G), which the test checks is below 10
for its rounds.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.flatten import scope_vector as j_scope_vector
from repro.data import synthetic as jsyn
from repro.data import federated as jfed
from repro.fl import client as jclient
from repro.fl import metrics as jmetrics
from repro.fl import server as jserver
from repro.kernels import ref as jref
from repro.models import get_model as j_get_model
from repro.models.config import ArchConfig as JArchConfig
from repro.models.logistic import logistic_apply as j_apply
from repro.models.logistic import logistic_loss as j_loss
from repro.models.logistic import make_mlp_classifier as j_mlp
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation as tagg
from repro_torch.core.flatten import scope_vector, tree_leaves, tree_map
from repro_torch.data import synthetic as tsyn
from repro_torch.data import federated as tfed
from repro_torch.fl import client as tclient
from repro_torch.fl import metrics as tmetrics
from repro_torch.fl import server as tserver
from repro_torch.fl.simulation import run_simulation
from repro_torch.kernels import gram_and_cross, launch_counts, reset_launch_counts
from repro_torch.models import get_model as t_get_model
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import init_logistic
from repro_torch.models.logistic import logistic_apply as t_apply
from repro_torch.models.logistic import logistic_loss as t_loss
from repro_torch.models.logistic import make_mlp_classifier as t_mlp
from repro_torch.obs import InMemoryTracker, use_tracker

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=rtol * max(1e-6, float(np.abs(want).max())), err_msg=what)


# ----------------------------------------------------------- bit-identical

@pytest.mark.parametrize("fn,kw", [
    ("make_synthetic", dict(alpha=1.0, beta=1.0, num_devices=3,
                            samples_per_device=10, dim=5, seed=2)),
    ("make_synthetic", dict(alpha=0.5, beta=0.5, num_devices=3,
                            samples_per_device=7, dim=4, iid=True, seed=1)),
    ("make_mnist_like", dict(num_samples=200, dim=20, seed=3)),
    ("make_femnist_like", dict(num_samples=150, dim=12, seed=4)),
    ("make_token_stream", dict(num_tokens=500, vocab_size=50, seed=5)),
])
def test_data_generators_bit_identical(fn, kw):
    got, want = getattr(tsyn, fn)(**kw), getattr(jsyn, fn)(**kw)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("concentration", [0.5, 0.1, None])
def test_make_federated_bit_identical(concentration):
    x, y = jsyn.make_mnist_like(num_samples=600, dim=16, seed=0)
    got = tfed.make_federated(x, y, num_devices=20, num_classes=10,
                              concentration=concentration, seed=3)
    want = jfed.make_federated(x, y, num_devices=20, num_classes=10,
                               concentration=concentration, seed=3)
    for field in ("x", "y", "mask", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.client_weights(), want.client_weights())


@pytest.mark.parametrize("kw", [
    dict(num_devices=30, clients_per_round=10, grad_sample=0),
    dict(num_devices=100, clients_per_round=10, grad_sample=7,
         min_epochs=2, max_epochs=5),
    dict(num_devices=10, clients_per_round=10, grad_sample=10)])
def test_sample_round_bit_identical(kw):
    rt, rj = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(5):
        got = tserver.sample_round(rt, tserver.ServerConfig(**kw), 6)
        want = jserver.sample_round(rj, jserver.ServerConfig(**kw), 6)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(num_devices=5, clients_per_round=6),
    dict(num_devices=5, clients_per_round=2, grad_sample=6)])
def test_sample_round_errors_match(kw):
    with pytest.raises(ValueError) as got:
        tserver.sample_round(np.random.RandomState(0),
                             tserver.ServerConfig(**kw), 3)
    with pytest.raises(ValueError) as want:
        jserver.sample_round(np.random.RandomState(0),
                             jserver.ServerConfig(**kw), 3)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------- one whole round

DIM, CLASSES, N_DEV, M, K = 12, 4, 8, 20, 4


@pytest.fixture(scope="module")
def small_problem():
    xs, ys = jsyn.make_synthetic(1.0, 1.0, num_devices=N_DEV,
                                 samples_per_device=M, dim=DIM,
                                 num_classes=CLASSES, seed=3)
    mask = np.ones(ys.shape, np.float32)
    mask[::2, -6:] = 0.0                    # padded shards on half the devices
    params = jax.tree_util.tree_map(np.asarray, j_get_model(JArchConfig(
        name="lr", family="logreg", input_dim=DIM,
        num_classes=CLASSES)).init(jax.random.PRNGKey(0)))
    return xs, ys, mask, params


def _replay_batch_indices(key, mask_sel, max_steps, batch_size):
    """The reference's mini-batch draws: split the round key per client, the
    client key per step, then ``choice`` with mask probabilities."""
    probs = mask_sel / jnp.maximum(mask_sel.sum(axis=1, keepdims=True), 1.0)

    def per_client(kk, pp):
        step_keys = jax.random.split(kk, max_steps)
        return jax.vmap(lambda sk: jax.random.choice(
            sk, mask_sel.shape[1], shape=(batch_size,), p=pp))(step_keys)

    keys = jax.random.split(key, mask_sel.shape[0])
    return np.array(jax.vmap(per_client)(keys, probs))


ROUNDS = [dict(aggregator="contextual"),
          dict(aggregator="contextual_expected", grad_sample=3, mu=0.1)]


@pytest.mark.parametrize("kw", ROUNDS, ids=[r["aggregator"] for r in ROUNDS])
def test_round_matches_reference(small_problem, kw):
    xs, ys, mask, params = small_problem
    base = dict(num_devices=N_DEV, clients_per_round=K, lr=0.1, batch_size=5,
                min_epochs=1, max_epochs=3)
    jcfg = jserver.ServerConfig(**base, **kw)
    tcfg = tserver.ServerConfig(**base, **kw)
    spe = M // jcfg.batch_size
    max_steps = jcfg.max_epochs * spe
    sel, grad_sel, num_steps = jserver.sample_round(
        np.random.RandomState(5), jcfg, spe)
    key = jax.random.PRNGKey(11)
    idx = _replay_batch_indices(key, jnp.asarray(mask[sel]), max_steps,
                                jcfg.batch_size)

    # client updates: the reference's vmapped client_update vs the port's
    jdeltas, jfirst = jax.vmap(lambda xx, yy, mm, ns, kk: jclient.client_update(
        j_loss, params, xx, yy, mm, ns, kk, max_steps=max_steps,
        batch_size=jcfg.batch_size, lr=jcfg.lr, mu=jcfg.mu))(
        jnp.asarray(xs[sel]), jnp.asarray(ys[sel]), jnp.asarray(mask[sel]),
        jnp.asarray(num_steps), jax.random.split(key, K))
    tparams = params_from_jax(params, device="cpu")
    tdeltas, tfirst = tclient.client_update(
        t_loss, tparams, torch.from_numpy(xs[sel]),
        torch.from_numpy(ys[sel]).long(), torch.from_numpy(mask[sel]),
        torch.from_numpy(num_steps.copy()).long(), torch.from_numpy(idx),
        lr=tcfg.lr, mu=tcfg.mu)
    for a, b in zip(tree_leaves(tdeltas), jax.tree_util.tree_leaves(jdeltas)):
        _close(a, b, 1e-5, "delta")
    for a, b in zip(tree_leaves(tfirst), jax.tree_util.tree_leaves(jfirst)):
        _close(a, b, 1e-5, "first_grad")

    # (G, c) of the round: the plain gram op vs the reference oracle
    U_j = jagg._stacked_to_matrix(jdeltas, None)
    g_j = j_scope_vector(jax.tree_util.tree_map(lambda g: g.mean(0), jfirst),
                         None)
    G_j, c_j = jref.gram_ref(U_j, g_j)
    U_t = tagg._stacked_to_matrix(tdeltas, None)
    g_t = scope_vector(tree_map(lambda g: g.mean(0), tfirst), None)
    G_t, c_t = gram_and_cross(U_t, g_t)
    _close(G_t, G_j, 1e-5, "G")
    _close(c_t, c_j, 1e-5, "c")
    assert float(torch.linalg.cond(G_t.double())) < 10

    # the whole round, each package's own round function
    jround = jserver.build_round_fn(j_loss, jcfg, M)
    jstate, jinfo = jround(jserver.init_server(params),
                           (jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mask)),
                           jnp.asarray(sel), jnp.asarray(grad_sel),
                           jnp.asarray(num_steps), key)
    tround = tserver.build_round_fn(t_loss, tcfg, M, device="cpu")
    reset_launch_counts()
    tstate, tinfo = tround(
        tserver.init_server(tparams),
        (torch.from_numpy(xs), torch.from_numpy(ys).long(),
         torch.from_numpy(mask)),
        sel, grad_sel, num_steps, batch_idx=torch.from_numpy(idx))
    assert launch_counts()["gram/torch"] == 1
    assert launch_counts()["combine/torch"] == 1
    assert tstate.round_idx == 1
    _close(tinfo["update_norms"], jinfo["update_norms"], 1e-5, "update_norms")
    _close(tinfo["alpha"], jinfo["alpha"], 1e-4, "alpha")
    for a, b in zip(tree_leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        _close(a, b, 1e-4, "new params")


def test_round_draws_batches_from_a_torch_generator(small_problem):
    xs, ys, mask, params = small_problem
    cfg = tserver.ServerConfig(aggregator="fedavg", num_devices=N_DEV,
                               clients_per_round=K, batch_size=5, max_epochs=2)
    data = (torch.from_numpy(xs), torch.from_numpy(ys).long(),
            torch.from_numpy(mask))
    sel, gsel, ns = tserver.sample_round(np.random.RandomState(0), cfg, 4)
    fn = tserver.build_round_fn(t_loss, cfg, M, device="cpu")
    state = tserver.init_server(params_from_jax(params, device="cpu"))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        outs.append(fn(state, data, sel, gsel, ns, gen)[0].params)
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    idx = tclient.draw_batch_indices(data[2][torch.as_tensor(sel).long()], 8,
                                     5, torch.Generator().manual_seed(0))
    assert idx.shape == (K, 8, 5)
    padded = data[2][torch.as_tensor(sel).long()] == 0
    assert not padded.gather(1, idx.reshape(K, -1)).any()   # mask respected
    with pytest.raises(ValueError, match="generator or batch_idx"):
        fn(state, data, sel, gsel, ns)


# ----------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def synth11():
    """Synthetic(α=1, β=1), as ``tests/test_fl_system.py`` builds it."""
    xs, ys = tsyn.make_synthetic(1.0, 1.0, num_devices=30,
                                 samples_per_device=60, dim=60, seed=2)
    mask = np.ones(ys.shape, np.float32)
    return tfed.FederatedDataset(xs, ys, mask, xs.reshape(-1, 60)[:400],
                                 ys.reshape(-1)[:400], 10)


def _port_run(name, agg, ds, rounds=60, **kw):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, j_get_model(
        JArchConfig(name="lr", family="logreg", input_dim=60, num_classes=10)
    ).init(jax.random.PRNGKey(0))), device="cpu")
    cfg = tserver.ServerConfig(aggregator=agg, num_devices=30,
                               clients_per_round=10, lr=0.2, batch_size=10,
                               min_epochs=1, max_epochs=20, **kw)
    return run_simulation(name, t_loss, t_apply, params, ds, cfg,
                          num_rounds=rounds, selection_seed=42, eval_every=3,
                          collect_alpha=True, device="cpu")


def test_contextual_beats_fedavg_under_heterogeneity(synth11):
    """The assertion of ``tests/test_fl_system.py`` of the same name, on
    the port: paper fig. 4/5."""
    r_ctx = _port_run("ctx", "contextual", synth11)
    r_avg = _port_run("avg", "fedavg", synth11)
    assert r_ctx.train_loss[-1] < r_avg.train_loss[-1]
    assert r_ctx.test_acc[-1] >= r_avg.test_acc[-1] - 0.02
    assert len(r_ctx.alpha_history) == 60
    assert np.isfinite(r_ctx.train_loss).all()


@pytest.mark.parametrize("agg", ["contextual", "fedavg"])
def test_paper_width_run_tracks_reference(agg):
    """The main path at full paper-logreg width (784 → 10, MNIST-like data
    over 100 devices, K = 10): the port's CPU run follows the reference's
    loss curve.  The mini-batch draws come from different generators
    (``jax.random`` vs ``torch.Generator``), so the curves agree
    statistically, not bitwise: 2 % per round (the gap is ~0.2 %)."""
    from repro.configs import get_config
    from repro.fl import ServerConfig as JServerConfig
    from repro.fl import run_simulation as j_run
    x, y = jsyn.make_mnist_like(num_samples=6000, seed=0)
    ds = jfed.make_federated(x, y, num_devices=100, num_classes=10,
                             concentration=0.5, seed=0)
    params = jax.tree_util.tree_map(np.asarray, j_get_model(
        get_config("paper-logreg")).init(jax.random.PRNGKey(0)))
    kw = dict(aggregator=agg, num_devices=100, clients_per_round=10,
              lr=0.05, batch_size=10, min_epochs=1, max_epochs=20)
    ref = j_run(agg, j_loss, j_apply, params, ds, JServerConfig(**kw),
                num_rounds=4, selection_seed=42)
    port = run_simulation(agg, t_loss, t_apply,
                          params_from_jax(params, device="cpu"), ds,
                          tserver.ServerConfig(**kw), num_rounds=4,
                          selection_seed=42, device="cpu")
    np.testing.assert_allclose(port.train_loss, ref.train_loss, rtol=0.02)
    assert port.train_loss[-1] < port.train_loss[0]


def test_run_simulation_opens_the_reference_spans(synth11):
    tracker = InMemoryTracker()
    with use_tracker(tracker):
        res = _port_run("spans", "contextual", synth11, rounds=3)
    paths = [e.metrics["path"] for e in tracker.span_events()]
    upd = ["round/update_aggregate", "round"]
    assert paths == upd + upd + ["round/update_aggregate", "round/eval",
                                 "round"]           # eval_every=3
    assert len(res.train_loss) == 1 and res.wall_time > 0
    assert tracker.series("sync/spans/train_loss") == res.train_loss


def test_metrics_match_reference(small_problem):
    xs, ys, mask, params = small_problem
    tparams = params_from_jax(params, device="cpu")
    tx, ty = xs.reshape(-1, DIM)[:50], ys.reshape(-1)[:50]
    got = tmetrics.evaluate_classifier(t_apply, tparams, torch.from_numpy(tx),
                                       torch.from_numpy(ty), batch=16)
    want = jmetrics.evaluate_classifier(j_apply, params, jnp.asarray(tx),
                                        jnp.asarray(ty), batch=16)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got = tmetrics.global_train_loss(t_loss, tparams, torch.from_numpy(xs),
                                     torch.from_numpy(ys).long(),
                                     torch.from_numpy(mask))
    want = jmetrics.global_train_loss(j_loss, params, jnp.asarray(xs),
                                      jnp.asarray(ys), jnp.asarray(mask))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mlp_classifier_matches_reference():
    cfg = JArchConfig(name="mlp", family="logreg", input_dim=9, num_classes=3)
    j_init, japply, jloss = j_mlp(cfg, hidden=6)
    params = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(1)))
    t_init, tapply, tloss = t_mlp(ArchConfig(name="mlp", family="logreg",
                                             input_dim=9, num_classes=3),
                                  hidden=6)
    tparams = params_from_jax(params, device="cpu")
    assert [x.shape for x in tree_leaves(t_init(0, device="cpu"))] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(params)]
    rng = np.random.RandomState(0)
    x = rng.randn(7, 9).astype(np.float32)
    y = rng.randint(0, 3, 7).astype(np.int32)
    w = np.ones(7, np.float32)
    np.testing.assert_allclose(_np(tapply(tparams, torch.from_numpy(x))),
                               np.asarray(japply(params, x)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(tloss(tparams, (torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w)))),
        float(jloss(params, (x, y, w))), rtol=1e-5)


def test_params_from_jax_keeps_keys_and_dtypes():
    tree = {"b": np.arange(3, dtype=np.float32),
            "blk": [jnp.ones((2, 2), jnp.bfloat16) * 1.5,
                    np.int32(4) * np.ones(2, np.int32)]}
    out = params_from_jax(tree, device="cpu")
    assert out["blk"][0].dtype == torch.bfloat16
    assert out["blk"][1].dtype == torch.int32
    np.testing.assert_array_equal(out["blk"][0].float().numpy(),
                                  np.full((2, 2), 1.5, np.float32))
    np.testing.assert_array_equal(out["b"].numpy(), tree["b"])


# ------------------------------------------------------------------ guards

def test_entry_points_refuse_cuda_without_a_card(monkeypatch, small_problem):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xs, ys, mask, params = small_problem
    ds = tfed.FederatedDataset(xs, ys, mask, xs[0], ys[0], CLASSES)
    cfg = tserver.ServerConfig(num_devices=N_DEV, clients_per_round=K)
    model_cfg = ArchConfig(name="lr", family="logreg", input_dim=DIM,
                           num_classes=CLASSES)
    calls = [
        lambda: run_simulation("x", t_loss, t_apply, params, ds, cfg, 1),
        lambda: tserver.build_round_fn(t_loss, cfg, M),
        lambda: params_from_jax(params),
        lambda: init_logistic(model_cfg, 0),
        lambda: t_get_model(model_cfg).init(0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    init_logistic(model_cfg, 0, device="cpu")     # explicit CPU is fine


def test_unported_parts_raise():
    # the robust aggregators register on first use, as the reference's
    fn = tserver.build_round_fn(
        t_loss, tserver.ServerConfig(aggregator="contextual_mom",
                                     malicious=(1,)), M, device="cpu")
    assert callable(fn)
    # every config and family of the reference is ported now: whisper's
    # config and the vlm / audio bundles build; unknown ones still raise
    assert tconfigs.get_config("whisper-large-v3").family == "audio"
    with pytest.raises(KeyError, match="unknown config"):
        tconfigs.get_config("whisper-small")
    assert tconfigs.get_config("paper-logreg").input_dim == 784
    for family in ("vlm", "audio"):
        assert t_get_model(ArchConfig(name="m", family=family)).prefill \
            is not None
    with pytest.raises(NotImplementedError, match="unknown model family"):
        t_get_model(ArchConfig(name="m", family="bogus"))
    # the moe, ssm and hybrid families are ported: their bundles build
    for family in ("moe", "ssm", "hybrid"):
        assert t_get_model(ArchConfig(name="m",
                                      family=family)).prefill is not None
    assert tconfigs.get_config("rwkv6-1.6b").family == "ssm"
    with pytest.raises(KeyError, match="unknown aggregator"):
        tserver.build_round_fn(t_loss, tserver.ServerConfig(aggregator="bogus"),
                               M, device="cpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    twins = sorted((ROOT / "examples").glob("torch_*.py")) + sorted(
        (ROOT / "benchmarks").glob("torch_*.py"))
    assert len(twins) >= 4
    files += twins
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, repro_torch.fl.simulation\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
