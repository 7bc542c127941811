"""The port's SCAFFOLD (``repro_torch.fl.scaffold``) against
``repro.fl.scaffold``: the state's shapes, one round against the
reference's ``round_fn`` from the same state on its replayed
``jax.random.choice`` draws (params, ``c_global`` and ``c_locals`` at rtol
1e-5 after a FedAvg combine, 1e-4 through the contextual solve, whose
α = −(1/β)G⁻¹c amplifies f32 summation order), the runner on replayed
draws, and the three assertions of ``tests/test_scaffold.py`` on the
port's own draws."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_synthetic
from repro.data.federated import FederatedDataset as JFederatedDataset
from repro.fl import ServerConfig as JServerConfig
from repro.fl import run_scaffold as j_run_scaffold
from repro.fl.scaffold import build_scaffold_round_fn as j_build
from repro.fl.scaffold import init_scaffold as j_init
from repro.fl.server import sample_round
from repro.models import get_model
from repro.models.config import ArchConfig
from repro.models.logistic import logistic_apply as j_apply
from repro.models.logistic import logistic_loss as j_loss
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_leaves
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import (ScaffoldState, ServerConfig,
                            build_scaffold_round_fn, init_scaffold,
                            run_scaffold)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.logistic import logistic_apply, logistic_loss

torch.set_num_threads(1)

N_DEV, M, DIM, CLASSES = 20, 40, 30, 10


@pytest.fixture(scope="module")
def problem():
    xs, ys = make_synthetic(1.0, 1.0, num_devices=N_DEV, samples_per_device=M,
                            dim=DIM, seed=5)
    mask = np.ones(ys.shape, np.float32)
    tx, ty = xs.reshape(-1, DIM)[:200], ys.reshape(-1)[:200]
    jds = JFederatedDataset(xs, ys, mask, tx, ty, CLASSES)
    tds = FederatedDataset(xs, ys, mask, tx, ty, CLASSES)
    params = jax.tree_util.tree_map(np.asarray, get_model(ArchConfig(
        name="lr", family="logreg", input_dim=DIM, num_classes=CLASSES)
    ).init(jax.random.PRNGKey(0)))
    return jds, tds, params


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol, what):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(b).max()),
                                   err_msg=what)


@partial(jax.jit, static_argnums=(2, 3))
def _ref_draws(keys, mask_rows, max_steps, batch_size):
    """``repro/fl/scaffold.py:47-51``: each client key split per step, then
    ``choice`` with mask probabilities."""
    m = mask_rows.shape[1]

    def per_client(kk, mk):
        probs = mk / jnp.maximum(mk.sum(), 1.0)
        return jax.vmap(lambda sk: jax.random.choice(
            sk, m, shape=(batch_size,), p=probs))(
            jax.random.split(kk, max_steps))
    return jax.vmap(per_client)(keys, mask_rows)


def _replayed(jds, round_key, sel, max_steps, batch_size):
    keys = jax.random.split(round_key, len(sel))
    return torch.from_numpy(np.array(_ref_draws(
        keys, jnp.asarray(jds.mask[sel]), max_steps, batch_size))).long()


def _cfg(agg, **kw):
    base = dict(aggregator=agg, num_devices=N_DEV, clients_per_round=8,
                lr=0.1, batch_size=10, min_epochs=1, max_epochs=5)
    base.update(kw)
    return base


def test_init_scaffold_shapes(problem):
    _, _, params = problem
    st = init_scaffold(params_from_jax(params, device="cpu"), N_DEV)
    ref = j_init(jax.tree_util.tree_map(jnp.asarray, params), N_DEV)
    assert isinstance(st, ScaffoldState) and st.round_idx == 0
    for c, p, jc in zip(tree_leaves(st.c_locals), tree_leaves(st.params),
                        jax.tree_util.tree_leaves(ref.c_locals)):
        assert tuple(c.shape) == (N_DEV,) + tuple(p.shape) == jc.shape
        assert c.dtype == torch.float32 and not c.any()
    for c, p in zip(tree_leaves(st.c_global), tree_leaves(st.params)):
        assert c.shape == p.shape and c.dtype == torch.float32


@pytest.mark.parametrize("agg,rtol", [("fedavg", 1e-5),
                                      ("contextual", 1e-4)])
def test_round_matches_reference(problem, agg, rtol):
    jds, tds, params = problem
    base = _cfg(agg)
    jcfg, tcfg = JServerConfig(**base), ServerConfig(**base)
    spe = M // 10
    max_steps = jcfg.max_epochs * spe
    rng = np.random.RandomState(3)
    # a state with nonzero variates, the same on both sides
    vr = np.random.RandomState(9)
    c_g = jax.tree_util.tree_map(
        lambda p: (0.1 * vr.randn(*p.shape)).astype(np.float32), params)
    c_l = jax.tree_util.tree_map(
        lambda p: (0.1 * vr.randn(N_DEV, *p.shape)).astype(np.float32),
        params)
    jstate = j_init(jax.tree_util.tree_map(jnp.asarray, params), N_DEV
                    )._replace(c_global=jax.tree_util.tree_map(jnp.asarray,
                                                               c_g),
                               c_locals=jax.tree_util.tree_map(jnp.asarray,
                                                               c_l))
    tstate = ScaffoldState(params_from_jax(params, device="cpu"),
                           params_from_jax(c_g, device="cpu"),
                           params_from_jax(c_l, device="cpu"), 0)
    data_j = tuple(jnp.asarray(a) for a in (jds.x, jds.y, jds.mask))
    data_t = (torch.from_numpy(tds.x), torch.from_numpy(tds.y).long(),
              torch.from_numpy(tds.mask))
    jfn = j_build(j_loss, jcfg, M)
    tfn = build_scaffold_round_fn(logistic_loss, tcfg, M, device="cpu")
    key = jax.random.PRNGKey(11)
    for r in range(2):
        sel, _, num_steps = sample_round(rng, jcfg, spe)
        key, rk = jax.random.split(key)
        idx = _replayed(jds, rk, sel, max_steps, 10)
        jstate, jinfo = jfn(jstate, data_j, jnp.asarray(sel),
                            jnp.asarray(num_steps), rk)
        tstate, tinfo = tfn(tstate, data_t, sel, num_steps, batch_idx=idx)
        _close(tstate.params, jstate.params, rtol, f"params, round {r}")
        _close(tstate.c_global, jstate.c_global, rtol, f"c_global, round {r}")
        _close(tstate.c_locals, jstate.c_locals, rtol, f"c_locals, round {r}")
        np.testing.assert_allclose(float(tinfo["c_norm"]),
                                   float(jinfo["c_norm"]), rtol=rtol)
        if agg == "contextual":
            np.testing.assert_allclose(_np(tinfo["alpha"]),
                                       np.asarray(jinfo["alpha"]),
                                       rtol=rtol, atol=rtol)
    assert tstate.round_idx == 2


def test_untouched_variates_stay_and_inputs_are_not_written(problem):
    jds, tds, params = problem
    tcfg = ServerConfig(**_cfg("fedavg"))
    st = init_scaffold(params_from_jax(params, device="cpu"), N_DEV)
    data = (torch.from_numpy(tds.x), torch.from_numpy(tds.y).long(),
            torch.from_numpy(tds.mask))
    gen = torch.Generator().manual_seed(0)
    sel = np.array([1, 4, 7, 9, 12, 15, 17, 19])
    new, _ = build_scaffold_round_fn(logistic_loss, tcfg, M, device="cpu")(
        st, data, sel, np.full(8, 8, np.int32), gen)
    rest = np.setdiff1d(np.arange(N_DEV), sel)
    for c_old, c_new in zip(tree_leaves(st.c_locals),
                            tree_leaves(new.c_locals)):
        assert not c_old.any()                   # the old state is intact
        assert not c_new[rest].any() and c_new[sel].abs().sum() > 0
    with pytest.raises(ValueError, match="generator or batch_idx"):
        build_scaffold_round_fn(logistic_loss, tcfg, M, device="cpu")(
            st, data, sel, np.full(8, 8, np.int32))


def test_run_matches_reference_on_replayed_draws(problem):
    jds, tds, params = problem
    base = _cfg("contextual")
    want = j_run_scaffold("j", j_loss, j_apply, params, jds,
                          JServerConfig(**base), num_rounds=3,
                          selection_seed=7)
    key = jax.random.PRNGKey(7)
    keys = []
    for _ in range(3):
        key, rk = jax.random.split(key)
        keys.append(rk)
    reset_launch_counts()
    got = run_scaffold(
        "t", logistic_loss, logistic_apply,
        params_from_jax(params, device="cpu"), tds, ServerConfig(**base),
        num_rounds=3, selection_seed=7, device="cpu",
        batch_indices=lambda t, sel, ms: _replayed(jds, keys[t], sel, ms,
                                                   10))
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-4)
    np.testing.assert_allclose(got.test_nll, want.test_nll, rtol=1e-4)
    assert got.test_acc == pytest.approx(want.test_acc, abs=1e-6)
    counts = launch_counts()
    # the contextual combine goes through the registry (plain on the CPU)
    assert counts["gram/torch"] == 3 and counts["combine/torch"] >= 3


# -- tests/test_scaffold.py's assertions, on the port's own draws ----------

def test_scaffold_converges(problem):
    _, tds, params = problem
    r = run_scaffold("scaffold", logistic_loss, logistic_apply,
                     params_from_jax(params, device="cpu"), tds,
                     ServerConfig(**_cfg("fedavg")), num_rounds=12,
                     device="cpu")
    assert np.isfinite(r.train_loss).all()
    assert r.train_loss[-1] < r.train_loss[0]


def test_scaffold_contextual_more_robust_than_vanilla(problem):
    _, tds, params = problem
    results = {}
    for agg in ("fedavg", "contextual"):
        cfg = ServerConfig(**_cfg(agg, lr=0.2, max_epochs=20))
        results[agg] = run_scaffold(agg, logistic_loss, logistic_apply,
                                    params_from_jax(params, device="cpu"),
                                    tds, cfg, num_rounds=18, device="cpu")
    assert (results["contextual"].loss_volatility()
            < results["fedavg"].loss_volatility())


def test_cuda_is_the_default_device(problem, monkeypatch):
    _, tds, params = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scaffold("x", logistic_loss, logistic_apply, params, tds,
                     ServerConfig(**_cfg("fedavg")), num_rounds=1)
