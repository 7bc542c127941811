"""The port's async edge runtime (``repro_torch.edge.async_server`` and
``repro_torch.fl.run_async_simulation``) against ``repro.edge`` / ``repro.fl``.

The staleness weights, the config's validation and the event stream are
host code and must match the reference exactly.  The three aggregators are
held at the reference's own tolerances (``tests/test_edge_runtime.py``:
rtol 1e-5, atol 1e-7) on the same numpy inputs.  The whole run at
``tests/test_edge_runtime.py``'s ``tiny_problem`` replays the reference's
mini-batch draws (``fold_in(PRNGKey(seed), evt.seq)``, split per step,
``choice`` with mask probabilities) through ``batch_indices``: virtual
times, versions and counts are then bitwise equal, each flush's α and the
train losses equal at rtol 1e-4 (α = −(1/β)(G + ρI)⁻¹c amplifies the f32
summation-order differences of (G, c) by up to cond(G)).  The assertions
of ``tests/test_edge_runtime.py`` on the async entry point are held on the
port with its own ``torch.Generator`` draws.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.edge.async_server as jasync
from repro.core import AggregatorConfig as JAggregatorConfig
from repro.core import SolveConfig as JSolveConfig
from repro.core import aggregate as j_aggregate
from repro.data import make_synthetic as j_make_synthetic
from repro.data.federated import FederatedDataset as JFederatedDataset
from repro.edge import bimodal_fleet as j_bimodal_fleet
from repro.fl import run_async_simulation as j_run_async
from repro.models import get_model as j_get_model
from repro.models.config import ArchConfig as JArchConfig
from repro.models.logistic import logistic_apply as j_apply
from repro.models.logistic import logistic_loss as j_loss
from repro_torch.convert import params_from_jax
from repro_torch.core import AggregatorConfig, SolveConfig, aggregate
from repro_torch.data.federated import FederatedDataset
from repro_torch.edge import (AsyncBuffer, AsyncConfig, BufferedUpdate,
                              bimodal_fleet, run_async_simulation,
                              staleness_weight, uniform_fleet)
from repro_torch.fl import AsyncSimulationResult
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.logistic import logistic_apply as t_apply
from repro_torch.models.logistic import logistic_loss as t_loss
from repro_torch.obs import InMemoryTracker, use_tracker
from repro_torch.obs.spans import span_fields

torch.set_num_threads(1)

AGG_RTOL, AGG_ATOL = 1e-5, 1e-7     # tests/test_edge_runtime.py's own
RUN_RTOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tensors(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


# ------------------------------------------------------------- staleness

@pytest.mark.parametrize("mode", ["poly", "exp", "const"])
def test_staleness_weight_matches_reference(mode):
    for decay in (0.1, 0.5, 2.0):
        for tau in (-1.0, 0.0, 0.5, 1.0, 3.0, 17.0, 1e3):
            assert staleness_weight(tau, mode, decay) == \
                jasync.staleness_weight(tau, mode, decay)
    with pytest.raises(KeyError, match="unknown staleness mode"):
        staleness_weight(1.0, "bogus")


@pytest.mark.parametrize("kw", [dict(aggregator="fedasync", buffer_size=4),
                                dict(buffer_size=0), dict(concurrency=0)],
                         ids=["fedasync_buffer", "buffer_size", "concurrency"])
def test_async_config_raises_as_the_reference(kw):
    with pytest.raises(ValueError) as want:
        jasync.AsyncConfig(**kw)
    with pytest.raises(ValueError) as got:
        AsyncConfig(**kw)
    assert str(got.value) == str(want.value)
    cfg = AsyncConfig(lr=0.25, staleness_mode="exp", staleness_decay=0.3)
    jcfg = jasync.AsyncConfig(lr=0.25, staleness_mode="exp",
                              staleness_decay=0.3)
    assert cfg.smoothness == jcfg.smoothness == 4.0
    assert cfg.weight(2) == jcfg.weight(2)


# ------------------------------------------------------------ aggregators

def _toy_updates(seed, K=6, dim=40):
    """``tests/test_edge_runtime.py``'s ``_toy_updates``, as numpy."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    stacked = {"w": jax.random.normal(k1, (K, dim, 3)) * 0.1,
               "b": jax.random.normal(k2, (K, 3)) * 0.1}
    grad = {"w": jax.random.normal(k3, (dim, 3)) * 0.1, "b": jnp.zeros((3,))}
    params = {"w": jnp.zeros((dim, 3)), "b": jnp.zeros((3,))}
    return jax.tree_util.tree_map(np.asarray, (params, stacked, grad))


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


AGGREGATIONS = [
    ("contextual_async", 6, None),
    ("contextual_async", 6, [1.0, 1.0, 1.0, 0.01, 0.01, 0.01]),
    ("contextual_async", 6, [1.0, 0.7071068, 0.5, 0.4472136, 0.25, 0.1]),
    ("fedbuff", 6, [1.0, 0.5, 0.25, 1.0, 0.5, 0.25]),
    ("fedbuff", 6, None),
    ("fedasync", 1, [0.35355338]),
]


@pytest.mark.parametrize("name,K,s", AGGREGATIONS,
                         ids=[f"{a}-{i}" for i, (a, _, _)
                              in enumerate(AGGREGATIONS)])
def test_aggregator_matches_reference(name, K, s):
    params, stacked, grad = _toy_updates(len(name) + K, K=K)
    jcfg = JAggregatorConfig(name="x", solve=JSolveConfig(beta=5.0),
                             staleness=None if s is None
                             else jnp.asarray(s, jnp.float32))
    tcfg = AggregatorConfig(name="x", solve=SolveConfig(beta=5.0),
                            staleness=None if s is None
                            else torch.tensor(s, dtype=torch.float32))
    jnew, jinfo = j_aggregate(name)(params, stacked, grad, jcfg)
    reset_launch_counts()
    tnew, tinfo = aggregate(name)(_tensors(params), _tensors(stacked),
                                  _tensors(grad), tcfg)
    counts = launch_counts()
    assert counts["gram/torch"] == (name == "contextual_async")
    assert counts["combine/torch"] == 2          # one per leaf
    for key in ("w", "b"):
        _close(tnew[key], jnew[key], AGG_RTOL, AGG_ATOL, f"{name} new {key}")
    for key in jinfo:
        _close(tinfo[key], jinfo[key], AGG_RTOL, AGG_ATOL, f"{name} {key}")
    assert set(tinfo) == set(jinfo)


def test_contextual_async_with_unit_staleness_equals_contextual():
    params, stacked, grad = map(_tensors, _toy_updates(0))
    cfg = AggregatorConfig(name="x", solve=SolveConfig(beta=5.0))
    new_a, info_a = aggregate("contextual_async")(params, stacked, grad, cfg)
    new_c, info_c = aggregate("contextual")(params, stacked, grad, cfg)
    _close(new_a["w"], _np(new_c["w"]), 1e-5, 1e-7, "w")
    _close(info_a["alpha"], _np(info_c["alpha"]), 1e-5, 1e-7, "alpha")


def test_contextual_async_staleness_damps_stale_updates():
    params, stacked, grad = map(_tensors, _toy_updates(1))
    s = torch.tensor([1.0, 1.0, 1.0, 0.01, 0.01, 0.01])
    base = AggregatorConfig(name="x", solve=SolveConfig(beta=5.0))
    _, info_fresh = aggregate("contextual_async")(params, stacked, grad, base)
    _, info_stale = aggregate("contextual_async")(
        params, stacked, grad, replace(base, staleness=s))
    a_fresh = np.abs(_np(info_fresh["alpha"]))
    a_stale = np.abs(_np(info_stale["alpha"]))
    assert np.all(a_stale[3:] < 0.1 * a_fresh[3:] + 1e-6)
    assert a_stale[:3].mean() > 0.2 * a_fresh[:3].mean()


def test_fedbuff_is_staleness_weighted_mean():
    params, stacked, grad = map(_tensors, _toy_updates(2))
    s = torch.tensor([1.0, 0.5, 0.25, 1.0, 0.5, 0.25])
    cfg = AggregatorConfig(name="x", solve=SolveConfig(beta=5.0), staleness=s)
    new, info = aggregate("fedbuff")(params, stacked, grad, cfg)
    expect = np.einsum("k,kij->ij", _np(s) / 6.0, _np(stacked["w"]))
    _close(new["w"], expect, 1e-5, 0, "w")
    _close(info["staleness_weight"], _np(s), 0, 0, "staleness_weight")


@pytest.mark.parametrize("agg,server_lr", [("contextual_async", 1.0),
                                           ("fedbuff", 0.5)])
def test_buffer_flush_matches_reference(agg, server_lr):
    """One flush of five buffered updates of mixed staleness: the ∇f
    estimate (a staleness-weighted sum of the buffered gradients), the
    discounted solve and the info dict."""
    rng = np.random.default_rng(4)
    dim = 30
    params = {"w": rng.normal(size=(dim, 10)).astype(np.float32) * 0.1,
              "b": np.zeros(10, np.float32)}
    items = [({"w": rng.normal(size=(dim, 10)).astype(np.float32) * 0.05,
               "b": rng.normal(size=10).astype(np.float32) * 0.05},
              {"w": rng.normal(size=(dim, 10)).astype(np.float32),
               "b": rng.normal(size=10).astype(np.float32)}, ver, dev)
             for ver, dev in ((7, 3), (4, 0), (7, 8), (1, 2), (6, 5))]
    kw = dict(aggregator=agg, buffer_size=5, lr=0.2, server_lr=server_lr)
    jbuf, tbuf = jasync.AsyncBuffer(jasync.AsyncConfig(**kw)), \
        AsyncBuffer(AsyncConfig(**kw))
    for delta, grad, ver, dev in items:
        jbuf.add(jasync.BufferedUpdate(
            jax.tree_util.tree_map(jnp.asarray, delta),
            jax.tree_util.tree_map(jnp.asarray, grad), ver, dev))
        tbuf.add(BufferedUpdate(_tensors(delta), _tensors(grad), ver, dev))
    assert tbuf.ready() and jbuf.ready()
    jnew, jinfo = jbuf.flush(jax.tree_util.tree_map(jnp.asarray, params), 7)
    tnew, tinfo = tbuf.flush(_tensors(params), 7)
    assert not tbuf.items
    for key in ("w", "b"):
        _close(tnew[key], jnew[key], AGG_RTOL, AGG_ATOL, f"new {key}")
    assert isinstance(tinfo["staleness"], np.ndarray)
    assert isinstance(tinfo["device_ids"], np.ndarray)
    np.testing.assert_array_equal(tinfo["staleness"], jinfo["staleness"])
    np.testing.assert_array_equal(tinfo["device_ids"], jinfo["device_ids"])
    assert set(tinfo) == set(jinfo)
    for key in set(jinfo) - {"staleness", "device_ids"}:
        _close(tinfo[key], jinfo[key], AGG_RTOL, AGG_ATOL, key)
    with pytest.raises(RuntimeError, match="empty buffer"):
        tbuf.flush(tnew, 8)


# ------------------------------------------------------- the whole run

DIM, N_DEV = 20, 10


@pytest.fixture(scope="module")
def tiny_problem():
    """``tests/test_edge_runtime.py``'s ``tiny_problem``: (reference
    dataset, port dataset, reference params as numpy)."""
    xs, ys = j_make_synthetic(1.0, 1.0, num_devices=N_DEV,
                              samples_per_device=30, dim=DIM, seed=5)
    parts = (xs, ys, np.ones(ys.shape, np.float32),
             xs.reshape(-1, DIM)[:150], ys.reshape(-1)[:150], 10)
    params = jax.tree_util.tree_map(np.asarray, j_get_model(JArchConfig(
        name="lr", family="logreg", input_dim=DIM, num_classes=10)
    ).init(jax.random.PRNGKey(0)))
    return JFederatedDataset(*parts), FederatedDataset(*parts), params


BASE = dict(num_devices=N_DEV, buffer_size=3, lr=0.2, batch_size=10,
            min_epochs=1, max_epochs=4)
FLEET = dict(slowdown=8.0, dropout_slow=0.2, seed=0)


def _port_async(ds, params, seed=11, aggs=8, **kw):
    """``tests/test_edge_runtime.py``'s ``_async`` on the port, with the
    port's own draws."""
    cfg = AsyncConfig(**dict(BASE, **dict(dict(aggregator="contextual_async"),
                                          **kw)))
    return run_async_simulation(
        "async", t_loss, t_apply, params_from_jax(params, device="cpu"), ds,
        cfg, bimodal_fleet(ds.num_devices, **FLEET), num_aggregations=aggs,
        selection_seed=seed, eval_every=2, device="cpu")


def _reference_draws(ds, seed, batch_size):
    """``batch_indices`` replaying the reference's per-arrival draws."""
    base_key = jax.random.PRNGKey(seed)
    m = ds.x.shape[1]

    @jax.jit
    def draws(key, mask, steps_keys_n):
        probs = mask / jnp.maximum(mask.sum(), 1.0)
        return jax.vmap(lambda sk: jax.random.choice(
            sk, m, shape=(batch_size,), p=probs))(steps_keys_n)

    seen = []

    def batch_indices(seq, device_id, max_steps):
        key = jax.random.fold_in(base_key, seq)
        idx = draws(key, jnp.asarray(ds.mask[device_id]),
                    jax.random.split(key, max_steps))
        seen.append(seq)
        return torch.from_numpy(np.array(idx)).long()[None]
    batch_indices.seen = seen
    return batch_indices


@pytest.mark.parametrize("agg,kw", [("contextual_async", {}),
                                    ("fedbuff", dict(server_lr=0.5))])
def test_async_run_matches_reference(tiny_problem, agg, kw):
    jds, tds, params = tiny_problem
    seed = 11
    cfg = dict(BASE, aggregator=agg, **kw)
    want = j_run_async("async", j_loss, j_apply, params, jds,
                       jasync.AsyncConfig(**cfg),
                       j_bimodal_fleet(N_DEV, **FLEET), num_aggregations=8,
                       selection_seed=seed, eval_every=2, collect_alpha=True)
    draws = _reference_draws(jds, seed, BASE["batch_size"])
    tracker = InMemoryTracker()
    reset_launch_counts()
    with use_tracker(tracker):
        got = run_async_simulation(
            "async", t_loss, t_apply, params_from_jax(params, device="cpu"),
            tds, AsyncConfig(**cfg), bimodal_fleet(N_DEV, **FLEET),
            num_aggregations=8, selection_seed=seed, eval_every=2,
            collect_alpha=True, batch_indices=draws, device="cpu")
    assert isinstance(got, AsyncSimulationResult)
    # the event stream and counters: bitwise
    assert got.times == want.times
    assert got.versions == want.versions == [2, 4, 6, 8]
    assert (got.dispatched, got.arrived, got.dropped) == \
        (want.dispatched, want.arrived, want.dropped)
    np.testing.assert_array_equal(got.updates_per_device,
                                  want.updates_per_device)
    assert got.staleness_mean == want.staleness_mean
    assert len(draws.seen) == got.updates_per_device.sum()
    # each flush's α and the losses
    assert len(got.alpha_history) == len(want.alpha_history) == 8
    for i, (a, b) in enumerate(zip(got.alpha_history, want.alpha_history)):
        np.testing.assert_allclose(a, b, rtol=RUN_RTOL,
                                   atol=RUN_RTOL * np.abs(b).max(),
                                   err_msg=f"alpha of flush {i + 1}")
    np.testing.assert_allclose(got.train_loss, want.train_loss,
                               rtol=RUN_RTOL)
    np.testing.assert_allclose(got.test_nll, want.test_nll, rtol=RUN_RTOL)
    # the kernels: gram once per contextual flush, combine once per leaf
    counts = launch_counts()
    assert counts["gram/torch"] == (8 if agg == "contextual_async" else 0)
    assert counts["combine/torch"] == 2 * 8
    names = [span_fields(e)["name"] for e in tracker.span_events()]
    assert names.count("aggregate") == 8
    assert names.count("client_update") == got.updates_per_device.sum()
    assert names.count("eval") == 4


def test_async_simulation_runs_and_is_deterministic(tiny_problem):
    _, ds, params = tiny_problem
    r1 = _port_async(ds, params)
    r2 = _port_async(ds, params)
    assert r1.times == r2.times
    assert r1.train_loss == r2.train_loss
    assert np.isfinite(r1.train_loss).all()
    assert all(b >= a for a, b in zip(r1.times, r1.times[1:]))
    assert r1.arrived + r1.dropped <= r1.dispatched
    assert r1.arrived >= 8 * 3
    assert r1.versions[-1] == 8


def test_async_simulation_learns(tiny_problem):
    _, ds, params = tiny_problem
    r = _port_async(ds, params, seed=13)
    assert r.train_loss[-1] < r.train_loss[0]


def test_concurrency_cap_rotates_across_whole_fleet(tiny_problem):
    _, ds, params = tiny_problem
    r = _port_async(ds, params, concurrency=3)
    assert r.updates_per_device.sum() == r.arrived
    assert (r.updates_per_device > 0).sum() >= ds.num_devices - 2


def test_async_fedbuff_and_fedasync_run(tiny_problem):
    _, ds, params = tiny_problem
    r = _port_async(ds, params, aggregator="fedbuff", server_lr=0.5)
    assert np.isfinite(r.train_loss).all()
    r = _port_async(ds, params, aggregator="fedasync", buffer_size=1,
                    server_lr=0.5, aggs=6)
    assert np.isfinite(r.train_loss).all() and r.versions[-1] == 6


def test_async_config_and_fleet_validation(tiny_problem, monkeypatch):
    with pytest.raises(ValueError, match="fedasync"):
        AsyncConfig(aggregator="fedasync", buffer_size=4)
    with pytest.raises(ValueError, match="concurrency"):
        AsyncConfig(concurrency=0)
    _, ds, params = tiny_problem
    tparams = params_from_jax(params, device="cpu")
    run = lambda fleet, **kw: run_async_simulation(  # noqa: E731
        "x", t_loss, t_apply, tparams, ds,
        AsyncConfig(num_devices=ds.num_devices), fleet, num_aggregations=1,
        device=kw.pop("device", "cpu"), **kw)
    with pytest.raises(ValueError, match="fleet"):
        run(uniform_fleet(3))
    with pytest.raises(ValueError, match="batch_indices returned"):
        run(uniform_fleet(ds.num_devices),
            batch_indices=lambda seq, d, steps: torch.zeros((1, steps, 3)))
    # attack and churn are ported: an object that is neither fails where
    # the reference's does, on the attribute the runtime reads
    for kw, attr in ((dict(attack=object()), "corrupts_data"),
                     (dict(churn=object()), "offline")):
        with pytest.raises(AttributeError, match=attr):
            run(uniform_fleet(ds.num_devices), **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(uniform_fleet(ds.num_devices), device="cuda")
