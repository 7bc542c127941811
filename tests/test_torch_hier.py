"""The port's hierarchical runtime (``repro_torch.hier``, ``run_hier_simulation``)
against ``repro.hier`` and ``repro.fl.run_hier_simulation``.

* Topologies and the byte ledger are copies: identical.
* Engine stages run on identical (P, n) round matrices: G and c at rtol
  1e-5 (f32, summation order only); α, ū and the cloud delta at rtol 1e-4,
  since the solve can amplify the relative error of (G, c) by up to cond(G),
  which the test checks is below 10.
* A whole run: the host randomness (selection, epochs, scheduler) is numpy
  and bit-identical, so times, bytes, the comm report and the counts must
  equal the reference's exactly; the losses differ because the mini-batch
  generators differ (``jax.random`` vs ``torch.Generator``), so they are
  held to a band of 10 % of the reference's loss.
* Then the reference's own assertions (``tests/test_hier.py``,
  ``tests/test_compress.py``) on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hier as jh
from repro.compress import CompressConfig as JCompressConfig
from repro.core.solve import SolveConfig as JSolveConfig
from repro.data import make_synthetic
from repro.edge import profiles as jprof
from repro.fl.simulation import run_hier_simulation as j_run
from repro.hier import fused as jfused
from repro.models.logistic import logistic_apply as j_apply
from repro.models.logistic import logistic_loss as j_loss
from repro_torch import hier as th
from repro_torch.compress import CompressConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_to_vector
from repro_torch.core.solve import SolveConfig
from repro_torch.data.federated import FederatedDataset as TFederatedDataset
from repro_torch.edge import profiles as tprof
from repro_torch.fl.simulation import run_hier_simulation as t_run
from repro_torch.hier import fused as tfused
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.logistic import logistic_apply as t_apply
from repro_torch.models.logistic import logistic_loss as t_loss
from repro_torch.obs import InMemoryTracker, use_tracker
from repro_torch.obs.spans import span_fields

torch.set_num_threads(1)

DIM, CLASSES, N_DEV = 20, 10, 12
N_MODEL = DIM * CLASSES + CLASSES


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=rtol * max(1e-6, float(np.abs(want).max())), err_msg=what)


# ------------------------------------------------------ topology and ledger

def _topo_sig(topo):
    return [(n.node_id, n.tier, n.parent, tuple(n.children),
             None if n.uplink is None else
             (n.uplink.up_bw, n.uplink.down_bw, n.uplink.latency))
            for n in sorted(topo.nodes.values(), key=lambda n: n.node_id)] + \
        [topo.depth, topo.cloud_id, [g.node_id for g in topo.gateways]]


@pytest.mark.parametrize("build", [
    lambda m, f: m.star_topology(f),
    lambda m, f: m.two_tier_topology(f, 3),
    lambda m, f: m.geo_partitioned_topology(f, 2, 2),
    lambda m, f: m.two_tier_topology(f, 4, assignment="random", seed=3),
    lambda m, f: m.get_topology("two_tier_bimodal", 12, num_gateways=4),
    lambda m, f: m.get_topology("geo", 12),
], ids=["star", "two_tier", "geo", "two_tier_random", "get_two_tier",
        "get_geo"])
def test_topologies_identical(build):
    jf = jprof.bimodal_fleet(N_DEV, slowdown=4.0, seed=0)
    tf = tprof.bimodal_fleet(N_DEV, slowdown=4.0, seed=0)
    assert _topo_sig(build(th, tf)) == _topo_sig(build(jh, jf))


def test_topology_misuse_raises_like_the_reference():
    f = tprof.uniform_fleet(3)
    with pytest.raises(ValueError):
        th.two_tier_topology(f, 5)
    with pytest.raises(KeyError):
        th.get_topology("bogus", 4)
    with pytest.raises(ValueError):
        th.Link(up_bw=0.0, down_bw=1.0)


def test_comm_ledger_and_byte_formulas_identical():
    for k, n in ((1, 7850), (25, 7850), (4, 210)):
        assert th.summary_bytes(k, n) == jh.summary_bytes(k, n)
        assert th.summary_bytes(k, n, include_grad=True) == \
            jh.summary_bytes(k, n, include_grad=True)
        assert th.update_bytes(n) == jh.update_bytes(n)
        assert th.compressed_summary_bytes(4.0 * n) == \
            jh.compressed_summary_bytes(4.0 * n)
    ledgers = [th.CommLedger(2), jh.CommLedger(2)]
    for led in ledgers:
        led.record_down(0, 100.0, count=5)
        led.record_down(1, 40.0, 0.5)
        led.record_up(1, 30.0, 0.25)
        led.record_up(2, 12.0, 0.1)
        led.record_up(2, 8.0, 0.2)
    assert ledgers[0].report() == ledgers[1].report()
    assert ledgers[0].cloud_uplink_bytes == ledgers[1].cloud_uplink_bytes
    assert ledgers[0].total_bytes() == ledgers[1].total_bytes()
    assert th.model_size({"w": torch.zeros(3, 4), "b": torch.zeros(4)}) == 16


# ----------------------------------------------------------------- config

@pytest.mark.parametrize("kw,err,match", [
    (dict(aggregator="bogus"), ValueError, "unknown hier aggregator"),
    (dict(fan_in=0), ValueError, "fan_in"),
    (dict(gateway_grad="bogus"), ValueError, "gateway_grad"),
    (dict(aggregator="hier_contextual", compress="cfg"), ValueError,
     "hier_contextual_sketch"),
    (dict(aggregator="hier_contextual_sketch", gateway_grad="global"),
     ValueError, "gateway_grad"),
])
def test_hier_config_validation_matches(kw, err, match):
    for H, C in ((th.HierConfig, CompressConfig),
                 (jh.HierConfig, JCompressConfig)):
        kw2 = dict(kw)
        if kw2.get("compress") == "cfg":
            kw2["compress"] = C()
        with pytest.raises(err, match=match):
            H(**kw2)
    cfg = th.HierConfig(aggregator="hier_contextual_sketch")
    assert cfg.compress == CompressConfig() and cfg.compressing
    assert th.HierConfig(lr=0.25).smoothness == pytest.approx(4.0)
    assert th.HierConfig(aggregator="hier_fedavg").tier_mode == "mean"


def test_hier_aggregators_registered():
    from repro_torch.core.aggregation import available_aggregators
    assert {"hier_contextual", "hier_fedavg", "hier_relay",
            "hier_contextual_sketch"} <= set(available_aggregators())


# ------------------------------------------------------------ engine stages

def _stacked(rng, P):
    w = rng.randn(P, DIM, CLASSES).astype(np.float32)
    b = rng.randn(P, CLASSES).astype(np.float32)
    return {"w": w, "b": b}


def _engines(tier_mode="contextual"):
    template = {"w": np.zeros((DIM, CLASSES), np.float32),
                "b": np.zeros(CLASSES, np.float32)}
    j_eng = jfused.HierRoundEngine(
        jax.tree_util.tree_map(jnp.asarray, template),
        JSolveConfig(beta=5.0, ridge=1e-6), tier_mode)
    t_eng = tfused.HierRoundEngine(
        {k: torch.from_numpy(v) for k, v in template.items()},
        SolveConfig(beta=5.0, ridge=1e-6), tier_mode)
    return j_eng, t_eng


def _round(P=12, seed=0):
    rng = np.random.RandomState(seed)
    d, g = _stacked(rng, P), _stacked(rng, P)
    j_eng, t_eng = _engines()
    jctx = j_eng.begin_round(jax.tree_util.tree_map(jnp.asarray, d),
                             jax.tree_util.tree_map(jnp.asarray, g))
    tctx = t_eng.begin_round({k: torch.from_numpy(v) for k, v in d.items()},
                             {k: torch.from_numpy(v) for k, v in g.items()})
    return jctx, tctx


def _check_summary(got, want, what):
    G = np.asarray(want["G"])
    assert np.linalg.cond(G) < 10, what
    _close(got["G"], want["G"], 1e-5, f"{what} G")
    _close(got["c"], want["c"], 1e-5, f"{what} c")
    _close(got["ghat"], want["ghat"], 1e-5, f"{what} ghat")
    _close(got["alpha"], want["alpha"], 1e-4, f"{what} alpha")
    _close(got["u_bar"], want["u_bar"], 1e-4, f"{what} u_bar")
    _check_info(got["info"], want["info"], np.abs(np.asarray(want["c"])).max(),
                what)


def _check_info(got, want, c_scale, what):
    """rtol 1e-4 per key; the stationarity residual ‖c + βGα‖ is ~0 at an
    unscaled optimum (a cancellation of terms of size |c|), so it also gets
    1e-4·max|c| absolute."""
    assert set(got) == set(want), what
    for key in want:
        atol = 1e-4 * c_scale if key == "stationarity_residual" else 0.0
        np.testing.assert_allclose(
            _np(got[key]), np.asarray(want[key]), rtol=1e-4,
            atol=max(atol, 1e-4 * max(1e-6, float(np.abs(want[key]).max()))),
            err_msg=f"{what} {key}")


def test_engine_gateway_and_merge_match_reference():
    jctx, tctx = _round()
    np.testing.assert_array_equal(_np(tctx.D), np.asarray(jctx.D))
    groups = [np.arange(0, 4), np.array([4, 6, 7]), np.arange(8, 12)]
    jouts, touts = [], []
    for gi, idxs in enumerate(groups):
        scale = 1.5 if gi == 1 else 1.0
        jo = jctx.gateway(idxs, pool_scale=scale)
        to = tctx.gateway(idxs, pool_scale=scale)
        _check_summary(to, jo, f"gateway {gi}")
        jouts.append(jo)
        touts.append(to)
    # solve against a supplied (global) gradient
    jg = jctx.mean_grad(np.arange(12))
    tg = tctx.mean_grad(np.arange(12))
    _close(tg, jg, 1e-5, "mean_grad")
    _check_summary(tctx.gateway(groups[0], solve_grad=tg),
                   jctx.gateway(groups[0], solve_grad=jg), "global grad")
    counts = [4, 3, 4]
    jm = jctx.merge([o["u_bar"] for o in jouts], [o["ghat"] for o in jouts],
                    counts)
    tm = tctx.merge([o["u_bar"] for o in touts], [o["ghat"] for o in touts],
                    counts)
    _check_summary(tm, jm, "merge")
    assert float(tm["alpha"].sum()) == pytest.approx(1.0, abs=1e-5)
    _close(tctx.compose_grads([o["ghat"] for o in touts], counts),
           jctx.compose_grads([o["ghat"] for o in jouts], counts), 1e-5,
           "compose_grads")


def _check_cloud(got, want, what, c, U=None):
    delta, info = got
    jdelta, jinfo = want
    if U is not None:                    # the solve's G (no override)
        assert np.linalg.cond(U @ U.T) < 10, what
    _close(delta, jdelta, 1e-4, f"{what} delta")
    _check_info(info, jinfo, float(np.abs(np.asarray(c)).max()), what)


@pytest.mark.parametrize("kind,scale", [("raw", 1.0), ("raw", 2.2),
                                        ("fedavg", 1.0)])
def test_engine_cloud_raw_matches_reference(kind, scale):
    jctx, tctx = _round(seed=1)
    idxs = [0, 2, 3, 5, 8, 9, 11]
    U, GM = np.asarray(jctx.D)[idxs], np.asarray(jctx.GM)[idxs]
    _check_cloud(tctx.cloud_raw(idxs, kind, solve_scale=scale),
                 jctx.cloud_raw(idxs, kind, solve_scale=scale), kind,
                 U @ GM.mean(axis=0), U)


@pytest.mark.parametrize("kind,override", [("combo", False), ("combo", True),
                                           ("fedavg", False)])
def test_engine_cloud_combo_matches_reference(kind, override):
    jctx, tctx = _round(seed=3)
    groups = [np.arange(0, 4), np.arange(4, 8), np.arange(8, 12)]
    jouts = [jctx.gateway(g) for g in groups]
    touts = [tctx.gateway(g) for g in groups]
    counts = [4, 4, 4]
    jghat = jctx.compose_grads([o["ghat"] for o in jouts], counts)
    tghat = tctx.compose_grads([o["ghat"] for o in touts], counts)
    jov = tov = None
    if override:
        rng = np.random.RandomState(3)
        S = rng.randn(3, 50).astype(np.float32)
        s = rng.randn(50).astype(np.float32)
        jov = (jnp.asarray(S @ S.T), jnp.asarray(S @ s))
        tov = (torch.from_numpy(S @ S.T), torch.from_numpy(S @ s))
    got = tctx.cloud_combo([o["u_bar"] for o in touts], counts, tghat,
                           kind=kind, override=tov)
    want = jctx.cloud_combo([o["u_bar"] for o in jouts], counts, jghat,
                            kind=kind, override=jov)
    ubar = np.stack([np.asarray(o["u_bar"]) for o in jouts])
    _check_cloud(got, want, kind, np.asarray(jov[1]) if override
                 else ubar @ np.asarray(jghat),
                 ubar if kind == "combo" and not override else None)
    if kind == "combo":
        assert float(got[1]["gamma"].sum()) == pytest.approx(1.0, abs=1e-5)
    # apply: w + Δ as a tree
    params = {"w": torch.zeros(DIM, CLASSES), "b": torch.ones(CLASSES)}
    new = tctx.apply(params, got[0])
    np.testing.assert_allclose(_np(tree_to_vector(new)),
                               _np(tree_to_vector(params) + got[0]))


def test_engine_decoded_rows_replace_their_rows():
    jctx, tctx = _round(seed=4)
    rng = np.random.RandomState(5)
    dv = rng.randn(N_MODEL).astype(np.float32)
    gv = rng.randn(N_MODEL).astype(np.float32)
    jctx.add_decoded_row(2, jnp.asarray(dv), jnp.asarray(gv))
    tctx.add_decoded_row(2, torch.from_numpy(dv), torch.from_numpy(gv))
    _check_summary(tctx.gateway([1, 2, 3]), jctx.gateway([1, 2, 3]),
                   "decoded gateway")
    rows = np.asarray(jctx.D)[[0, 2, 4, 6]]
    rows[1] = dv
    grads = np.asarray(jctx.GM)[[0, 2, 4, 6]]
    grads[1] = gv
    _check_cloud(tctx.cloud_raw([0, 2, 4, 6], "raw"),
                 jctx.cloud_raw([0, 2, 4, 6], "raw"), "decoded cloud",
                 rows @ grads.mean(axis=0), rows)
    assert tctx.engine.peak_round_bytes(12) == jctx.engine.peak_round_bytes(12)


def test_reference_functions_match():
    """``summarize_updates`` / ``merge_summaries`` on trees."""
    rng = np.random.RandomState(6)
    ups = [{"w": rng.randn(DIM, CLASSES).astype(np.float32),
            "b": rng.randn(CLASSES).astype(np.float32)} for _ in range(5)]
    grs = [{"w": rng.randn(DIM, CLASSES).astype(np.float32),
            "b": rng.randn(CLASSES).astype(np.float32)} for _ in range(5)]
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    tt = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}  # noqa: E731
    jcfg, tcfg = JSolveConfig(beta=5.0), SolveConfig(beta=5.0)
    for mode, pool in (("contextual", None), ("contextual", 9),
                       ("mean", None)):
        js = jh.summarize_updates(0, range(5), [jt(u) for u in ups],
                                  [jt(g) for g in grs], [1, 2, 1, 1, 3],
                                  jcfg, mode, pool_size=pool)
        ts = th.summarize_updates(0, range(5), [tt(u) for u in ups],
                                  [tt(g) for g in grs], [1, 2, 1, 1, 3],
                                  tcfg, mode, pool_size=pool)
        assert ts.num_updates == js.num_updates == 8
        _close(ts.G, js.G, 1e-5, "G")
        _close(ts.alpha, js.alpha, 1e-4, "alpha")
        for k in ("w", "b"):
            _close(ts.u_bar[k], js.u_bar[k], 1e-4, f"u_bar {k}")
            _close(ts.grad_est[k], js.grad_est[k], 1e-5, f"grad_est {k}")
    ups2 = [{"w": rng.randn(DIM, CLASSES).astype(np.float32),
             "b": rng.randn(CLASSES).astype(np.float32)} for _ in range(5)]
    js = jh.summarize_updates(0, range(5), [jt(u) for u in ups],
                              [jt(g) for g in grs], [1, 1, 1, 1, 1], jcfg)
    ts = th.summarize_updates(0, range(5), [tt(u) for u in ups],
                              [tt(g) for g in grs], [1, 1, 1, 1, 1], tcfg)
    js2 = jh.summarize_updates(1, range(5), [jt(u) for u in ups2],
                               [jt(g) for g in grs], [1, 1, 1, 1, 1], jcfg)
    ts2 = th.summarize_updates(1, range(5), [tt(u) for u in ups2],
                               [tt(g) for g in grs], [1, 1, 1, 1, 1], tcfg)
    jm = jh.merge_summaries(9, [js, js2], jcfg)
    tm = th.merge_summaries(9, [ts, ts2], tcfg)
    assert np.linalg.cond(np.asarray(jm.G)) < 10
    _close(tm.alpha, jm.alpha, 1e-4, "merge alpha")
    for k in ("w", "b"):
        _close(tm.u_bar[k], jm.u_bar[k], 1e-4, f"merge u_bar {k}")
    with pytest.raises(ValueError, match="zero updates"):
        th.summarize_updates(0, [], [], [], [], tcfg)
    with pytest.raises(ValueError, match="pool_size"):
        th.summarize_updates(0, [0, 1], [tt(ups[0])] * 2, [tt(grs[0])] * 2,
                             [1, 1], tcfg, pool_size=1)
    jd = jh.blockdiag_diagnostics([js, js], jnp.asarray([0.4, 0.6]), 5.0)
    td = th.blockdiag_diagnostics([ts, ts], torch.tensor([0.4, 0.6]), 5.0)
    assert td["devices_represented"] == jd["devices_represented"]
    _close(td["blockdiag_bound"], jd["blockdiag_bound"], 1e-4, "bound")


# ------------------------------------------------------------- whole runs

@pytest.fixture(scope="module")
def problem():
    xs, ys = make_synthetic(1.0, 1.0, num_devices=N_DEV,
                            samples_per_device=30, dim=DIM, seed=5)
    mask = np.ones(ys.shape, np.float32)
    tx, ty = xs.reshape(-1, DIM)[:150], ys.reshape(-1)[:150]
    from repro.data.federated import FederatedDataset as JFederatedDataset
    from repro.models import get_model
    from repro.models.config import ArchConfig
    jds = JFederatedDataset(xs, ys, mask, tx, ty, CLASSES)
    tds = TFederatedDataset(xs, ys, mask, tx, ty, CLASSES)
    jp = get_model(ArchConfig(name="lr", family="logreg", input_dim=DIM,
                              num_classes=CLASSES)).init(
        jax.random.PRNGKey(0))
    return jds, tds, jp, params_from_jax(jp, device="cpu")


BASE = dict(aggregator="hier_contextual", lr=0.2, batch_size=10,
            min_epochs=1, max_epochs=4)


def _t_hier(problem, topo, rounds=5, seed=11, fleet=None, run_kw=None,
            **kw):
    _, tds, _, tp = problem
    cfg = dict(BASE)
    cfg.update(kw)
    return t_run("hier", t_loss, t_apply, tp, tds, th.HierConfig(**cfg),
                 topo(th, fleet(tprof)), num_rounds=rounds,
                 selection_seed=seed, eval_every=2, device="cpu",
                 **(run_kw or {}))


def _j_hier(problem, topo, rounds=5, seed=11, fleet=None, **kw):
    jds, _, jp, _ = problem
    cfg = dict(BASE)
    cfg.update(kw)
    if "compress" in cfg:
        cfg["compress"] = JCompressConfig(**vars(cfg["compress"]))
    return j_run("hier", j_loss, j_apply, jp, jds, jh.HierConfig(**cfg),
                 topo(jh, fleet(jprof)), num_rounds=rounds,
                 selection_seed=seed, eval_every=2)


def _bimodal(m):
    return m.bimodal_fleet(N_DEV, slowdown=4.0, dropout_slow=0.2, seed=0)


def _uniform(m):
    return m.uniform_fleet(N_DEV, dropout=0.1)


def _two_tier(m, f):
    return m.two_tier_topology(f, 3)


RUNS = {
    "two_tier": dict(topo=_two_tier, fleet=_bimodal),
    "topk": dict(topo=_two_tier, fleet=_bimodal,
                 aggregator="hier_contextual_sketch",
                 compress=CompressConfig(scheme="topk", ratio=3.4,
                                         u_frac=0.75)),
    "sign_sketch": dict(topo=_two_tier, fleet=_uniform,
                        aggregator="hier_contextual_sketch",
                        compress=CompressConfig(scheme="sign_sketch",
                                                ratio=4.0)),
    "geo_global": dict(topo=lambda m, f: m.geo_partitioned_topology(f, 2, 2),
                       fleet=_uniform, gateway_grad="global"),
    # FedAvg at lr 0.2 swings by ±15 % between mini-batch draws; at 0.05 it
    # is steady enough for the loss band
    "fedavg_fan_in": dict(topo=_two_tier, fleet=_bimodal, lr=0.05,
                          aggregator="hier_fedavg", fan_in=2),
    "star_device_uplink": dict(
        topo=lambda m, f: m.star_topology(f), fleet=_uniform, fan_in=8,
        aggregator="hier_contextual_sketch",
        compress=CompressConfig(scheme="topk", ratio=4.0,
                                device_uplink=True)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_reference(problem, name):
    kw = dict(RUNS[name])
    got = _t_hier(problem, rounds=4, **kw)
    want = _j_hier(problem, rounds=4, **kw)
    assert got.times == want.times
    assert got.comm == want.comm
    assert got.cloud_uplink_bytes == want.cloud_uplink_bytes
    assert got.total_bytes == want.total_bytes
    assert (got.dispatched, got.arrived, got.dropped, got.rounds_skipped) == \
        (want.dispatched, want.arrived, want.dropped, want.rounds_skipped)
    assert np.isfinite(got.train_loss).all()
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=0.1)
    assert got.engine["engine_name"] == "fused"
    assert got.engine["dense_round_matrix_bytes"] == \
        want.engine["dense_round_matrix_bytes"]


def test_run_is_deterministic_and_goes_through_the_ops(problem):
    kw = dict(RUNS["sign_sketch"])
    reset_launch_counts()
    r1 = _t_hier(problem, **kw)
    counts = launch_counts()
    r2 = _t_hier(problem, **kw)
    assert r1.train_loss == r2.train_loss and r1.times == r2.times
    assert r1.cloud_uplink_bytes == r2.cloud_uplink_bytes
    assert counts["gram/torch"] > 0
    assert counts["sign_sketch/torch"] > 0
    assert counts["sign_sketch_adjoint/torch"] > 0
    assert all(v == 0 for k, v in counts.items() if k.endswith("/cuda"))


def test_batch_generator_draws_the_batches(problem):
    """A run handed a generator trains on its draws: one seeded as the run's
    own default reproduces the default run, another seed gives other
    batches but the same host-side schedule."""
    def gen(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g
    kw = dict(RUNS["two_tier"])
    base = _t_hier(problem, rounds=3, **kw)
    same = _t_hier(problem, rounds=3, run_kw=dict(batch_generator=gen(11)),
                   **kw)
    other = _t_hier(problem, rounds=3, run_kw=dict(batch_generator=gen(3)),
                    **kw)
    assert same.train_loss == base.train_loss
    assert other.train_loss != base.train_loss
    assert other.times == base.times


def test_hier_learns_and_saves_uplink(problem):
    fleet = lambda m: m.bimodal_fleet(N_DEV, slowdown=4.0,  # noqa: E731
                                      dropout_slow=0.0, seed=0)
    flat = _t_hier(problem, lambda m, f: m.star_topology(f), rounds=6,
                   fleet=fleet)
    hier = _t_hier(problem, _two_tier, rounds=6, fleet=fleet)
    assert hier.train_loss[-1] < hier.train_loss[0]
    assert hier.cloud_uplink_bytes < flat.cloud_uplink_bytes
    assert hier.comm["tier_2"]["bytes_up"] == hier.cloud_uplink_bytes
    assert hier.comm["tier_1"]["bytes_up"] > 0
    assert hier.comm["tier_1"]["bytes_down"] > 0


def test_relay_matches_flat(problem):
    fleet = lambda m: m.uniform_fleet(N_DEV, dropout=0.0,  # noqa: E731
                                      jitter=0.05)
    flat = _t_hier(problem, lambda m, f: m.star_topology(f), rounds=4,
                   fleet=fleet)
    relay = _t_hier(problem, _two_tier, rounds=4, fleet=fleet,
                    aggregator="hier_relay")
    np.testing.assert_allclose(flat.train_loss, relay.train_loss, rtol=1e-5)
    assert relay.cloud_uplink_bytes == pytest.approx(flat.cloud_uplink_bytes)


def test_full_budget_topk_and_identity_equal_uncompressed(problem):
    fleet = lambda m: m.uniform_fleet(N_DEV, dropout=0.0)  # noqa: E731
    plain = _t_hier(problem, _two_tier, fleet=fleet)
    exact = _t_hier(problem, _two_tier, fleet=fleet,
                    aggregator="hier_contextual_sketch",
                    compress=CompressConfig(scheme="topk", k=N_MODEL))
    np.testing.assert_allclose(exact.train_loss, plain.train_loss, rtol=1e-4)
    ident = _t_hier(problem, _two_tier, fleet=fleet,
                    aggregator="hier_contextual_sketch",
                    compress=CompressConfig(scheme="identity"))
    np.testing.assert_allclose(ident.train_loss, plain.train_loss, rtol=1e-4)
    assert ident.cloud_uplink_bytes < plain.cloud_uplink_bytes


def test_ledger_matches_serialized_payload_sizes(problem):
    fleet = lambda m: m.uniform_fleet(N_DEV, dropout=0.0)  # noqa: E731
    ccfg = CompressConfig(scheme="topk", ratio=4.0, u_frac=0.75)
    r = _t_hier(problem, _two_tier, rounds=4, fleet=fleet,
                aggregator="hier_contextual_sketch", compress=ccfg)
    cu, cg = ccfg.build_pair(N_MODEL)
    per_summary = th.compressed_summary_bytes(
        4.0 * (cu.wire_floats(N_MODEL) + cg.wire_floats(N_MODEL)))
    assert r.cloud_uplink_bytes == pytest.approx(4 * 3 * per_summary)
    plain = _t_hier(problem, _two_tier, rounds=4, fleet=fleet)
    assert plain.cloud_uplink_bytes == pytest.approx(
        4 * 3 * th.summary_bytes(4, N_MODEL, include_grad=True))


def test_device_uplink_compression_star(problem):
    fleet = lambda m: m.uniform_fleet(N_DEV, dropout=0.0)  # noqa: E731
    star = lambda m, f: m.star_topology(f)                 # noqa: E731
    ccfg = CompressConfig(scheme="topk", ratio=4.0, device_uplink=True)
    r = _t_hier(problem, star, rounds=4, fleet=fleet,
                aggregator="hier_contextual_sketch", compress=ccfg)
    assert np.isfinite(r.train_loss).all()
    plain = _t_hier(problem, star, rounds=4, fleet=fleet)
    assert r.cloud_uplink_bytes < 0.6 * plain.cloud_uplink_bytes
    cu, cg = ccfg.build_pair(N_MODEL)
    per_dev = 4.0 * (cu.wire_floats(N_MODEL) + cg.wire_floats(N_MODEL))
    assert r.cloud_uplink_bytes == pytest.approx(4 * 12 * per_dev)


def test_run_opens_the_reference_spans_and_publishes(problem):
    published = []
    tracker = InMemoryTracker()
    with use_tracker(tracker):
        r = _t_hier(problem, _two_tier, rounds=3, fleet=_bimodal,
                    run_kw=dict(publish_fn=lambda t, p: published.append(t),
                                collect_gamma=True))
    names = {span_fields(e)["name"] for e in tracker.span_events()}
    assert {"round", "client_update", "begin_round", "event_loop",
            "gateway", "cloud", "eval"} <= names
    assert published == [0, 1, 2][:3 - r.rounds_skipped]
    assert len(r.gamma_history) == 3 - r.rounds_skipped
    assert set(r.engine) >= {"compile_wall_time_s",
                             "steady_wall_time_per_round_s",
                             "rounds_wall_time_s"}
    assert r.time_to_accuracy(0.0) == r.times[0]


def test_unported_parts_raise(problem, monkeypatch):
    _, tds, _, tp = problem
    topo = th.two_tier_topology(tprof.uniform_fleet(N_DEV), 3)
    cfg = th.HierConfig(**BASE)
    run = lambda **kw: t_run("x", t_loss, t_apply, tp, tds, cfg,  # noqa: E731
                             topo, 1, device="cpu", **kw)
    for kw, item in ((dict(scheduler_mode="cohort"), "repro.data.fleetgen"),
                     (dict(mesh=object()), "repro.sharding")):
        with pytest.raises(NotImplementedError, match=item):
            run(**kw)
    # attack and churn are ported: an object that is neither fails where
    # the reference's does, on the attribute the runtime reads
    with pytest.raises(AttributeError, match="corrupts_data"):
        run(attack=object())
    with pytest.raises(AttributeError, match="offline"):
        run(churn=object())
    # the streamed engine runs now, by name and above the budget
    assert run(engine="streamed").engine["engine_name"] == "streamed"
    monkeypatch.setenv("REPRO_DENSE_ROUND_BYTES", "16")
    assert run().engine["engine_name"] == "streamed"
    monkeypatch.delenv("REPRO_DENSE_ROUND_BYTES")
    for H in (th.HierConfig, jh.HierConfig):
        with pytest.raises(TypeError, match="RobustConfig"):
            H(robust=object())
    with pytest.raises(ValueError, match="device shards"):
        t_run("x", t_loss, t_apply, tp, tds, cfg,
              th.star_topology(tprof.uniform_fleet(50)), 1, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        run(engine="bogus")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        t_run("x", t_loss, t_apply, tp, tds, cfg, topo, 1)
