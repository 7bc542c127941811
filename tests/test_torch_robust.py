"""The port's robust subsystem (``repro_torch.robust``: attacks, churn, robust
Gram statistics, robust aggregators) against ``repro.robust``, and its
wiring into the sync, async and both hier runtimes.

* Host code is copied or numpy: churn membership, ``offline_mask``, the
  scheduler's trace under churn, ``assign_adversaries`` and
  ``poison_labels`` must equal the reference's bit for bit.
* The K-space statistics (``clip_scales``, ``pool_cross``, ``robustify``)
  run on the same f32 inputs at rtol 1e-6 (summation order only), and
  ``robustify`` with defenses off is the exact identity.
* The four flat aggregators at rtol 1e-5 (``tests/test_edge_runtime.py``'s
  aggregator tolerance), with krum's selection and the order of its scores
  exact, and the coordinate median at even and odd K.
* Attacks: ``SignFlip`` / ``ScaledUpdate`` bitwise; ``ByzantineGauss`` on
  the reference's own ``jax.random.normal`` leaves, fed in through the
  ``noise`` seam, at rtol 1e-6; honest rows bitwise untouched.
* One sync round, one hier round per engine and an async run with attack
  (and churn) on the reference's replayed mini-batch draws and noise:
  event traces and counters bitwise, parameters and losses at rtol 1e-4,
  the run tolerance of ``tests/test_torch_async.py`` (α = −(1/β)G⁻¹c
  amplifies the f32 summation-order differences of (G, c)).
* Then the reference's end-to-end assertions (``tests/test_robust.py``) and
  ``BENCH_robust.json``'s acceptance thresholds on the port's own draws.
"""
import dataclasses
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import AggregatorConfig as JAggregatorConfig
from repro.core.aggregation import aggregate as j_aggregate
from repro.core.solve import SolveConfig as JSolveConfig
from repro.data import make_synthetic
from repro.data.federated import FederatedDataset as JFederatedDataset
from repro.edge import AsyncConfig as JAsyncConfig
from repro.edge import events as jevents
from repro.edge import profiles as jprof
from repro.fl import run_async_simulation as j_run_async
from repro.fl import run_hier_simulation as j_run_hier
from repro.fl import server as jserver
from repro.hier import HierConfig as JHierConfig
from repro.hier import star_topology as j_star
from repro.hier import two_tier_topology as j_two_tier
from repro.models.logistic import logistic_apply as j_apply
from repro.models.logistic import logistic_loss as j_loss
import repro.robust as jr
from repro_torch import robust as tr
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import AggregatorConfig, aggregate
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.core.solve import SolveConfig
from repro_torch.data.federated import FederatedDataset
from repro_torch.edge import AsyncConfig
from repro_torch.edge import events as tevents
from repro_torch.edge import profiles as tprof
from repro_torch.fl import (ServerConfig, build_round_fn, init_server,
                            run_async_simulation, run_hier_simulation,
                            run_simulation)
from repro_torch.hier import HierConfig, star_topology, two_tier_topology
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.logistic import logistic_apply as t_apply
from repro_torch.models.logistic import logistic_loss as t_loss

torch.set_num_threads(1)

STAT_RTOL = 1e-6
AGG_RTOL = 1e-5
RUN_RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=rtol * max(1e-6, float(np.abs(want).max())), err_msg=what)


# ------------------------------------------------------------------ churn

WAVES = [(10.0, 20.0, 0.5, 3), (0.0, 5.0, 1.0, 0), (2.5, 7.5, 0.3, 9)]


@pytest.mark.parametrize("start,end,frac,seed", WAVES)
def test_churn_membership_and_offline_mask_bitwise(start, end, frac, seed):
    n = 37
    jw, tw = (jr.ChurnWave(start, end, frac, seed),
              tr.ChurnWave(start, end, frac, seed))
    js, ts = jr.ChurnSchedule(n, (jw,)), tr.ChurnSchedule(n, (tw,))
    assert ts.members(0) == js.members(0)
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n, size=200)
    times = rng.uniform(start - 5.0, end + 5.0, size=200)
    np.testing.assert_array_equal(ts.offline_mask(ids, times),
                                  js.offline_mask(ids, times))
    for d, t in zip(ids[:40], times[:40]):
        assert ts.offline(int(d), float(t)) == js.offline(int(d), float(t))


@pytest.mark.parametrize("profile", ["none", "wave", "blackout", "rolling"])
def test_churn_profiles_bitwise(profile):
    js = jr.churn_schedule(profile, 50, 80.0, seed=4)
    ts = tr.churn_schedule(profile, 50, 80.0, seed=4)
    assert [(w.start, w.end, w.fraction, w.seed) for w in ts.waves] == \
        [(w.start, w.end, w.fraction, w.seed) for w in js.waves]
    for i in range(len(ts.waves)):
        assert ts.members(i) == js.members(i)


def test_churn_validation_matches():
    for m in (jr, tr):
        with pytest.raises(ValueError, match="fraction"):
            m.ChurnWave(0.0, 1.0, 1.5)
        with pytest.raises(ValueError, match="end"):
            m.ChurnWave(2.0, 1.0, 0.5)
        with pytest.raises(KeyError, match="churn profile"):
            m.churn_schedule("bogus", 20, 100.0)
        with pytest.raises(ValueError, match="t_end"):
            m.churn_schedule("wave", 20, 0.0)


def _churn_trace(events, fleet, churn, stream, batch):
    sch = events.EventScheduler(fleet, seed=3, flops_per_step=1e6,
                                payload_bytes=1e4, churn=churn,
                                rng_stream=stream)
    for t in range(6):
        if batch:
            sch.dispatch_batch(np.arange(8), np.full(8, 5), version=t,
                               at=np.full(8, float(t) * 10.0))
        else:
            for d in range(8):
                sch.dispatch(d, 5, version=t, at=float(t) * 10.0)
        while sch.pop() is not None:
            pass
    st = sch.stats
    return sch.trace_signature(), (st.dispatched, st.arrived, st.dropped)


@pytest.mark.parametrize("stream,batch", [("v1", False), ("v1", True),
                                          ("v2", True)])
def test_scheduler_trace_under_churn_bitwise(stream, batch):
    jf = jprof.uniform_fleet(8, dropout=0.1)
    tf = tprof.uniform_fleet(8, dropout=0.1)
    js = jr.churn_schedule("blackout", 8, 60.0, seed=1)
    ts = tr.churn_schedule("blackout", 8, 60.0, seed=1)
    want = _churn_trace(jevents, jf, js, stream, batch)
    got = _churn_trace(tevents, tf, ts, stream, batch)
    assert got == want
    assert got != _churn_trace(tevents, tf, None, stream, batch)
    assert got[1][2] > 0                                  # the wave dropped


# ------------------------------------------------------- placement, labels

@pytest.mark.parametrize("n,frac,seed", [(20, 0.25, 5), (64, 0.2, 3),
                                         (100, 0.2, 3), (12, 0.17, 3),
                                         (20, 0.0, 1)])
def test_assign_adversaries_exact(n, frac, seed):
    got = tr.assign_adversaries(tprof.uniform_fleet(n), frac, seed=seed)
    want = jr.assign_adversaries(jprof.uniform_fleet(n), frac, seed=seed)
    assert got.malicious == want.malicious
    bim = tr.assign_adversaries(tprof.bimodal_fleet(n, slowdown=4.0, seed=0),
                                frac, seed=seed)
    assert bim.malicious == want.malicious
    with pytest.raises(ValueError, match="fraction"):
        tr.assign_adversaries(tprof.uniform_fleet(n), 1.0)


def test_poison_labels_exact():
    y = np.random.RandomState(0).randint(0, 10, size=(20, 6))
    parts = (np.zeros((20, 6, 3), np.float32), y,
             np.ones((20, 6), np.float32), np.zeros((4, 3), np.float32),
             np.arange(4) % 10, 10)
    mal = jr.assign_adversaries(jprof.uniform_fleet(20), 0.25,
                                seed=5).malicious
    want = jr.poison_labels(JFederatedDataset(*parts), mal)
    got = tr.poison_labels(FederatedDataset(*parts), mal)
    assert isinstance(got, FederatedDataset)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.test_y, want.test_y)
    ds = FederatedDataset(*parts)
    assert tr.poison_labels(ds, ()) is ds


# ----------------------------------------------------- robust statistics

def test_robust_config_validation_matches():
    for kw, match in ((dict(pool="bogus"), "pool"), (dict(clip=0.0), "clip"),
                      (dict(trim_frac=0.5), "trim_frac"),
                      (dict(mom_buckets=-1), "mom_buckets")):
        for m in (jr, tr):
            with pytest.raises(ValueError, match=match):
                m.RobustConfig(**kw)
    for kw in (dict(clip=2.0, pool="mom"), dict(clip=None, pool="trimmed"),
               dict(clip=None, pool="mean")):
        assert tr.RobustConfig(**kw).enabled == jr.RobustConfig(**kw).enabled
    assert hash(tr.RobustConfig()) == hash(tr.RobustConfig())


def _stats(K, J, seed, poisoned=()):
    rng = np.random.RandomState(seed)
    U = rng.randn(K, 40).astype(np.float32)
    Gm = rng.randn(J, 40).astype(np.float32)
    for i in poisoned:
        U[i] *= 10.0
        Gm[i % J] *= 50.0
    return U @ U.T, (U @ Gm.T).astype(np.float32), \
        np.full((J,), 1.0 / J, np.float32)


@pytest.mark.parametrize("K", [1, 6, 7])
@pytest.mark.parametrize("clip", [None, 2.0, 0.5])
def test_clip_scales_match(K, clip):
    G, _, _ = _stats(K, 3, K, poisoned=(0,))
    cfg_kw = dict(clip=clip, pool="mom")
    got = tr.clip_scales(torch.from_numpy(G), tr.RobustConfig(**cfg_kw))
    want = jr.clip_scales(jnp.asarray(G), jr.RobustConfig(**cfg_kw))
    _close(got, want, STAT_RTOL, "clip scales")


POOLS = [dict(pool="mean"), dict(pool="mom"), dict(pool="mom", mom_buckets=4),
         dict(pool="mom", mom_buckets=3), dict(pool="trimmed"),
         dict(pool="trimmed", trim_frac=0.4)]


@pytest.mark.parametrize("J", [2, 3, 8, 9])
@pytest.mark.parametrize("kw", POOLS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_pool_cross_matches(J, kw):
    _, C, w = _stats(5, J, J, poisoned=(1,))
    got = tr.pool_cross(torch.from_numpy(C), torch.from_numpy(w),
                        tr.RobustConfig(clip=None, **kw))
    want = jr.pool_cross(jnp.asarray(C), jnp.asarray(w),
                         jr.RobustConfig(clip=None, **kw))
    _close(got, want, STAT_RTOL, f"pool_cross J={J} {kw}")


def test_pool_cross_resists_poisoned_columns():
    """``tests/test_robust.py``'s breakdown anchor: f = 2/9 poisoned
    columns leave the robust pools at the honest value."""
    C = torch.full((5, 9), 3.0)
    C[:, 2], C[:, 6] = 1e4, 4e3
    w = torch.full((9,), 1.0 / 9)
    for pool in ("mom", "trimmed"):
        est = tr.pool_cross(C, w, tr.RobustConfig(clip=None, pool=pool))
        np.testing.assert_allclose(_np(est), 3.0, atol=1e-3)
    assert (torch.abs(C @ w - 3.0) > 100.0).all()


@pytest.mark.parametrize("K,J", [(6, 6), (7, 5), (8, 2)])
@pytest.mark.parametrize("kw", [dict(clip=2.0, pool="mom"),
                                dict(clip=2.0, pool="mean"),
                                dict(clip=None, pool="trimmed")])
def test_robustify_matches(K, J, kw):
    G, C, w = _stats(K, J, 100 + K, poisoned=(0, 3))
    got = tr.robustify(torch.from_numpy(G), torch.from_numpy(C),
                       torch.from_numpy(w), tr.RobustConfig(**kw))
    want = jr.robustify(jnp.asarray(G), jnp.asarray(C), jnp.asarray(w),
                        jr.RobustConfig(**kw))
    for a, b, what in zip(got, want, ("G'", "c'", "s")):
        _close(a, b, STAT_RTOL, what)
    # the premixed c vector (gradient pre-pass shape): clipping only
    c = C @ w
    got = tr.robustify(torch.from_numpy(G), torch.from_numpy(c),
                       torch.from_numpy(w), tr.RobustConfig(**kw))
    want = jr.robustify(jnp.asarray(G), jnp.asarray(c), jnp.asarray(w),
                        jr.RobustConfig(**kw))
    for a, b, what in zip(got, want, ("G'", "c'", "s")):
        _close(a, b, STAT_RTOL, what + " premixed")


def test_robustify_identity_when_disabled():
    G, C, w = (torch.from_numpy(a) for a in _stats(6, 6, 0))
    off = tr.RobustConfig(clip=None, pool="mean")
    Gr, cr, s = tr.robustify(G, C, w, off)
    torch.testing.assert_close(Gr, G, rtol=0, atol=0)
    torch.testing.assert_close(cr, C @ w, rtol=0, atol=0)
    torch.testing.assert_close(s, torch.ones(6), rtol=0, atol=0)
    Gr2, cr2, _ = tr.robustify(G, C @ w, w, off)
    torch.testing.assert_close(cr2, C @ w, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(6, 11), (7, 11), (1, 4), (2, 3)])
def test_median_is_jnp_median(shape):
    x = np.random.RandomState(shape[0]).randn(*shape).astype(np.float32)
    for dim in (0, 1):
        np.testing.assert_array_equal(
            _np(tr.median(torch.from_numpy(x), dim)),
            np.asarray(jnp.median(jnp.asarray(x), axis=dim)))


# ------------------------------------------------------------ aggregators

def _agg_inputs(K, J, n=30, seed=3, poisoned=(0,)):
    rng = np.random.RandomState(seed)
    U = (rng.randn(K, n) * 0.1).astype(np.float32)
    Gm = (rng.randn(J, n) * 0.1).astype(np.float32)
    for i in poisoned:
        U[i] = (rng.randn(n) * 2.0).astype(np.float32)
        Gm[i % J] = (rng.randn(n) * 2.0).astype(np.float32)
    params = {"b": np.zeros((3,), np.float32),
              "w": (rng.randn(n - 3) * 0.1).astype(np.float32)}
    split = lambda M: {"b": M[:, :3], "w": M[:, 3:]}    # noqa: E731
    return params, split(U), split(Gm)


def _run_both(name, params, stacked, grads, robust_kw):
    solve = dict(beta=5.0)
    jcfg = JAggregatorConfig(
        name=name, solve=JSolveConfig(**solve),
        robust=None if robust_kw is None else jr.RobustConfig(**robust_kw))
    tcfg = AggregatorConfig(
        name=name, solve=SolveConfig(**solve),
        robust=None if robust_kw is None else tr.RobustConfig(**robust_kw))
    j = jax.tree_util.tree_map(jnp.asarray, (params, stacked, grads))
    t = jax.tree_util.tree_map(torch.from_numpy, (params, stacked, grads))
    want = j_aggregate(name)(*j, jcfg)
    reset_launch_counts()
    got = aggregate(name)(*t, tcfg)
    return got, want, launch_counts()


@pytest.mark.parametrize("name,robust_kw", [
    ("contextual_mom", dict(clip=2.0, pool="mom")),
    ("contextual_mom", None),
    ("contextual_clipped", None),
    ("contextual_mom", dict(clip=None, pool="trimmed")),
])
@pytest.mark.parametrize("K,J", [(8, 8), (7, 3)])
def test_contextual_robust_aggregators_match(name, robust_kw, K, J):
    params, stacked, grads = _agg_inputs(K, J)
    (tnew, tinfo), (jnew, jinfo), counts = _run_both(name, params, stacked,
                                                     grads, robust_kw)
    assert aggregate(name).grad_stack is True
    for key in ("alpha", "clip_scale", "gram_diag", "bound",
                "theorem1_reduction"):
        _close(tinfo[key], jinfo[key], AGG_RTOL, key)
    for k in params:
        _close(tnew[k], jnew[k], AGG_RTOL, f"new params {k}")
    # G from gram, C = U Gmᵀ from gram_block, the combine once
    assert (counts["gram/torch"], counts["gram_block/torch"],
            counts["combine/torch"]) == (1, 1, 1)


@pytest.mark.parametrize("K,krum_f", [(8, 2), (9, None), (5, None), (3, 1)])
def test_krum_matches(K, krum_f):
    params, stacked, grads = _agg_inputs(K, K, poisoned=(0, K - 1))
    (tnew, tinfo), (jnew, jinfo), counts = _run_both(
        "krum", params, stacked, grads, dict(krum_f=krum_f))
    assert tinfo["krum_f"] == jinfo["krum_f"]
    _close(tinfo["krum_scores"], jinfo["krum_scores"], AGG_RTOL, "scores")
    np.testing.assert_array_equal(np.argsort(_np(tinfo["krum_scores"]),
                                             kind="stable"),
                                  np.argsort(np.asarray(jinfo["krum_scores"]),
                                             kind="stable"))
    np.testing.assert_array_equal(_np(tinfo["alpha"]),
                                  np.asarray(jinfo["alpha"]))
    for k in params:
        _close(tnew[k], jnew[k], AGG_RTOL, f"new params {k}")
    assert (counts["gram/torch"], counts["combine/torch"]) == (1, 1)


def test_krum_ties_keep_the_stable_order():
    """Four identical updates tie on their scores: the selection keeps the
    lower indices first, as ``jnp.argsort`` (stable) does."""
    U = np.tile(np.arange(6, dtype=np.float32), (6, 1))
    U[5] += 100.0
    stacked = {"w": U}
    params = {"w": np.zeros(6, np.float32)}
    (_, tinfo), (_, jinfo), _ = _run_both("krum", params, stacked, stacked,
                                          dict(krum_f=2))
    np.testing.assert_array_equal(_np(tinfo["alpha"]),
                                  np.asarray(jinfo["alpha"]))
    assert _np(tinfo["alpha"])[5] == 0.0


@pytest.mark.parametrize("K", [6, 7, 2])
def test_coordinate_median_matches(K):
    params, stacked, grads = _agg_inputs(K, K)
    (tnew, tinfo), (jnew, jinfo), counts = _run_both(
        "coordinate_median", params, stacked, grads, None)
    for k in params:
        _close(tnew[k], jnew[k], AGG_RTOL, f"new params {k}")
    _close(tinfo["alpha"], jinfo["alpha"], AGG_RTOL, "alpha")
    assert counts["combine/torch"] == 1


# ----------------------------------------------------------------- attacks

def _stacked_pair(K=6, seed=7):
    rng = np.random.RandomState(seed)
    return ({"b": rng.randn(K, 3).astype(np.float32),
             "w": rng.randn(K, 4, 3).astype(np.float32)},
            {"b": rng.randn(K, 3).astype(np.float32),
             "w": rng.randn(K, 4, 3).astype(np.float32)})


@partial(jax.jit, static_argnums=(1, 2))
def _ref_noise_leaves(keys, dshapes, gshapes):
    def leaves_of(k, shapes):
        ks = jax.random.split(k, len(shapes))
        return [jax.random.normal(kk, shape, jnp.float32)
                for kk, shape in zip(ks, shapes)]

    def row(k):
        kd, kg = jax.random.split(k)
        return leaves_of(kd, dshapes), leaves_of(kg, gshapes)
    return jax.vmap(row)(keys)


def _ref_row_noise(keys, deltas, grads):
    """The reference's per-row ``ByzantineGauss`` draws — each row's key
    split into (kd, kg), then one key per leaf — as port trees shaped like
    the stacked ``deltas`` / ``grads``."""
    shapes = lambda t: tuple(tuple(l.shape[1:])  # noqa: E731
                             for l in tree_leaves(t))
    nd, ng = _ref_noise_leaves(keys, shapes(deltas), shapes(grads))
    to = lambda arrs, like: tree_unflatten(   # noqa: E731
        like, [torch.from_numpy(np.array(a)).to(l.device)
               for a, l in zip(arrs, tree_leaves(like))])
    return to(nd, deltas), to(ng, grads)


def _ref_stacked_noise(key):
    """A ``noise`` seam replaying ``corrupt_stacked``'s keys: split per row."""
    def noise(deltas, grads):
        K = tree_leaves(deltas)[0].shape[0]
        return _ref_row_noise(jax.random.split(key, K), deltas, grads)
    return noise


MASK = np.array([False, True, False, False, True, False])


@pytest.mark.parametrize("name,kw", [("sign_flip", {}),
                                     ("sign_flip", dict(factor=2.0)),
                                     ("scaled_update", dict(factor=5.0)),
                                     ("label_flip", {})])
def test_deterministic_attacks_bitwise(name, kw):
    d, g = _stacked_pair()
    jd, jg = jr.corrupt_stacked(jr.get_attack(name, **kw),
                                jax.tree_util.tree_map(jnp.asarray, d),
                                jax.tree_util.tree_map(jnp.asarray, g),
                                jnp.asarray(MASK), jax.random.PRNGKey(9))
    td, tg = tr.corrupt_stacked(tr.get_attack(name, **kw),
                                jax.tree_util.tree_map(torch.from_numpy, d),
                                jax.tree_util.tree_map(torch.from_numpy, g),
                                torch.from_numpy(MASK))
    for k in d:
        np.testing.assert_array_equal(_np(td[k]), np.asarray(jd[k]))
        np.testing.assert_array_equal(_np(tg[k]), np.asarray(jg[k]))


def test_byzantine_gauss_on_the_reference_noise():
    d, g = _stacked_pair()
    key = jax.random.PRNGKey(9)
    atk_j, atk_t = jr.ByzantineGauss(scale=25.0), tr.ByzantineGauss(scale=25.0)
    jd, jg = jr.corrupt_stacked(atk_j, jax.tree_util.tree_map(jnp.asarray, d),
                                jax.tree_util.tree_map(jnp.asarray, g),
                                jnp.asarray(MASK), key)
    td, tg = tr.corrupt_stacked(atk_t,
                                jax.tree_util.tree_map(torch.from_numpy, d),
                                jax.tree_util.tree_map(torch.from_numpy, g),
                                torch.from_numpy(MASK),
                                _ref_stacked_noise(key))
    for k in d:
        _close(td[k], jd[k], STAT_RTOL, f"delta {k}")
        _close(tg[k], jg[k], STAT_RTOL, f"grad {k}")
    # one norm per row: each corrupted row is 25x its own honest norm
    norms = lambda t: np.sqrt(sum((_np(l) ** 2).reshape(6, -1).sum(1)  # noqa
                                  for l in tree_leaves(t)))
    honest = norms(jax.tree_util.tree_map(torch.from_numpy, d))
    np.testing.assert_allclose(norms(td)[MASK], 25.0 * honest[MASK],
                               rtol=1e-5)
    # the single-client path: the async arrival's key, unsplit
    one = jax.random.fold_in(key, 3)
    jd1, jg1 = atk_j.corrupt(jax.tree_util.tree_map(lambda a: a[1], d),
                             jax.tree_util.tree_map(lambda a: a[1], g), one)
    td1, tg1 = tr.corrupt_one(
        atk_t, jax.tree_util.tree_map(lambda a: torch.from_numpy(a[1]), d),
        jax.tree_util.tree_map(lambda a: torch.from_numpy(a[1]), g),
        lambda dd, gg: _ref_row_noise(one[None], dd, gg))
    for k in d:
        _close(td1[k], jd1[k], STAT_RTOL, f"one delta {k}")
        _close(tg1[k], jg1[k], STAT_RTOL, f"one grad {k}")


@pytest.mark.parametrize("name", ["byzantine_gauss", "sign_flip",
                                  "scaled_update"])
def test_honest_rows_bitwise_untouched(name):
    d, g = _stacked_pair()
    td0 = jax.tree_util.tree_map(torch.from_numpy, d)
    tg0 = jax.tree_util.tree_map(torch.from_numpy, g)
    gen = torch.Generator().manual_seed(0)
    cd, cg = tr.corrupt_stacked(tr.get_attack(name), td0, tg0,
                                torch.from_numpy(MASK),
                                tr.generator_noise(gen))
    for orig, new in ((td0, cd), (tg0, cg)):
        for k in orig:
            torch.testing.assert_close(new[k][~torch.from_numpy(MASK)],
                                       orig[k][~torch.from_numpy(MASK)],
                                       rtol=0, atol=0)
    assert not torch.allclose(cd["w"][1], td0["w"][1])
    if name == "scaled_update":          # the gradient report stays honest
        for k in tg0:
            torch.testing.assert_close(cg[k], tg0[k], rtol=0, atol=0)


def test_attack_registry_matches():
    assert tr.available_attacks() == jr.available_attacks()
    for m in (jr, tr):
        with pytest.raises(KeyError, match="unknown attack"):
            m.get_attack("bogus")
    assert tr.get_attack("byzantine_gauss", scale=3.0).scale == 3.0
    for name in tr.available_attacks():
        a, b = tr.get_attack(name), jr.get_attack(name)
        assert (a.name, a.corrupts_data) == (b.name, b.corrupts_data)
        assert isinstance(a, tr.AttackModel)
    d, g = {"w": torch.ones(1, 3)}, {"w": torch.ones(1, 3)}
    d2, g2 = tr.LabelFlip().corrupt(d, g)
    assert d2 is d and g2 is g
    with pytest.raises(ValueError, match="noise"):
        tr.ByzantineGauss().corrupt(d, g)
    assert tr.stream_seed(1, 2) == tr.stream_seed(1, 2) != tr.stream_seed(2, 1)


# ------------------------------------------- runs on the reference's draws

@pytest.fixture(scope="module")
def robust_problem(tiny_edge_problem):
    """``tests/test_robust.py``'s problem: (reference dataset, port dataset,
    reference params as numpy, fleet ids of the malicious devices)."""
    ds, params, _ = tiny_edge_problem
    tds = FederatedDataset(ds.x, ds.y, ds.mask, ds.test_x, ds.test_y,
                           ds.num_classes)
    mal = jr.assign_adversaries(jprof.uniform_fleet(12), 0.17,
                                seed=3).malicious
    return ds, tds, jax.tree_util.tree_map(np.asarray, params), mal


@partial(jax.jit, static_argnums=(2, 3))
def _ref_draws(keys, mask_rows, max_steps, batch_size):
    m = mask_rows.shape[1]

    def per_client(kk, mk):
        probs = mk / jnp.maximum(mk.sum(), 1.0)
        return jax.vmap(lambda sk: jax.random.choice(
            sk, m, shape=(batch_size,), p=probs))(
            jax.random.split(kk, max_steps))
    return jax.vmap(per_client)(keys, mask_rows)


def _ref_batch_indices(mask_rows, keys, max_steps, batch_size):
    """The reference's mini-batch draws: each client key split per step,
    then ``choice`` with mask probabilities."""
    return torch.from_numpy(np.array(_ref_draws(
        keys, jnp.asarray(mask_rows), max_steps, batch_size))).long()


@pytest.mark.parametrize("grad_sample", [3])
def test_sync_round_with_attack_matches_reference(robust_problem,
                                                  grad_sample):
    jds, tds, params, mal = robust_problem
    base = dict(aggregator="contextual_mom", num_devices=12,
                clients_per_round=8, grad_sample=grad_sample, lr=0.2,
                batch_size=10, max_epochs=4, malicious=mal)
    jcfg = jserver.ServerConfig(**base, attack=jr.ByzantineGauss(10.0),
                                robust=jr.RobustConfig(2.0, "mom"))
    tcfg = ServerConfig(**base, attack=tr.ByzantineGauss(10.0),
                        robust=tr.RobustConfig(2.0, "mom"))
    spe = 30 // 10
    max_steps = jcfg.max_epochs * spe
    rng = np.random.RandomState(2)
    while True:          # a round whose cohort and K2 sample both hold one
        sel, grad_sel, num_steps = jserver.sample_round(rng, jcfg, spe)
        if np.isin(sel, mal).any() and (grad_sample == 0
                                        or np.isin(grad_sel, mal).any()):
            break
    key = jax.random.PRNGKey(11)
    idx = _ref_batch_indices(jds.mask[sel], jax.random.split(key, 8),
                             max_steps, 10)
    tags = {0: jax.random.fold_in(key, 0x0BAD),
            1: jax.random.fold_in(key, 0x0BAD ^ 1)}
    seen = []

    def noise(tag, deltas, grads):
        seen.append(tag)
        return _ref_stacked_noise(tags[tag])(deltas, grads)

    data_j = tuple(jnp.asarray(a) for a in (jds.x, jds.y, jds.mask))
    jstate, jinfo = jserver.build_round_fn(j_loss, jcfg, 30)(
        jserver.init_server(params), data_j, jnp.asarray(sel),
        jnp.asarray(grad_sel), jnp.asarray(num_steps), key)
    data_t = (torch.from_numpy(tds.x), torch.from_numpy(tds.y).long(),
              torch.from_numpy(tds.mask))
    tstate, tinfo = build_round_fn(t_loss, tcfg, 30, device="cpu")(
        init_server(params_from_jax(params, device="cpu")), data_t, sel,
        grad_sel, num_steps, batch_idx=idx, attack_noise=noise)
    assert seen == ([0] if grad_sample == 0 else [0, 1])
    _close(tinfo["update_norms"], jinfo["update_norms"], RUN_RTOL, "norms")
    _close(tinfo["clip_scale"], jinfo["clip_scale"], RUN_RTOL, "clip")
    _close(tinfo["alpha"], jinfo["alpha"], RUN_RTOL, "alpha")
    for a, b in zip(tree_leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        _close(a, b, RUN_RTOL, "new params")


def _hier_replay(jds, t_selection_seed):
    """``batch_indices`` and ``attack_noise`` replaying the reference's hier
    draws: participant i of round t trains on ``fold_in(PRNGKey(seed),
    t·P + i)``; the adversary's rows on ``fold_in(PRNGKey(seed + 7919), t)``
    split per row."""
    base = jax.random.PRNGKey(t_selection_seed)

    def batch_indices(t, part_dev, max_steps):
        P = len(part_dev)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            base, jnp.arange(t * P, (t + 1) * P, dtype=jnp.uint32))
        return _ref_batch_indices(jds.mask[part_dev], keys, max_steps, 10)

    def attack_noise(t, deltas, grads):
        akey = jax.random.fold_in(
            jax.random.PRNGKey(t_selection_seed + 7919), t)
        return _ref_stacked_noise(akey)(deltas, grads)
    return batch_indices, attack_noise


HIER_BASE = dict(aggregator="hier_contextual", lr=0.2, batch_size=10,
                 min_epochs=1, max_epochs=4)


@pytest.mark.parametrize("engine,topo,t_end", [("fused", "two_tier", 0.06),
                                               ("streamed", "star", 0.003)])
def test_hier_round_with_attack_and_churn_matches_reference(
        robust_problem, engine, topo, t_end):
    """Two rounds whose second starts inside the churn wave
    (``[0.4, 0.6] · t_end``), the fused engine's gateway stages and the
    streamed engine's raw cloud, each against the reference engine."""
    jds, tds, params, mal = robust_problem
    jfleet = dataclasses.replace(jprof.uniform_fleet(12), malicious=mal)
    tfleet = dataclasses.replace(tprof.uniform_fleet(12), malicious=mal)
    jtopo, ttopo = ((j_star(jfleet), star_topology(tfleet)) if topo == "star"
                    else (j_two_tier(jfleet, 3), two_tier_topology(tfleet, 3)))
    rounds, seed = 2, 11
    kw = dict(num_rounds=rounds, selection_seed=seed, eval_every=1,
              engine=engine)
    want = j_run_hier("r", j_loss, j_apply, params, jds,
                      JHierConfig(**HIER_BASE,
                                  robust=jr.RobustConfig(2.0, "mom")),
                      jtopo, attack=jr.ByzantineGauss(10.0),
                      churn=jr.churn_schedule("wave", 12, t_end, seed=1),
                      **kw)
    batch_indices, attack_noise = _hier_replay(jds, seed)
    reset_launch_counts()
    got = run_hier_simulation(
        "r", t_loss, t_apply, params_from_jax(params, device="cpu"), tds,
        HierConfig(**HIER_BASE, robust=tr.RobustConfig(2.0, "mom")), ttopo,
        attack=tr.ByzantineGauss(10.0),
        churn=tr.churn_schedule("wave", 12, t_end, seed=1),
        batch_indices=batch_indices, attack_noise=attack_noise,
        device="cpu", **kw)
    assert got.times == want.times
    assert (got.dispatched, got.arrived, got.dropped, got.rounds_skipped) == \
        (want.dispatched, want.arrived, want.dropped, want.rounds_skipped)
    assert got.comm == want.comm
    assert got.dropped > 0                               # the wave bit
    np.testing.assert_allclose(got.train_loss, want.train_loss,
                               rtol=RUN_RTOL)
    np.testing.assert_allclose(got.test_nll, want.test_nll, rtol=RUN_RTOL)
    counts = launch_counts()
    if engine == "fused":       # each member-level stage: gram + gram_block
        assert counts["gram_block/torch"] > 0
        assert counts["gram/torch"] >= counts["gram_block/torch"]
    else:                       # no gram_block: C is the round's D GMᵀ
        assert counts["gram_block/torch"] == 0
        assert counts["stream_stats/torch"] > 0


def test_async_with_attack_and_churn_matches_reference(robust_problem):
    jds, tds, params, mal = robust_problem
    seed = 11
    base = dict(num_devices=12, buffer_size=3, lr=0.2, batch_size=10,
                min_epochs=1, max_epochs=4, aggregator="contextual_async")
    fleet_kw = dict(slowdown=8.0, dropout_slow=0.1, seed=0)
    jfleet = dataclasses.replace(jprof.bimodal_fleet(12, **fleet_kw),
                                 malicious=mal)
    tfleet = dataclasses.replace(tprof.bimodal_fleet(12, **fleet_kw),
                                 malicious=mal)
    want = j_run_async("a", j_loss, j_apply, params, jds, JAsyncConfig(**base),
                       jfleet, num_aggregations=6, selection_seed=seed,
                       eval_every=2, collect_alpha=True,
                       attack=jr.ByzantineGauss(10.0),
                       churn=jr.churn_schedule("wave", 12, 0.02, seed=1))
    base_key = jax.random.PRNGKey(seed)

    def batch_indices(seq, d, steps):
        return _ref_batch_indices(jds.mask[d:d + 1],
                                  jax.random.fold_in(base_key, seq)[None],
                                  steps, 10)
    noised = []

    def attack_noise(seq, deltas, grads):
        noised.append(seq)
        key = jax.random.fold_in(jax.random.fold_in(base_key, seq), 0x0BAD)
        return _ref_row_noise(key[None], deltas, grads)

    got = run_async_simulation(
        "a", t_loss, t_apply, params_from_jax(params, device="cpu"), tds,
        AsyncConfig(**base), tfleet, num_aggregations=6, selection_seed=seed,
        eval_every=2, collect_alpha=True, attack=tr.ByzantineGauss(10.0),
        churn=tr.churn_schedule("wave", 12, 0.02, seed=1),
        batch_indices=batch_indices, attack_noise=attack_noise, device="cpu")
    assert got.times == want.times and got.versions == want.versions
    assert (got.dispatched, got.arrived, got.dropped) == \
        (want.dispatched, want.arrived, want.dropped)
    np.testing.assert_array_equal(got.updates_per_device,
                                  want.updates_per_device)
    assert noised, "no malicious arrival in the run"
    for a, b in zip(got.alpha_history, want.alpha_history):
        np.testing.assert_allclose(a, b, rtol=RUN_RTOL,
                                   atol=RUN_RTOL * np.abs(b).max())
    np.testing.assert_allclose(got.train_loss, want.train_loss,
                               rtol=RUN_RTOL)


# ------------------------------- the reference's end-to-end assertions

def _flat(tds, params, mal, agg, attack=None, robust=None, rounds=8,
          fleet_mal=True):
    cfg = ServerConfig(aggregator=agg, num_devices=12, clients_per_round=8,
                       lr=0.2, batch_size=10, max_epochs=4, attack=attack,
                       malicious=mal if attack and fleet_mal else (),
                       robust=robust)
    r = run_simulation(agg, t_loss, t_apply,
                       params_from_jax(params, device="cpu"), tds, cfg,
                       num_rounds=rounds, eval_every=rounds, device="cpu")
    return r.train_loss[-1]


def test_flat_robust_matches_plain_when_disabled(robust_problem):
    _, tds, params, mal = robust_problem
    off = tr.RobustConfig(clip=None, pool="mean")
    plain = _flat(tds, params, mal, "contextual", rounds=4)
    rob = _flat(tds, params, mal, "contextual_mom", robust=off, rounds=4)
    np.testing.assert_allclose(rob, plain, rtol=1e-4)


def test_flat_bounded_inflation_under_byzantine(robust_problem):
    _, tds, params, mal = robust_problem
    atk = tr.ByzantineGauss(scale=10.0)
    rob = tr.RobustConfig(clip=2.0, pool="mom")
    mom_clean = _flat(tds, params, mal, "contextual_mom", robust=rob)
    mom_atk = _flat(tds, params, mal, "contextual_mom", atk, robust=rob)
    fa_clean = _flat(tds, params, mal, "fedavg")
    fa_atk = _flat(tds, params, mal, "fedavg", atk)
    assert np.isfinite(mom_atk)
    assert mom_atk <= 1.45 * mom_clean
    assert fa_atk >= 1.8 * fa_clean
    for agg in ("krum", "coordinate_median"):
        assert _flat(tds, params, mal, agg, atk, rounds=4) < fa_atk


def test_flat_label_flip_poisons_dataset_only(robust_problem):
    _, tds, params, mal = robust_problem
    loss = _flat(tds, params, mal, "contextual_mom",
                 tr.get_attack("label_flip"),
                 robust=tr.RobustConfig(clip=2.0, pool="mom"), rounds=3)
    assert np.isfinite(loss)


def test_attack_does_not_perturb_honest_rng(robust_problem):
    """An attack with no malicious device anywhere is inert, and so is one
    whose malicious devices sit outside every cohort: both runs are the
    clean run, bit for bit."""
    _, tds, params, mal = robust_problem
    atk = tr.ByzantineGauss(scale=10.0)
    a = _flat(tds, params, mal, "contextual", rounds=3)
    b = _flat(tds, params, mal, "contextual", atk, rounds=3, fleet_mal=False)
    assert a == b
    tparams = params_from_jax(params, device="cpu")
    data = (torch.from_numpy(tds.x), torch.from_numpy(tds.y).long(),
            torch.from_numpy(tds.mask))
    outs = []
    for attack in (None, atk):
        cfg = ServerConfig(aggregator="contextual", num_devices=12,
                           clients_per_round=8, lr=0.2, batch_size=10,
                           max_epochs=4, attack=attack, malicious=(11,))
        fn = build_round_fn(t_loss, cfg, 30, device="cpu")
        gen = torch.Generator().manual_seed(5)
        outs.append(fn(init_server(tparams), data, np.arange(8), np.arange(1),
                       np.full(8, 6), gen,
                       attack_noise=lambda *a: pytest.fail("noise drawn")
                       )[0].params)
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


def _hier(tds, params, mal, topo, engine, attack=None, churn=None,
          robust=None, rounds=4, seed=11):
    cfg = HierConfig(aggregator="hier_contextual", lr=0.2, batch_size=10,
                     min_epochs=1, max_epochs=4, robust=robust)
    return run_hier_simulation(f"rob-{engine}", t_loss, t_apply,
                               params_from_jax(params, device="cpu"), tds,
                               cfg, topo, num_rounds=rounds,
                               selection_seed=seed, eval_every=2,
                               engine=engine, attack=attack, churn=churn,
                               device="cpu")


def _tfleet(mal):
    return dataclasses.replace(tprof.uniform_fleet(12), malicious=mal)


@pytest.mark.parametrize("topo", ["star", "two_tier"])
def test_hier_robust_engine_parity_under_attack(robust_problem, topo):
    _, tds, params, mal = robust_problem
    fleet = _tfleet(mal)
    t = star_topology(fleet) if topo == "star" else two_tier_topology(fleet, 3)
    atk = tr.ByzantineGauss(scale=10.0)
    churn = tr.churn_schedule("wave", 12, 40.0, seed=1)
    rob = tr.RobustConfig(clip=2.0, pool="mom")
    batches = [torch.Generator().manual_seed(1) for _ in range(2)]
    runs = [run_hier_simulation(
        "p", t_loss, t_apply, params_from_jax(params, device="cpu"), tds,
        HierConfig(aggregator="hier_contextual", lr=0.2, batch_size=10,
                   min_epochs=1, max_epochs=4, robust=rob), t, 4,
        selection_seed=11, eval_every=2, engine=e, attack=atk, churn=churn,
        batch_generator=b, device="cpu")
        for e, b in zip(("fused", "streamed"), batches)]
    rf, rs = runs
    assert rf.times == rs.times
    np.testing.assert_allclose(rf.train_loss, rs.train_loss, rtol=5e-4,
                               atol=5e-4)
    assert np.isfinite(rf.train_loss).all()


@pytest.mark.parametrize("engine", ["fused", "streamed"])
def test_seeded_determinism_attack_churn(robust_problem, engine):
    _, tds, params, mal = robust_problem
    atk = tr.ByzantineGauss(scale=10.0)
    churn = tr.churn_schedule("rolling", 12, 40.0, seed=2)
    rob = tr.RobustConfig(clip=2.0, pool="mom")
    topo = star_topology(_tfleet(mal))
    r1 = _hier(tds, params, mal, topo, engine, atk, churn, rob, rounds=3)
    r2 = _hier(tds, params, mal, topo, engine, atk, churn, rob, rounds=3)
    assert r1.times == r2.times
    assert r1.train_loss == r2.train_loss
    assert (r1.dispatched, r1.arrived, r1.dropped) == \
        (r2.dispatched, r2.arrived, r2.dropped)


def test_hier_two_tier_robust_runs(robust_problem):
    _, tds, params, mal = robust_problem
    r = _hier(tds, params, mal, two_tier_topology(_tfleet(mal), 3), "fused",
              tr.ByzantineGauss(scale=10.0),
              robust=tr.RobustConfig(clip=2.0, pool="mom"), rounds=3)
    assert np.isfinite(r.train_loss).all()


def test_hier_config_robust_validation_matches():
    for H, R in ((HierConfig, tr.RobustConfig), (JHierConfig, jr.RobustConfig)):
        rob = R(clip=2.0, pool="mom")
        with pytest.raises(TypeError, match="RobustConfig"):
            H(robust="clip")
        with pytest.raises(ValueError, match="hier_contextual"):
            H(aggregator="hier_fedavg", robust=rob)
        with pytest.raises(ValueError, match="gateway_grad"):
            H(gateway_grad="global", robust=rob)
        assert H(robust=rob).robust is rob
    with pytest.raises(TypeError, match="RobustConfig"):
        HierConfig(robust=jr.RobustConfig())     # the reference's type


def test_unported_parts_still_raise(robust_problem):
    _, tds, params, mal = robust_problem
    topo = star_topology(_tfleet(mal))
    cfg = HierConfig(**HIER_BASE)
    run = lambda **kw: run_hier_simulation(  # noqa: E731
        "x", t_loss, t_apply, params_from_jax(params, device="cpu"), tds,
        cfg, topo, 1, device="cpu", **kw)
    # the mesh is ported: a one-rank fleet mesh runs the same round, and an
    # object that is no mesh fails naming the class it wants
    from repro_torch.sharding import fleet_mesh
    assert run(mesh=fleet_mesh()).train_loss == run().train_loss
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        run(mesh=object())
    # the cohort scheduler is ported: the same call runs, on the event
    # path's clock
    cohort, event = run(scheduler_mode="cohort"), run(scheduler_mode="event")
    assert cohort.times == event.times
    assert (cohort.arrived, cohort.dropped) == (event.arrived, event.dropped)


# ------------------------------------- BENCH_robust.json's acceptance

def test_bench_robust_acceptance_on_the_port():
    """``benchmarks/robust_suite.py``'s headline: 64 devices, 20 %
    Byzantine at 25x, 10 rounds; the inflation thresholds of
    ``BENCH_robust.json``'s ``acceptance`` block on the port's own draws."""
    bench = json.loads((ROOT / "BENCH_robust.json").read_text())["acceptance"]
    assert bench["attack"] == "byzantine_gauss@25" and bench["frac"] == 0.2
    xs, ys = make_synthetic(1.0, 1.0, num_devices=64, samples_per_device=30,
                            dim=20, seed=5)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 20)[:400], ys.reshape(-1)[:400], 10)
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.logistic import init_logistic
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=20, num_classes=10), 0,
                           device="cpu")
    fleet = tr.assign_adversaries(tprof.uniform_fleet(64), 0.2, seed=3)
    rob = tr.RobustConfig(clip=2.0, pool="mom")

    def final(agg, robust, attack):
        cfg = ServerConfig(aggregator=agg, num_devices=64,
                           clients_per_round=16, lr=0.2, batch_size=10,
                           min_epochs=1, max_epochs=4, attack=attack,
                           malicious=fleet.malicious if attack else (),
                           robust=robust)
        return run_simulation(agg, t_loss, t_apply, params, ds, cfg,
                              num_rounds=10, selection_seed=42,
                              eval_every=10, device="cpu").train_loss[-1]

    atk = tr.ByzantineGauss(scale=25.0)
    infl = {agg: final(agg, r, atk) / final(agg, r, None)
            for agg, r in (("contextual_mom", rob), ("contextual", None),
                           ("fedavg", None))}
    assert infl["contextual_mom"] <= 1.10
    assert infl["contextual"] >= 1.25
    assert infl["fedavg"] >= 1.5


def test_torch_edge_robust_example_runs_on_the_cpu():
    import ast
    import os
    import subprocess
    import sys
    script = ROOT / "examples" / "torch_edge_robust.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(EXAMPLE_SMOKE="1", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), "--device", "cpu"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    rows = {l.split()[0]: l.split() for l in out.stdout.splitlines()
            if l.split() and l.split()[0] in ("contextual", "contextual_mom",
                                              "fedavg", "krum",
                                              "coordinate_median")}
    assert len(rows) == 5
    assert all(np.isfinite([float(r[1]), float(r[2])]).all()
               for r in rows.values())
    assert "hier robust (4 gateways)" in out.stdout
    tree = ast.parse(script.read_text())
    tops = {name.split(".")[0] for node in ast.walk(tree)
            for name in ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module] if isinstance(node, ast.ImportFrom)
                         and node.level == 0 else [])}
    assert "repro_torch" in tops and not tops & {"jax", "jaxlib", "repro"}
