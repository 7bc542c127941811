"""The port's fleet scale (``repro_torch.data.fleetgen``, the cohort
scheduler, ``cohort_chunk`` and the eval subsample of
``run_hier_simulation``) against ``repro``.

* ``eval_device_ids`` and ``VirtualFleetDataset``'s validation equal the
  reference's.
* The shard recipe: ``shard_from_normals`` fed the reference's own six
  ``jax.random`` normals gives the reference's x at rtol 1e-6 and its
  labels wherever the top two logits differ by more than 1e-4.  The port's
  counter-based normals are standard normal over 10⁶ draws.
* The invariant the reference states (``fleetgen.py:16-18``): a shard
  generated inside the cohort pass equals ``materialize_arrays`` of its id
  bit for bit, whatever the chunking and the order of the ids.
* The cohort path against the event path on the port's own shards, clean
  and under ``ByzantineGauss(10)`` with 25 % adversaries and a churn wave:
  times, bytes and counts exactly, losses within 1e-5
  (``tests/test_fleet_scale.py``'s ``_assert_equivalent``).
* The reference's cohort run against the port's cohort run on the
  reference's materialized shards, with its mini-batch draws replayed
  through ``batch_indices``: times, comm, bytes and counts exactly, losses
  at rtol 1e-4.
* ``cohort_chunk``, ``"auto"`` at 4 096 participants, and the
  ``device_uplink`` and ``LabelFlip`` rejections.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import VirtualFleetDataset as JVirtualFleetDataset
from repro.data import eval_device_ids as j_eval_device_ids
from repro.edge import array_bimodal_fleet as j_array_bimodal
from repro.fl import run_hier_simulation as j_run_hier
from repro.hier import HierConfig as JHierConfig
from repro.hier import stacked_two_tier as j_stacked_two_tier
from repro.models import get_model
from repro.models.config import ArchConfig
from repro.models.logistic import logistic_apply as j_apply
from repro.models.logistic import logistic_loss as j_loss
from repro_torch.compress import CompressConfig
from repro_torch.convert import params_from_jax
from repro_torch.data import VirtualFleetDataset, eval_device_ids
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.fleetgen import (fleet_normals, shard_from_normals,
                                       sigma_vector)
from repro_torch.edge import (array_bimodal_fleet, array_uniform_fleet,
                              bimodal_fleet)
from repro_torch.fl import run_hier_simulation
from repro_torch.fl.client import cohort_update
from repro_torch.hier import HierConfig, stacked_two_tier, two_tier_topology
from repro_torch.models.logistic import logistic_apply, logistic_loss
from repro_torch.robust import ChurnSchedule, ChurnWave
from repro_torch.robust.attacks import (ByzantineGauss, LabelFlip,
                                        assign_adversaries)

torch.set_num_threads(1)

RUN_RTOL = 1e-4
DIM, CLASSES = 10, 3


def _cfg(**kw):
    base = dict(aggregator="hier_contextual", lr=0.1, mu=0.0, batch_size=8,
                min_epochs=1, max_epochs=2)
    base.update(kw)
    return HierConfig(**base)


def _hier_kw(rounds=3):
    return dict(num_rounds=rounds, selection_seed=42, eval_every=1,
                rng_stream="v2", device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, get_model(ArchConfig(
        name="lr", family="logreg", input_dim=DIM, num_classes=CLASSES)
    ).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jparams, device="cpu")


def _vds(n=64, **kw):
    return VirtualFleetDataset(num_devices=n, samples_per_device=16,
                               dim=DIM, num_classes=CLASSES, seed=3, **kw)


# ---------------------------------------------------------------------------
# eval subsample, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_devices,cap", [
    (1, 1), (10, 64), (64, 64), (65, 64), (1000, 64), (4097, 4096),
    (100_000, 4096), (1_000_000, 4096), (999_999, 7)])
def test_eval_device_ids_match_reference(num_devices, cap):
    got, want = eval_device_ids(num_devices, cap), j_eval_device_ids(
        num_devices, cap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(num_devices=0), dict(num_devices=4, samples_per_device=0),
    dict(num_devices=4, test_devices=0)])
def test_validation_errors_match_reference(kw):
    with pytest.raises(ValueError) as want:
        JVirtualFleetDataset(**kw)
    with pytest.raises(ValueError, match=str(want.value)):
        VirtualFleetDataset(**kw)


def test_fields_and_defaults_match_reference():
    a, b = VirtualFleetDataset(5), JVirtualFleetDataset(5)
    names = [f for f in JVirtualFleetDataset.__dataclass_fields__]
    assert names == [f for f in VirtualFleetDataset.__dataclass_fields__]
    assert all(getattr(a, f) == getattr(b, f) for f in names)
    assert a.virtual is True
    assert hash(a) != hash(VirtualFleetDataset(5))     # identity-hashed
    with pytest.raises(Exception):
        a.num_devices = 7                               # frozen


# ---------------------------------------------------------------------------
# the recipe
# ---------------------------------------------------------------------------

def _reference_normals(ds, ids):
    """The reference's six normals per id, drawn as
    ``repro/data/fleetgen.py:64-74`` draws them."""
    m, dim, C = ds.samples_per_device, ds.dim, ds.num_classes
    base = jax.random.PRNGKey(ds.seed)
    out = [[] for _ in range(6)]
    for d in ids:
        key = jax.random.fold_in(base, jnp.uint32(d))
        k_u, k_w, k_b, k_B, k_v, k_x = jax.random.split(key, 6)
        for i, z in enumerate((
                jax.random.normal(k_u), jax.random.normal(k_w, (dim, C)),
                jax.random.normal(k_b, (C,)), jax.random.normal(k_B),
                jax.random.normal(k_v, (dim,)),
                jax.random.normal(k_x, (m, dim)))):
            out[i].append(np.asarray(z))
    return [torch.from_numpy(np.stack(z)) for z in out]


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.5, 2.0)])
def test_recipe_on_reference_normals(alpha, beta):
    jds = JVirtualFleetDataset(num_devices=40, samples_per_device=16, dim=16,
                               num_classes=4, alpha=alpha, beta=beta, seed=7)
    ids = np.array([0, 5, 17, 39, 40, 63])
    z = _reference_normals(jds, ids)
    x, y = shard_from_normals(*z, torch.from_numpy(sigma_vector(16)),
                              alpha, beta)
    jx, jy, jm = jds.materialize_arrays(ids)
    # rtol 1e-6, and an atol of 1e-6 of max |x| where v + σ·z cancels
    # (XLA contracts the multiply-add into one FMA, torch rounds twice)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-6,
                               atol=1e-6 * np.abs(jx).max())
    assert y.dtype == torch.int64 and y.shape == jy.shape
    # the labels wherever the reference's top two logits are apart
    logits = []
    for i in range(len(ids)):
        W = alpha * z[0][i] + z[1][i]
        b = alpha * z[0][i] + z[2][i]
        logits.append(jx[i] @ W.numpy() + b.numpy())
    top2 = np.sort(np.stack(logits), axis=2)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(y.numpy()[clear], jy[clear])


def test_normal_source_is_standard_normal():
    ids = torch.arange(1000, dtype=torch.int64)
    z = fleet_normals(3, ids, 5, 1000).double()
    assert z.shape == (1000, 1000) and z.dtype == torch.float64
    assert abs(float(z.mean())) < 5e-3
    assert abs(float(z.var()) - 1.0) < 5e-3
    # each (seed, field) is its own stream
    assert not torch.equal(fleet_normals(3, ids[:4], 5, 8),
                           fleet_normals(4, ids[:4], 5, 8))
    assert not torch.equal(fleet_normals(3, ids[:4], 5, 8),
                           fleet_normals(3, ids[:4], 4, 8))


def test_normals_depend_on_the_id_alone():
    ids = torch.tensor([9, 2, 700_000, 2, 0])
    z = fleet_normals(11, ids, 1, 7)
    assert torch.equal(z[1], z[3])
    for i, d in enumerate(ids.tolist()):
        assert torch.equal(z[i], fleet_normals(11, torch.tensor([d]), 1, 7)[0])
    # a longer draw extends the shorter one
    assert torch.equal(fleet_normals(11, ids, 1, 12)[:, :7], z)


# ---------------------------------------------------------------------------
# in-pass shards = materialize_arrays, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 1, 7, 16, 100])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_in_pass_shards_equal_materialized(tparams, chunk, order):
    ds = _vds(n=48)
    ids = np.arange(40, dtype=np.int64)
    if order == "shuffled":
        ids = np.random.RandomState(1).permutation(ids)
    seen = {}
    shard = ds.shard_fn("cpu")

    def recording(chunk_ids):
        x, y, mask = shard(chunk_ids)
        for i, d in enumerate(chunk_ids.tolist()):
            seen[d] = (x[i], y[i], mask[i])
        return x, y, mask

    P = ids.size
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 16, (P, 4, 8), generator=gen)
    cohort_update(logistic_loss, tparams, recording, torch.from_numpy(ids),
                  torch.full((P,), 4), idx, lr=0.1, chunk=chunk)
    x, y, mask = ds.materialize_arrays(ids, "cpu")
    assert sorted(seen) == sorted(ids.tolist())
    for i, d in enumerate(ids.tolist()):
        np.testing.assert_array_equal(seen[d][0].numpy(), x[i])
        np.testing.assert_array_equal(seen[d][1].numpy(), y[i])
        np.testing.assert_array_equal(seen[d][2].numpy(), mask[i])


def test_materialize_and_test_set_shapes():
    ds = _vds(n=32)
    fed = ds.materialize(device="cpu")
    assert fed.x.shape == (32, 16, DIM) and fed.y.shape == (32, 16)
    tx, ty = ds.test_set("cpu")
    assert tx.shape == (ds.test_devices * 16, DIM) and ty.dtype == np.int32
    # the held-out ids are [N, N + test_devices)
    hx, _, _ = ds.materialize_arrays(np.arange(32, 32 + 64), "cpu")
    np.testing.assert_array_equal(hx.reshape(-1, DIM), tx)
    np.testing.assert_array_equal(fed.test_x, tx)


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _vds().materialize_arrays([0])


# ---------------------------------------------------------------------------
# cohort path vs event path on the port's own shards
# ---------------------------------------------------------------------------

def _run_pair(tparams, attack=None, frac=0.0, churn=None):
    ds = _vds()
    obj = bimodal_fleet(64, slowdown=10.0, dropout_slow=0.05, seed=0)
    arr = array_bimodal_fleet(64, slowdown=10.0, dropout_slow=0.05, seed=0)
    if frac:
        obj = assign_adversaries(obj, frac, seed=5)
        arr = assign_adversaries(arr, frac, seed=5)
    kw = _hier_kw()
    ev = run_hier_simulation(
        "ev", logistic_loss, logistic_apply, tparams,
        ds.materialize(device="cpu"), _cfg(), two_tier_topology(obj, 4),
        scheduler_mode="event", attack=attack, churn=churn, **kw)
    co = run_hier_simulation(
        "co", logistic_loss, logistic_apply, tparams, ds, _cfg(),
        stacked_two_tier(arr, 4), scheduler_mode="cohort", attack=attack,
        churn=churn, **kw)
    return ev, co


def _assert_equivalent(ev, co, tol=1e-5):
    """``tests/test_fleet_scale.py``'s checks."""
    assert co.times == ev.times
    assert co.cloud_uplink_bytes == ev.cloud_uplink_bytes
    assert co.total_bytes == ev.total_bytes
    assert (co.arrived, co.dropped) == (ev.arrived, ev.dropped)
    assert max(abs(a - b) for a, b in
               zip(ev.train_loss, co.train_loss)) < tol
    assert max(abs(a - b) for a, b in zip(ev.test_acc, co.test_acc)) <= tol


def test_cohort_matches_event_path(tparams):
    ev, co = _run_pair(tparams)
    _assert_equivalent(ev, co)
    assert co.comm == ev.comm
    assert co.train_loss[-1] < co.train_loss[0]


def test_cohort_matches_event_path_under_attack_and_churn(tparams):
    churn = ChurnSchedule(64, (ChurnWave(0.0, 1e9, 0.2, seed=4),))
    ev, co = _run_pair(tparams, attack=ByzantineGauss(scale=10.0), frac=0.25,
                       churn=churn)
    _assert_equivalent(ev, co)
    assert ev.dropped > 0                        # the wave bit


@pytest.mark.parametrize("engine", ["fused", "streamed"])
def test_cohort_runs_robust_config_on_both_engines(tparams, engine):
    from repro_torch.robust import RobustConfig
    cfg = _cfg(robust=RobustConfig(2.0, "mom"))
    arr = assign_adversaries(array_uniform_fleet(48), 0.25, seed=5)
    runs = [run_hier_simulation(
        name, logistic_loss, logistic_apply, tparams, _vds(48), cfg,
        stacked_two_tier(arr, 4), scheduler_mode=mode, engine=engine,
        attack=ByzantineGauss(scale=10.0), **_hier_kw(rounds=2))
        for name, mode in (("a", "cohort"), ("b", "event"))]
    assert runs[0].times == runs[1].times
    assert runs[0].engine["engine_name"] == engine
    np.testing.assert_allclose(runs[0].train_loss, runs[1].train_loss,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["fused", "streamed"])
@pytest.mark.parametrize("scheme", ["topk", "sign_sketch"])
def test_cohort_matches_event_path_with_compressed_summaries(tparams, engine,
                                                             scheme):
    cfg = _cfg(aggregator="hier_contextual_sketch",
               compress=CompressConfig(scheme=scheme, ratio=3.0))
    ds = _vds(48)
    kw = dict(engine=engine, **_hier_kw(rounds=2))
    ev = run_hier_simulation(
        "ev", logistic_loss, logistic_apply, tparams,
        ds.materialize(device="cpu"), cfg,
        two_tier_topology(bimodal_fleet(48, seed=0), 4),
        scheduler_mode="event", **kw)
    co = run_hier_simulation(
        "co", logistic_loss, logistic_apply, tparams, ds, cfg,
        stacked_two_tier(array_bimodal_fleet(48, seed=0), 4),
        scheduler_mode="cohort", **kw)
    _assert_equivalent(ev, co)
    assert co.comm == ev.comm and co.engine["engine_name"] == engine


# ---------------------------------------------------------------------------
# the reference's cohort run on its own shards, draws replayed
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(2, 3))
def _ref_draws(keys, mask_rows, max_steps, batch_size):
    m = mask_rows.shape[1]

    def per_client(kk, mk):
        probs = mk / jnp.maximum(mk.sum(), 1.0)
        return jax.vmap(lambda sk: jax.random.choice(
            sk, m, shape=(batch_size,), p=probs))(
            jax.random.split(kk, max_steps))
    return jax.vmap(per_client)(keys, mask_rows)


def _replayed_batch_indices(jfed, seed, batch_size):
    """Participant i of round t trains on ``fold_in(PRNGKey(seed), t·P +
    i)``, each key split per step, then ``choice`` with mask weights."""
    base = jax.random.PRNGKey(seed)

    def batch_indices(t, part_dev, max_steps):
        P = len(part_dev)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            base, jnp.arange(t * P, (t + 1) * P, dtype=jnp.uint32))
        return torch.from_numpy(np.array(_ref_draws(
            keys, jnp.asarray(jfed.mask[part_dev]), max_steps,
            batch_size))).long()
    return batch_indices


@pytest.mark.parametrize("chunk", [None, 20])
def test_cohort_run_matches_reference_on_its_shards(jparams, tparams, chunk):
    jds = JVirtualFleetDataset(num_devices=64, samples_per_device=16,
                               dim=DIM, num_classes=CLASSES, seed=3)
    jfed = jds.materialize()
    tfed = FederatedDataset(jfed.x, jfed.y, jfed.mask, jfed.test_x,
                            jfed.test_y, jfed.num_classes)
    jcfg = JHierConfig(aggregator="hier_contextual", lr=0.1, mu=0.0,
                       batch_size=8, min_epochs=1, max_epochs=2)
    kw = dict(num_rounds=3, selection_seed=42, eval_every=1, rng_stream="v2",
              scheduler_mode="cohort")
    want = j_run_hier("j", j_loss, j_apply, jparams, jds, jcfg,
                      j_stacked_two_tier(j_array_bimodal(64), 4),
                      cohort_chunk=chunk, **kw)
    got = run_hier_simulation(
        "t", logistic_loss, logistic_apply, tparams, tfed, _cfg(),
        stacked_two_tier(array_bimodal_fleet(64), 4), device="cpu",
        batch_indices=_replayed_batch_indices(jfed, 42, 8), **kw)
    assert got.times == want.times
    assert got.comm == want.comm
    assert got.cloud_uplink_bytes == want.cloud_uplink_bytes
    assert got.total_bytes == want.total_bytes
    assert (got.dispatched, got.arrived, got.dropped, got.rounds_skipped) == (
        want.dispatched, want.arrived, want.dropped, want.rounds_skipped)
    np.testing.assert_allclose(got.train_loss, want.train_loss,
                               rtol=RUN_RTOL)
    np.testing.assert_allclose(got.test_nll, want.test_nll, rtol=RUN_RTOL)


# ---------------------------------------------------------------------------
# chunking, auto mode, rejections
# ---------------------------------------------------------------------------

def test_cohort_chunking_matches_unchunked(tparams):
    topo = stacked_two_tier(array_uniform_fleet(48), 4)
    a, b = (run_hier_simulation(
        name, logistic_loss, logistic_apply, tparams, _vds(48), _cfg(), topo,
        scheduler_mode="cohort", cohort_chunk=chunk, **_hier_kw())
        for name, chunk in (("a", None), ("b", 16)))
    assert a.times == b.times
    assert a.total_bytes == b.total_bytes
    assert a.train_loss == b.train_loss
    assert a.test_acc == b.test_acc


def test_auto_mode_switches_to_cohort_at_4096(tparams):
    fleet = array_uniform_fleet(4096, dropout=0.1)
    topo = stacked_two_tier(fleet, 8)
    cfg = _cfg(min_epochs=1, max_epochs=1)
    kw = dict(num_rounds=1, selection_seed=5, rng_stream="v2",
              eval_device_cap=256, device="cpu")
    auto, cohort = (run_hier_simulation(
        name, logistic_loss, logistic_apply, tparams, _vds(4096), cfg, topo,
        scheduler_mode=mode, **kw) for name, mode in (("a", "auto"),
                                                      ("c", "cohort")))
    assert auto.times == cohort.times
    assert auto.comm == cohort.comm
    assert (auto.arrived, auto.dropped) == (cohort.arrived, cohort.dropped)
    assert auto.train_loss == cohort.train_loss
    assert auto.dispatched == 4096 and auto.dropped > 0


def test_cohort_rejects_device_uplink_compression(tparams):
    cfg = _cfg(aggregator="hier_contextual_sketch",
               compress=CompressConfig(scheme="sign_sketch", ratio=4,
                                       device_uplink=True))
    topo = stacked_two_tier(array_uniform_fleet(16), 4)
    with pytest.raises(ValueError, match="device_uplink"):
        run_hier_simulation("c", logistic_loss, logistic_apply, tparams,
                            _vds(16), cfg, topo, scheduler_mode="cohort",
                            **_hier_kw(rounds=1))
    # "auto" falls back to the event path instead
    r = run_hier_simulation("c", logistic_loss, logistic_apply, tparams,
                            _vds(16), cfg, topo, scheduler_mode="auto",
                            **_hier_kw(rounds=1))
    assert r.dispatched == 16


def test_virtual_dataset_rejects_data_poisoning(tparams):
    fleet = assign_adversaries(array_uniform_fleet(16), 0.25, seed=1)
    with pytest.raises(ValueError, match="materialized shards"):
        run_hier_simulation("p", logistic_loss, logistic_apply, tparams,
                            _vds(16), _cfg(), stacked_two_tier(fleet, 4),
                            attack=LabelFlip(), **_hier_kw(rounds=1))
