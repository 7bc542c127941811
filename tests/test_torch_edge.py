"""The port's edge runtime pieces (``repro_torch.edge``) against ``repro.edge``.

Profiles, fleets and the event scheduler are numpy code copied into the
port, so everything here must match the reference bit for bit: fleet
profiles, per-task outcomes under both RNG streams (v1 sequential draws, v2
counter-based), ``dispatch`` / ``dispatch_batch`` traces, the transfer
events ``schedule`` adds, and the wall-clock replay of a sync run.
"""
import numpy as np
import pytest
import torch

from repro.edge import events as jevents
from repro.edge import profiles as jprof
from repro.edge import wallclock as jwall
from repro.fl.server import ServerConfig as JServerConfig
from repro_torch.edge import events as tevents
from repro_torch.edge import profiles as tprof
from repro_torch.edge import wallclock as twall
from repro_torch.fl.server import ServerConfig as TServerConfig

torch.set_num_threads(1)

FLEETS = [
    ("uniform_fleet", (10,), dict(dropout=0.1, jitter=0.2)),
    ("bimodal_fleet", (16,), dict(slowdown=10.0, dropout_slow=0.05, seed=0)),
    ("longtail_fleet", (9,), dict(seed=4)),
    ("array_uniform_fleet", (10,), dict(dropout=0.1, jitter=0.2)),
    ("array_bimodal_fleet", (16,), dict(slowdown=4.0, dropout_slow=0.2,
                                        seed=1)),
    ("array_longtail_fleet", (9,), dict(seed=4)),
]


def _profiles(fleet):
    return [tuple(float(getattr(p, f)) for f in
                  ("flops", "up_bw", "down_bw", "dropout", "jitter"))
            for p in fleet]


@pytest.mark.parametrize("fn,args,kw", FLEETS, ids=[f[0] for f in FLEETS])
def test_fleets_bit_identical(fn, args, kw):
    jf = getattr(jprof, fn)(*args, **kw)
    tf = getattr(tprof, fn)(*args, **kw)
    assert _profiles(tf) == _profiles(jf)
    for a, b in zip(tprof.fleet_arrays(tf), jprof.fleet_arrays(jf)):
        np.testing.assert_array_equal(a, b)
    assert tf.describe() == jf.describe()


@pytest.mark.parametrize("name", ["uniform", "bimodal", "longtail"])
def test_get_fleet_matches_and_rejects_unknown(name):
    assert _profiles(tprof.get_fleet(name, 7)) == \
        _profiles(jprof.get_fleet(name, 7))
    with pytest.raises(KeyError):
        tprof.get_fleet("bogus", 3)


def _drive(mod, fleet, stream, batch):
    """Two rounds of dispatches (batched or one by one), a transfer event
    per round, and every event popped: the full trace signature and stats."""
    sched = mod.EventScheduler(fleet, seed=7, flops_per_step=3e9,
                               payload_bytes=4e4, rng_stream=stream)
    rng = np.random.RandomState(2)
    for version in range(2):
        ids = rng.choice(fleet.num_devices, 6, replace=False)
        steps = rng.randint(1, 40, size=6)
        at = sched.now + rng.rand(6)
        if batch:
            sched.dispatch_batch(ids, steps, version=version, at=at)
        else:
            for d, s, a in zip(ids, steps, at):
                sched.dispatch(int(d), int(s), version, at=float(a))
        sched.schedule(0.5, node_id=100 + version, version=version)
        while sched.pending():
            sched.pop()
    st = sched.stats
    return (sched.trace_signature(), sched.now,
            (st.dispatched, st.arrived, st.dropped), sched.conservation_ok())


@pytest.mark.parametrize("stream", ["v1", "v2"])
@pytest.mark.parametrize("batch", [False, True], ids=["dispatch", "batch"])
@pytest.mark.parametrize("fleet", ["bimodal", "jitter"])
def test_scheduler_traces_bit_identical(stream, batch, fleet):
    if fleet == "bimodal":
        jf = jprof.bimodal_fleet(12, slowdown=10.0, dropout_slow=0.3, seed=0)
        tf = tprof.bimodal_fleet(12, slowdown=10.0, dropout_slow=0.3, seed=0)
    else:
        jf = jprof.uniform_fleet(12, dropout=0.2, jitter=0.3)
        tf = tprof.uniform_fleet(12, dropout=0.2, jitter=0.3)
    want = _drive(jevents, jf, stream, batch)
    got = _drive(tevents, tf, stream, batch)
    assert got == want
    assert got[-1]                          # conservation holds


def test_batch_dispatch_equals_scalar_dispatch_in_the_port():
    tf = tprof.uniform_fleet(12, dropout=0.2, jitter=0.3)
    for stream in ("v1", "v2"):
        assert _drive(tevents, tf, stream, True)[0] == \
            _drive(tevents, tf, stream, False)[0]


def test_v2_counter_stream_matches():
    seqs = np.arange(0, 5000, 7, dtype=np.int64)
    for fieldno in range(4):
        np.testing.assert_array_equal(
            tevents._stream_uniform(99, seqs, fieldno),
            jevents._stream_uniform(99, seqs, fieldno))


def test_scheduler_rejects_unknown_stream():
    with pytest.raises(ValueError, match="rng_stream"):
        tevents.EventScheduler(tprof.uniform_fleet(2), seed=0,
                               flops_per_step=1.0, payload_bytes=1.0,
                               rng_stream="v3")


def test_sync_wallclock_replay_matches():
    kw = dict(num_devices=16, clients_per_round=5, min_epochs=1,
              max_epochs=6)
    jf = jprof.bimodal_fleet(16, slowdown=10.0, dropout_slow=0.05, seed=0)
    tf = tprof.bimodal_fleet(16, slowdown=10.0, dropout_slow=0.05, seed=0)
    args = (3, 4, 1e9, 3.14e4)
    want = jwall.sync_round_durations(jf, JServerConfig(**kw), *args,
                                      selection_seed=5)
    got = twall.sync_round_durations(tf, TServerConfig(**kw), *args,
                                     selection_seed=5)
    np.testing.assert_array_equal(got, want)
    params = {"w": torch.zeros(20, 10), "b": torch.zeros(10)}
    assert twall.model_payload_bytes(params) == 4.0 * 210
    assert twall.model_flops_per_step(params, 10) == 6.0 * 10 * 210
    curve = twall.WallclockCurve("c", times=[1.0, 2.0, 3.0],
                                 test_acc=[0.1, 0.5, 0.4])
    assert curve.time_to_accuracy(0.5) == 2.0
    assert curve.accuracy_at(3.5) == 0.5 and curve.accuracy_at(0.5) is None
