"""The port's serving stack (``repro_torch.serve``) on the CPU: the nine
invariants of ``tests/test_serve.py`` on the port, on the same config, and
the port held against the JAX reference on the same params:

  * greedy token streams equal to the reference ``DecodeEngine``'s, token
    for token, with staggered admission, multi-chunk prefill into a reused
    slot and a mid-flight publish;
  * ``synthetic_trace`` identical to the reference's (numpy draws);
  * the prefill overhang: a 14-token prompt in a 16-row slot gives the same
    tokens and cache rows whatever the chunk width on the port, while the
    reference's clamped chunk write (``prefill_chunk``) makes width 6 emit
    other tokens than 7 and 16 — recorded here as long as the reference
    keeps the fault.

Greedy streams are compared exactly: both engines take argmax of f32 logits
that agree to ~1e-6, and these prompts have no near-ties.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.serve import DecodeEngine as JEngine
from repro.serve import ModelBus as JBus
from repro.serve import synthetic_trace as j_synthetic_trace
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_map
from repro_torch.serve import (DecodeEngine, ModelBus, ScheduledModel,
                               TraceRequest, replay, synthetic_trace)

torch.set_num_threads(1)

CFG = get_config("qwen3-14b").reduced(num_layers=1, d_model=32,
                                      vocab_size=64, dtype="float32")
J_CFG = j_get_config("qwen3-14b").reduced(num_layers=1, d_model=32,
                                          vocab_size=64, dtype="float32")


@pytest.fixture(scope="module")
def jparams():
    return j_get_model(J_CFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


def _engine(params, **kw):
    return DecodeEngine(CFG, ModelBus(params), device="cpu", **kw)


def _prompts(n, plen=6, seed=3):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, CFG.vocab_size, plen)]
            for _ in range(n)]


# -------------------------------------------------- batching equivalence

def test_continuous_batching_bit_identical_to_solo_decode(params):
    """Three staggered requests on one engine produce exactly the token
    streams each request gets served alone (same engine width)."""
    prompts = _prompts(3)
    max_new = (7, 4, 9)
    eng = _engine(params, num_slots=3, max_seq=32, scan_chunk=4,
                  prefill_chunk_tokens=8)
    eng.submit(prompts[0], max_new[0], rid=0)
    done = eng.step()                        # r0 resident before r1/r2 land
    eng.submit(prompts[1], max_new[1], rid=1)
    eng.submit(prompts[2], max_new[2], rid=2)
    done += eng.run()
    batched = {c.rid: c.tokens for c in done}
    assert sorted(batched) == [0, 1, 2]
    for rid in range(3):
        solo = _engine(params, num_slots=3, max_seq=32, scan_chunk=4,
                       prefill_chunk_tokens=8)
        solo.submit(prompts[rid], max_new[rid], rid=rid)
        (c,) = solo.run()
        assert c.tokens == batched[rid], f"rid={rid} diverged"


def _reused_slot_scenario(make):
    """Reference regression scenario: rC's 3-chunk prefill into a reused
    slot (stale position 4) while rD decodes in the other slot."""
    pA, pB, pD = _prompts(3, plen=4, seed=11)
    pC = _prompts(1, plen=12, seed=13)[0]        # 12 > chunk 4 → 3 chunks
    eng = make(num_slots=2, max_seq=32, scan_chunk=2, prefill_chunk_tokens=4)
    eng.submit(pA, 1, rid=0)
    eng.submit(pB, 1, rid=1)
    done = eng.step()
    eng.submit(pD, 20, rid=2)
    done += eng.step()
    eng.submit(pC, 4, rid=3)
    done += eng.run()
    return {c.rid: c.tokens for c in done}, [(pA, 1), (pB, 1), (pD, 20),
                                             (pC, 4)]


def test_multichunk_prefill_into_reused_slot_while_decoding(params):
    """A prompt longer than ``prefill_chunk_tokens`` chunk-prefilled into a
    *reused* slot, while another slot decodes, produces the same tokens as
    serving it alone: inactive slots' stale positions write nothing."""
    batched, reqs = _reused_slot_scenario(
        lambda **kw: _engine(params, **kw))
    assert sorted(batched) == [0, 1, 2, 3]
    for rid, (prompt, max_new) in enumerate(reqs):
        solo = _engine(params, num_slots=2, max_seq=32, scan_chunk=2,
                       prefill_chunk_tokens=4)
        solo.submit(prompt, max_new, rid=rid)
        (c,) = solo.run()
        assert c.tokens == batched[rid], f"rid={rid} diverged"


def test_chunked_prefill_matches_wide_prefill_first_token(params):
    prompt = _prompts(1, plen=12)[0]
    tokens = {}
    for chunk_w in (4, 16):
        eng = _engine(params, num_slots=1, max_seq=16, scan_chunk=2,
                      prefill_chunk_tokens=chunk_w)
        eng.submit(prompt, 1)
        (c,) = eng.run()
        tokens[chunk_w] = c.tokens
    assert tokens[4] == tokens[16]


# ------------------------------------------------------------- hot swap

def test_hot_swap_version_monotone_and_recorded(params):
    bus = ModelBus(params)
    eng = DecodeEngine(CFG, bus, num_slots=2, max_seq=32, scan_chunk=2,
                       prefill_chunk_tokens=8, device="cpu")
    for p in _prompts(4):
        eng.submit(p, 8)
    done, seen = [], []
    v = 0
    while not eng.idle:
        done += eng.step()
        seen.append(eng.model_version)
        if len(seen) % 2 == 0 and v < 3:     # publish mid-flight
            v = bus.publish(tree_map(lambda a: a * (1.0 + 0.01), params))
    assert seen == sorted(seen), "adopted versions must be monotone"
    assert eng.stats["swaps"] == eng.model_version == bus.version == v
    for c in done:
        assert 0 <= c.admit_version <= c.final_version <= bus.version
    eng.submit(_prompts(1)[0], 2)
    (c,) = eng.run()
    assert c.admit_version == c.final_version == v


def test_completions_change_with_published_params(params):
    prompts = _prompts(2, plen=8, seed=9)
    outs = []
    for scale in (1.0, 1.5):
        eng = _engine(tree_map(lambda a: a * scale, params), num_slots=2,
                      max_seq=32, scan_chunk=4)
        for p in prompts:
            eng.submit(p, 8)
        outs.append([c.tokens for c in eng.run()])
    assert outs[0] != outs[1]


def test_engine_refuses_a_tree_on_another_device(params):
    meta = tree_map(lambda a: a.to("meta"), params)
    with pytest.raises(ValueError, match="does not move parameters"):
        DecodeEngine(CFG, ModelBus(meta), device="cpu")
    bus = ModelBus(params)
    eng = DecodeEngine(CFG, bus, device="cpu")
    bus.publish(meta)
    eng.submit([1, 2, 3], 2)
    with pytest.raises(ValueError, match="does not move parameters"):
        eng.step()


# ------------------------------------------------------- slot accounting

def test_slot_accounting_balances_every_step(params):
    eng = _engine(params, num_slots=2, max_seq=32, scan_chunk=4,
                  prefill_chunk_tokens=8)
    lens = [1, 5, 2, 7, 3]
    for p, mn in zip(_prompts(5), lens):
        eng.submit(p, mn)
    done, steps = [], 0
    while not eng.idle:
        assert len(eng._free_slots()) + len(eng._slots) == eng.num_slots
        done += eng.step()
        steps += 1
        assert steps < 200
    assert len(eng._free_slots()) == eng.num_slots and not eng._slots
    assert not eng.pending and eng._prefilling is None
    assert sorted(len(c.tokens) for c in done) == sorted(lens)
    assert eng.stats["tokens_emitted"] == sum(mn - 1 for mn in lens)
    assert {c.rid for c in done} == set(range(5))


def test_submit_validates_budget(params):
    eng = _engine(params, num_slots=1, max_seq=16)
    with pytest.raises(ValueError):
        eng.submit(list(range(12)), 8)       # 12 + 8 > 16
    with pytest.raises(ValueError):
        eng.submit([], 4)
    with pytest.raises(ValueError):
        eng.submit([1, 2], 0)


# ---------------------------------------------------------------- bus

def test_bus_snapshot_never_torn_under_concurrent_publisher():
    bus = ModelBus({"w": torch.zeros(4)}, train_loss=0.0)
    stop = threading.Event()

    def publisher():
        v = 0
        while not stop.is_set():
            v += 1
            bus.publish({"w": torch.full((4,), float(v))},
                        train_loss=float(v))
    th = threading.Thread(target=publisher, daemon=True)
    th.start()
    try:
        last = -1
        for _ in range(300):
            snap = bus.snapshot()
            assert snap.version >= last
            last = snap.version
            if snap.version > 0:
                assert float(snap.params["w"][0]) == snap.version
                assert snap.train_loss == snap.version
    finally:
        stop.set()
        th.join(timeout=5)


# ----------------------------------------------------- offline harness

def test_replay_deterministic_under_virtual_clock(params):
    trace = synthetic_trace(num_requests=5, vocab=CFG.vocab_size, seed=7,
                            mean_interarrival_s=0.2, prompt_len=(4, 8),
                            max_new=(2, 6))
    assert all(isinstance(r, TraceRequest) for r in trace)
    sched = [ScheduledModel(t_publish_s=0.3,
                            params=tree_map(lambda a: a * 1.01, params),
                            train_loss=0.5, round=0)]
    reports = []
    for _ in range(2):
        eng = _engine(params, num_slots=2, max_seq=32, scan_chunk=2,
                      prefill_chunk_tokens=8)
        reports.append(replay(eng, trace, sched, step_cost_s=0.05))
    a, b = reports
    for key in ("num_completed", "tokens_generated", "virtual_time_s",
                "tokens_per_virtual_s", "latency_virtual_mean_s",
                "staleness_virtual_mean_s", "served_loss_mean",
                "num_swaps", "by_request"):
        assert a[key] == b[key], key
    assert a["num_completed"] == 5
    assert a["num_swaps"] == 1
    stale = [r["staleness_virtual_s"] for r in a["by_request"]
             if r["final_version"] == 1]
    assert stale and all(s >= 0.0 for s in stale)


# ------------------------------------------------ against the reference

def test_synthetic_trace_identical_to_reference():
    kw = dict(num_requests=40, vocab=1000, seed=5, mean_interarrival_s=0.3,
              prompt_len=(3, 50), max_new=(1, 20))
    assert [r.__dict__ for r in synthetic_trace(**kw)] == \
        [r.__dict__ for r in j_synthetic_trace(**kw)]


def test_greedy_streams_equal_reference_engine(jparams, params):
    """The reference's reused-slot scenario, then a staggered run with a
    mid-flight publish, on both engines: the same tokens for every rid."""
    port, _ = _reused_slot_scenario(lambda **kw: _engine(params, **kw))
    ref, _ = _reused_slot_scenario(
        lambda **kw: JEngine(J_CFG, JBus(jparams), **kw))
    assert port == ref

    def staggered(eng, publish):
        for i, p in enumerate(_prompts(4, plen=10, seed=21)):
            eng.submit(p, 6 + 3 * i, rid=i)
        done = eng.step()
        publish()
        return {c.rid: c.tokens for c in done + eng.run()}
    tbus, jbus = ModelBus(params), JBus(jparams)
    port = staggered(DecodeEngine(CFG, tbus, num_slots=3, max_seq=40,
                                  scan_chunk=3, prefill_chunk_tokens=4,
                                  device="cpu"),
                     lambda: tbus.publish(tree_map(lambda a: a * 1.02,
                                                   params)))
    ref = staggered(JEngine(J_CFG, jbus, num_slots=3, max_seq=40,
                            scan_chunk=3, prefill_chunk_tokens=4),
                    lambda: jbus.publish(jax.tree_util.tree_map(
                        lambda a: a * 1.02, jparams)))
    assert port == ref and len(port) == 4


def _overhang_prompt():
    return _prompts(1, plen=14)[0]


def test_prefill_overhang_writes_the_real_rows(params):
    """A 14-token prompt in a 16-row slot: chunk widths 6 (last chunk at
    12 overhangs the cache by 2), 7 and 16 give the same tokens and the
    same cache rows on the port."""
    prompt = _overhang_prompt()
    tokens, rows = {}, {}
    for chunk_w in (6, 7, 16):
        eng = _engine(params, num_slots=1, max_seq=16, scan_chunk=2,
                      prefill_chunk_tokens=chunk_w)
        eng.submit(prompt, 2)
        (c,) = eng.run()
        tokens[chunk_w] = c.tokens
        # rows 0..14 are the prompt's and the first decode step's
        rows[chunk_w] = [t[:, :, :15].clone() for t in eng._cache.kv]
    assert tokens[6] == tokens[7] == tokens[16]
    for w in (6, 7):
        for got, want in zip(rows[w], rows[16]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_reference_prefill_overhang_fault_recorded(jparams, params):
    """The reference clamps the overhanging chunk's write to start
    S − C = 10 (``repro/models/transformer.py`` ``prefill_chunk``), so its
    rows land shifted: width 6 emits [10, 19] where 7 and 16 emit
    [57, 28], the port's tokens at every width.  This test records the
    fault while the reference keeps it (ROADMAP queue 3)."""
    prompt = _overhang_prompt()
    ref = {}
    for chunk_w in (6, 7, 16):
        eng = JEngine(J_CFG, JBus(jparams), num_slots=1, max_seq=16,
                      scan_chunk=2, prefill_chunk_tokens=chunk_w)
        eng.submit(prompt, 2)
        (c,) = eng.run()
        ref[chunk_w] = c.tokens
    assert ref[6] == [10, 19]
    assert ref[7] == ref[16] == [57, 28]
    port = _engine(params, num_slots=1, max_seq=16, scan_chunk=2,
                   prefill_chunk_tokens=6)
    port.submit(prompt, 2)
    (c,) = port.run()
    assert c.tokens == [57, 28]
