"""The port's MoE family (``repro_torch.models.moe``, the ``moe`` branches
of the transformer, olmoe-1b-7b and deepseek-moe-16b) against the JAX
reference on the same weights.

The reference initialises its params; they reach the port through numpy
(``convert.params_from_jax``).  Routing is discrete, so every parity test
asserts that its inputs' smallest top-k margin (the gap between the k-th
and the (k+1)-th router probability, relative to the k-th) is at least
``MARGIN``, far above the relative f32 difference between the two
packages' probabilities (~1e-7): no pass rests on a near tie.  The
router weights are scaled up (``ROUTER_SCALE``) so the small test widths
route decisively.  The tie test is the exception: a zero router makes
every expert equally likely, and the port must pick ``jax.lax.top_k``'s
experts (the lower index first).

Tolerances: f32, max |port − reference| ≤ 1e-5 · max(1, max |reference|)
(as ``tests/test_torch_models.py``: the same f32 arithmetic summed in
another order); bf16, 1.6e-2 (four bf16 ulps at the largest output: both
round every product and activation to bf16, in other orders).
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
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.config import ArchConfig as JArchConfig
from repro.serve import DecodeEngine as JEngine
from repro.serve import ModelBus as JBus
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_map
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ArchConfig
from repro_torch.models.mlp import mlp_forward
from repro_torch.serve import DecodeEngine, ModelBus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
BF16_TOL = 1.6e-2
MARGIN = 1e-4
ROUTER_SCALE = 50.0
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
_ZERO_INIT = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"rel err {err:.3e} > {tol}"


def _margin(probs, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th probability of a row,
    relative to the k-th (both packages' probabilities carry a relative
    f32 error)."""
    p = -np.sort(-np.asarray(probs, np.float64).reshape(-1, probs.shape[-1]),
                 axis=-1)
    if k >= p.shape[-1]:
        return float("inf")
    return float(((p[:, k - 1] - p[:, k]) / p[:, k - 1]).min())


class _Margins:
    """Records the smallest top-k margin of every ``route`` call."""

    def __init__(self, monkeypatch):
        self.seen = []
        route = tmoe.route

        def recording(cfg, router, xt):
            out = route(cfg, router, xt)
            self.seen.append(_margin(out[0].numpy(),
                                     cfg.experts_per_token))
            return out
        monkeypatch.setattr(tmoe, "route", recording)

    def check(self):
        assert self.seen, "no router call was recorded"
        assert min(self.seen) >= MARGIN, \
            f"top-k margin {min(self.seen):.3e} < {MARGIN}: a near tie"


def _moe_cfgs(**kw):
    """The reference's ``_moe_cfg`` shape (tests/test_model_numerics.py)."""
    spec = dict(name="t", family="moe", num_layers=1, d_model=16, d_ff=32,
                vocab_size=64, num_heads=2, num_kv_heads=2, num_experts=8,
                experts_per_token=2, num_shared_experts=1, dtype="float32")
    spec.update(kw)
    return JArchConfig(**spec), ArchConfig(**spec)


def _layer(jcfg, seed=0, router_scale=ROUTER_SCALE, zero_router=False):
    dt = jnp.bfloat16 if jcfg.dtype == "bfloat16" else jnp.float32
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), dt)
    router = jp["router"] * (0.0 if zero_router else router_scale)
    jp = dict(jp, router=router)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _inputs(jcfg, T, seed=1, offset=0.0):
    x = np.random.RandomState(seed).randn(1, T, jcfg.d_model)
    x = (x + offset).astype(np.float32)
    if jcfg.dtype == "bfloat16":
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
            torch.bfloat16)
        return xj, xt
    return jnp.asarray(x), torch.from_numpy(x)


def _reference_keep(cfg, top_e, T):
    """The reference's kept entries (flat t·k + j order), from its own
    top_e and sort: position in expert < capacity."""
    flat = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    pos_sorted = np.arange(flat.size) - np.searchsorted(se, se)
    pos = np.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos < tmoe.capacity(cfg, T)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("name", MOE_ARCHS)
def test_configs_are_the_references(name):
    assert get_config(name).__dict__ == j_get_config(name).__dict__
    assert get_config(name).reduced().__dict__ == \
        j_get_config(name).reduced().__dict__
    assert get_config(name.replace("-", "_")) is get_config(name)
    cfg = get_config(name)
    assert cfg.param_count_estimate() == \
        j_get_config(name).param_count_estimate()
    assert cfg.active_param_count() == j_get_config(name).active_param_count()


# ------------------------------------------------------------- the layer

_LAYER_CASES = {
    "silu-shared": ({}, 24),
    "silu": ({"num_shared_experts": 0}, 24),
    "geglu": ({"activation": "geglu", "num_shared_experts": 0}, 24),
    "gelu-shared": ({"activation": "gelu"}, 24),
    "gelu": ({"activation": "gelu", "num_shared_experts": 0}, 24),
    "top3-of-4": ({"num_experts": 4, "experts_per_token": 3}, 40),
    "t256": ({}, 256),
}


@pytest.mark.parametrize("case", list(_LAYER_CASES))
def test_moe_forward_matches_reference(case):
    kw, T = _LAYER_CASES[case]
    jcfg, cfg = _moe_cfgs(**kw)
    jp, tp = _layer(jcfg)
    xj, xt = _inputs(jcfg, T)
    jout, jaux = jmoe.moe_forward(jcfg, jp, xj)
    probs = jax.nn.softmax(xj.reshape(T, -1) @ jp["router"], -1)
    assert _margin(probs, cfg.experts_per_token) >= MARGIN
    out, aux = tmoe.moe_forward(cfg, tp, xt)
    _close(out, jout)
    _close(aux, jaux)
    assert aux.dtype == torch.float32 and out.dtype == xt.dtype
    assert set(tp) == set(jp) and tp["router"].dtype == torch.float32
    assert ("w_gate" in tp) == (cfg.activation in ("silu", "geglu"))


@pytest.mark.parametrize("k", [1, 2])
def test_moe_drops_the_references_entries(k):
    """T = 320 > 256 at E = 4: the capacity int(320·k/4·1.25) + 1 binds,
    and an offset input sends most tokens to the same experts, so entries
    are dropped — the same entries as the reference's."""
    jcfg, cfg = _moe_cfgs(num_experts=4, experts_per_token=k)
    jp, tp = _layer(jcfg, seed=2, router_scale=5.0)
    T = 320
    xj, xt = _inputs(jcfg, T, offset=0.5)
    probs = jax.nn.softmax(xj.reshape(T, -1) @ jp["router"], -1)
    assert _margin(probs, k) >= MARGIN
    _, j_top_e = jax.lax.top_k(probs, k)
    want_keep = _reference_keep(cfg, j_top_e, T)
    assert 0 < (~want_keep).sum() < want_keep.size // 2
    _, _, top_e = tmoe.route(cfg, tp["router"], xt.reshape(T, -1))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(j_top_e))
    _, placed = tmoe.dispatch(cfg, xt.reshape(T, -1), top_e)
    np.testing.assert_array_equal(placed.keep.numpy(), want_keep)
    jout, jaux = jmoe.moe_forward(jcfg, jp, xj)
    out, aux = tmoe.moe_forward(cfg, tp, xt)
    _close(out, jout)
    _close(aux, jaux)


@pytest.mark.parametrize("T", [24, 320])
def test_moe_ties_take_lax_top_k_order(T):
    """A zero router: every expert equally likely.  ``lax.top_k`` takes the
    lower indices first, so every token goes to experts 0..k−1 (and at
    T = 320 the later tokens overflow them, as in the reference)."""
    jcfg, cfg = _moe_cfgs(num_experts=4, experts_per_token=2)
    jp, tp = _layer(jcfg, zero_router=True)
    xj, xt = _inputs(jcfg, T)
    _, top_p, top_e = tmoe.route(cfg, tp["router"], xt.reshape(T, -1))
    _, j_top_e = jax.lax.top_k(
        jax.nn.softmax(xj.reshape(T, -1) @ jp["router"], -1), 2)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(j_top_e))
    assert (top_e.numpy() == [0, 1]).all()
    assert torch.equal(top_p, torch.full((T, 2), 0.5))
    jout, jaux = jmoe.moe_forward(jcfg, jp, xj)
    out, aux = tmoe.moe_forward(cfg, tp, xt)
    _close(out, jout)
    _close(aux, jaux)


@pytest.mark.parametrize("kw", [{}, {"d_model": 256, "d_ff": 512,
                                     "activation": "gelu"}])
def test_moe_bf16_matches_reference(kw):
    jcfg, cfg = _moe_cfgs(dtype="bfloat16", **kw)
    jp, tp = _layer(jcfg)
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == torch.bfloat16
    T = 64
    xj, xt = _inputs(jcfg, T)
    probs = jax.nn.softmax(xj.reshape(T, -1).astype(jnp.float32)
                           @ jp["router"], -1)
    assert _margin(probs, cfg.experts_per_token) >= MARGIN
    jout, jaux = jmoe.moe_forward(jcfg, jp, xj)
    out, aux = tmoe.moe_forward(cfg, tp, xt)
    assert out.dtype == torch.bfloat16
    _close(out, jout.astype(jnp.float32), BF16_TOL)
    _close(aux, jaux)


def test_moe_layer_source_has_no_host_sync_or_atomic():
    """The ops that would stop the host at every layer on the card
    (bincount, nonzero, .item(), boolean-mask indexing) or add with float
    atomics (index_add_, accumulating index_put_) are absent; the card
    test (tests/test_torch_cuda.py) runs the layer under
    ``set_sync_debug_mode("error")``."""
    tree = ast.parse(
        (ROOT / "src" / "repro_torch" / "models" / "moe.py").read_text())
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    used |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    used |= {n.arg for n in ast.walk(tree) if isinstance(n, ast.keyword)}
    banned = {"bincount", "nonzero", "item", "index_add", "index_add_",
              "index_put", "index_put_", "accumulate", "masked_select",
              "unique", "tolist", "cpu", "numpy", "synchronize"}
    assert not used & banned, used & banned
    assert {"searchsorted", "argsort", "bmm"} <= used


# ---------------------------------------- the reference's own layer tests

def test_moe_no_drop_matches_dense_formula():
    """tests/test_model_numerics.py's dense-formula test on the port: in the
    drop-free regime the sort-based dispatch equals every token through
    every expert, weighted by the renormalised top-k gate."""
    _, cfg = _moe_cfgs()
    gen = torch.Generator().manual_seed(0)
    params = tmoe.init_moe(cfg, gen, torch.float32)
    x = torch.randn((2, 12, cfg.d_model), generator=gen)
    out, aux = tmoe.moe_forward(cfg, params, x)

    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ params["router"], -1)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, top_e, top_p)
    up = torch.einsum("td,edf->tef", xt, params["w_up"])
    gate = torch.einsum("td,edf->tef", xt, params["w_gate"])
    eo = torch.einsum("tef,efd->ted", torch.nn.functional.silu(gate) * up,
                      params["w_down"])
    ref = torch.einsum("te,ted->td", gates, eo)
    ref = ref + mlp_forward(cfg, params["shared"], xt)
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), rtol=2e-4, atol=2e-4)
    assert float(aux) > 0


@settings(max_examples=10, deadline=None)
@given(E=st.sampled_from([4, 8]), k=st.integers(1, 3),
       T=st.integers(2, 40), seed=st.integers(0, 2**16))
def test_moe_property_output_finite_and_balanced_aux(E, k, T, seed):
    _, cfg = _moe_cfgs(num_experts=E, experts_per_token=min(k, E),
                       num_shared_experts=0)
    gen = torch.Generator().manual_seed(seed)
    params = tmoe.init_moe(cfg, gen, torch.float32)
    x = torch.randn((1, T, cfg.d_model), generator=gen)
    out, aux = tmoe.moe_forward(cfg, params, x)
    assert torch.isfinite(out).all()
    # Switch aux loss is ≥ 1 at uniform routing and small near init
    assert 0.5 < float(aux) < 4.0


# ------------------------------------------------------ reduced models

_PARAMS = {}


def _params(name):
    """(jax cfg, jax params, torch cfg, torch params) of the reduced config:
    the reference's init with its zero leaves perturbed and the router
    scaled by ROUTER_SCALE, carried over through numpy."""
    if name not in _PARAMS:
        jcfg = j_get_config(name).reduced()
        jp = j_get_model(jcfg).init(jax.random.PRNGKey(1))
        rng = np.random.RandomState(7)

        def perturb(path, a):
            a = np.asarray(a)
            last = jax.tree_util.keystr(path).split("'")[-2]
            if last in _ZERO_INIT:
                a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
            if last == "router":
                a = a * ROUTER_SCALE
            return a
        jp = jax.tree_util.tree_map_with_path(perturb, jp)
        _PARAMS[name] = (jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                         get_config(name).reduced(),
                         params_from_jax(jp, device="cpu"))
    return _PARAMS[name]


def _tokens(B, S, vocab, seed=0):
    t = np.random.RandomState(seed).randint(0, vocab, size=(B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t.astype(np.int32))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_forward_train_matches_reference(name, monkeypatch):
    jcfg, jp, cfg, tp = _params(name)
    margins = _Margins(monkeypatch)
    tj, tt = _tokens(2, 12, cfg.vocab_size)
    jl, jaux = jtf.forward_train(jcfg, jp, tj)
    tl, taux = ttf.forward_train(cfg, tp, tt)
    _close(tl, jl)
    _close(taux, jaux)
    assert float(taux) > 0
    jloss, _ = j_get_model(jcfg).train_loss(jp, {"tokens": tj})
    tloss, _ = get_model(cfg).train_loss(tp, {"tokens": tt})
    _close(tloss, jloss)
    margins.check()
    assert set(tp["blocks"]) == {"ln1", "ln2", "attn", "moe"}


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_prefill_and_decode_step_match_reference(name, monkeypatch):
    jcfg, jp, cfg, tp = _params(name)
    margins = _Margins(monkeypatch)
    tj, tt = _tokens(2, 12, cfg.vocab_size, seed=3)
    jlog, jc = jtf.prefill(jcfg, jp, tj, max_seq=20)
    tlog, tc = ttf.prefill(cfg, tp, tt, max_seq=20)
    _close(tlog, jlog)
    _close(tc.kv.k, jc.kv.k)
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(3):
        jlog, jc = jtf.decode_step(jcfg, jp, tok, jc)
        tlog, tc = ttf.decode_step(cfg, tp, torch.from_numpy(
            np.array(tok)), tc)
        _close(tlog, jlog)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    _close(tc.kv.v, jc.kv.v)
    assert tc.position == int(jc.position) == 15
    margins.check()


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_prefill_chunk_and_decode_slots_match_reference(name, monkeypatch):
    """Two prefill chunks into slot 1 of an engine cache, then decode steps
    with slots at different depths and slot 2 inactive.  The chunks lie
    inside the cache, so the reference's overhang clamp does not arise."""
    jcfg, jp, cfg, tp = _params(name)
    margins = _Margins(monkeypatch)
    B, S, C = 3, 24, 8
    jc = jtf.init_lm_cache(jcfg, B, S, ring=False)
    tc = ttf.init_lm_cache(cfg, B, S, ring=False, device="cpu")
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, 2 * C)
    for start in (0, C):
        chunk = prompt[start:start + C].astype(np.int32)
        jlog, jc = jtf.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                                     jnp.asarray(1), jnp.asarray(start))
        tlog, tc = ttf.prefill_chunk(cfg, tp, torch.from_numpy(chunk), tc,
                                     1, start)
        _close(tlog, jlog)
    positions = np.array([5, 2 * C, 3], np.int32)
    active = np.array([True, True, False])
    tok = np.array([7, 11, 13], np.int32)
    for _ in range(2):
        jlog, jc = jtf.decode_slots(jcfg, jp, jnp.asarray(tok), jc,
                                    jnp.asarray(positions),
                                    active=jnp.asarray(active))
        tlog, tc = ttf.decode_slots(cfg, tp, torch.from_numpy(tok), tc,
                                    torch.from_numpy(positions),
                                    active=torch.from_numpy(active))
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
        positions = positions + active
    _close(tc.kv.k, jc.kv.k)
    _close(tc.kv.v, jc.kv.v)
    margins.check()


def test_moe_bundle_inits_the_references_tree():
    cfg = get_config("deepseek-moe-16b").reduced(num_layers=1, d_model=32,
                                                 vocab_size=64)
    params = get_model(cfg).init(0, device="cpu")
    jcfg = j_get_config("deepseek-moe-16b").reduced(num_layers=1,
                                                    d_model=32, vocab_size=64)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    shapes = lambda tree: sorted(  # noqa: E731
        (jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
        for p, a in jax.tree_util.tree_leaves_with_path(tree))
    assert shapes(tree_map(lambda a: np.asarray(a.float()).astype(
        np.float32), params)) == shapes(jparams)
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
    assert params["blocks"]["moe"]["shared"]["w_up"].shape == (1, 32, 512)


# -------------------------------------------------------------- serving

SERVE_NAME = "olmoe-1b-7b"


def _serve_cfgs():
    kw = dict(num_layers=1, d_model=32, vocab_size=64, dtype="float32")
    return (get_config(SERVE_NAME).reduced(**kw),
            j_get_config(SERVE_NAME).reduced(**kw))


def _prompts(n, vocab, plen=10, seed=21):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, plen)] for _ in range(n)]


def _reused_slot_scenario(make, vocab):
    """tests/test_torch_serve.py's scenario: a 3-chunk prefill into a
    reused slot (stale position 4) while another slot decodes."""
    pA, pB, pD = _prompts(3, vocab, plen=4, seed=11)
    pC = _prompts(1, vocab, plen=12, seed=13)[0]
    eng = make(num_slots=2, max_seq=32, scan_chunk=2, prefill_chunk_tokens=4)
    eng.submit(pA, 1, rid=0)
    eng.submit(pB, 1, rid=1)
    done = eng.step()
    eng.submit(pD, 20, rid=2)
    done += eng.step()
    eng.submit(pC, 4, rid=3)
    done += eng.run()
    return {c.rid: c.tokens for c in done}


def test_greedy_streams_equal_reference_engine(monkeypatch):
    """The reused-slot scenario, then a staggered run with multi-chunk
    prefill and a mid-flight publish, on both engines over a reduced
    olmoe: the same tokens for every rid."""
    cfg, jcfg = _serve_cfgs()
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: a * ROUTER_SCALE
        if jax.tree_util.keystr(p).endswith("['router']") else a, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    margins = _Margins(monkeypatch)
    port = _reused_slot_scenario(
        lambda **kw: DecodeEngine(cfg, ModelBus(tp), device="cpu", **kw),
        cfg.vocab_size)
    ref = _reused_slot_scenario(lambda **kw: JEngine(jcfg, JBus(jp), **kw),
                                cfg.vocab_size)
    assert port == ref and sorted(port) == [0, 1, 2, 3]

    def staggered(eng, publish):
        for i, p in enumerate(_prompts(4, cfg.vocab_size)):
            eng.submit(p, 6 + 3 * i, rid=i)
        done = eng.step()
        publish()
        return {c.rid: c.tokens for c in done + eng.run()}
    kw = dict(num_slots=3, max_seq=40, scan_chunk=3, prefill_chunk_tokens=4)
    tbus, jbus = ModelBus(tp), JBus(jp)
    port = staggered(DecodeEngine(cfg, tbus, device="cpu", **kw),
                     lambda: tbus.publish(tree_map(lambda a: a * 1.02, tp)))
    ref = staggered(JEngine(jcfg, jbus, **kw),
                    lambda: jbus.publish(jax.tree_util.tree_map(
                        lambda a: a * 1.02, jp)))
    assert port == ref and len(port) == 4
    assert all(len(port[i]) == 6 + 3 * i for i in range(4))
    margins.check()


def test_launch_serve_runs_moe_on_the_cpu(capsys):
    tserve.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                 "--requests", "3", "--prompt-len", "9", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=deepseek-moe-16b-smoke" in out and "12 tokens" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-14b"])
def test_serve_example_runs_on_the_cpu(arch):
    script = ROOT / "examples" / "torch_serve_decode.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(EXAMPLE_SMOKE="1", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), "--arch", arch,
                          "--device", "cpu"], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert f"arch={arch}" in out.stdout and "swaps=1" in out.stdout
    tops = {name.split(".")[0]
            for node in ast.walk(ast.parse(script.read_text()))
            for name in ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])}
    assert "jax" not in tops and "repro" not in tops
