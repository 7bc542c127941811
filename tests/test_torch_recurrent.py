"""The port's recurrent families (``repro_torch.models.rwkv``, ``.ssd``, the
``ssm`` and ``hybrid`` branches of the transformer, rwkv6-1.6b and
zamba2-1.2b, the lockstep serving loop) against the JAX reference on the
same weights and inputs.

The reference initialises its params; they reach the port through numpy
(``convert.params_from_jax``), with the zero-initialised norms, biases and
``dt_bias`` moved off zero first so that every one is exercised.  Inputs are
numpy draws from a seed.

Tolerances: f32, max |port − reference| ≤ 1e-5 · max(1, max |reference|):
the same f32 arithmetic summed in other orders (the scans' einsums, the
cumulative sums).  bf16 layers, 1.6e-2 · max(1, max |reference|), four bf16
roundings (3.9e-3 each) at the largest output: both round every projection,
mix and gate to bf16, the port op by op and XLA after fusing some of them
in f32 (8.8e-3 is the largest seen).  The
port's own invariants (chunked = stepwise, state carry = one pass) hold at
the reference's own tolerance for them, rtol = atol = 2e-3
(``tests/test_model_numerics.py``).  Greedy tokens are compared only where
every step's top-1 logit leads the runner-up by ``MARGIN`` of the logits'
scale, far above the 1e-5 the two packages may differ by: no pass rests on
a near tie.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.models import ssd as jssd
from repro.models import transformer as jtf
from repro.models.config import ArchConfig as JArchConfig
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_leaves, tree_leaves_with_path
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssd as tssd
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ArchConfig

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 1.6e-2
INVARIANT_TOL = 2e-3
MARGIN = 1e-4
_ZERO_INIT = ("ln1", "ln2", "final_norm", "norm", "conv_b", "ln_x_b",
              "dt_bias", "bq", "bk", "bv")


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"rel err {err:.3e} > {tol}"


def _perturbed(tree, seed=7):
    """The reference's tree as numpy, its zero-initialised leaves moved off
    zero."""
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).split("'")[-2] in _ZERO_INIT:
            a = a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _layer(init, cfg, dtype=jnp.float32, seed=0):
    """(reference params, port params) of one layer."""
    jp = _perturbed(init(cfg, jax.random.PRNGKey(seed), dtype))
    return (jax.tree_util.tree_map(jnp.asarray, jp),
            params_from_jax(jp, device="cpu"))


def _x(shape, seed=1, dtype=np.float32):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _rwkv_cfgs(**kw):
    spec = dict(name="t", family="ssm", rwkv=True, num_layers=1, d_model=64,
                d_ff=128, vocab_size=64, rwkv_head_dim=16, ssm_chunk=128,
                dtype="float32")       # wkv chunk 32
    spec.update(kw)
    return JArchConfig(**spec), ArchConfig(**spec)


def _ssm_cfgs(chunk=8, **kw):
    spec = dict(name="t", family="ssm", num_layers=1, d_model=32, d_ff=64,
                vocab_size=64, ssm_state=8, ssm_head_dim=16, ssm_chunk=chunk,
                dtype="float32")
    spec.update(kw)
    return JArchConfig(**spec), ArchConfig(**spec)


def _rwkv_state(jcfg, B, seed):
    """A random RWKVState, as (reference, port)."""
    rng = np.random.RandomState(seed)
    H, P, d = jcfg.rwkv_num_heads, jcfg.rwkv_head_dim, jcfg.d_model
    parts = (rng.randn(B, d), rng.randn(B, H, P, P) * 0.3, rng.randn(B, d))
    parts = [a.astype(np.float32) for a in parts]
    return (jrwkv.RWKVState(*map(jnp.asarray, parts)),
            trwkv.RWKVState(*map(torch.from_numpy, parts)))


def _ssm_state(jcfg, B, seed):
    rng = np.random.RandomState(seed)
    conv_ch = jcfg.ssm_d_inner + 2 * jcfg.ssm_state
    parts = (rng.randn(B, jcfg.ssm_conv_width - 1, conv_ch),
             rng.randn(B, jcfg.ssm_num_heads, jcfg.ssm_head_dim,
                       jcfg.ssm_state) * 0.3)
    parts = [a.astype(np.float32) for a in parts]
    return (jssd.SSMState(*map(jnp.asarray, parts)),
            tssd.SSMState(*map(torch.from_numpy, parts)))


@functools.lru_cache(maxsize=None)
def _jit(fn):
    """A reference layer function jitted with its config static (eager, its
    ops and ``lax.scan`` compile one by one on every call)."""
    return jax.jit(fn, static_argnums=0)


def _close_state(got, want, tol=TOL):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        _close(g, w, tol)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 96) * 4 + 2).astype(np.float32)
    w, b = rng.randn(96).astype(np.float32), rng.randn(96).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    got = tlayers.layer_norm(torch.from_numpy(x).to(td),
                             torch.from_numpy(w).to(td),
                             torch.from_numpy(b).to(td), 1e-5)
    want = jlayers.layer_norm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                              jnp.asarray(b, jd), 1e-5)
    assert got.dtype == td
    # the same f32 arithmetic, one final rounding to the dtype
    _close(got, want, TOL if dtype == "float32" else 2 ** -8)


def test_softplus_within_f32_rounding_of_jax():
    """``F.softplus`` (linear above 20) against ``jax.nn.softplus``
    (``logaddexp(x, 0)``) over the range a dt can take, the cut-off
    included: within two f32 ulps of the value, 2e-7 of it, far inside the
    1e-5 parity tolerance (the two libraries' exp and log1p differ by as
    much: ``logaddexp``'s own formula written in torch is 2 ulps off too)."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [19.99, 20.0, 20.01, 88.0]]).astype(np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= 2 * ulp), float(
        np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("S", [21, 45], ids=["one_chunk", "two_chunks"])
@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "state"])
def test_rwkv6_forward_matches_reference(S, carried):
    jcfg, cfg = _rwkv_cfgs()
    jp, tp = _layer(jrwkv.init_rwkv6, jcfg)
    jx, tx = _x((2, S, cfg.d_model))
    js, ts = _rwkv_state(jcfg, 2, 3) if carried else (None, None)
    jy, jst = _jit(jrwkv.rwkv6_forward)(jcfg, jp, jx, js)
    ty, tst = trwkv.rwkv6_forward(cfg, tp, tx, ts)
    _close(ty, jy)
    _close_state(tst, jst)


def test_rwkv6_decode_matches_reference():
    jcfg, cfg = _rwkv_cfgs()
    jp, tp = _layer(jrwkv.init_rwkv6, jcfg)
    js, ts = _rwkv_state(jcfg, 3, 4)
    jx, tx = _x((3, 1, cfg.d_model), seed=5)
    for _ in range(3):
        jy, js = _jit(jrwkv.rwkv6_decode)(jcfg, jp, jx, js)
        ty, ts = trwkv.rwkv6_decode(cfg, tp, tx, ts)
        _close(ty, jy)
        _close_state(ts, js)
        jx, tx = jy, ty


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mamba2_forward_carries_the_conv_window(chunk):
    """Two segments (13 then 10 tokens), the second from the first's state:
    y and the final states of both against the reference."""
    jcfg, cfg = _ssm_cfgs(chunk)
    jp, tp = _layer(jssd.init_mamba2, jcfg)
    jx, tx = _x((2, 23, cfg.d_model))
    jy1, js = _jit(jssd.mamba2_forward)(jcfg, jp, jx[:, :13])
    ty1, ts = tssd.mamba2_forward(cfg, tp, tx[:, :13])
    _close(ty1, jy1)
    _close_state(ts, js)
    jy2, js = _jit(jssd.mamba2_forward)(jcfg, jp, jx[:, 13:], js)
    ty2, ts = tssd.mamba2_forward(cfg, tp, tx[:, 13:], ts)
    _close(ty2, jy2)
    _close_state(ts, js)


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "state"])
def test_mamba2_short_prompt_matches_reference(S, carried):
    """Prompts shorter than the conv window: the zero pad of the conv tail
    (no state) or the carried window (a state)."""
    jcfg, cfg = _ssm_cfgs(8)
    jp, tp = _layer(jssd.init_mamba2, jcfg)
    jx, tx = _x((2, S, cfg.d_model), seed=S)
    js, ts = _ssm_state(jcfg, 2, 6) if carried else (None, None)
    jy, jst = _jit(jssd.mamba2_forward)(jcfg, jp, jx, js)
    ty, tst = tssd.mamba2_forward(cfg, tp, tx, ts)
    _close(ty, jy)
    _close_state(tst, jst)


def test_mamba2_decode_matches_reference():
    jcfg, cfg = _ssm_cfgs(8)
    jp, tp = _layer(jssd.init_mamba2, jcfg)
    js, ts = _ssm_state(jcfg, 3, 2)
    jx, tx = _x((3, 1, cfg.d_model), seed=9)
    for _ in range(3):
        jy, js = _jit(jssd.mamba2_decode)(jcfg, jp, jx, js)
        ty, ts = tssd.mamba2_decode(cfg, tp, tx, ts)
        _close(ty, jy)
        _close_state(ts, js)
        jx, tx = jy, ty


@pytest.mark.parametrize("block", ["rwkv6", "mamba2"])
def test_bf16_layer_matches_reference(block):
    """One bf16 layer over 37 tokens (across chunks), then a decode step
    from its state, at ``BF16_TOL``: the model dtype through the whole
    layer, the scans and f32 leaves as the reference keeps them."""
    if block == "rwkv6":
        jcfg, cfg = _rwkv_cfgs(dtype="bfloat16")
        mod, tmod, init = jrwkv, trwkv, jrwkv.init_rwkv6
        fwd, dec = "rwkv6_forward", "rwkv6_decode"
    else:
        jcfg, cfg = _ssm_cfgs(16, dtype="bfloat16")
        mod, tmod, init = jssd, tssd, jssd.init_mamba2
        fwd, dec = "mamba2_forward", "mamba2_decode"
    jp, tp = _layer(init, jcfg, jnp.bfloat16)
    assert {str(a.dtype) for a in tree_leaves(tp)} == {"torch.bfloat16",
                                                       "torch.float32"}
    jx, tx = _x((2, 38, cfg.d_model), dtype=jnp.bfloat16)
    jy, js = _jit(getattr(mod, fwd))(jcfg, jp, jx[:, :37])
    ty, ts = getattr(tmod, fwd)(cfg, tp, tx[:, :37])
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, BF16_TOL)
    _close_state(ts, js, BF16_TOL)
    jy, js = _jit(getattr(mod, dec))(jcfg, jp, jx[:, 37:], js)
    ty, ts = getattr(tmod, dec)(cfg, tp, tx[:, 37:], ts)
    _close(ty, jy, BF16_TOL)
    _close_state(ts, js, BF16_TOL)


# ------------------------------------------- the port's own invariants

def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _stepwise(step, cfg, params, x, state):
    ys = []
    for t in range(x.shape[1]):
        y, state = step(cfg, params, x[:, t:t + 1], state)
        ys.append(y)
    return torch.cat(ys, 1), state


@pytest.mark.parametrize("block", ["rwkv6", "mamba2-4", "mamba2-8",
                                   "mamba2-16"])
def test_chunked_matches_stepwise(block):
    """Full-sequence chunked forward == the token-by-token recurrence, on
    the port's own init."""
    if block == "rwkv6":
        cfg = _rwkv_cfgs(d_model=32, rwkv_head_dim=16, ssm_chunk=64)[1]
        params = trwkv.init_rwkv6(cfg, _gen(), torch.float32)
        fwd, step = trwkv.rwkv6_forward, trwkv.rwkv6_decode
        state = trwkv.init_rwkv_state(cfg, 2, torch.float32)
        S = 21
    else:
        cfg = _ssm_cfgs(int(block.split("-")[1]))[1]
        params = tssd.init_mamba2(cfg, _gen(), torch.float32)
        fwd, step = tssd.mamba2_forward, tssd.mamba2_decode
        state = tssd.init_ssm_state(cfg, 2, torch.float32)
        S = 20
    x = torch.randn((2, S, cfg.d_model), generator=_gen(1))
    y_full, final = fwd(cfg, params, x)
    y_step, stepped = _stepwise(step, cfg, params, x, state)
    torch.testing.assert_close(y_full, y_step, rtol=INVARIANT_TOL,
                               atol=INVARIANT_TOL)
    for a, b in zip(final, stepped):
        torch.testing.assert_close(a, b, rtol=INVARIANT_TOL,
                                   atol=INVARIANT_TOL)


@pytest.mark.parametrize("block", ["rwkv6", "mamba2"])
def test_state_carry_equals_one_pass(block):
    """forward(x[:10]) then forward(x[10:], state) == forward(x): the
    prefill-then-continue invariant."""
    if block == "rwkv6":
        cfg = _rwkv_cfgs(d_model=32, rwkv_head_dim=16, ssm_chunk=64)[1]
        params = trwkv.init_rwkv6(cfg, _gen(3), torch.float32)
        fwd = trwkv.rwkv6_forward
    else:
        cfg = _ssm_cfgs(8)[1]
        params = tssd.init_mamba2(cfg, _gen(3), torch.float32)
        fwd = tssd.mamba2_forward
    x = torch.randn((1, 24, cfg.d_model), generator=_gen(4))
    y_all, st_all = fwd(cfg, params, x)
    y1, st = fwd(cfg, params, x[:, :10])
    y2, st = fwd(cfg, params, x[:, 10:], st)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all,
                               rtol=INVARIANT_TOL, atol=INVARIANT_TOL)
    for a, b in zip(st, st_all):
        torch.testing.assert_close(a, b, rtol=INVARIANT_TOL,
                                   atol=INVARIANT_TOL)


# ------------------------------------------------------------ whole models

MODELS = {
    "rwkv6": lambda get: get("rwkv6-1.6b").reduced(ssm_chunk=64),
    "zamba2": lambda get: get("zamba2-1.2b").reduced(num_layers=5),
    "mamba2": lambda get: (JArchConfig if get is j_get_config
                           else ArchConfig)(
        name="mamba2-ssm", family="ssm", num_layers=2, d_model=32, d_ff=64,
        vocab_size=64, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
        dtype="float32"),
}
B, S, NEW, MAX_SEQ = 2, 37, 4, 48


def _margin(logits) -> float:
    """Smallest gap between a row's top-1 and top-2 logit, over the scale
    max(1, max |logit|)."""
    a = np.asarray(logits, np.float64).reshape(-1, logits.shape[-1])
    top = -np.sort(-a, axis=-1)[:, :2]
    return float((top[:, 0] - top[:, 1]).min()) / max(1.0, np.abs(a).max())


def _cache_leaves(cache):
    """The cache's tensors in a fixed order (None fields skipped)."""
    out = []
    for field in (cache.kv, cache.ssm, cache.shared_kv):
        if field is not None:
            out.extend(field)
    return out


class _J_REF:
    """The reference's entry points, jitted once per config (its eager
    ``lax.scan`` traces its body again on every call)."""
    forward_train = staticmethod(jax.jit(jtf.forward_train,
                                         static_argnums=0))
    prefill = staticmethod(jax.jit(jtf.prefill, static_argnums=(0, 3)))
    decode_step = staticmethod(jax.jit(jtf.decode_step, static_argnums=0))


@pytest.fixture(scope="module")
def model_runs():
    """Per model: the reference's and the port's forward_train logits,
    prefill logits and cache, and NEW greedy decode steps (each package
    feeding its own argmax), from the reference's perturbed weights."""
    runs = {}
    for name, make in MODELS.items():
        jcfg, cfg = make(j_get_config), make(get_config)
        jp = _perturbed(j_get_model(jcfg).init(jax.random.PRNGKey(1)))
        tp = params_from_jax(jp, device="cpu")
        jp = jax.tree_util.tree_map(jnp.asarray, jp)
        toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S))
        jt = jnp.asarray(toks, jnp.int32)
        tt = torch.from_numpy(toks.astype(np.int32))
        out = {"j": {}, "t": {}}
        out["j"]["train"] = _J_REF.forward_train(jcfg, jp, jt)
        out["t"]["train"] = ttf.forward_train(cfg, tp, tt)
        for side, mod, c, p, t in (("j", _J_REF, jcfg, jp, jt),
                                   ("t", ttf, cfg, tp, tt)):
            logits, cache = mod.prefill(c, p, t, MAX_SEQ)
            rec = out[side]
            # the port writes its cache in place: keep the prefill's
            rec["prefill"] = (logits, [np.array(a) for a in
                                       _cache_leaves(cache)])
            steps, tokens = [], []
            for _ in range(NEW):
                if side == "j":
                    tok = jnp.argmax(logits, -1).astype(jnp.int32)
                else:
                    tok = logits.argmax(-1).to(torch.int32)
                tokens.append(np.asarray(tok))
                logits, cache = mod.decode_step(c, p, tok, cache)
                steps.append(logits)
            rec["steps"], rec["tokens"] = steps, tokens
            rec["cache"] = _cache_leaves(cache)
            rec["position"] = int(cache.position)
        runs[name] = out
    return runs


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_train_matches_reference(model_runs, name):
    (jl, jaux), (tl, taux) = (model_runs[name]["j"]["train"],
                              model_runs[name]["t"]["train"])
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_matches_reference(model_runs, name):
    (jl, jc), (tl, tc) = (model_runs[name]["j"]["prefill"],
                          model_runs[name]["t"]["prefill"])
    _close(tl, jl)
    assert len(tc) == len(jc)
    for t, j in zip(tc, jc):
        _close(t, j)


@pytest.mark.parametrize("name", list(MODELS))
def test_greedy_decode_matches_reference(model_runs, name):
    jr, tr = model_runs[name]["j"], model_runs[name]["t"]
    for want in [jr["prefill"][0]] + jr["steps"][:-1]:
        assert _margin(want) >= MARGIN, _margin(want)
    for t, j in zip(tr["tokens"], jr["tokens"]):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tr["steps"], jr["steps"]):
        _close(t, j)
    for t, j in zip(tr["cache"], jr["cache"]):
        _close(t, j)
    assert tr["position"] == jr["position"] == S + NEW


@pytest.mark.parametrize("name", list(MODELS))
def test_param_tree_is_the_references(name):
    """The port's own init gives the reference's keys, shapes and dtypes
    (the hybrid's (n_groups, attn_every) stack, its remainder layers and
    the shared block included)."""
    jcfg, cfg = MODELS[name](j_get_config), MODELS[name](get_config)
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tp = get_model(cfg).init(0, device="cpu")
    want = [("/".join(str(k.key) for k in path), a.shape, str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(jp)]
    got = [(path, tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for path, a in tree_leaves_with_path(tp)]
    assert got == want
    if name == "zamba2":
        assert tp["blocks"]["mamba"]["in_proj"].shape[:2] == (2, 2)
        assert tp["blocks_rem"]["ln1"].shape == (1, cfg.d_model)
        assert set(tp["shared_attn"]) == {"ln1", "ln2", "attn", "mlp"}


def test_families_and_cache_layout():
    """The ssm / hybrid caches: states stacked over num_layers (the
    remainder layers at the tail), one shared_kv slice per group; the slot
    entry points keep raising for caches without kv."""
    cfg = get_config("zamba2-1.2b").reduced(num_layers=5)
    cache = ttf.init_lm_cache(cfg, 2, 16, device="cpu")
    assert cache.kv is None and isinstance(cache.ssm, tssd.SSMState)
    assert cache.ssm.ssm.shape == (5, 2, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state)
    assert cache.ssm.ssm.dtype == torch.float32
    assert cache.shared_kv.k.shape == (2, 2, 16, cfg.num_kv_heads,
                                       cfg.resolved_head_dim)
    rw = get_config("rwkv6-1.6b").reduced()
    rcache = get_model(rw).init_cache(3, 8, device="cpu")
    assert isinstance(rcache.ssm, trwkv.RWKVState)
    assert rcache.ssm.wkv.shape == (2, 3, rw.rwkv_num_heads,
                                    rw.rwkv_head_dim, rw.rwkv_head_dim)
    params = get_model(cfg).init(0, device="cpu")
    tok = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="KV-cache family"):
        ttf.decode_slots(cfg, params, tok, cache, tok)
    with pytest.raises(ValueError, match="KV-cache family"):
        ttf.prefill_chunk(cfg, params, tok, cache, 0, 0)
    # the vlm and audio families build their bundles now; an unknown
    # family still raises, and the decoder-only prefill names encdec for
    # audio
    for family in ("vlm", "audio"):
        fb = get_model(cfg.with_overrides(family=family, encoder_layers=1,
                                          num_image_tokens=2))
        assert fb.prefill is not None and fb.batch_spec(1, 4)
    with pytest.raises(NotImplementedError, match="unknown model family"):
        get_model(cfg.with_overrides(family="bogus"))
    with pytest.raises(NotImplementedError,
                       match="repro_torch.models.encdec"):
        ttf.prefill(cfg.with_overrides(family="audio"), params, tok[None],
                    4)


# --------------------------------------------------- checkpoints and serve

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_checkpoint_both_ways(tmp_path, dtype):
    """A reduced zamba2 (2 groups and a remainder layer) written by one
    package loads in the other: the same leaf names, bitwise values."""
    jcfg = j_get_config("zamba2-1.2b").reduced(num_layers=5, dtype=dtype)
    jp = _perturbed(j_get_model(jcfg).init(jax.random.PRNGKey(4)))
    tp = params_from_jax(jp, device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "port"), 1, tp)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                          jax.tree_util.tree_map(jnp.asarray, jp))
    for side in ("port", "ref"):
        names = np.load(tmp_path / side / "00000001.ckpt.npz").files
        assert len(names) == len(tree_leaves(tp))
    like_j = j_get_model(jcfg).init(jax.random.PRNGKey(5))
    like_t = params_from_jax(jax.tree_util.tree_map(np.asarray, like_j),
                             device="cpu")
    back_j, _ = jckpt.load_checkpoint(str(tmp_path / "port"), 1, like_j)
    back_t, _ = tckpt.load_checkpoint(str(tmp_path / "ref"), 1, like_t)
    want = jax.tree_util.tree_leaves_with_path(jp)
    got_j = jax.tree_util.tree_leaves_with_path(back_j)
    assert [jax.tree_util.keystr(p) for p, _ in got_j] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, w) in zip(got_j, want):
        assert np.asarray(a).dtype == w.dtype
        assert np.asarray(a).tobytes() == w.tobytes()
    for t, (_, w) in zip(tree_leaves(back_t), want):
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert bits.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_launch_serve_runs_the_lockstep_loop(arch, capsys):
    tserve.main(["--arch", arch, "--device", "cpu", "--prompt-len", "20",
                 "--new-tokens", "5", "--batch", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-smoke device=cpu batch=3 "
                             "prompt=20 new=5")
    assert out[1].startswith("prefill: ") and "tok/s" in out[1]
    first = out[2].split(": ", 1)
    assert first[0] == "first sequence" and len(eval(first[1])) == 5


def test_lockstep_equals_prefill_then_decode():
    """``lockstep`` is the reference loop: its tokens are the greedy
    argmax of prefill then each decode step, every row yields new_tokens,
    and the logits it returns are the ones each token came from."""
    cfg = get_config("zamba2-1.2b").reduced(num_layers=3)
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    batch = tserve.lockstep_prompt(cfg, 2, 11, torch.device("cpu"))
    assert list(batch) == ["tokens"]       # no frames or image embeddings
    prompt = batch["tokens"]
    assert prompt.dtype == torch.int32 and prompt.shape == (2, 11)
    assert torch.equal(prompt, tserve.lockstep_prompt(
        cfg, 2, 11, torch.device("cpu"))["tokens"])
    assert tserve.lockstep_max_seq(cfg, 11, 4) == 15
    run = tserve.lockstep(bundle, params, batch, 4, 15)
    assert run.tokens.shape == (2, 4) and run.logits.shape == (2, 4, 512)
    logits, cache = ttf.prefill(cfg, params, prompt, 15)
    for t in range(4):
        torch.testing.assert_close(run.logits[:, t], logits, rtol=0, atol=0)
        tok = logits.argmax(-1).to(torch.int32)
        assert torch.equal(run.tokens[:, t], tok)
        logits, cache = ttf.decode_step(cfg, params, tok, cache)


def test_unported_families_still_raise(capsys):
    """whisper-large-v3 and chameleon-34b serve now through the lockstep
    loop; an unknown arch name or family still raises."""
    for name in ("whisper-large-v3", "chameleon-34b"):
        tserve.main(["--arch", name, "--device", "cpu", "--prompt-len", "6",
                     "--new-tokens", "3", "--batch", "1"])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith(f"arch={name}-smoke device=cpu batch=1")
    with pytest.raises(KeyError, match="unknown config"):
        tserve.main(["--arch", "whisper-tiny", "--device", "cpu"])
    for family in ("vlm", "audio"):
        assert get_model(ArchConfig(name="m", family=family)).decode \
            is not None
    with pytest.raises(NotImplementedError, match="unknown model family"):
        get_model(ArchConfig(name="m", family="bogus"))
