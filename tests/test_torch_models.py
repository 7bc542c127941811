"""The port's dense transformer (``repro_torch.models``) against the JAX
reference (``repro.models``) on the same weights.

The reference initialises its params; they reach the port through numpy
(``convert.params_from_jax``), with the zero-initialised norms and biases
moved off zero first so every scale and bias is exercised.  The four dense
configs run ``.reduced()`` in f32 (qwen3-14b also with two query heads per
KV head, so the grouping is held as well); starcoder2 also runs with an
8-row window so prefill ring-places and decode wraps its ring.

Tolerance: max |port − reference| ≤ 1e-5 · max(1, max |reference|) — both
compute in f32 and differ in summation order (and in the last bits of
``pow``/``cos``/``sin`` for RoPE).  ``jax.nn.gelu`` is the tanh form, so
starcoder2 (gelu) and gemma (geglu) hold the port's activation to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import get_model as j_get_model
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_leaves_with_path
from repro_torch.models import attention as tattn
from repro_torch.models import get_model
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

TOL = 1e-5
# test name -> (config name, overrides of .reduced())
_SPECS = {
    "qwen3": ("qwen3-14b", {}),
    "qwen3-g2": ("qwen3-14b", {"num_kv_heads": 2}),
    "gemma": ("gemma-7b", {}),
    "qwen2.5": ("qwen2.5-32b", {}),
    "starcoder2": ("starcoder2-15b", {}),
    "starcoder2-ring": ("starcoder2-15b", {"sliding_window": 8}),
}
ARCHS = {name: get_config(c).reduced(**o) for name, (c, o) in _SPECS.items()}
_ZERO_INIT = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "bq", "bk", "bv")


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"rel err {err:.3e} > {tol}"


def _jax_cfg(name):
    cfg_name, overrides = _SPECS[name]
    return j_get_config(cfg_name).reduced(**overrides)


_PARAMS = {}


def _params(name):
    """(jax params, torch params) — the reference's init with its zero
    leaves perturbed, carried over through numpy."""
    if name not in _PARAMS:
        jcfg = _jax_cfg(name)
        jp = j_get_model(jcfg).init(jax.random.PRNGKey(1))
        rng = np.random.RandomState(7)

        def perturb(path, a):
            a = np.asarray(a)
            last = jax.tree_util.keystr(path).split("'")[-2]
            if last in _ZERO_INIT:
                a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
            return a
        jp = jax.tree_util.tree_map_with_path(perturb, jp)
        _PARAMS[name] = (jax.tree_util.tree_map(jnp.asarray, jp),
                         params_from_jax(jp, device="cpu"))
    return _PARAMS[name]


def _tokens(B, S, vocab, seed=0):
    t = np.random.RandomState(seed).randint(0, vocab, size=(B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t.astype(np.int32))


# ------------------------------------------------------------------ layers

def test_configs_are_the_references():
    for name in ("qwen3-14b", "gemma-7b", "qwen2.5-32b", "starcoder2-15b",
                 "rwkv6-1.6b", "zamba2-1.2b", "whisper-large-v3",
                 "chameleon-34b"):
        assert get_config(name).__dict__ == j_get_config(name).__dict__
        assert get_config(name).reduced().__dict__ == \
            j_get_config(name).reduced().__dict__
    assert get_config("qwen3_14b") is get_config("qwen3-14b")
    # every config of the reference is ported; an unknown name raises
    assert get_config("whisper-large-v3").family == "audio"
    with pytest.raises(KeyError, match="unknown config 'whisper-large-v2'"):
        get_config("whisper-large-v2")


def test_layers_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 64).astype(np.float32) * 3
    w = rng.randn(64).astype(np.float32) * 0.2
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _close(tlayers.rms_norm(xt, wt, 1e-6), jlayers.rms_norm(x, w, 1e-6))
    for name in ("silu", "gelu", "geglu", "relu"):
        _close(tlayers.activation_fn(name)(xt),
               jlayers.activation_fn(name)(jnp.asarray(x)))
    _close(tlayers.softcap(xt, 2.5), jlayers.softcap(jnp.asarray(x), 2.5))
    assert tlayers.softcap(xt, None) is xt
    _close(tlayers.rope_frequencies(64, 1e6), jlayers.rope_frequencies(64, 1e6))
    # the reference's three position forms: (S,), (1, C) and (B, 1)
    for pos, xs in ((np.arange(5), x),
                    (np.arange(7, 12)[None], x),
                    (np.array([[3], [40]]), x[:, :1])):
        _close(tlayers.apply_rope(torch.from_numpy(xs),
                                  torch.from_numpy(pos), 1e6),
               jlayers.apply_rope(jnp.asarray(xs), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("name", ["qwen3", "gemma", "starcoder2"])
def test_mlp_matches_reference(name):
    jp, tp = _params(name)
    jcfg = _jax_cfg(name)
    x = np.random.RandomState(1).randn(2, 4, jcfg.d_model).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["mlp"])
    tl = {k: v[0] for k, v in tp["blocks"]["mlp"].items()}
    _close(tmlp.mlp_forward(ARCHS[name], tl, torch.from_numpy(x)),
           jmlp.mlp_forward(jcfg, jl, jnp.asarray(x)))


@pytest.mark.parametrize("mode,window,cap", [("causal", None, None),
                                             ("window", 5, None),
                                             ("bidir", None, 4.0)])
def test_naive_and_flash_attention_match_reference(mode, window, cap):
    rng = np.random.RandomState(2)
    B, S, KV, G, hd = 2, 23, 2, 3, 16
    q = rng.randn(B, S, KV * G, hd).astype(np.float32)
    k = rng.randn(B, S, KV, hd).astype(np.float32)
    v = rng.randn(B, S, KV, hd).astype(np.float32)
    pos = np.arange(S)
    kw = dict(mode=mode, window=window, logit_softcap=cap)
    want = jattn.naive_attention(q, k, v, q_positions=jnp.asarray(pos),
                                 k_positions=jnp.asarray(pos), **kw)
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    _close(tattn.naive_attention(*t[:3], q_positions=t[3], k_positions=t[3],
                                 **kw), want)
    # small blocks: several q and k blocks, and padding on both axes
    _close(tattn.flash_attention(*t[:3], q_positions=t[3], k_positions=t[3],
                                 block_q=8, block_k=5, **kw),
           jattn.flash_attention(q, k, v, q_positions=jnp.asarray(pos),
                                 k_positions=jnp.asarray(pos), block_q=8,
                                 block_k=5, **kw))


def test_ring_place_matches_reference():
    x = np.arange(2 * 11 * 2 * 3, dtype=np.float32).reshape(2, 11, 2, 3)
    for cap in (4, 11, 16):
        _close(tattn.ring_place(torch.from_numpy(x), cap),
               jattn.ring_place(jnp.asarray(x), cap))


# ------------------------------------------------------------- transformer

@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_train_matches_reference(name):
    jp, tp = _params(name)
    tj, tt = _tokens(2, 12, ARCHS[name].vocab_size)
    jl, jaux = jtf.forward_train(_jax_cfg(name), jp, tj)
    tl, taux = ttf.forward_train(ARCHS[name], tp, tt)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0
    bundle = get_model(ARCHS[name])
    jloss, _ = j_get_model(_jax_cfg(name)).train_loss(jp, {"tokens": tj})
    tloss, _ = bundle.train_loss(tp, {"tokens": tt})
    _close(tloss, jloss)


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_and_decode_step_match_reference(name):
    """Prefill then three decode steps; with starcoder2-ring the 12-token
    prompt ring-places into 8 rows and decode wraps the ring."""
    jp, tp = _params(name)
    cfg, jcfg = ARCHS[name], _jax_cfg(name)
    tj, tt = _tokens(2, 12, cfg.vocab_size, seed=3)
    jlog, jc = jtf.prefill(jcfg, jp, tj, max_seq=20)
    tlog, tc = ttf.prefill(cfg, tp, tt, max_seq=20)
    _close(tlog, jlog)
    _close(tc.kv.k, jc.kv.k)
    _close(tc.kv.v, jc.kv.v)
    assert tc.position == int(jc.position) == 12
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(3):
        jlog, jc = jtf.decode_step(jcfg, jp, tok, jc)
        tlog, tc = ttf.decode_step(cfg, tp, torch.from_numpy(
            np.array(tok)), tc)
        _close(tlog, jlog)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    _close(tc.kv.k, jc.kv.k)
    _close(tc.kv.v, jc.kv.v)
    assert tc.position == int(jc.position) == 15


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_chunk_and_decode_slots_match_reference(name):
    """Two prefill chunks into slot 1 of an engine cache, then decode steps
    with slots at different depths and slot 2 inactive (its write is
    dropped; its stale position points into slot-1-like rows)."""
    jp, tp = _params(name)
    cfg, jcfg = ARCHS[name], _jax_cfg(name)
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
    _close(tc.kv.k, jc.kv.k)
    _close(tc.kv.v, jc.kv.v)
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


def test_inactive_slots_write_nothing():
    cfg = ARCHS["qwen3"]
    _, tp = _params("qwen3")
    tc = ttf.init_lm_cache(cfg, 3, 16, ring=False, device="cpu")
    torch.manual_seed(0)
    for t in tc.kv:
        t.normal_()
    before = [t.clone() for t in tc.kv]
    positions = torch.tensor([4, 15, 40], dtype=torch.int32)  # 40 is past S
    active = torch.tensor([False, True, True])
    ttf.decode_slots(cfg, tp, torch.tensor([1, 2, 3], dtype=torch.int32), tc,
                     positions, active=active)
    for new, old in zip(tc.kv, before):
        changed = (new != old).flatten(3).any(-1)          # (L, B, S)
        assert changed[:, 1, 15].all()
        changed[:, 1, 15] = False
        assert not changed.any()       # slot 0 inactive, slot 2 past S


def test_dense_bundle_and_unported_families():
    cfg = get_config("qwen3-14b").reduced(num_layers=1, d_model=32,
                                          vocab_size=64)
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    again = bundle.init(0, device="cpu")
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(params),
                                tree_leaves_with_path(again)):
        assert pa == pb and torch.equal(a, b)
    assert params["blocks"]["attn"]["wq"].shape == (1, 32, 4 * 64)
    assert "lm_head" in params and params["lm_head"].shape == (32, 64)
    tied = get_model(get_config("gemma-7b").reduced(num_layers=1))
    assert "lm_head" not in tied.init(1, device="cpu")
    cache = bundle.init_cache(2, 8, device="cpu")
    assert cache.kv.k.shape == (1, 2, 8, 4, 64) and cache.position == 0
    assert bundle.batch_spec(2, 8) == {"tokens": ((2, 8), torch.int32)}
    # activation checkpointing runs and changes no value; an unknown
    # policy raises, as the reference's remat_wrap
    tokens = torch.tensor([[1, 5, 9, 3]], dtype=torch.int32)
    plain = ttf.forward_train(cfg, params, tokens)
    for remat in ("full", "dots", True):
        torch.testing.assert_close(
            ttf.forward_train(cfg, params, tokens, remat=remat), plain,
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown remat policy"):
        ttf.forward_train(cfg, params, tokens, remat="bogus")
    # the vlm and audio families build their bundles now
    # (tests/test_torch_vlm.py and test_torch_encdec.py hold them to the
    # reference); an unknown family still raises, and audio on the
    # decoder-only functions names its module
    for family in ("vlm", "audio"):
        fb = get_model(cfg.with_overrides(family=family, encoder_layers=1,
                                          max_source_positions=8,
                                          num_image_tokens=2))
        assert fb.prefill is not None and fb.decode is not None
        assert "embed" in fb.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="unknown model family"):
        get_model(cfg.with_overrides(family="diffusion"))
    with pytest.raises(NotImplementedError,
                       match="repro_torch.models.encdec"):
        ttf.init_lm(cfg.with_overrides(family="audio"),
                    torch.Generator())
    # the ssm and hybrid families run now (tests/test_torch_recurrent.py
    # holds them to the reference)
    for rec in (get_config("rwkv6-1.6b").reduced(num_layers=1),
                cfg.with_overrides(family="ssm", ssm_state=8),
                cfg.with_overrides(family="hybrid", ssm_state=8,
                                   attn_every=1)):
        rb = get_model(rec)
        logits = rb.forward(rb.init(0, device="cpu"), {"tokens": torch.zeros(
            1, 4, dtype=torch.int32)})
        assert logits.shape == (1, 4, rec.vocab_size)
        assert torch.isfinite(logits).all()
    # the moe family runs now (tests/test_torch_moe.py holds it to the
    # reference)
    moe = get_model(cfg.with_overrides(family="moe", num_experts=4,
                                       experts_per_token=2))
    moe_params = moe.init(0, device="cpu")
    assert "moe" in moe_params["blocks"] and "mlp" not in moe_params["blocks"]
    logits = moe.forward(moe_params, {"tokens": torch.zeros(
        1, 4, dtype=torch.int32)})
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu' (a card is present)")
        bundle.init(0)


def test_decode_past_capacity_refused():
    """Reduced qwen3-14b, a 6-token prompt in a 7-row cache: the step at
    position 6 fills the last row, the next one raises before any write,
    naming the capacity and the position."""
    name = "qwen3"
    _, tp = _params(name)
    cfg = ARCHS[name]
    _, tt = _tokens(2, 6, cfg.vocab_size, seed=4)
    logits, cache = ttf.prefill(cfg, tp, tt, max_seq=7)
    tok = logits.argmax(-1).to(torch.int32)
    _, cache = ttf.decode_step(cfg, tp, tok, cache)
    assert cache.position == 7
    before = [t.clone() for t in cache.kv]
    with pytest.raises(ValueError, match=r"position 7 .*capacity S=7"):
        ttf.decode_step(cfg, tp, tok, cache)
    for t, b in zip(cache.kv, before):
        assert torch.equal(t, b)
    # ring mode (a window at least the capacity) keeps wrapping
    ring = ARCHS["starcoder2-ring"]
    _, rp = _params("starcoder2-ring")
    logits, rc = ttf.prefill(ring, rp, tt, max_seq=7)
    for _ in range(4):
        logits, rc = ttf.decode_step(ring, rp, tok, rc)
    assert rc.position == 10 and torch.isfinite(logits).all()


def test_reference_decode_past_capacity_clamp_recorded():
    """The reference decodes on past max_seq = 7: its ``attention_decode``
    writes with ``dynamic_update_slice``, which clamps the row to S − 1, and
    positions 7, 8 and 9 give finite logits.  This records the reference's
    behaviour the port refuses."""
    name = "qwen3"
    jp, _ = _params(name)
    jcfg = _jax_cfg(name)
    tj, _ = _tokens(2, 6, jcfg.vocab_size, seed=4)
    decode = jax.jit(jtf.decode_step, static_argnums=0)
    logits, cache = jtf.prefill(jcfg, jp, tj, max_seq=7)
    for pos in range(6, 10):
        assert int(cache.position) == pos
        logits, cache = decode(jcfg, jp, jnp.argmax(logits, -1).astype(
            jnp.int32), cache)
        assert np.isfinite(np.asarray(logits)).all()
    assert int(cache.position) == 10


def test_params_from_jax_carries_a_stacked_bf16_tree():
    jcfg = j_get_config("qwen3-14b").reduced(num_layers=2, d_model=32,
                                             vocab_size=64, dtype="bfloat16")
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = tree_leaves_with_path(tp)
    assert len(jleaves) == len(tleaves)
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
