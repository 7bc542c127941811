"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-large-v3,
the audio bundle and the lockstep loop's audio branch) against the JAX
reference (``repro.models.encdec``) on the same weights and inputs.

The reference initialises its params; they reach the port through numpy
(``convert.params_from_jax``), with the zero-initialised norms moved off
zero first so that every one is exercised.  Frames and tokens are numpy
draws from a seed.

Tolerances: f32, max |port − reference| ≤ 1e-5 · max(1, max |reference|):
the same f32 arithmetic summed in other orders.  ``sinusoidal_positions``
at whisper's full width, atol 1e-4: torch's and XLA's ``pow`` differ in the
last bit of 11 of the 640 frequencies at d = 1 280, which a sine of an
angle near 1 500 turns into 3.05e-5 (7.6e-6 at 448 rows); at the reduced
d = 256 the two tables agree within 6e-8.  bf16 whisper, ``BF16_TOL`` =
1.6e-2 of max(1, max |logit|), four bf16 roundings (3.9e-3 each) at the
largest output, as ``tests/test_torch_recurrent.py``'s bf16 cases: both
round every projection and residual to bf16, in other orders (7.1e-3 is
the largest seen).  Greedy tokens are compared only where every step's top-1
logit leads the runner-up by ``MARGIN`` of the logits' scale: no pass
rests on a near tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import encdec as jenc
from repro.models import get_model as j_get_model
from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_leaves, tree_leaves_with_path
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tenc
from repro_torch.models import get_model
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 1.6e-2
MARGIN = 1e-4
_ZERO_INIT = ("ln1", "ln2", "ln_x", "enc_norm", "final_norm", "bq", "bk",
              "bv")
NAME = "whisper-large-v3"
B, S, NEW, MAX_SEQ = 2, 9, 4, 16


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"rel err {err:.3e} > {tol}"


def _margin(logits) -> float:
    a = np.asarray(logits, np.float64).reshape(-1, logits.shape[-1])
    top = -np.sort(-a, axis=-1)[:, :2]
    return float((top[:, 0] - top[:, 1]).min()) / max(1.0, np.abs(a).max())


def _perturbed(jp, seed=7):
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        last = jax.tree_util.keystr(path).split("'")[-2]
        if last in _ZERO_INIT:
            a = (a.astype(np.float32)
                 + 0.1 * rng.randn(*a.shape).astype(np.float32)).astype(
                     a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, jp)


def _weights(cfg_kw=None, seed=1):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = j_get_config(NAME).reduced(**(cfg_kw or {}))
    cfg = get_config(NAME).reduced(**(cfg_kw or {}))
    jp = _perturbed(j_get_model(jcfg).init(jax.random.PRNGKey(seed)))
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, jp),
            params_from_jax(jp, device="cpu"))


def _frames(T, d, dtype=np.float32, seed=3):
    f = np.random.RandomState(seed).randn(B, T, d).astype(np.float32)
    jf = jnp.asarray(f).astype(dtype)
    tf = params_from_jax(np.asarray(jf), device="cpu")
    return jf, tf


def _tokens(vocab, n=S, seed=2):
    t = np.random.RandomState(seed).randint(0, vocab, (B, n))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t.astype(np.int32))


class _J:
    """The reference's entry points, jitted with the config static (its
    eager ``lax.scan`` traces the body again on every call)."""
    encode = staticmethod(jax.jit(jenc.encode, static_argnums=0))
    forward_train = staticmethod(jax.jit(jenc.whisper_forward_train,
                                         static_argnums=0))
    prefill = staticmethod(jax.jit(jenc.whisper_prefill,
                                   static_argnums=(0, 4)))
    decode_step = staticmethod(jax.jit(jenc.whisper_decode_step,
                                       static_argnums=0))


class _T:
    prefill = staticmethod(tenc.whisper_prefill)
    decode_step = staticmethod(tenc.whisper_decode_step)


def _cache_fields(cache):
    return [cache.self_kv.k, cache.self_kv.v, cache.cross_k, cache.cross_v]


def _serve(mod, cfg, params, frames, tokens, steps, max_seq=MAX_SEQ):
    """prefill, then ``steps`` greedy decode steps: (prefill logits, prefill
    cache copies, step logits, tokens fed, the final cache)."""
    logits, cache = mod.prefill(cfg, params, frames, tokens, max_seq)
    first = (logits, [np.array(a) for a in _cache_fields(cache)],
             int(cache.position))
    outs, fed = [], []
    for _ in range(steps):
        if isinstance(logits, torch.Tensor):
            tok = logits.argmax(-1).to(torch.int32)
        else:
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = mod.decode_step(cfg, params, tok, cache)
        outs.append(logits)
    return first, outs, fed, cache


@pytest.fixture(scope="module")
def f32():
    jcfg, cfg, jp, tp = _weights()
    jf, tf = _frames(cfg.max_source_positions, cfg.d_model)
    jt, tt = _tokens(cfg.vocab_size)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jf=jf, tf=tf, jt=jt, tt=tt,
                j=_serve(_J, jcfg, jp, jf, jt, NEW),
                t=_serve(_T, cfg, tp, tf, tt, NEW))


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("n,dim,atol", [(64, 256, 1e-5), (1100, 256, 1e-5),
                                        (448, 1280, 1e-4),
                                        (1500, 1280, 1e-4)])
def test_sinusoidal_positions_match_reference(n, dim, atol):
    got = tlayers.sinusoidal_positions(n, dim)
    want = np.asarray(jlayers.sinusoidal_positions(n, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= atol


@pytest.mark.parametrize("Se", [64, 2100])
def test_cross_attention_forward_matches_reference(f32, Se):
    """Se = 64 takes ``naive_attention``, 2 100 > 2 048 ``flash_attention``
    (mode bidir, unmasked), on both sides."""
    jcfg, cfg = f32["jcfg"], f32["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], f32["jp"]["dec_blocks"])
    tp = {k: v[0] for k, v in f32["tp"]["dec_blocks"]["cross"].items()}
    rng = np.random.RandomState(5)
    x = rng.randn(B, 3, cfg.d_model).astype(np.float32)
    k, v = (rng.randn(B, Se, cfg.num_kv_heads, 64).astype(np.float32)
            for _ in range(2))
    want = jattn.cross_attention_forward(jcfg, jp["cross"], jnp.asarray(x),
                                         jnp.asarray(k), jnp.asarray(v))
    got = tattn.cross_attention_forward(cfg, tp, torch.from_numpy(x),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v))
    _close(got, want)


@pytest.mark.parametrize("T", [64, 1100])
def test_encode_matches_reference(f32, T):
    """T = 64 (the reduced config) runs naive attention, T = 1 100
    (``reduced(max_source_positions=1100)``) the flash path past 1 024."""
    jcfg = j_get_config(NAME).reduced(max_source_positions=T)
    cfg = get_config(NAME).reduced(max_source_positions=T)
    jf, tf = _frames(T, cfg.d_model, seed=4)
    _close(tenc.encode(cfg, f32["tp"], tf), _J.encode(jcfg, f32["jp"], jf))


def test_flash_cross_attention_forward_train_matches_reference():
    """``reduced(max_source_positions=2100)`` end to end: the encoder on
    the flash path, every decoder layer's cross-attention past 2 048."""
    jcfg, cfg, jp, tp = _weights({"max_source_positions": 2100,
                                  "num_layers": 1, "encoder_layers": 1})
    jf, tf = _frames(2100, cfg.d_model, seed=6)
    jt, tt = _tokens(cfg.vocab_size, n=5)
    (jl, _), (tl, _) = (_J.forward_train(jcfg, jp, jf, jt),
                        tenc.whisper_forward_train(cfg, tp, tf, tt))
    _close(tl, jl)


# ------------------------------------------------------------ whole model

def test_whisper_forward_train_matches_reference(f32):
    jl, jaux = _J.forward_train(f32["jcfg"], f32["jp"], f32["jf"], f32["jt"])
    tl, taux = tenc.whisper_forward_train(f32["cfg"], f32["tp"], f32["tf"],
                                          f32["tt"])
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def test_whisper_prefill_matches_reference(f32):
    (jl, jc, jpos), (tl, tc, tpos) = f32["j"][0], f32["t"][0]
    _close(tl, jl)
    assert tpos == jpos == S
    for t, j in zip(tc, jc):
        assert t.dtype == j.dtype == np.float32
        _close(t, j)


def test_whisper_greedy_decode_matches_reference(f32):
    (jfirst, jsteps, jfed, jcache), (_, tsteps, tfed, tcache) = \
        f32["j"], f32["t"]
    for want in [jfirst[0]] + jsteps[:-1]:
        assert _margin(want) >= MARGIN, _margin(want)
    for t, j in zip(tfed, jfed):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tsteps, jsteps):
        _close(t, j)
    for t, j in zip(_cache_fields(tcache), _cache_fields(jcache)):
        _close(t, j)
    assert tcache.position == int(jcache.position) == S + NEW


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
def test_whisper_bf16_promotes_as_the_reference(frames_dtype):
    """A bf16 model: f32 frames (what the serving loop draws) run the
    encoder and the cross K/V in f32, as jnp promotes f32 @ bf16; bf16
    frames keep everything in bf16.  The cache dtypes equal the
    reference's, and the logits agree within ``BF16_TOL``."""
    jcfg, cfg, jp, tp = _weights({"dtype": "bfloat16"})
    np_dt = jnp.float32 if frames_dtype == "float32" else jnp.bfloat16
    jf, tf = _frames(cfg.max_source_positions, cfg.d_model, dtype=np_dt)
    jt, tt = _tokens(cfg.vocab_size)
    jl, jc = _J.prefill(jcfg, jp, jf, jt, MAX_SEQ)
    tl, tc = tenc.whisper_prefill(cfg, tp, tf, tt, MAX_SEQ)
    want = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    assert tc.self_kv.k.dtype == torch.bfloat16
    assert str(jc.self_kv.k.dtype) == "bfloat16"
    assert tc.cross_k.dtype == tc.cross_v.dtype == want[frames_dtype]
    assert str(jc.cross_k.dtype) == frames_dtype
    assert tl.dtype == torch.bfloat16 and str(jl.dtype) == "bfloat16"
    _close(tl, jl, BF16_TOL)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    jd, _ = _J.decode_step(jcfg, jp, tok, jc)
    td, _ = tenc.whisper_decode_step(cfg, tp, torch.from_numpy(
        np.array(tok)), tc)
    _close(td, jd, BF16_TOL)


def test_param_tree_is_the_references():
    jcfg = j_get_config(NAME).reduced()
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tp = get_model(get_config(NAME).reduced()).init(0, device="cpu")
    want = [("/".join(str(k.key) for k in path), a.shape, str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(jp)]
    got = [(path, tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for path, a in tree_leaves_with_path(tp)]
    assert got == want
    assert tp["enc_blocks"]["attn"]["wq"].shape[0] == jcfg.encoder_layers
    assert tp["dec_blocks"]["cross"]["wk"].shape[0] == jcfg.num_layers


def test_bundle_matches_the_references(f32):
    """``get_model``'s audio bundle: batch_spec, forward, the loss."""
    jb, tb = jreg.get_model(f32["jcfg"]), get_model(f32["cfg"])
    assert tb.init_cache is None and jb.init_cache is None
    for cfg_kw in ({}, {"dtype": "bfloat16"}):
        jspec = jreg.get_model(j_get_config(NAME).reduced(
            **cfg_kw)).batch_spec(3, 5)
        tspec = get_model(get_config(NAME).reduced(**cfg_kw)).batch_spec(3, 5)
        assert {k: (s, str(d).replace("torch.", "")) for k, (s, d)
                in tspec.items()} == {k: (s, jnp.dtype(d).name) for k, (s, d)
                                      in jspec.items()}
    jbatch = {"frames": f32["jf"], "tokens": f32["jt"]}
    tbatch = {"frames": f32["tf"], "tokens": f32["tt"]}
    _close(tb.forward(f32["tp"], tbatch), jb.forward(f32["jp"], jbatch))
    jloss, _ = jax.jit(lambda p, b: jb.train_loss(p, b))(f32["jp"], jbatch)
    tloss, _ = tb.train_loss(f32["tp"], tbatch)
    _close(tloss, jloss)
    # activation checkpointing of the encoder's and the decoder's layers
    # runs and changes no value
    plain = tenc.whisper_forward_train(f32["cfg"], f32["tp"], f32["tf"],
                                       f32["tt"])
    torch.testing.assert_close(
        tenc.whisper_forward_train(f32["cfg"], f32["tp"], f32["tf"],
                                   f32["tt"], remat="full"), plain,
        rtol=0, atol=0)


# ------------------------------------------- decode past the cache's rows

def test_decode_past_capacity_refused(f32):
    """At position S_max the port raises, naming the capacity and the
    position, before anything is written."""
    cfg, tp = f32["cfg"], f32["tp"]
    _, cache = tenc.whisper_prefill(cfg, tp, f32["tf"], f32["tt"][:, :6], 7)
    tok = f32["tt"][:, 0]
    _, cache = tenc.whisper_decode_step(cfg, tp, tok, cache)   # row 6
    assert cache.position == 7
    before = [t.clone() for t in _cache_fields(cache)]
    with pytest.raises(ValueError, match=r"position 7 .*capacity S=7"):
        tenc.whisper_decode_step(cfg, tp, tok, cache)
    for t, b in zip(_cache_fields(cache), before):
        assert torch.equal(t, b)


def test_reference_decode_past_capacity_clamp_recorded(f32):
    """The reference decodes on past S_max = 7: ``dynamic_slice_in_dim``
    clamps its position row and ``dynamic_update_slice`` its K/V write onto
    row 6, and positions 7, 8 and 9 give finite logits.  This records the
    reference's behaviour the port refuses."""
    jcfg, jp = f32["jcfg"], f32["jp"]
    _, cache = _J.prefill(jcfg, jp, f32["jf"], f32["jt"][:, :6], 7)
    tok = f32["jt"][:, 0]
    for pos in range(6, 10):
        assert int(cache.position) == pos
        logits, cache = _J.decode_step(jcfg, jp, tok, cache)
        assert np.isfinite(np.asarray(logits)).all()
    assert int(cache.position) == 10


# ------------------------------------------------- checkpoints and serving

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_checkpoint_both_ways(tmp_path, dtype):
    """A reduced whisper tree written by one package loads in the other:
    the same leaf names, bitwise values."""
    jcfg = j_get_config(NAME).reduced(dtype=dtype)
    jp = _perturbed(j_get_model(jcfg).init(jax.random.PRNGKey(4)))
    tp = params_from_jax(jp, device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "port"), 1, tp)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                          jax.tree_util.tree_map(jnp.asarray, jp))
    names = {side: np.load(tmp_path / side / "00000001.ckpt.npz").files
             for side in ("port", "ref")}
    assert sorted(names["port"]) == sorted(names["ref"])
    assert len(names["port"]) == len(tree_leaves(tp))
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


def test_launch_serve_runs_whisper(capsys):
    tserve.main(["--arch", NAME, "--device", "cpu", "--prompt-len", "12",
                 "--new-tokens", "4", "--batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={NAME}-smoke device=cpu batch=2 "
                             "prompt=12 new=4")
    assert out[1].startswith("prefill: ") and "tok/s" in out[1]
    first = out[2].split(": ", 1)
    assert first[0] == "first sequence" and len(eval(first[1])) == 4


def test_lockstep_prompt_and_loop_for_audio():
    """The lockstep batch dict carries f32 frames (B, max_source_positions,
    d) after the tokens, from one generator seeded 0; the loop's tokens are
    prefill then each decode step's argmax."""
    cfg = get_config(NAME).reduced(dtype="bfloat16")
    prompt = tserve.lockstep_prompt(cfg, 2, 11, torch.device("cpu"))
    assert sorted(prompt) == ["frames", "tokens"]
    assert prompt["tokens"].dtype == torch.int32
    assert prompt["frames"].dtype == torch.float32
    assert prompt["frames"].shape == (2, cfg.max_source_positions,
                                      cfg.d_model)
    again = tserve.lockstep_prompt(cfg, 2, 11, torch.device("cpu"))
    assert all(torch.equal(prompt[k], again[k]) for k in prompt)
    assert tserve.lockstep_max_seq(cfg, 11, 4) == 15
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    run = tserve.lockstep(bundle, params, prompt, 4, 15)
    assert run.tokens.shape == (2, 4)
    logits, cache = bundle.prefill(params, prompt, 15)
    assert cache.cross_k.dtype == torch.float32
    for t in range(4):
        torch.testing.assert_close(run.logits[:, t], logits, rtol=0, atol=0)
        tok = logits.argmax(-1).to(torch.int32)
        assert torch.equal(run.tokens[:, t], tok)
        logits, cache = bundle.decode(params, tok, cache)
