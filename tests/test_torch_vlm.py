"""The port's early-fusion VLM (``repro_torch.models.vlm``, chameleon-34b, the
vlm bundle and the lockstep loop's vlm branch) against the JAX reference
(``repro.models.vlm``) on the same weights and inputs.

The reference initialises its params; they reach the port through numpy
(``convert.params_from_jax``), with the zero-initialised norms (qk-norm
included) moved off zero first.  Image embeddings and tokens are numpy
draws from a seed.

Tolerance: f32, max |port − reference| ≤ 1e-5 · max(1, max |reference|):
the same f32 arithmetic summed in other orders.  The K cache of the
1 030-image-token prefill, ``ROPE_TOL`` = 5e-5: its RoPE angles reach
1 035 rad, where the reference's compiled sin/cos (XLA fuses them inside
``lax.scan``'s body) put a rotated row 1.1e-5 of max |x| off an f64 RoPE
(the port 7.0e-8, eager jnp 8.7e-8); the K rows differ by 1.26e-5 of
max |k|, the logits by 3.3e-6.  The port's own decode =
forward check keeps ``tests/test_arch_smoke.py``'s rtol = atol = 5e-3.
Greedy tokens are compared only where every step's top-1 logit leads the
runner-up by ``MARGIN`` of the logits' scale: no pass rests on a near tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro.models import vlm as jvlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import tree_leaves_with_path
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.models import vlm as tvlm

torch.set_num_threads(1)

TOL = 1e-5
ROPE_TOL = 5e-5
MARGIN = 1e-4
_ZERO_INIT = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
NAME = "chameleon-34b"
B, S, NEW = 2, 9, 4


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


def _weights(cfg_kw=None, seed=1):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = j_get_config(NAME).reduced(**(cfg_kw or {}))
    cfg = get_config(NAME).reduced(**(cfg_kw or {}))
    rng = np.random.RandomState(7)

    def perturb(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).split("'")[-2] in _ZERO_INIT:
            a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a
    jp = jax.tree_util.tree_map_with_path(
        perturb, j_get_model(jcfg).init(jax.random.PRNGKey(seed)))
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, jp),
            params_from_jax(jp, device="cpu"))


def _inputs(cfg, n=S, seed=2):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, cfg.vocab_size, (B, n))
    img = rng.randn(B, cfg.num_image_tokens, cfg.d_model).astype(np.float32)
    return (jnp.asarray(t, jnp.int32), jnp.asarray(img),
            torch.from_numpy(t.astype(np.int32)), torch.from_numpy(img))


class _J:
    """The reference's entry points, jitted with the config static."""
    forward_train = staticmethod(jax.jit(jvlm.vlm_forward_train,
                                         static_argnums=0))
    prefill = staticmethod(jax.jit(jvlm.vlm_prefill, static_argnums=(0, 4)))
    decode_step = staticmethod(jax.jit(jtf.decode_step, static_argnums=0))


class _T:
    forward_train = staticmethod(tvlm.vlm_forward_train)
    prefill = staticmethod(tvlm.vlm_prefill)
    decode_step = staticmethod(tvlm.vlm_decode_step)


def _serve(mod, cfg, params, tokens, img, steps, max_seq):
    logits, cache = mod.prefill(cfg, params, tokens, img, max_seq)
    first = (logits, np.array(cache.kv.k), np.array(cache.kv.v),
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
    jt, jimg, tt, timg = _inputs(cfg)
    max_seq = cfg.num_image_tokens + S + NEW
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jt=jt, jimg=jimg, tt=tt,
                timg=timg,
                j=_serve(_J, jcfg, jp, jt, jimg, NEW, max_seq),
                t=_serve(_T, cfg, tp, tt, timg, NEW, max_seq))


def test_fuse_matches_reference(f32):
    got = tvlm._fuse(f32["cfg"], f32["tp"], f32["tt"], f32["timg"])
    want = jvlm._fuse(f32["jcfg"], f32["jp"], f32["jt"], f32["jimg"])
    _close(got, want)
    assert got.shape == (B, f32["cfg"].num_image_tokens + S,
                         f32["cfg"].d_model)


def test_vlm_forward_train_matches_reference(f32):
    jl, jaux = _J.forward_train(f32["jcfg"], f32["jp"], f32["jt"],
                                f32["jimg"])
    tl, taux = _T.forward_train(f32["cfg"], f32["tp"], f32["tt"],
                                f32["timg"])
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def test_vlm_prefill_matches_reference(f32):
    (jl, jk, jv, jpos), (tl, tk, tv, tpos) = f32["j"][0], f32["t"][0]
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    assert tpos == jpos == f32["cfg"].num_image_tokens + S


def test_vlm_greedy_decode_matches_reference(f32):
    (jfirst, jsteps, jfed, jcache), (_, tsteps, tfed, tcache) = \
        f32["j"], f32["t"]
    for want in [jfirst[0]] + jsteps[:-1]:
        assert _margin(want) >= MARGIN, _margin(want)
    for t, j in zip(tfed, jfed):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tsteps, jsteps):
        _close(t, j)
    _close(tcache.kv.k, jcache.kv.k)
    _close(tcache.kv.v, jcache.kv.v)
    assert tcache.position == int(jcache.position) == \
        f32["cfg"].num_image_tokens + S + NEW


def test_fused_prefill_past_flash_threshold():
    """``reduced(num_image_tokens=1030)``: the fused prefill of 1 030 + 5
    rows takes the flash path on both sides; then one decode step.  The K
    rows carry RoPE at angles up to 1 035 rad (``ROPE_TOL``)."""
    jcfg, cfg, jp, tp = _weights({"num_image_tokens": 1030,
                                  "num_layers": 1})
    jt, jimg, tt, timg = _inputs(cfg, n=5, seed=3)
    max_seq = 1030 + 5 + 1
    (jl, jk, jv, jpos), jsteps, jfed, _ = _serve(_J, jcfg, jp, jt, jimg, 1,
                                                 max_seq)
    (tl, tk, tv, tpos), tsteps, tfed, _ = _serve(_T, cfg, tp, tt, timg, 1,
                                                 max_seq)
    _close(tl, jl)
    _close(tk, jk, ROPE_TOL)
    _close(tv, jv)
    assert tpos == jpos == 1035
    assert _margin(jl) >= MARGIN
    np.testing.assert_array_equal(tfed[0], jfed[0])
    _close(tsteps[0], jsteps[0])


def test_smoke_decode_matches_forward_on_the_port():
    """``tests/test_arch_smoke.py::test_smoke_decode_matches_forward`` on
    the port's reduced chameleon-34b: prefill of the first T - 1 text
    tokens, then one decode step, against forward's logits at the prompt's
    last and the decoded token's fused positions."""
    cfg = get_config(NAME).reduced()
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    T = 24 - cfg.num_image_tokens
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, T),
                                     generator=gen, dtype=torch.int32),
             "image_embeds": torch.randn(2, cfg.num_image_tokens,
                                         cfg.d_model, generator=gen)}
    full = bundle.forward(params, batch)
    prompt = dict(batch, tokens=batch["tokens"][:, :T - 1])
    off = cfg.num_image_tokens
    lp, cache = bundle.prefill(params, prompt, off + T + 8)
    ld, _ = bundle.decode(params, batch["tokens"][:, T - 1], cache)
    np.testing.assert_allclose(lp.numpy(), full[:, off + T - 2].numpy(),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(ld.numpy(), full[:, off + T - 1].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_param_tree_is_the_references():
    jcfg = j_get_config(NAME).reduced()
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tp = get_model(get_config(NAME).reduced()).init(0, device="cpu")
    want = [("/".join(str(k.key) for k in path), a.shape, str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(jp)]
    got = [(path, tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for path, a in tree_leaves_with_path(tp)]
    assert got == want
    assert tp["img_proj"].shape == (jcfg.d_model, jcfg.d_model)


def test_bundle_matches_the_references(f32):
    """``get_model``'s vlm bundle: batch_spec, forward, the text-only loss
    and the cache it builds."""
    jb, tb = jreg.get_model(f32["jcfg"]), get_model(f32["cfg"])
    for cfg_kw in ({}, {"dtype": "bfloat16"}):
        jspec = jreg.get_model(j_get_config(NAME).reduced(
            **cfg_kw)).batch_spec(3, 20)
        tspec = get_model(get_config(NAME).reduced(**cfg_kw)).batch_spec(3,
                                                                          20)
        assert {k: (s, str(d).replace("torch.", "")) for k, (s, d)
                in tspec.items()} == {k: (s, jnp.dtype(d).name) for k, (s, d)
                                      in jspec.items()}
    jbatch = {"tokens": f32["jt"], "image_embeds": f32["jimg"]}
    tbatch = {"tokens": f32["tt"], "image_embeds": f32["timg"]}
    _close(tb.forward(f32["tp"], tbatch), jb.forward(f32["jp"], jbatch))
    jloss, _ = jax.jit(lambda p, b: jb.train_loss(p, b))(f32["jp"], jbatch)
    tloss, _ = tb.train_loss(f32["tp"], tbatch)
    _close(tloss, jloss)
    cache = tb.init_cache(2, 30, device="cpu")
    jcache = jb.init_cache(2, 30)
    assert tuple(cache.kv.k.shape) == jcache.kv.k.shape
    assert cache.position == 0
    # activation checkpointing of the stack runs and changes no value
    torch.testing.assert_close(
        tvlm.vlm_forward_train(f32["cfg"], f32["tp"], f32["tt"], f32["timg"],
                               remat="full"),
        tvlm.vlm_forward_train(f32["cfg"], f32["tp"], f32["tt"],
                               f32["timg"]), rtol=0, atol=0)
    # the dense decoder's functions run the vlm family's text-only stream
    ttf.forward_train(f32["cfg"], f32["tp"], f32["tt"])


def test_launch_serve_runs_chameleon(capsys):
    tserve.main(["--arch", NAME, "--device", "cpu", "--prompt-len", "12",
                 "--new-tokens", "4", "--batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={NAME}-smoke device=cpu batch=2 "
                             "prompt=12 new=4")
    assert out[1].startswith("prefill: ") and "tok/s" in out[1]
    first = out[2].split(": ", 1)
    assert first[0] == "first sequence" and len(eval(first[1])) == 4


def test_lockstep_prompt_and_loop_for_vlm():
    """The lockstep batch dict carries f32 image embeddings (B,
    num_image_tokens, d) after the tokens; the cache holds the image
    tokens too; the loop's tokens are prefill then each step's argmax."""
    cfg = get_config(NAME).reduced(dtype="bfloat16")
    prompt = tserve.lockstep_prompt(cfg, 2, 11, torch.device("cpu"))
    assert sorted(prompt) == ["image_embeds", "tokens"]
    assert prompt["image_embeds"].dtype == torch.float32
    assert prompt["image_embeds"].shape == (2, cfg.num_image_tokens,
                                            cfg.d_model)
    max_seq = tserve.lockstep_max_seq(cfg, 11, 4)
    assert max_seq == cfg.num_image_tokens + 15
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    run = tserve.lockstep(bundle, params, prompt, 4, max_seq)
    logits, cache = bundle.prefill(params, prompt, max_seq)
    assert cache.kv.k.shape[2] == max_seq
    assert cache.position == cfg.num_image_tokens + 11
    for t in range(4):
        torch.testing.assert_close(run.logits[:, t], logits, rtol=0, atol=0)
        tok = logits.argmax(-1).to(torch.int32)
        assert torch.equal(run.tokens[:, t], tok)
        logits, cache = bundle.decode(params, tok, cache)
