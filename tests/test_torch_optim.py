"""The port's ``repro_torch.optim`` against ``repro.optim``: SGD (plain,
momentum, Nesterov, weight decay), AdamW and ``make_optimizer`` over a few
steps on the same trees and gradients, the three schedules at sample
points and the FedProx objective, each at rtol 1e-6 (f32 rounding order
only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jo
import repro_torch.optim as to
from repro_torch.core.flatten import tree_leaves

torch.set_num_threads(1)

RTOL = 1e-6


def _trees(seed=0, steps=4):
    rng = np.random.RandomState(seed)
    shapes = {"w": (5, 3), "b": (3,), "h": {"k": (2, 4)}}

    def draw(scale=1.0):
        return {"w": rng.randn(*shapes["w"]).astype(np.float32) * scale,
                "b": rng.randn(*shapes["b"]).astype(np.float32) * scale,
                "h": {"k": rng.randn(*shapes["h"]["k"]).astype(np.float32)
                      * scale}}
    return draw(), [draw(0.5) for _ in range(steps)]


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, what):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL, err_msg=what)


def _run(j_init, j_update, t_init, t_update, lrs):
    params, grads = _trees()
    jp, tp = _j(params), _t(params)
    js, ts = j_init(jp), t_init(tp)
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        jp, js = j_update(jp, _j(g), js, lr)
        tp, ts = t_update(tp, _t(g), ts, lr)
        _close(tp, jp, f"params after step {i}")
    return js, ts


@pytest.mark.parametrize("kw", [
    dict(), dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
    dict(momentum=0.5, weight_decay=0.01), dict(weight_decay=0.1)])
def test_sgd_matches_reference(kw):
    js, ts = _run(jo.sgd_init, lambda p, g, s, lr: jo.sgd_update(
        p, g, s, lr, **kw), to.sgd_init, lambda p, g, s, lr: to.sgd_update(
        p, g, s, lr, **kw), [0.1, 0.05, 0.2, 0.01])
    _close(ts.momentum, js.momentum, "momentum")
    assert int(ts.count) == int(js.count) == 4
    assert ts.count.dtype == torch.int32


@pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.01),
                                dict(b1=0.8, b2=0.99, eps=1e-6)])
def test_adamw_matches_reference(kw):
    js, ts = _run(jo.adamw_init, lambda p, g, s, lr: jo.adamw_update(
        p, g, s, lr, **kw), to.adamw_init, lambda p, g, s, lr: to.adamw_update(
        p, g, s, lr, **kw), [1e-3, 2e-3, 5e-4, 1e-3])
    _close(ts.mu, js.mu, "mu")
    _close(ts.nu, js.nu, "nu")
    assert int(ts.count) == int(js.count) == 4


@pytest.mark.parametrize("name,kw", [("sgd", dict(momentum=0.9)),
                                     ("adamw", dict(weight_decay=0.05))])
def test_make_optimizer_matches_reference(name, kw):
    ji, ju = jo.make_optimizer(name, **kw)
    ti, tu = to.make_optimizer(name, **kw)
    _run(ji, ju, ti, tu, [0.01, 0.02, 0.03, 0.01])


def test_make_optimizer_rejects_unknown_names():
    for mod in (jo, to):
        with pytest.raises(KeyError, match="unknown optimizer"):
            mod.make_optimizer("lion")


def test_bf16_leaves_keep_their_dtype():
    params, grads = _trees()
    tp = {k: v for k, v in _t(params).items()}
    tp["w"] = tp["w"].to(torch.bfloat16)
    jp = dict(_j(params))
    jp["w"] = jp["w"].astype(jnp.bfloat16)
    for init, upd, jinit, jupd in ((to.sgd_init, to.sgd_update, jo.sgd_init,
                                    jo.sgd_update),
                                   (to.adamw_init, to.adamw_update,
                                    jo.adamw_init, jo.adamw_update)):
        new, _ = upd(tp, _t(grads[0]), init(tp), 0.1)
        want, _ = jupd(jp, _j(grads[0]), jinit(jp), 0.1)
        assert new["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            new["w"].float().numpy(), np.asarray(want["w"], np.float32))


SCHEDULES = [
    ("constant", (0.3,)), ("cosine_decay", (0.1, 50)),
    ("cosine_decay", (0.2, 10, 0.0)), ("linear_warmup_cosine", (0.1, 5, 40)),
    ("linear_warmup_cosine", (1.0, 1, 2, 0.5))]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_reference(name, args):
    jf, tf = getattr(jo, name)(*args), getattr(to, name)(*args)
    for step in (0, 1, 2, 3, 4, 5, 6, 9, 10, 25, 39, 40, 50, 51, 100):
        got, want = tf(step), jf(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=1e-9, err_msg=f"{name} at {step}")
    steps = torch.arange(12)
    np.testing.assert_allclose(tf(steps).numpy(),
                               np.asarray(jf(jnp.arange(12))), rtol=RTOL,
                               atol=1e-9)


@pytest.mark.parametrize("mu", [0.0, 0.01, 1.0])
def test_proximal_loss_matches_reference(mu):
    params, grads = _trees(seed=3, steps=1)
    anchor = grads[0]

    def j_loss(p, batch):
        return jnp.sum(p["w"] * batch) + jnp.sum(p["b"] ** 2)

    def t_loss(p, batch):
        return torch.sum(p["w"] * batch) + torch.sum(p["b"] ** 2)
    batch = np.linspace(-1, 1, 15, dtype=np.float32).reshape(5, 3)
    want = jo.proximal_loss_fn(j_loss, mu)(_j(params), jnp.asarray(batch),
                                           _j(anchor))
    got = to.proximal_loss_fn(t_loss, mu)(_t(params), torch.from_numpy(batch),
                                          _t(anchor))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    if mu:
        # its gradient pulls toward the anchor
        tp = _t(params)
        tp["h"]["k"].requires_grad_()
        to.proximal_loss_fn(t_loss, mu)(tp, torch.from_numpy(batch),
                                        _t(anchor)).backward()
        np.testing.assert_allclose(
            tp["h"]["k"].grad.numpy(),
            mu * (params["h"]["k"] - anchor["h"]["k"]), rtol=1e-5)
