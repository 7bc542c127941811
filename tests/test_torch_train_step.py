"""The port's train step (``repro_torch.launch.steps.build_train_step``)
and its grads against ``repro`` on the CPU.

* Grads against ``jax.grad`` of the reference's loss on every family, the
  MoE layer's with drops and ties, the recurrent scans' and the hybrid's
  two layouts; each grad in its leaf's dtype.
* ``build_train_step`` on the one-device host mesh (C = 1) against the
  reference's jitted step: loss and new params at 1e-5 relative to
  max(1, max |p|) (``tests/test_torch_models.py``'s convention), α at the
  reference's own bound for a sharded step (rtol 1e-3, atol 1e-4,
  ``tests/test_distributed_spmd.py``): contextual on every family,
  fedavg, ``local_steps=2`` and ``server_momentum=0.9`` over two steps on
  the dense and MoE families; C = 4 on an emulated mesh against the
  reference's cohort formula; CPU steps bitwise repeatable; the
  ``launch.train`` command line.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.solve import solve_alpha_simple as j_solve
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import (tree_leaves, tree_leaves_with_path,
                                     tree_map)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ArchConfig

torch.set_num_threads(1)

TOL = 1e-5
ALPHA_RTOL, ALPHA_ATOL = 1e-3, 1e-4
# one reduced config a family, 1 layer (the hybrid: one group of 2), the
# narrow widths of .reduced()
FAMILIES = {"dense": ("qwen3-14b", {"num_layers": 1}),
            "moe": ("olmoe-1b-7b", {"num_layers": 1}),
            "ssm": ("rwkv6-1.6b", {"num_layers": 1}),
            "hybrid": ("zamba2-1.2b", {"num_layers": 2}),
            "audio": ("whisper-large-v3", {"num_layers": 1,
                                           "encoder_layers": 1}),
            "vlm": ("chameleon-34b", {"num_layers": 1})}
# the recurrent scans' backward: pure Mamba2, and the hybrid's two layouts
# (groups only; groups and a remainder)
GRAD_CASES = dict(FAMILIES, **{
    "mamba2": ("zamba2-1.2b", {"num_layers": 2, "family": "ssm"}),
    "hybrid-rem": ("zamba2-1.2b", {"num_layers": 3})})


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


def _cfgs(name, ov):
    return (j_get_config(name).reduced(**ov), get_config(name).reduced(**ov))


def _batch(jcfg, B=4, S=16, seed=0):
    """The same random batch for both sides (numpy, then each framework)."""
    spec = j_get_model(jcfg).batch_spec(
        B, S + (jcfg.num_image_tokens if jcfg.family == "vlm" else 0))
    rng = np.random.RandomState(seed)
    jb, tb = {}, {}
    for k, (shp, _) in spec.items():
        a = (rng.randint(0, jcfg.vocab_size, shp).astype(np.int32)
             if k == "tokens" else rng.normal(0, 1, shp).astype(np.float32))
        jb[k], tb[k] = jnp.asarray(a), torch.from_numpy(a)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jparams(jcfg):
    """The reference's params of ``jcfg``, initialised once for the file
    (its eager init takes seconds a config; the trees are immutable)."""
    return j_get_model(jcfg).init(jax.random.PRNGKey(0))


def _params(jcfg):
    jp = _jparams(jcfg)
    return jp, params_from_jax(jp, device="cpu")



# ------------------------------------------------------------------ grads

def _loss(bundle, params, batch, remat):
    return bundle.train_loss(params, batch, remat=remat)[0]


def _jgrads(jcfg, jp, jbatch):
    jb = j_get_model(jcfg)
    g = jax.jit(jax.grad(lambda p, b: jb.train_loss(p, b)[0]))(jp, jbatch)
    return jax.tree_util.tree_leaves(g)


def _grad_reference(case):
    """``jax.grad`` of the reference's loss: a family's from its one
    compiled program (:func:`_reference_run`), the other cases' alone."""
    if case in FAMILIES:
        return jax.tree_util.tree_leaves(_reference_run(case)["grads"])
    jcfg, _ = _cfgs(*GRAD_CASES[case])
    return _jgrads(jcfg, _jparams(jcfg), _batch(jcfg)[0])


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grads_match_reference(case):
    jcfg, cfg = _cfgs(*GRAD_CASES[case])
    jp, tp = _params(jcfg)
    jbatch, tbatch = _batch(jcfg)
    bundle = get_model(cfg)
    _, got = tsteps._loss_and_grads(lambda p, b: _loss(bundle, p, b, "full"),
                                    tp, tbatch)
    want = _grad_reference(case)
    assert len(got) == len(want)
    for (name, _), g, w in zip(tree_leaves_with_path(tp), got, want):
        assert g.dtype == tree_leaves(tp)[0].dtype
        assert _rel(g, w) <= TOL, name


def _moe_layer(**kw):
    spec = dict(name="t", family="moe", num_layers=1, d_model=16, d_ff=32,
                vocab_size=64, num_heads=2, num_kv_heads=2, num_experts=4,
                experts_per_token=2, num_shared_experts=1, dtype="float32")
    spec.update(kw)
    return JArchConfig(**spec), ArchConfig(**spec)


@pytest.mark.parametrize("case", ["drops", "ties-24", "ties-320"])
def test_moe_layer_grads_match_reference(case):
    """The dispatch's backward (index writes into a zero buffer with a
    trash row) against ``jax.grad`` of the reference's layer: T = 320 with
    entries dropped at capacity, and a zero router (every expert tied)."""
    jcfg, cfg = _moe_layer()
    T = 24 if case == "ties-24" else 320
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(2), jnp.float32)
    jp = dict(jp, router=jp["router"] * (0.0 if case.startswith("ties")
                                         else 5.0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    x = np.random.RandomState(1).randn(1, T, 16).astype(np.float32)
    x = x + (0.5 if case == "drops" else 0.0)
    w = np.random.RandomState(3).randn(1, T, 16).astype(np.float32)
    if case == "drops":
        _, _, top_e = tmoe.route(cfg, tp["router"],
                                 torch.from_numpy(x).reshape(T, -1))
        _, placed = tmoe.dispatch(cfg, torch.from_numpy(x).reshape(T, -1),
                                  top_e)
        assert 0 < int((~placed.keep).sum()) < placed.keep.numel() // 2

    def jloss(p, xx):
        out, aux = jmoe.moe_forward(jcfg, p, xx)
        return jnp.sum(out * w) + 0.01 * aux

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    leaves = tree_map(lambda v: v.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_forward(cfg, leaves, xt)
    (torch.sum(out * torch.from_numpy(w)) + 0.01 * aux).backward()
    assert _rel(xt.grad, want_x) <= TOL
    for (name, got), want in zip(tree_leaves_with_path(leaves),
                                 jax.tree_util.tree_leaves(want_p)):
        assert _rel(got.grad, want) <= TOL, name


# ------------------------------------------------------------- train step

VARIANTS = {"contextual": {}, "fedavg": {"aggregator": "fedavg"},
            "local_steps": {"local_steps": 2},
            "momentum": {"server_momentum": 0.9}}
VARIANT_FAMILIES = ("dense", "moe")


def _seq(jcfg):
    return 16 + (jcfg.num_image_tokens if jcfg.family == "vlm" else 0)


def _shape(jcfg, module):
    return module.InputShape("t", "train", _seq(jcfg), 4)


@functools.lru_cache(maxsize=None)
def _reference_run(family):
    """Everything the reference computes for ``family`` in one compiled
    program (one XLA compile a family, not one a case): ``jax.grad`` of the
    loss and the jitted train step at the C = 1 host mesh on the batch of
    seed 0, and on the dense and MoE families the fedavg, ``local_steps=2``
    and ``server_momentum=0.9`` steps (momentum over the batches of seeds
    0 and 1, from a zero f32 velocity)."""
    jcfg, _ = _cfgs(*FAMILIES[family])
    jb = j_get_model(jcfg)
    names = ["contextual"] + (list(VARIANTS)[1:]
                              if family in VARIANT_FAMILIES else [])
    steps = {v: jsteps.build_train_step(jcfg, j_host_mesh(),
                                        _shape(jcfg, jshapes), remat=False,
                                        **VARIANTS[v]) for v in names}

    def run(p, b, b2):
        out = {"grads": jax.grad(lambda q: jb.train_loss(q, b)[0])(p)}
        for v, step in steps.items():
            if v != "momentum":
                out[v] = step(p, b)
                continue
            state = (p, jax.tree_util.tree_map(
                lambda a: jnp.zeros(a.shape, jnp.float32), p))
            first = step(state, b)
            out[v] = (first, step(first[0], b2))
        return out

    return jax.jit(run)(_jparams(jcfg), _batch(jcfg)[0],
                        _batch(jcfg, seed=1)[0])


def _port_step(family, variant):
    jcfg, cfg = _cfgs(*FAMILIES[family])
    _, tp = _params(jcfg)
    return tp, tsteps.build_train_step(
        cfg, tmesh.make_host_mesh(), _shape(jcfg, tshapes), remat="full",
        **VARIANTS[variant])


def _check_step(jout, tout):
    (jnew, jm), (tnew, tm) = jout, tout
    assert _rel(tm["loss"], jm["loss"]) <= TOL
    np.testing.assert_allclose(tm["alpha"].numpy(), np.asarray(jm["alpha"]),
                               rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
    jl = jax.tree_util.tree_leaves(jnew)
    tl = tree_leaves(tnew)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).replace("torch.", "") == b.dtype.name
        assert _rel(a, b) <= TOL
    for k in ("gram_diag_mean", "bound"):
        if k in jm:
            assert _rel(tm[k], jm[k]) <= 1e-3 * max(
                1.0, abs(float(jm[k]))) or abs(
                float(tm[k]) - float(jm[k])) <= 1e-3 * abs(float(jm[k]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_reference(family):
    tp, tstep = _port_step(family, "contextual")
    jcfg, _ = _cfgs(*FAMILIES[family])
    _check_step(_reference_run(family)["contextual"],
                tstep(tp, _batch(jcfg)[1]))


@pytest.mark.parametrize("family", VARIANT_FAMILIES)
@pytest.mark.parametrize("variant", ["fedavg", "local_steps", "momentum"])
def test_train_step_variants_match_reference(family, variant):
    tp, tstep = _port_step(family, variant)
    jcfg, _ = _cfgs(*FAMILIES[family])
    want = _reference_run(family)[variant]
    tb, tb2 = _batch(jcfg)[1], _batch(jcfg, seed=1)[1]
    if variant != "momentum":
        _check_step(want, tstep(tp, tb))
        return
    tstate = (tp, tree_map(lambda a: torch.zeros(a.shape), tp))
    for ((jnew, jv), jm), tbb in zip(want, (tb, tb2)):
        (tnew, tv), tm = tstep(tstate, tbb)
        _check_step((jnew, jm), (tnew, tm))
        for a, b in zip(tree_leaves(tv), jax.tree_util.tree_leaves(jv)):
            assert a.dtype == torch.float32 and _rel(a, b) <= TOL
        tstate = (tnew, tv)


def test_train_step_cohorts_on_an_emulated_mesh():
    """C = 4 on an emulated (4, 2) mesh against the reference's cohort
    formula computed by hand on one device (its test_distributed_spmd's):
    four cohorts of batch 2, α from the scoped U."""
    jcfg, cfg = _cfgs("qwen3-14b", {"num_layers": 1})
    jp, tp = _params(jcfg)
    jb, tb = _batch(jcfg, B=8)
    step = tsteps.build_train_step(
        cfg, tmesh.emulated_mesh((4, 2), ("data", "model")),
        tshapes.InputShape("t", "train", 16, 8), lr=0.05, remat=False)
    new, m = step(tp, tb)
    bundle = j_get_model(jcfg)
    loss = lambda p, b: bundle.train_loss(p, b)[0]   # noqa: E731
    cb = jb["tokens"].reshape(4, 2, 16)
    grads = jax.jit(jax.vmap(lambda b: jax.grad(loss)(jp, {"tokens": b})))(
        cb)
    deltas = jax.tree_util.tree_map(lambda g: -0.05 * g, grads)
    flat = [l.reshape(4, -1) for p, l in
            jax.tree_util.tree_flatten_with_path(deltas)[0]
            if "lm_head" in str(p) or "final_norm" in str(p)]
    U = jnp.concatenate(flat, axis=1).astype(jnp.float32)
    alpha = j_solve(U @ U.T, U @ (-jnp.mean(U, 0) / 0.05), 1 / 0.05, 1e-6)
    ref = jax.tree_util.tree_map(
        lambda p, u: p + jnp.einsum("k,k...->...", alpha, u), jp, deltas)
    np.testing.assert_allclose(m["alpha"].numpy(), np.asarray(alpha),
                               rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
    for a, b in zip(tree_leaves(new), jax.tree_util.tree_leaves(ref)):
        assert _rel(a, b) <= TOL
    assert float(m["bound"]) < 0


def test_train_cli_runs_and_checkpoints(tmp_path, capsys):
    ttrain.main(["--device", "cpu", "--reduced", "--steps", "3",
                 "--batch", "4", "--seq", "16",
                 "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("arch=olmoe-1b-7b-smoke params=3.9M mesh={'data': 1, "
                      "'model': 1} aggregator=contextual")
    assert out[1].startswith("step    0 loss=") and "alpha[mean=+1.0000" \
        in out[1]
    assert out[-1].startswith("checkpoint written: ")
    assert (tmp_path / "00000003.ckpt.npz").exists()


def test_grads_keep_leaf_dtypes_and_cpu_steps_repeat_bitwise():
    """Autograd returns each grad in its leaf's dtype, as ``jax.grad``
    (bf16 weights, the MoE router in f32; no f32 master copy), and two
    train steps on the CPU are bitwise equal."""
    cfg = get_config("olmoe-1b-7b").reduced(num_layers=1,
                                            dtype="bfloat16")
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    batch = next(ttrain.make_batches(cfg, bundle, 4, 16, 1))
    _, grads = tsteps._loss_and_grads(
        lambda p, b: bundle.train_loss(p, b)[0], params, batch)
    dtypes = {p.dtype for p in tree_leaves(params)}
    assert dtypes == {torch.bfloat16, torch.float32}
    for p, g in zip(tree_leaves(params), grads):
        assert g.dtype == p.dtype and g.shape == p.shape
    step = tsteps.build_train_step(cfg, tmesh.make_host_mesh(),
                                   tshapes.InputShape("t", "train", 16, 4))
    (a, ma), (b, mb) = step(params, batch), step(params, batch)
    assert torch.equal(ma["alpha"], mb["alpha"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
