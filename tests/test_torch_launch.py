"""The port's training stack (``repro_torch.launch.{mesh,shapes,steps,
train}``, ``repro_torch.sharding``, ``solve_alpha_simple`` and the models'
``remat``) against ``repro`` on the CPU (the train step and its grads:
``tests/test_torch_train_step.py``).

* ``solve_alpha_simple`` at 1e-5.
* The spec rules as tuples: every leaf of every registered config's params
  (``jax.eval_shape`` on the reference side, ``FakeTensorMode`` on the
  port's) and decode cache, on meshes (1, 1), (4, 2), (16, 16) and
  (2, 16, 16), ``tp`` and ``dp``; the reference's rule functions read only
  ``mesh.shape``, so a duck mesh carries them.  ``batch_pspec``,
  ``INPUT_SHAPES``, ``arch_for_shape``, ``num_cohorts`` / ``cohort_axes``.
* ``make_batches`` bit for bit.
* Remat ``False`` / ``"full"`` / ``"dots"``: equal logits and grads on
  every family; ``"dots"`` recomputes fewer 2-D products than ``"full"``.
* The serving steps are the bundle's functions.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.solve import solve_alpha_simple as j_solve
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.launch.train import make_batches as j_make_batches
from repro.models import get_model as j_get_model
from repro.sharding import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_leaves_with_path
from repro_torch.core.solve import solve_alpha_simple
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model
from repro_torch.sharding import specs as tspecs

torch.set_num_threads(1)

TOL = 1e-5
ALPHA_RTOL, ALPHA_ATOL = 1e-3, 1e-4
CONFIGS = ["chameleon-34b", "deepseek-moe-16b", "gemma-7b", "olmoe-1b-7b",
           "paper-logreg", "qwen2.5-32b", "qwen3-14b", "rwkv6-1.6b",
           "starcoder2-15b", "whisper-large-v3", "zamba2-1.2b"]
MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# one reduced config a family, 1 layer (the hybrid: one group of 2), the
# narrow widths of .reduced()
FAMILIES = {"dense": ("qwen3-14b", {"num_layers": 1}),
            "moe": ("olmoe-1b-7b", {"num_layers": 1}),
            "ssm": ("rwkv6-1.6b", {"num_layers": 1}),
            "hybrid": ("zamba2-1.2b", {"num_layers": 2}),
            "audio": ("whisper-large-v3", {"num_layers": 1,
                                           "encoder_layers": 1}),
            "vlm": ("chameleon-34b", {"num_layers": 1})}


def _duck(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


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


# ------------------------------------------------------------------ solve

@pytest.mark.parametrize("K", [1, 4, 9])
def test_solve_alpha_simple_matches_reference(K):
    rng = np.random.RandomState(K)
    U = rng.normal(size=(K, 50)).astype(np.float32)
    G, c = U @ U.T, U @ rng.normal(size=50).astype(np.float32)
    want = j_solve(jnp.asarray(G), jnp.asarray(c), 8.0, 1e-6)
    got = solve_alpha_simple(torch.from_numpy(G), torch.from_numpy(c), 8.0,
                             1e-6)
    assert _rel(got, want) <= TOL


# ------------------------------------------------------------------ rules

def _ref_cache(jcfg, B, S):
    jb = j_get_model(jcfg)
    if jb.init_cache is not None:
        return jax.eval_shape(lambda: jb.init_cache(B, S))
    params = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    dt = jnp.bfloat16 if jcfg.dtype == "bfloat16" else jnp.float32
    prompt = {"frames": jax.ShapeDtypeStruct(
        (B, jcfg.max_source_positions, jcfg.d_model), dt),
        "tokens": jax.ShapeDtypeStruct((B, 8), jnp.int32)}
    return jax.eval_shape(lambda p, b: jb.prefill(p, b, S)[1], params, prompt)


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jspecs._path_str(p), tuple(s)) for p, s in flat]


def _port_specs(tree):
    return [(path, tuple(s)) for path, s in tspecs.spec_leaves(tree)]


@pytest.mark.parametrize("name", CONFIGS)
def test_param_and_cache_specs_match_reference(name):
    """Every leaf's spec, as a tuple, on the four mesh shapes in both
    modes; the cache's at decode_32k (batch over data, seq over model) and
    long_500k (batch 1: seq over every axis)."""
    jcfg, cfg = j_get_config(name), get_config(name)
    jshape = jax.eval_shape(j_get_model(jcfg).init, jax.random.PRNGKey(0))
    tshape = tshapes.meta_params(cfg)
    assert [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(tshape)] \
        == [(jspecs._path_str(p), tuple(l.shape)) for p, l in
            jax.tree_util.tree_flatten_with_path(jshape)[0]]
    shapes = [jshapes.INPUT_SHAPES["decode_32k"]]
    if jcfg.family != "audio":
        shapes.append(jshapes.INPUT_SHAPES["long_500k"])
    caches = [] if jcfg.family == "logreg" else [
        (s.global_batch, _ref_cache(jcfg, s.global_batch, s.seq_len),
         tsteps.cache_sds(cfg, tmesh.emulated_mesh((1, 1), ("data",
                                                            "model")),
                          tshapes.INPUT_SHAPES[s.name]))
        for s in shapes]
    for shp, axes in MESHES:
        jm, tm = _duck(shp, axes), tmesh.emulated_mesh(shp, axes)
        for mode in ("tp", "dp"):
            want = _ref_specs(jspecs.param_pspecs(jcfg, jshape, jm, mode))
            got = _port_specs(tspecs.param_pspecs(cfg, tshape, tm, mode))
            assert got == want, (shp, mode)
        for B, jcache, tcache in caches:
            want = [s for _, s in _ref_specs(
                jspecs.cache_pspecs(jcfg, jcache, jm, B))]
            meta = tshapes.to_meta(tspecs.map_with_path(
                tcache, lambda p, t: t.tensor if hasattr(t, "tensor")
                else t))
            got = [s for _, s in _port_specs(
                tspecs.cache_pspecs(cfg, meta, tm, B))]
            assert got == want, (shp, B)
            assert [tuple(t.shape) for _, t in tspecs.spec_leaves(meta)
                    if torch.is_tensor(t)] == [
                tuple(l.shape) for l in jax.tree_util.tree_leaves(jcache)
                if l.ndim]


def test_params_sds_carries_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tmesh.emulated_mesh((4, 2), ("data", "model"))
    sds = tsteps.params_sds(get_config("qwen3-14b"), mesh)
    wq = sds["blocks"]["attn"]["wq"]
    assert wq.tensor.device.type == "meta"
    # 14.8·10⁹ params: FSDP over data beside the model axis
    assert tuple(wq.sharding.spec) == (None, "data", "model")
    assert wq.sharding.placements == (Shard(1), Shard(2))
    assert sds["final_norm"].sharding.placements == (Replicate(),
                                                     Replicate())
    pod = tmesh.emulated_mesh((2, 16, 16), ("pod", "data", "model"))
    ns = tspecs.NamedSharding(pod, tspecs.PartitionSpec(("pod", "data"),
                                                        None))
    assert ns.placements == (Shard(0), Shard(0), Replicate())


def test_shape_only_prefill_keeps_the_model_tables_real():
    """``cache_sds`` runs whisper's prefill under ``FakeTensorMode``: a
    real sinusoid table cached before it is not fed into it, and no fake
    one outlives it (the tables are cached per shape and device)."""
    from repro_torch.models.layers import sinusoidal_positions
    cfg = get_config("whisper-large-v3").reduced()
    mesh = tmesh.emulated_mesh((1, 1), ("data", "model"))
    table = lambda: sinusoidal_positions(  # noqa: E731
        cfg.max_source_positions, cfg.d_model, torch.device("cpu"))
    before = table()
    tsteps.cache_sds(cfg, mesh, tshapes.InputShape("t", "decode", 64, 2))
    after = table()
    assert type(after) is torch.Tensor and torch.equal(after, before)


def test_batch_specs_input_shapes_and_cohorts():
    for shp, axes in MESHES + [((2, 3), ("data", "model")),
                               ((1,), ("fleet",))]:
        jm, tm = _duck(shp, axes), tmesh.emulated_mesh(shp, axes)
        for B in (1, 2, 6, 8, 32, 256, 512):
            assert tuple(tspecs.batch_pspec(tm, B)) == \
                tuple(jspecs.batch_pspec(jm, B))
            if "data" not in axes:
                continue
            for dp in (False, True):
                assert tsteps.num_cohorts(tm, dp, B) == \
                    jsteps.num_cohorts(jm, dp, B)
                assert tsteps.cohort_axes(tm, dp, B) == \
                    jsteps.cohort_axes(jm, dp, B)
    assert {k: tuple(vars(v).values()) for k, v in
            tshapes.INPUT_SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in jshapes.INPUT_SHAPES.items()}
    for name in CONFIGS:
        for sname, s in jshapes.INPUT_SHAPES.items():
            want = jshapes.arch_for_shape(j_get_config(name), s)
            got = tshapes.arch_for_shape(get_config(name),
                                         tshapes.INPUT_SHAPES[sname])
            assert (got is None) == (want is None)
            if want is not None:
                assert got.sliding_window == want.sliding_window
    cfg = get_config("chameleon-34b")
    spec = tshapes.input_specs(cfg, tshapes.INPUT_SHAPES["train_4k"],
                               tmesh.emulated_mesh((16, 16),
                                                   ("data", "model")))
    assert tuple(spec["tokens"].shape) == (256, 4096 - 1024)
    assert tuple(spec["image_embeds"].sharding.spec) == ("data", None, None)
    dec = tshapes.input_specs(cfg, tshapes.INPUT_SHAPES["long_500k"],
                              tmesh.emulated_mesh((16, 16),
                                                  ("data", "model")))
    assert tuple(dec["token"].sharding.spec) == (None,)


def test_meshes():
    """The one-rank builders, the refusals and the production mesh's
    RuntimeError, as the reference's."""
    host = tmesh.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    assert host.device_mesh is None and host.size == 1
    with pytest.raises(ValueError, match="needs 8 ranks"):
        tmesh.make_mesh((4, 2), ("data", "model"))
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {need} devices"):
            tmesh.make_production_mesh(multi_pod=multi)
    assert tspecs.fleet_mesh().shape == {"fleet": 1}
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.Mesh((1, 2), ("data",))


# ---------------------------------------------------------------- batches

@pytest.mark.parametrize("name,reduced", [
    ("olmoe-1b-7b", True), ("chameleon-34b", True),
    ("whisper-large-v3", True), ("chameleon-34b", False)])
def test_make_batches_bitwise(name, reduced):
    jcfg, cfg = j_get_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    seq = 16 + (jcfg.num_image_tokens if jcfg.family == "vlm" else 0)
    want = list(j_make_batches(jcfg, j_get_model(jcfg), 2, seq, 3))
    got = list(ttrain.make_batches(cfg, get_model(cfg), 2, seq, 3))
    for wb, gb in zip(want, got):
        assert set(wb) == set(gb)
        for k in wb:
            a = np.asarray(wb[k])
            b = gb[k]
            assert str(b.dtype).replace("torch.", "") == a.dtype.name
            if b.dtype == torch.bfloat16:
                assert np.array_equal(a.view(np.uint16),
                                      b.view(torch.int16).numpy()
                                      .view(np.uint16))
            else:
                assert np.array_equal(a, b.numpy())


# ------------------------------------------------------------------ remat

def _loss(bundle, params, batch, remat):
    return bundle.train_loss(params, batch, remat=remat)[0]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_policies_are_equal(family):
    """The logits and every grad under False, "full" and "dots" are
    equal to the last bit on the CPU."""
    _, cfg = _cfgs(*FAMILIES[family])
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    jcfg = _cfgs(*FAMILIES[family])[0]
    _, batch = _batch(jcfg)
    fwd = {}
    grads = {}
    for remat in (False, "full", "dots"):
        loss, grads[remat] = tsteps._loss_and_grads(
            lambda p, b: _loss(bundle, p, b, remat), params, batch)
        fwd[remat] = loss
    for remat in ("full", "dots"):
        assert torch.equal(fwd[remat], fwd[False])
        for a, b in zip(grads[remat], grads[False]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown remat policy"):
        bundle.train_loss(params, batch, remat="sometimes")


def test_remat_dots_recomputes_fewer_products():
    """Counting aten.mm under a TorchDispatchMode over forward + backward:
    "full" runs the forward's products twice, "dots" saves them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    _, cfg = _cfgs("qwen3-14b", {"num_layers": 2})
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    _, batch = _batch(_cfgs("qwen3-14b", {"num_layers": 2})[0])
    seen = {}
    for remat in (False, "full", "dots"):
        with Count() as c:
            tsteps._loss_and_grads(lambda p, b: _loss(bundle, p, b, remat),
                                   params, batch)
        seen[remat] = c.mm
    # "full" runs each layer's forward products again (the same number in
    # both layers); "dots" none
    again = seen["full"] - seen[False]
    assert again > 0 and again % 2 == 0
    assert seen["dots"] == seen[False] < seen["full"]


def test_serve_steps_are_the_bundles():
    cfg = get_config("qwen3-14b").reduced(num_layers=1)
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    mesh, shape = tmesh.make_host_mesh(), tshapes.InputShape("p", "prefill",
                                                              12, 2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = tsteps.build_prefill_step(cfg, mesh, shape)(
        params, {"tokens": tokens})
    want, _ = bundle.prefill(params, {"tokens": tokens}, 12)
    assert torch.equal(logits, want) and cache.kv.k.shape[2] == 12
    out, cache = tsteps.build_decode_step(cfg, mesh, shape)(
        params, logits.argmax(-1).int(), cache)
    assert out.shape == (2, cfg.vocab_size) and cache.position == 9
