"""The port's core library (``repro_torch.core``) against ``repro.core``.

Inputs are made with numpy from a seed and go through both packages on the
CPU.  f32 math that differs only in summation order is held at rtol 1e-5;
the solve outputs at 1e-4, since α inherits G's conditioning (cond(G) of
these random updates is O(10), so 1e-5 input noise stays below 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import flatten as jflat
from repro.core import gram as jgram
from repro.core import solve as jsolve
from repro_torch.core import aggregation as tagg
from repro_torch.core import flatten as tflat
from repro_torch.core import gram as tgram
from repro_torch.core import solve as tsolve

torch.set_num_threads(1)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_tree(tree):
    return tflat.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _mlp_tree(rng, K=None):
    lead = () if K is None else (K,)
    return {"hidden": {"w": rng.randn(*lead, 5, 4).astype(np.float32),
                       "b": rng.randn(*lead, 4).astype(np.float32)},
            "head": {"w": rng.randn(*lead, 4, 3).astype(np.float32),
                     "b": rng.randn(*lead, 3).astype(np.float32)}}


def _logreg_tree(rng, K=None, dim=7, classes=3):
    lead = () if K is None else (K,)
    # insertion order w then b: the flat order must still be b then w
    return {"w": rng.randn(*lead, dim, classes).astype(np.float32),
            "b": rng.randn(*lead, classes).astype(np.float32)}


# ---------------------------------------------------------------- flatten

def test_tree_to_vector_uses_sorted_key_order():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.array([10.0, 11.0], np.float32)}
    vec = tflat.tree_to_vector(_torch_tree(tree))
    np.testing.assert_array_equal(_np(vec), [10, 11, 0, 1, 2, 3, 4, 5])
    np.testing.assert_array_equal(
        _np(vec), np.asarray(jflat.tree_to_vector(_jax_tree(tree))))


@pytest.mark.parametrize("make", [_logreg_tree, _mlp_tree])
def test_flatten_round_trip_matches_reference(make):
    tree = make(np.random.RandomState(0))
    vec = tflat.tree_to_vector(_torch_tree(tree))
    np.testing.assert_array_equal(
        _np(vec), np.asarray(jflat.tree_to_vector(_jax_tree(tree))))
    back = tflat.vector_to_tree(vec * 2, _torch_tree(tree))
    jback = jflat.vector_to_tree(jflat.tree_to_vector(_jax_tree(tree)) * 2,
                                 _jax_tree(tree))
    assert [p for p, _ in tflat.tree_leaves_with_path(back)] == \
        ["/".join(str(k.key) for k in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(jback)[0]]
    for a, b in zip(tflat.tree_leaves(back), jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert tflat.tree_size(_torch_tree(tree)) == jflat.tree_size(_jax_tree(tree))


@pytest.mark.parametrize("make,scope", [
    (_mlp_tree, "last_layer"),         # matches the "head" pattern
    (_logreg_tree, "last_layer"),      # no head name: falls back to "w"
    (_mlp_tree, "hidden/w"),
    (_mlp_tree, ["head/b", "^hidden/b$"]),
    (_mlp_tree, None), (_mlp_tree, "full")])
def test_select_scope_matches_reference(make, scope):
    tree = make(np.random.RandomState(1))
    got = tflat.select_scope(_torch_tree(tree), scope)
    want = jflat.select_scope(_jax_tree(tree), scope)
    sizes = [x.numel() for x in tflat.tree_leaves(got)]
    assert sizes == [x.size for x in jax.tree_util.tree_leaves(want)]
    assert 0 < sum(sizes)
    np.testing.assert_array_equal(
        _np(tflat.scope_vector(_torch_tree(tree), scope)),
        np.asarray(jflat.scope_vector(_jax_tree(tree), scope)))


def test_stacked_weighted_sum_matches_reference():
    rng = np.random.RandomState(2)
    stacked, w = _mlp_tree(rng, K=4), rng.randn(4).astype(np.float32)
    got = tflat.stacked_weighted_sum(_torch_tree(stacked), torch.from_numpy(w))
    want = jflat.stacked_weighted_sum(_jax_tree(stacked), jnp.asarray(w))
    for a, b in zip(tflat.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    # the tree form w + Σ w_k Δ_k equals what the aggregators get from the
    # flat combine kernel
    params = _mlp_tree(rng)
    tree_form = tflat.tree_add(_torch_tree(params), got)
    flat = tagg._combine(_torch_tree(params), _torch_tree(stacked),
                         torch.from_numpy(w))
    for a, b in zip(tflat.tree_leaves(flat), tflat.tree_leaves(tree_form)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The gap from each bf16 value to its neighbour away from zero."""
    bits = x.view(torch.int16)
    nxt = torch.where(bits == 0x7F7F, bits, bits + 1).view(torch.bfloat16)
    return (nxt.float() - x.float()).abs()


def test_stacked_weighted_sum_bf16_within_one_ulp_of_reference():
    """bf16 leaves: the reference rounds each weight to bf16 before an
    f32-accumulated contraction (``mix_rows``); the port does the same, so
    every entry lies within one bf16 ulp of the reference's (summation order
    alone can flip the last rounding).  An f32 upcast of the weights, the
    earlier form, differs by more."""
    rng = np.random.RandomState(13)
    P, n = 16, 4096
    leaf = rng.randn(P, n).astype(np.float32)
    w = (rng.randn(P) * 0.3).astype(np.float32)
    want = jflat.stacked_weighted_sum(
        {"x": jnp.asarray(leaf).astype(jnp.bfloat16)}, jnp.asarray(w))["x"]
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tflat.stacked_weighted_sum(
        {"x": torch.from_numpy(leaf).to(torch.bfloat16)},
        torch.from_numpy(w))["x"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n,)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= _bf16_ulp(want)).all()), \
        f"{int((gap > _bf16_ulp(want)).sum())} entries beyond one ulp"


def test_chunked_view_and_mix_rows_match_reference():
    rng = np.random.RandomState(8)
    stacked = _mlp_tree(rng, K=5)
    w = rng.randn(5).astype(np.float32)
    tv = tflat.ChunkedFlatView(_torch_tree(stacked), "last_layer")
    jv = jflat.ChunkedFlatView(_jax_tree(stacked), "last_layer")
    assert [(s.offset, s.width, s.in_scope) for s in tv.slabs] == \
        [(s.offset, s.width, s.in_scope) for s in jv.slabs]
    for ts, js in zip(tv.slabs, jv.slabs):
        np.testing.assert_allclose(
            _np(tflat.mix_rows(torch.from_numpy(w), ts.matrix)),
            np.asarray(jflat.mix_rows(jnp.asarray(w), js.matrix)),
            rtol=1e-5, atol=1e-6)
    out = torch.full((tv.slabs[0].width,), 7.0)
    assert tflat.mix_rows(torch.from_numpy(w), tv.slabs[0].matrix,
                          out=out) is out
    np.testing.assert_allclose(
        _np(out), np.asarray(jflat.mix_rows(jnp.asarray(w),
                                            jv.slabs[0].matrix)),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ gram, solve

def _gram_inputs(K=6, n=50, seed=3):
    rng = np.random.RandomState(seed)
    U = rng.randn(K, n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    G, c = (np.array(a) for a in jgram.gram_and_cross(jnp.asarray(U),
                                                         jnp.asarray(g)))
    return U, g, G, c


def test_dense_gram_and_residual_match_reference():
    U, g, G, c = _gram_inputs()
    Gt, ct = tgram.gram_and_cross(torch.from_numpy(U), torch.from_numpy(g))
    np.testing.assert_allclose(_np(Gt), G, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(ct), c, rtol=1e-5, atol=1e-4)
    a = np.linspace(-1, 1, 6).astype(np.float32)
    np.testing.assert_allclose(
        _np(tgram.gram_residual(Gt, ct, torch.from_numpy(a), 3.0)),
        np.asarray(jgram.gram_residual(jnp.asarray(G), jnp.asarray(c),
                                       jnp.asarray(a), 3.0)),
        rtol=1e-5, atol=1e-4)


def _split(U, sizes):
    out, start = [], 0
    for k in sizes:
        out.append(U[start:start + k])
        start += k
    return out


def test_chunked_and_block_gram_match_reference():
    U, g, G, c = _gram_inputs(K=11, n=900, seed=7)
    Ut, gt = torch.from_numpy(U), torch.from_numpy(g)
    Gc, cc = tgram.gram_and_cross_chunked(Ut, gt, chunk=256)
    Gj, cj = jgram.gram_and_cross_chunked(jnp.asarray(U), jnp.asarray(g),
                                          chunk=256)
    np.testing.assert_allclose(_np(Gc), np.asarray(Gj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(cc), np.asarray(cj), rtol=1e-5, atol=1e-4)
    a, b = U[:4], U[4:]
    for got, want in (
            (tgram.gram_block(torch.from_numpy(a), torch.from_numpy(b)),
             jgram.gram_block(jnp.asarray(a), jnp.asarray(b))),
            (tgram.gram_block_chunked(torch.from_numpy(a),
                                      torch.from_numpy(b), chunk=256),
             jgram.gram_block_chunked(jnp.asarray(a), jnp.asarray(b),
                                      chunk=256))):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="disagree on n"):
        tgram.gram_block_chunked(torch.from_numpy(a),
                                 torch.from_numpy(b[:, :10]))


@pytest.mark.parametrize("fns", ["default", "chunked", "kernel_op"])
def test_block_merge_equals_flat(fns):
    """``blockwise_gram_and_cross`` over uneven groups reproduces the flat
    (G, c) of the reference, with the dense, the chunked and the
    ``gram_block`` op's block functions (``tests/test_hier.py``)."""
    from repro_torch.kernels.ops import gram_block_and_cross
    U, g, G, c = _gram_inputs(K=11, n=900, seed=7)
    Ut, gt = torch.from_numpy(U), torch.from_numpy(g)
    kw = {"default": {},
          "chunked": dict(
              diag_fn=lambda u, gr: tgram.gram_and_cross_chunked(u, gr, 256),
              block_fn=lambda a, b: tgram.gram_block_chunked(a, b, 256)),
          "kernel_op": dict(
              block_fn=lambda a, b: gram_block_and_cross(a, b, gt)[0])}[fns]
    Gm, cm = tgram.blockwise_gram_and_cross(_split(Ut, (4, 3, 4)), gt, **kw)
    Gr, cr = jgram.blockwise_gram_and_cross(_split(jnp.asarray(U), (4, 3, 4)),
                                            jnp.asarray(g))
    np.testing.assert_allclose(_np(Gm), np.asarray(Gr), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(cm), np.asarray(cr), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(Gm), G, rtol=1e-5, atol=1e-4)


def test_merge_gram_blocks_validates_segment_count():
    with pytest.raises(ValueError, match="cross-term"):
        tgram.merge_gram_blocks([torch.eye(2)], {}, [])
    with pytest.raises(ValueError, match="cross-term"):
        jgram.merge_gram_blocks([jnp.eye(2)], {}, [])


SOLVES = {
    "cholesky": dict(beta=5.0),
    "pinv": dict(beta=5.0, method="pinv"),
    "expectation_scale": dict(beta=5.0, expectation_scale=2.5),
    "pinv_expectation": dict(beta=2.0, method="pinv", expectation_scale=3.0),
    "sum_to": dict(beta=5.0, sum_to=1.0),
    "clip_norm": dict(beta=0.01, clip_norm=0.5),      # the clip binds
    "clip_norm_slack": dict(beta=5.0, clip_norm=1e6),  # the clip is slack
    "ridge": dict(beta=1.0, ridge=0.1),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_alpha_matches_reference(name):
    _, _, G, c = _gram_inputs()
    kw = SOLVES[name]
    a_j = np.asarray(jsolve.solve_alpha(jnp.asarray(G), jnp.asarray(c),
                                        jsolve.SolveConfig(**kw)))
    Gt, ct = torch.from_numpy(G), torch.from_numpy(c)
    a_t = tsolve.solve_alpha(Gt, ct, tsolve.SolveConfig(**kw))
    np.testing.assert_allclose(_np(a_t), a_j, rtol=1e-4, atol=1e-6)
    if "sum_to" in kw:
        assert abs(float(a_t.sum()) - kw["sum_to"]) < 1e-4
    if name == "clip_norm":
        assert abs(float(torch.linalg.vector_norm(a_t)) - 0.5) < 1e-5
    beta = kw["beta"]
    np.testing.assert_allclose(
        float(tsolve.bound_value(Gt, ct, a_t, beta)),
        float(jsolve.bound_value(jnp.asarray(G), jnp.asarray(c),
                                 jnp.asarray(a_j), beta)), rtol=1e-4)
    np.testing.assert_allclose(
        float(tsolve.theorem1_reduction(Gt, a_t, beta)),
        float(jsolve.theorem1_reduction(jnp.asarray(G), jnp.asarray(a_j),
                                        beta)), rtol=1e-4)


def test_solve_config_rejects_clip_with_sum_to():
    with pytest.raises(ValueError, match="clip_norm cannot be combined"):
        tsolve.SolveConfig(sum_to=1.0, clip_norm=1.0)


# -------------------------------------------------------------- aggregators

AGGREGATORS = [
    ("fedavg", {}), ("fedprox", {}), ("weighted", {"client_weights": True}),
    ("folb", {}), ("folb", {"gram_scope": "last_layer"}),
    ("contextual", {}), ("contextual", {"gram_scope": "last_layer"}),
    ("contextual_expected", {}),
]


@pytest.mark.parametrize("name,extra", AGGREGATORS,
                         ids=[f"{n}-{'-'.join(e) or 'plain'}"
                              for n, e in AGGREGATORS])
def test_aggregators_match_reference(name, extra):
    rng = np.random.RandomState(4)
    K = 5
    params = _mlp_tree(rng)
    stacked = {k: {kk: vv * 0.1 for kk, vv in v.items()}
               for k, v in _mlp_tree(rng, K=K).items()}
    grad = _mlp_tree(rng)
    weights = rng.rand(K).astype(np.float32) + 0.1
    solve = dict(beta=4.0)
    jcfg = jagg.AggregatorConfig(
        name=name, solve=jsolve.SolveConfig(**solve),
        gram_scope=extra.get("gram_scope"),
        client_weights=jnp.asarray(weights) if "client_weights" in extra else None)
    tcfg = tagg.AggregatorConfig(
        name=name, solve=tsolve.SolveConfig(**solve),
        gram_scope=extra.get("gram_scope"),
        client_weights=torch.from_numpy(weights) if "client_weights" in extra else None)
    kw = {"pool_size": 20} if name == "contextual_expected" else {}
    new_j, info_j = jagg.aggregate(name)(_jax_tree(params), _jax_tree(stacked),
                                         _jax_tree(grad), jcfg, **kw)
    new_t, info_t = tagg.aggregate(name)(_torch_tree(params),
                                         _torch_tree(stacked),
                                         _torch_tree(grad), tcfg, **kw)
    np.testing.assert_allclose(_np(info_t["alpha"]), np.asarray(info_j["alpha"]),
                               rtol=1e-4, atol=1e-6)
    for key in info_j:
        np.testing.assert_allclose(_np(info_t[key]), np.asarray(info_j[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    for a, b in zip(tflat.tree_leaves(new_t), jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_contextual_honours_gram_override():
    rng = np.random.RandomState(5)
    params, stacked = _logreg_tree(rng), _logreg_tree(rng, K=3)
    _, _, G, c = _gram_inputs(K=3, n=10, seed=6)
    jcfg = jagg.AggregatorConfig(gram_override=(jnp.asarray(G), jnp.asarray(c)))
    tcfg = tagg.AggregatorConfig(gram_override=(torch.from_numpy(G),
                                                torch.from_numpy(c)))
    _, info_j = jagg.aggregate("contextual")(_jax_tree(params),
                                             _jax_tree(stacked), None, jcfg)
    _, info_t = tagg.aggregate("contextual")(_torch_tree(params),
                                             _torch_tree(stacked), None, tcfg)
    np.testing.assert_allclose(_np(info_t["alpha"]), np.asarray(info_j["alpha"]),
                               rtol=1e-4, atol=1e-6)


def test_aggregator_registry():
    import repro_torch.hier  # noqa: F401  (registers the hier aggregators)
    import repro_torch.edge  # noqa: F401  (registers the async aggregators)
    import repro_torch.robust  # noqa: F401  (registers the robust ones)
    core = ("contextual", "contextual_expected", "fedavg", "fedprox", "folb",
            "weighted")
    hier = ("hier_contextual", "hier_contextual_sketch", "hier_fedavg",
            "hier_relay")
    edge = ("contextual_async", "fedasync", "fedbuff")
    robust = ("contextual_clipped", "contextual_mom", "coordinate_median",
              "krum")
    assert tagg.available_aggregators() == tuple(sorted(core + hier + edge
                                                        + robust))
    # the reference registry also holds what its subsystems registered
    assert set(core) <= set(jagg.available_aggregators())
    with pytest.raises(KeyError, match="unknown aggregator"):
        tagg.aggregate("bogus")
    with pytest.raises(KeyError, match="already registered"):
        tagg.register_aggregator("fedavg", tagg.aggregate_fedavg)
    tagg.register_aggregator("fedavg", tagg.aggregate_fedavg, overwrite=True)
