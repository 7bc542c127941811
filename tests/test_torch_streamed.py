"""The port's streamed round engine (``repro_torch.hier.streamed``) and its
``stream_stats`` op against ``repro.hier.streamed``, the port's fused engine
and ``repro.fl.run_hier_simulation``.

Inputs are made with numpy and handed to both packages.  The tolerance is
the reference's own ``TOL`` (``tests/test_streamed_engine.py``: rtol 1e-5,
atol 1e-4): f32 accumulation in another order, the same solves.  The
reference's streamed tests are ported here except the autotune cap (the
port dispatches by device, with no autotune); the mesh-sharded chunk axis
on one device is ``tests/test_torch_distributed.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import CompressConfig as JCompressConfig
from repro.core.flatten import ChunkedFlatView as JView
from repro.core.solve import SolveConfig as JSolveConfig
from repro.fl.simulation import run_hier_simulation as j_run
from repro.hier import HierConfig as JHierConfig
from repro.hier import streamed as jstreamed
from repro.hier import two_tier_topology as j_two_tier
from repro.edge import bimodal_fleet as j_bimodal
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.logistic import logistic_apply as j_apply
from repro.models.logistic import logistic_loss as j_loss
from repro_torch.compress import CompressConfig, ErrorFeedback
from repro_torch.convert import params_from_jax
from repro_torch.core.flatten import ChunkedFlatView, tree_leaves, tree_map
from repro_torch.core.solve import SolveConfig
from repro_torch.data.federated import FederatedDataset as TFederatedDataset
from repro_torch.edge import bimodal_fleet
from repro_torch.fl.simulation import run_hier_simulation as t_run
from repro_torch.hier import HierConfig, fused, streamed, two_tier_topology
from repro_torch.hier.streamed import (RowMix, StreamedRoundEngine,
                                       dense_round_bytes)
from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                 stream_stats)
from repro_torch.models.logistic import logistic_apply as t_apply
from repro_torch.models.logistic import logistic_loss as t_loss

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
LEAVES = ((3, 5), (7,), (4, 6), (1,))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _allclose(x, y):
    np.testing.assert_allclose(np.asarray(_np(x), np.float32),
                               np.asarray(_np(y), np.float32), **TOL)


def _stacked_np(P=8, seed=0, leaves=LEAVES):
    """A stacked multi-leaf tree (leading P axis) and its gradient twin, as
    numpy arrays."""
    rng = np.random.RandomState(seed)
    tree = {f"leaf{i}": rng.randn(P, *shape).astype(np.float32)
            for i, shape in enumerate(leaves)}
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in tree.items()}
    return tree, grads


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _template(tree):
    return {k: v[0] for k, v in tree.items()}


# ------------------------------------------------------------- kernel op

@pytest.mark.parametrize("P,n", [(4, 333), (1, 7), (6, 64), (5, 100),
                                 (3, 129)])
def test_stream_stats_plain_matches_reference(P, n):
    rng = np.random.RandomState(P * 1000 + n)
    D = rng.randn(P, n).astype(np.float32)
    GM = rng.randn(P, n).astype(np.float32)
    want = jref.stream_stats_ref(jnp.asarray(D), jnp.asarray(GM))
    xla = jops.stream_stats(jnp.asarray(D), jnp.asarray(GM), backend="xla",
                            block_n=64)
    reset_launch_counts()
    G, C = stream_stats(torch.from_numpy(D), torch.from_numpy(GM))
    assert launch_counts()["stream_stats/torch"] == 1
    assert G.dtype == torch.float32 and tuple(G.shape) == (P, P)
    for got, ref, x in ((G, want[0], xla[0]), (C, want[1], xla[1])):
        _allclose(got, ref)
        _allclose(got, x)


def test_stream_stats_bf16_inputs_accumulate_f32():
    D = torch.ones((3, 300), dtype=torch.bfloat16)
    G, C = stream_stats(D, D)
    assert G.dtype == torch.float32
    np.testing.assert_array_equal(_np(G), np.full((3, 3), 300.0))
    np.testing.assert_array_equal(_np(C), np.full((3, 3), 300.0))


def test_stream_stats_adds_into_out_in_slab_order():
    """``out=(G, C)`` sums slabs: two column slabs give the statistics of
    the whole matrix."""
    rng = np.random.RandomState(4)
    D = torch.from_numpy(rng.randn(5, 90).astype(np.float32))
    GM = torch.from_numpy(rng.randn(5, 90).astype(np.float32))
    out = (torch.zeros(5, 5), torch.zeros(5, 5))
    for sl in (slice(0, 37), slice(37, 90)):
        assert stream_stats(D[:, sl], GM[:, sl], out=out) is out
    whole = stream_stats(D, GM)
    _allclose(out[0], whole[0])
    _allclose(out[1], whole[1])


# --------------------------------------------------------- chunked view

@pytest.mark.parametrize("scope", [None, "last_layer", "leaf2"])
def test_chunked_flat_view_matches_reference(scope):
    tree, _ = _stacked_np(P=6)
    jv, tv = JView(_jt(tree), scope), ChunkedFlatView(_tt(tree), scope)
    assert (tv.K, tv.n, tv.n_scoped) == (jv.K, jv.n, jv.n_scoped)
    assert [(s.index, s.offset, s.width, s.in_scope) for s in tv.slabs] == \
        [(s.index, s.offset, s.width, s.in_scope) for s in jv.slabs]
    for s, js in zip(tv.slabs, jv.slabs):
        np.testing.assert_array_equal(_np(s.matrix), np.asarray(js.matrix))
    np.testing.assert_array_equal(_np(tv.materialize()),
                                  np.asarray(jv.materialize()))
    for chunk in (1, 4, 7, 1000):
        for scoped in (False, True):
            got = list(tv.chunks(chunk, scoped_only=scoped))
            want = list(jv.chunks(chunk, scoped_only=scoped))
            assert [(o, s) for o, s, _ in got] == [(o, s) for o, s, _ in want]
            for (_, _, a), (_, _, b) in zip(got, want):
                np.testing.assert_array_equal(_np(a), np.asarray(b))
    with pytest.raises(ValueError, match="chunk_cols"):
        next(tv.chunks(0))


# --------------------------------------------------- P-space stages

def _stats(P=9, seed=3):
    """(G, C) of a random round, as numpy, and both packages' configs."""
    tree, grads = _stacked_np(P=P, seed=seed)
    D = np.concatenate([v.reshape(P, -1) for v in tree.values()], axis=1)
    GM = np.concatenate([v.reshape(P, -1) for v in grads.values()], axis=1)
    return (D @ D.T).astype(np.float32), (D @ GM.T).astype(np.float32)


@pytest.mark.parametrize("mode,pool_scale,with_g", [
    ("contextual", 1.0, False), ("contextual", 1.5, True),
    ("mean", 1.0, False)])
def test_tier_and_merge_stages_match_reference(mode, pool_scale, with_g):
    G, C = _stats()
    P = G.shape[0]
    jcfg, tcfg = JSolveConfig(beta=4.0, ridge=1e-8), SolveConfig(beta=4.0,
                                                                 ridge=1e-8)
    idx = np.array([1, 3, 4, 6])
    g_w = np.linspace(0.0, 1.0, P).astype(np.float32) / P if with_g else None
    jout = jstreamed.tier_stage(P, 4, jcfg, mode, pool_scale=pool_scale)(
        jnp.asarray(G), jnp.asarray(C), jnp.asarray(idx, jnp.int32),
        jnp.ones(4, jnp.float32), None if g_w is None else jnp.asarray(g_w))
    tout = streamed.tier_stage(
        torch.from_numpy(G), torch.from_numpy(C), torch.from_numpy(idx),
        torch.ones(4), tcfg, mode, pool_scale=pool_scale,
        g_w=None if g_w is None else torch.from_numpy(g_w))
    for k in ("G", "c", "alpha", "u_w", "ghat_w"):
        _allclose(tout[k], jout[k])
    for k in jout["info"]:
        _allclose(tout["info"][k], jout["info"][k])
    # a merge over three cohorts' mixes
    rng = np.random.RandomState(1)
    W = rng.rand(3, P).astype(np.float32)
    GW = rng.rand(3, P).astype(np.float32) / P
    counts = np.array([3.0, 2.0, 4.0], np.float32)
    jm = jstreamed.merge_stage(P, 3, jcfg, mode)(
        jnp.asarray(G), jnp.asarray(C), jnp.asarray(W), jnp.asarray(GW),
        jnp.asarray(counts), None if g_w is None else jnp.asarray(g_w))
    tm = streamed.merge_stage(
        torch.from_numpy(G), torch.from_numpy(C), torch.from_numpy(W),
        torch.from_numpy(GW), torch.from_numpy(counts), tcfg, mode,
        g_w=None if g_w is None else torch.from_numpy(g_w))
    for k in ("G", "c", "alpha", "u_w", "ghat_w"):
        _allclose(tm[k], jm[k])


@pytest.mark.parametrize("kind,scale", [("raw", 1.0), ("raw", 2.0),
                                        ("fedavg", 1.0)])
def test_cloud_stages_match_reference(kind, scale):
    G, C = _stats(P=7, seed=4)
    jcfg, tcfg = JSolveConfig(beta=3.0, ridge=1e-8), SolveConfig(beta=3.0,
                                                                 ridge=1e-8)
    idx = np.array([0, 2, 3, 5, 6])
    jout = jstreamed.cloud_raw_stage(7, 5, jcfg, kind, solve_scale=scale)(
        jnp.asarray(G), jnp.asarray(C), jnp.asarray(idx, jnp.int32),
        jnp.ones(5, jnp.float32))
    tout = streamed.cloud_raw_stage(
        torch.from_numpy(G), torch.from_numpy(C), torch.from_numpy(idx),
        torch.ones(5), tcfg, kind, solve_scale=scale)
    _allclose(tout["u_w"], jout["u_w"])
    for k in jout["info"]:
        _allclose(tout["info"][k], jout["info"][k])
    combo = "fedavg" if kind == "fedavg" else "combo"
    rng = np.random.RandomState(2)
    W = rng.rand(2, 7).astype(np.float32)
    g_w = (rng.rand(7) / 7).astype(np.float32)
    counts = np.array([3.0, 4.0], np.float32)
    jc = jstreamed.cloud_combo_stage(7, 2, jcfg, combo)(
        jnp.asarray(G), jnp.asarray(C), jnp.asarray(W), jnp.asarray(g_w),
        jnp.asarray(counts))
    tc = streamed.cloud_combo_stage(
        torch.from_numpy(G), torch.from_numpy(C), torch.from_numpy(W),
        torch.from_numpy(g_w), torch.from_numpy(counts), tcfg, combo)
    _allclose(tc["eff_w"], jc["eff_w"])
    for k in jc["info"]:
        _allclose(tc["info"][k], jc["info"][k])


# ------------------------------------------------ round contexts

def _round_ctxs(P=8, seed=0, scope=None, chunk=None, beta=4.0, mode=None):
    """The port's fused and streamed contexts and the reference's streamed
    context on one round."""
    tree, grads = _stacked_np(P=P, seed=seed)
    mode = mode or "contextual"
    tcfg = SolveConfig(beta=beta, ridge=1e-8)
    tmpl = _template(_tt(tree))
    fctx = fused.HierRoundEngine(tmpl, tcfg, mode, scope).begin_round(
        _tt(tree), _tt(grads))
    sctx = StreamedRoundEngine(tmpl, tcfg, mode, scope,
                               chunk=chunk).begin_round(_tt(tree), _tt(grads))
    jctx = jstreamed.StreamedRoundEngine(
        _template(_jt(tree)), JSolveConfig(beta=beta, ridge=1e-8), mode,
        scope, chunk=chunk).begin_round(_jt(tree), _jt(grads))
    return fctx, sctx, jctx, tree, grads


@pytest.mark.parametrize("scope,chunk", [(None, None), (None, 7),
                                         ("leaf2", 5)])
def test_gateway_stage_matches_fused_and_reference(scope, chunk):
    fctx, sctx, jctx, _, _ = _round_ctxs(scope=scope, chunk=chunk)
    _allclose(sctx.G, jctx.G)
    _allclose(sctx.C, jctx.C)
    idxs = [1, 3, 4, 6]
    fo, so, jo = fctx.gateway(idxs), sctx.gateway(idxs), jctx.gateway(idxs)
    for k in ("G", "c", "alpha"):
        _allclose(so[k], fo[k])
        _allclose(so[k], jo[k])
    _allclose(sctx.materialize(so["u_bar"]), fo["u_bar"])
    _allclose(sctx.materialize(so["ghat"]), fo["ghat"])
    _allclose(sctx.materialize(so["u_bar"]), jctx.materialize(jo["u_bar"]))


def test_merge_and_cloud_stages_match_fused_and_reference():
    fctx, sctx, jctx, _, _ = _round_ctxs(P=9, seed=3)
    cohorts = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    fs = [fctx.gateway(c) for c in cohorts]
    ss = [sctx.gateway(c) for c in cohorts]
    js = [jctx.gateway(c) for c in cohorts]
    counts = [3.0, 3.0]
    fm = fctx.merge([s["u_bar"] for s in fs[:2]], [s["ghat"] for s in fs[:2]],
                    counts)
    sm = sctx.merge([s["u_bar"] for s in ss[:2]], [s["ghat"] for s in ss[:2]],
                    counts)
    jm = jctx.merge([s["u_bar"] for s in js[:2]], [s["ghat"] for s in js[:2]],
                    counts)
    for k in ("G", "c", "alpha"):
        _allclose(sm[k], fm[k])
        _allclose(sm[k], jm[k])
    _allclose(sctx.materialize(sm["u_bar"]), fm["u_bar"])
    ghat_f = fctx.compose_grads([fm["ghat"], fs[2]["ghat"]], [6.0, 3.0])
    ghat_s = sctx.compose_grads([sm["ghat"], ss[2]["ghat"]], [6.0, 3.0])
    ghat_j = jctx.compose_grads([jm["ghat"], js[2]["ghat"]], [6.0, 3.0])
    assert isinstance(ghat_s, RowMix)
    _allclose(ghat_s.w, ghat_j.w)
    fd, fi = fctx.cloud_combo([fm["u_bar"], fs[2]["u_bar"]], [6.0, 3.0],
                              ghat_f)
    sd, si = sctx.cloud_combo([sm["u_bar"], ss[2]["u_bar"]], [6.0, 3.0],
                              ghat_s)
    jd, ji = jctx.cloud_combo([jm["u_bar"], js[2]["u_bar"]], [6.0, 3.0],
                              ghat_j)
    for k in ("gamma", "gram_diag"):
        _allclose(si[k], fi[k])
        _allclose(si[k], ji[k])
    _allclose(sctx.materialize(sd), fd)
    _allclose(sd.w, jd.w)


@pytest.mark.parametrize("mode,kind", [("contextual", "raw"),
                                       ("mean", "fedavg")])
def test_cloud_raw_and_fedavg_match_fused(mode, kind):
    fctx, sctx, jctx, _, _ = _round_ctxs(P=7, seed=4, beta=3.0, mode=mode)
    idxs = [0, 2, 3, 5, 6]
    fd, fi = fctx.cloud_raw(idxs, kind)
    sd, si = sctx.cloud_raw(idxs, kind)
    jd, ji = jctx.cloud_raw(idxs, kind)
    _allclose(si["gamma"], fi["gamma"])
    _allclose(si["gamma"], ji["gamma"])
    _allclose(sctx.materialize(sd), fd)


def test_streamed_apply_matches_dense_apply_and_reference():
    fctx, sctx, jctx, tree, _ = _round_ctxs(P=8, seed=5)
    w = np.random.RandomState(9).randn(8).astype(np.float32)
    tmpl = _template(_tt(tree))
    fres = fctx.apply(tmpl, torch.from_numpy(w) @ fctx.D)
    sres = sctx.apply(tmpl, RowMix(torch.from_numpy(w), "delta"))
    jres = jctx.apply(_template(_jt(tree)), jstreamed.RowMix(jnp.asarray(w),
                                                             "delta"))
    for a, b, c in zip(tree_leaves(sres), tree_leaves(fres),
                       jax.tree_util.tree_leaves(jres)):
        _allclose(a, b)
        _allclose(a, c)
    # a dense delta (above a compression hop) takes the fused apply
    dense = sctx.apply(tmpl, torch.from_numpy(w) @ fctx.D)
    for a, b in zip(tree_leaves(dense), tree_leaves(fres)):
        _allclose(a, b)


def test_apply_does_not_donate_by_default():
    """The caller's params stay as they were unless the engine donates
    them; with ``donate_params`` the update lands in the same tensors."""
    tree, grads = _stacked_np(P=8, seed=7)
    tmpl = _template(_tt(tree))
    before = {k: v.clone() for k, v in tmpl.items()}
    w = RowMix(torch.ones(8) / 8, "delta")
    eng = StreamedRoundEngine(tmpl, SolveConfig(beta=2.0), "contextual")
    assert eng.donate_params is False
    ctx = eng.begin_round(_tt(tree), _tt(grads))
    a, b = ctx.apply(tmpl, w), ctx.apply(tmpl, w)
    for k in tmpl:
        torch.testing.assert_close(tmpl[k], before[k], rtol=0, atol=0)
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    donating = StreamedRoundEngine(tmpl, SolveConfig(beta=2.0), "contextual",
                                   donate_params=True)
    params = {k: v.clone() for k, v in tmpl.items()}
    ptrs = {k: v.data_ptr() for k, v in params.items()}
    out = donating.begin_round(_tt(tree), _tt(grads)).apply(params, w)
    for k in tmpl:
        assert out[k].data_ptr() == ptrs[k]
        torch.testing.assert_close(out[k], a[k], rtol=0, atol=0)


def test_sketch_ef_composition_matches_fused():
    """Materialized refs feed the same EF/encode pipeline as the fused
    engine's vectors: identical payloads, decodes and residuals."""
    fctx, sctx, _, _, _ = _round_ctxs(P=8, seed=6)
    comp = CompressConfig(scheme="sign_sketch", ratio=4.0).build(
        fctx.D.shape[1])
    ef_f, ef_s = ErrorFeedback(), ErrorFeedback()
    for rnd in range(3):                 # residuals telescope across rounds
        fo = fctx.gateway([1, 2, 5])
        so = sctx.gateway([1, 2, 5])
        cf, df = ef_f.step(("u", 0), fo["u_bar"], comp, seed=rnd)
        cs, ds = ef_s.step(("u", 0), sctx.materialize(so["u_bar"]), comp,
                           seed=rnd)
        _allclose(cs.data[0], cf.data[0])
        _allclose(ds, df)
        _allclose(ef_s.residual[("u", 0)], ef_f.residual[("u", 0)])
    # decoded (dense) refs re-enter the streamed tiers through the fused
    # stack stages: a mixed-ref merge must still match
    fo2, so2 = fctx.gateway([0, 4]), sctx.gateway([0, 4])
    fm = fctx.merge([df, fo2["u_bar"]], [fo2["ghat"], fo2["ghat"]],
                    [3.0, 2.0])
    sm = sctx.merge([ds, so2["u_bar"]], [so2["ghat"], so2["ghat"]],
                    [3.0, 2.0])
    _allclose(sm["alpha"], fm["alpha"])
    _allclose(sctx.materialize(sm["u_bar"]), fm["u_bar"])


def test_streamed_never_builds_dense_round_matrix(monkeypatch):
    """The accumulate pass calls ``stream_stats`` on leaf-slab shapes, never
    on a concatenated (P, n) matrix, and sums every scoped slab."""
    tree, grads = _stacked_np(P=5, seed=8)
    tmpl = _template(_tt(tree))
    seen = []
    orig = streamed.stream_stats

    def spy(d, g, **kw):
        seen.append((tuple(d.shape), tuple(g.shape), d.is_contiguous()))
        return orig(d, g, **kw)

    monkeypatch.setattr(streamed, "stream_stats", spy)
    ctx = StreamedRoundEngine(tmpl, SolveConfig(beta=2.0), "contextual",
                              chunk=8).begin_round(_tt(tree), _tt(grads))
    n = sum(v.numel() for v in tmpl.values())
    assert [s[0] for s in seen] == [(5, int(np.prod(s))) for s in LEAVES]
    assert all(d == g and d[1] < n and contig for d, g, contig in seen)
    D = np.concatenate([v.reshape(5, -1) for v in tree.values()], axis=1)
    _allclose(ctx.G, D @ D.T)


# ------------------------------------------------------------ estimator

def test_peak_bytes_equal_the_reference():
    tmpl_np = {"w": np.zeros((1000, 100), np.float32),
               "b": np.zeros((100,), np.float32)}
    n = 1000 * 100 + 100
    for P, chunk, members in ((16, 1 << 10, 0), (16, 1 << 10, 4),
                              (100, 1 << 30, 0), (3, 7, 2)):
        t = StreamedRoundEngine(_tt(tmpl_np), SolveConfig(beta=4.0),
                                "contextual", chunk=chunk)
        j = jstreamed.StreamedRoundEngine(_jt(tmpl_np), JSolveConfig(beta=4.0),
                                          "contextual", chunk=chunk)
        assert t.peak_round_bytes(P, dense_fallback_members=members) == \
            j.peak_round_bytes(P, dense_fallback_members=members)
    assert dense_round_bytes(16, n) == jstreamed.dense_round_bytes(16, n)
    feng = fused.HierRoundEngine(_tt(tmpl_np), SolveConfig(beta=4.0),
                                 "contextual")
    assert feng.peak_round_bytes(16) == dense_round_bytes(16, n)
    with pytest.raises(ValueError, match="chunk"):
        StreamedRoundEngine(_tt(tmpl_np), SolveConfig(beta=4.0),
                            "contextual", chunk=0)
    # the robust tier statistics are ported: the engine holds the config,
    # as the reference's does
    from repro_torch.robust import RobustConfig
    rob = RobustConfig(clip=2.0, pool="mom")
    assert StreamedRoundEngine(_tt(tmpl_np), SolveConfig(beta=4.0),
                               "contextual", robust=rob).robust is rob


# ------------------------------------------------------ whole runs

DIM, CLASSES, N_DEV = 20, 10, 12
N_MODEL = DIM * CLASSES + CLASSES
BASE = dict(lr=0.2, batch_size=10, min_epochs=1, max_epochs=3)


@pytest.fixture(scope="module")
def problem():
    from repro.data import make_synthetic
    from repro.data.federated import FederatedDataset as JFederatedDataset
    from repro.models import get_model
    from repro.models.config import ArchConfig
    xs, ys = make_synthetic(1.0, 1.0, num_devices=N_DEV,
                            samples_per_device=30, dim=DIM, seed=5)
    mask = np.ones(ys.shape, np.float32)
    tx, ty = xs.reshape(-1, DIM)[:150], ys.reshape(-1)[:150]
    jds = JFederatedDataset(xs, ys, mask, tx, ty, CLASSES)
    tds = TFederatedDataset(xs, ys, mask, tx, ty, CLASSES)
    jp = get_model(ArchConfig(name="lr", family="logreg", input_dim=DIM,
                              num_classes=CLASSES)).init(
        jax.random.PRNGKey(0))
    return jds, tds, jp, params_from_jax(jp, device="cpu")


def _t(problem, cfg, engine, rounds=4, seed=11, **kw):
    _, tds, _, tp = problem
    gen = torch.Generator()
    gen.manual_seed(seed)
    topo = two_tier_topology(bimodal_fleet(N_DEV, slowdown=5.0,
                                           dropout_slow=0.1, seed=0), 3)
    return t_run("t", t_loss, t_apply, tp, tds, cfg, topo,
                 num_rounds=rounds, selection_seed=seed, eval_every=rounds,
                 engine=engine, device="cpu", batch_generator=gen, **kw)


CONFIGS = {
    "contextual": dict(aggregator="hier_contextual"),
    "global_grad": dict(aggregator="hier_contextual", gateway_grad="global"),
    "sign_sketch": dict(aggregator="hier_contextual_sketch",
                        compress=dict(scheme="sign_sketch", ratio=4.0)),
}


def _cfgs(name):
    kw = dict(CONFIGS[name])
    comp = kw.pop("compress", None)
    t = HierConfig(compress=None if comp is None else CompressConfig(**comp),
                   **kw, **BASE)
    j = JHierConfig(compress=None if comp is None else JCompressConfig(**comp),
                    **kw, **BASE)
    return t, j


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_streamed_matches_fused_and_reference_bytes(problem, name):
    """Streamed against fused on the same mini-batches: losses at TOL,
    bytes equal to each other and to the reference run's."""
    tcfg, jcfg = _cfgs(name)
    rf = _t(problem, tcfg, "fused")
    rs = _t(problem, tcfg, "streamed", stream_chunk=37)
    _allclose(rs.train_loss[-1], rf.train_loss[-1])
    assert rs.cloud_uplink_bytes == rf.cloud_uplink_bytes
    assert rs.total_bytes == rf.total_bytes
    assert rf.engine["engine_name"] == "fused"
    assert rs.engine["engine_name"] == "streamed"
    jds, _, jp, _ = problem
    jtopo = j_two_tier(j_bimodal(N_DEV, slowdown=5.0, dropout_slow=0.1,
                                 seed=0), 3)
    rj = j_run("t", j_loss, j_apply, jp, jds, jcfg, jtopo, num_rounds=4,
               selection_seed=11, eval_every=4, engine="streamed",
               stream_chunk=37)
    assert rs.cloud_uplink_bytes == rj.cloud_uplink_bytes
    assert rs.total_bytes == rj.total_bytes
    assert rs.engine["round_matrix_peak_bytes"] == \
        rj.engine["round_matrix_peak_bytes"]


def test_streamed_run_goes_through_stream_stats_and_keeps_init_params(
        problem):
    _, _, _, tp = problem
    before = {k: v.clone() for k, v in tp.items()}
    tcfg, _ = _cfgs("contextual")
    reset_launch_counts()
    rs = _t(problem, tcfg, "streamed", rounds=2)
    counts = launch_counts()
    assert counts["stream_stats/torch"] == 2 * 2      # two leaves per round
    assert counts["gram/torch"] == 0                   # no dense Gram
    assert rs.engine["dense_fallback_members"] == 0
    for k in tp:
        torch.testing.assert_close(tp[k], before[k], rtol=0, atol=0)


def test_engine_auto_selection_budget(problem, monkeypatch):
    tcfg, _ = _cfgs("contextual")
    r = _t(problem, tcfg, "auto", rounds=1)
    assert r.engine["engine_name"] == "fused"      # tiny model under budget
    monkeypatch.setenv("REPRO_DENSE_ROUND_BYTES", "10")
    r2 = _t(problem, tcfg, "auto", rounds=1)
    assert r2.engine["engine_name"] == "streamed"
    _allclose(r2.train_loss[-1], r.train_loss[-1])
    with pytest.raises(ValueError, match="unknown engine"):
        _t(problem, tcfg, "bogus", rounds=1)
    # explicit streamed + device-uplink decode rows fail loudly; auto picks
    # the fused engine instead
    dcfg = HierConfig(aggregator="hier_contextual_sketch",
                      compress=CompressConfig(scheme="topk", ratio=4.0,
                                              u_frac=0.75,
                                              device_uplink=True), **BASE)
    with pytest.raises(ValueError, match="device_uplink"):
        _t(problem, dcfg, "streamed", rounds=1)
    assert _t(problem, dcfg, "auto", rounds=1).engine["engine_name"] == \
        "fused"


def test_compressed_run_reports_dense_fallback_peak(problem):
    plain = _t(problem, _cfgs("contextual")[0], "streamed", rounds=1)
    comp = _t(problem, _cfgs("sign_sketch")[0], "streamed", rounds=1)
    # 3 gateways report dense decodes to the cloud: 2 stacks of (3, n) f32
    assert comp.engine["dense_fallback_members"] == 3
    assert (comp.engine["round_matrix_peak_bytes"]
            == plain.engine["round_matrix_peak_bytes"] + 2 * 3 * N_MODEL * 4)


def test_streamed_unported_parts_still_raise(problem):
    tcfg, _ = _cfgs("contextual")
    # the mesh is ported: a one-rank mesh runs the same streamed round, and
    # an object that is no mesh fails naming the class it wants
    from repro_torch.launch.mesh import make_mesh
    one = _t(problem, tcfg, "streamed", rounds=1,
             mesh=make_mesh((1,), ("data",)))
    assert one.train_loss == _t(problem, tcfg, "streamed",
                                rounds=1).train_loss
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        _t(problem, tcfg, "streamed", rounds=1, mesh=object())
    # the cohort scheduler is ported: the same call runs, on the event
    # path's clock
    cohort = _t(problem, tcfg, "streamed", rounds=1, scheduler_mode="cohort")
    assert cohort.engine["engine_name"] == "streamed"
    assert cohort.times == _t(problem, tcfg, "streamed", rounds=1).times
    with pytest.raises(TypeError, match="RobustConfig"):
        HierConfig(robust=object(), **BASE)


def test_streamed_bf16_round_rounds_weights_to_the_leaf_dtype():
    """A stacked bf16 tree through a streamed round: the statistics
    accumulate in f32, and apply rounds each weight to bf16 (as
    ``mix_rows``) and keeps the leaves' dtype."""
    tree, grads = _stacked_np(P=4, seed=2)
    tb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tree.items()}
    gb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in grads.items()}
    tmpl = tree_map(lambda v: v[0], tb)
    ctx = StreamedRoundEngine(tmpl, SolveConfig(beta=2.0),
                              "contextual").begin_round(tb, gb)
    w = torch.tensor([0.3, -0.2, 0.7, 0.1])
    out = ctx.apply(tmpl, RowMix(w, "delta"))
    wq = w.to(torch.bfloat16).float()
    for k, v in out.items():
        assert v.dtype == torch.bfloat16
        want = (tmpl[k].float() + torch.einsum(
            "k,k...->...", wq, tb[k].float())).to(torch.bfloat16)
        torch.testing.assert_close(v, want, rtol=0, atol=0)
    D = torch.cat([v.reshape(4, -1).float() for v in tb.values()], dim=1)
    _allclose(ctx.G, D @ D.T)


def _mixed_dtype_round(P=6, seed=3):
    """A streamed round over a stacked tree of bf16 and f32 leaves, its
    template, and the round's weights."""
    tree, grads = _stacked_np(P=P, seed=seed,
                              leaves=((3, 5), (7,), (4, 6), (1,), (2, 8)))
    dts = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float32,
           torch.bfloat16]
    tt = {k: torch.from_numpy(v).to(dt) for (k, v), dt in zip(tree.items(),
                                                             dts)}
    gt = {k: torch.from_numpy(v).to(dt) for (k, v), dt in zip(grads.items(),
                                                             dts)}
    tmpl = tree_map(lambda v: v[0].clone(), tt)
    ctx = StreamedRoundEngine(tmpl, SolveConfig(beta=2.0),
                              "contextual").begin_round(tt, gt)
    w = torch.from_numpy(np.random.RandomState(seed).randn(P)
                         .astype(np.float32) * 0.3)
    return ctx, tt, tmpl, w


def test_streamed_apply_rounds_the_weights_once_per_leaf_dtype():
    """apply casts the round's weights once for each leaf dtype (two here),
    not once per leaf (five): on the card each cast is a launch."""
    from torch.overrides import TorchFunctionMode

    ctx, _, tmpl, w = _mixed_dtype_round()

    class CountCasts(TorchFunctionMode):
        casts = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.to and args and args[0] is w:
                CountCasts.casts += 1
            return func(*args, **(kwargs or {}))

    with CountCasts():
        ctx.apply(tmpl, RowMix(w, "delta"))
    assert CountCasts.casts == 2


def test_streamed_apply_equals_the_per_leaf_rounding_bitwise():
    """The applied parameters are bitwise those of rounding the weights
    anew for every leaf, as apply did before."""
    from repro_torch.kernels import weighted_combine
    ctx, tt, tmpl, w = _mixed_dtype_round()
    got = ctx.apply(tmpl, RowMix(w, "delta"))
    for k, leaf in tt.items():
        m = leaf.reshape(leaf.shape[0], -1)
        want = weighted_combine(tmpl[k].reshape(-1), m,
                                w.to(m.dtype).float()).view(tmpl[k].shape)
        assert got[k].dtype == tmpl[k].dtype
        assert torch.equal(got[k], want)
