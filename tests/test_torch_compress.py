"""The port's summary compression (``repro_torch.compress``) and its kernels'
plain versions against ``repro.compress`` and ``repro.kernels``.

* topk: the same values and indices as the reference's ``ref`` backend,
  exactly, ties included (``lax.top_k``'s order: |v| descending, the lower
  index first among equal magnitudes).
* the counter-based sign matrix: bit-identical, and ``_seed32``'s fold too.
* sign_sketch and its adjoint: rtol 1e-5 relative to max(1, |ref|) against
  ``rng_sketch_xla`` / ``rng_sketch_adjoint_xla`` — both sum f32 products
  chunk by chunk, in another order.
* SRHT draws its signs and rows from ``jax.random`` in the reference, which
  torch cannot reproduce, so the test injects the reference's (d, rows).
* low-rank factors are sign-ambiguous under SVD: decodes are compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as jc
from repro.compress import sketch as jsketch
from repro.core.solve import SolveConfig as JSolveConfig
from repro.kernels import ops as jops
from repro.kernels import rng_sketch as jrng
from repro_torch import compress as tc
from repro_torch.compress import sketch as tsketch
from repro_torch.core.solve import SolveConfig, solve_alpha
from repro_torch.kernels import (gram_and_cross, launch_counts, ref,
                                 reset_launch_counts, sign_sketch,
                                 sign_sketch_adjoint, topk_select)

torch.set_num_threads(1)

N = 300
SCHEMES = ["identity", "sign_sketch", "srht", "topk", "lowrank"]


def _vec(seed, n=N):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


# ------------------------------------------------------------------- topk

TOPK_CASES = {
    "random": _vec(1, 257),
    "all_equal": np.where(np.arange(64) % 3 == 0, -2.5, 2.5).astype(np.float32),
    "zeros": np.zeros(40, np.float32),
    "signed_zeros": np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0], np.float32),
    "few_values": ((np.arange(90) % 4) - 1.5).astype(np.float32),
    "one": np.array([-3.0], np.float32),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_matches_reference_exactly(case):
    v = TOPK_CASES[case]
    n = v.shape[0]
    for k in sorted({1, min(5, n), n // 2 or 1, n}):
        jv, ji = jops.topk_select(jnp.asarray(v), k, backend="ref")
        tv, ti = topk_select(_t(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.dtype == torch.int32
        # bitwise, so the sign of -0.0 counts
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))


def test_topk_clamps_k_and_counts_the_plain_version():
    reset_launch_counts()
    vals, idx = topk_select(torch.tensor([1.0, -4.0, 2.0]), 10)
    assert idx.tolist() == [1, 2, 0] and vals.tolist() == [-4.0, 2.0, 1.0]
    assert launch_counts()["topk/torch"] == 1
    assert launch_counts()["topk/cuda"] == 0


# ------------------------------------------------------------- sign sketch

@pytest.mark.parametrize("seed_base,seed", [(0, 0), (0, 5), (3, 7),
                                            (2 ** 31 + 11, 2 ** 20)])
def test_seed_fold_matches(seed_base, seed):
    assert tsketch._seed32(seed_base, seed) == \
        int(jsketch._seed32(seed_base, seed))


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF, 123456789])
def test_sign_matrix_bit_identical(seed):
    want = np.asarray(jrng.rng_sign_matrix(jnp.uint32(seed), 37, 300))
    np.testing.assert_array_equal(ref.rng_sign_matrix(seed, 37, 300).numpy(),
                                  want)
    # any column window of the same matrix agrees exactly
    np.testing.assert_array_equal(
        ref.rng_sign_matrix(seed, 37, 100, col0=200).numpy(), want[:, 200:])
    s = tc.SignSketch(m=37, seed_base=seed % 1000)
    np.testing.assert_array_equal(
        s.sign_matrix(300, seed=4).numpy(),
        np.asarray(jc.SignSketch(m=37, seed_base=seed % 1000)
                   .sign_matrix(300, seed=4)))


@pytest.mark.parametrize("K,n,m", [(1, 7850, 981), (3, 9000, 77),
                                   (2, 130, 17), (1, 1, 1)])
def test_sign_sketch_matches_reference(K, n, m):
    U = np.random.RandomState(K + n).randn(K, n).astype(np.float32)
    seed = 0xC0FFEE
    want = jrng.rng_sketch_xla(jnp.asarray(U), jnp.uint32(seed), m=m)
    reset_launch_counts()
    got = sign_sketch(_t(U), seed, m)
    assert launch_counts()["sign_sketch/torch"] == 1
    assert got.shape == (K, m) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= 1e-5
    s = U[0, :m]
    want_a = jrng.rng_sketch_adjoint_xla(jnp.asarray(s), jnp.uint32(seed), n=n)
    got_a = sign_sketch_adjoint(_t(s), seed, n)
    assert got_a.shape == (n,)
    assert _rel_err(got_a.numpy(), want_a) <= 1e-5


def test_sign_sketch_compressor_matches_reference():
    v = _vec(3, 2000)
    for m in (50, 500):
        jcomp = jc.SignSketch(m=m, seed_base=2)
        tcomp = tc.SignSketch(m=m, seed_base=2)
        jpay = jcomp.encode(jnp.asarray(v), seed=9)
        tpay = tcomp.encode(_t(v), seed=9)
        assert tpay.nbytes == jpay.nbytes == 4.0 * m
        assert _rel_err(tpay.data[0].numpy(), jpay.data[0]) <= 1e-5
        assert _rel_err(tcomp.decode(tpay).numpy(), jcomp.decode(jpay)) <= 1e-5


# -------------------------------------------------------------------- SRHT

def test_fwht_matches_reference_and_rejects_odd_lengths():
    x = _vec(4, 64)
    np.testing.assert_allclose(tc.fwht(_t(x)).numpy(),
                               np.asarray(jc.fwht(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tc.fwht(tc.fwht(_t(x))).numpy(), 64 * x,
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="power-of-2"):
        tc.fwht(torch.ones(12))


@pytest.mark.parametrize("m", [40, 512])
def test_srht_with_injected_draws_matches_reference(monkeypatch, m):
    v = _vec(5, N)
    jcomp = jc.SRHTSketch(m=m, seed_base=1)
    tcomp = tc.SRHTSketch(m=m, seed_base=1)
    d, rows, NN, mm = jcomp._signs_rows(N, 6)
    monkeypatch.setattr(tcomp, "_signs_rows", lambda n, seed: (
        _t(d), torch.from_numpy(np.asarray(rows, np.int64)), NN, mm))
    jpay = jcomp.encode(jnp.asarray(v), seed=6)
    tpay = tcomp.encode(_t(v), seed=6)
    assert tpay.nbytes == jpay.nbytes
    assert _rel_err(tpay.data[0].numpy(), jpay.data[0]) <= 1e-5
    assert _rel_err(tcomp.decode(tpay).numpy(), jcomp.decode(jpay)) <= 1e-5


def test_srht_draws_are_seeded_and_exact_at_full_width():
    c = tc.SRHTSketch(m=1 << 9)
    v = _t(_vec(6, N))
    a, b = c.encode(v, seed=3), c.encode(v, seed=3)
    assert torch.equal(a.data[0], b.data[0])
    assert not torch.equal(a.data[0], c.encode(v, seed=4).data[0])
    np.testing.assert_allclose(c.decode(a).numpy(), v.numpy(), atol=1e-4)


# ----------------------------------------------------------------- lowrank

@pytest.mark.parametrize("rank", [1, 3, 18])
def test_lowrank_decode_matches_reference(rank):
    v = _vec(7, N)
    jcomp, tcomp = jc.LowRankCompressor(rank), tc.LowRankCompressor(rank)
    jpay, tpay = jcomp.encode(jnp.asarray(v)), tcomp.encode(_t(v))
    assert tpay.nbytes == jpay.nbytes
    np.testing.assert_allclose(tcomp.decode(tpay).numpy(),
                               np.asarray(jcomp.decode(jpay)),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ budget and payloads

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("ratio,u_frac", [(8.0, 0.5), (3.4, 0.75),
                                          (1.2, 0.75)])
def test_wire_sizes_match_reference(scheme, ratio, u_frac):
    if u_frac != 0.5 and scheme in ("identity", "sign_sketch", "srht"):
        with pytest.raises(ValueError, match="selection scheme"):
            tc.CompressConfig(scheme=scheme, ratio=ratio, u_frac=u_frac)
        return
    jcfg = jc.CompressConfig(scheme=scheme, ratio=ratio, u_frac=u_frac)
    tcfg = tc.CompressConfig(scheme=scheme, ratio=ratio, u_frac=u_frac)
    for n in (7, 300, 7850):
        for jcomp, tcomp in zip(jcfg.build_pair(n), tcfg.build_pair(n)):
            assert tcomp.wire_floats(n) == jcomp.wire_floats(n)
            assert tcomp.name == jcomp.name and tcomp.linear == jcomp.linear
        t_one = tcfg.build(n)
        pay = t_one.encode(_t(_vec(n, n)), seed=1)
        assert pay.nbytes == 4.0 * t_one.wire_floats(n)
        assert t_one.decode(pay).shape == (n,)


def test_wire_size_counts_four_bytes_per_element_whatever_the_dtype():
    c = tc.Compressed("x", 10, (torch.ones(3, dtype=torch.bfloat16),
                                torch.ones(2, dtype=torch.int64)))
    assert c.nbytes == 20.0


def test_path_shapes_of_the_default_and_example_budgets():
    """k = 490 for both vectors by default; ratio 3.4 / u_frac 0.75 gives
    1 731 and 577; sign_sketch at ratio 4 keeps m = 1 962."""
    n = 7850
    assert [c.k for c in tc.CompressConfig().build_pair(n)] == [490, 490]
    assert [c.k for c in tc.CompressConfig(ratio=3.4, u_frac=0.75)
            .build_pair(n)] == [1731, 577]
    assert tc.CompressConfig(scheme="sign_sketch", ratio=4.0).build(n).m \
        == 1962
    assert tc.CompressConfig(scheme="sign_sketch").build(n).m == 981


@pytest.mark.parametrize("kw,match", [
    (dict(ratio=0.5), "ratio"), (dict(k=0), "k must be"),
    (dict(sketch_dim=0), "sketch_dim"), (dict(rank=0), "rank"),
    (dict(u_frac=1.5), "u_frac"), (dict(u_frac=0.0), "u_frac"),
    (dict(scheme="srht", u_frac=0.75), "selection scheme"),
    (dict(scheme="sign_sketch", u_frac=0.6), "selection scheme"),
])
def test_compress_config_validation_matches(kw, match):
    with pytest.raises(ValueError, match=match):
        jc.CompressConfig(**kw)
    with pytest.raises(ValueError, match=match):
        tc.CompressConfig(**kw)


def test_unknown_scheme_and_registry():
    with pytest.raises(KeyError, match="unknown compression scheme"):
        tc.CompressConfig(scheme="bogus").build(100)
    assert tc.available_schemes() == jc.available_schemes()
    with pytest.raises(KeyError, match="already registered"):
        tc.register_scheme("topk", lambda cfg, n: None)
    with pytest.raises(ValueError):
        tc.TopKCompressor(0)
    with pytest.raises(ValueError):
        tc.SignSketch(0)


def test_payload_gram_matches_reference():
    vs = [_vec(10 + i) for i in range(3)]
    g = [_vec(20 + i) for i in range(3)]
    w = np.array([3.0, 1.0, 2.0])
    for scheme in ("identity", "sign_sketch", "topk"):
        jcomp = jc.CompressConfig(scheme=scheme, ratio=4.0).build(N)
        tcomp = tc.CompressConfig(scheme=scheme, ratio=4.0).build(N)
        jG, jc2 = jc.payload_gram(
            jcomp, [jcomp.encode(jnp.asarray(v), 2) for v in vs],
            [jcomp.encode(jnp.asarray(x), 2) for x in g], w)
        tG, tc2 = tc.payload_gram(tcomp, [tcomp.encode(_t(v), 2) for v in vs],
                                  [tcomp.encode(_t(x), 2) for x in g], w)
        assert _rel_err(tG.numpy(), jG) <= 1e-5, scheme
        assert _rel_err(tc2.numpy(), jc2) <= 1e-5, scheme
    # identity is the exact Gram; a linear sketch needs one shared seed
    ident = tc.IdentityCompressor()
    U = torch.stack([_t(v) for v in vs])
    G, _ = tc.payload_gram(ident, [ident.encode(u) for u in U],
                           [ident.encode(_t(g[0]))] * 3, np.ones(3))
    np.testing.assert_allclose(G.numpy(), gram_and_cross(U, U[0])[0].numpy(),
                               rtol=1e-5)
    sk = tc.SignSketch(m=30)
    with pytest.raises(ValueError, match="shared sketch"):
        tc.payload_gram(sk, [sk.encode(U[0], 0), sk.encode(U[1], 1)],
                        [sk.encode(U[0], 0)] * 2, np.ones(2))
    with pytest.raises(ValueError, match="shared sketch"):
        sk.dot(sk.encode(U[0], 0), sk.encode(U[1], 1))


def test_mass_conserving_gamma_invariant_to_uniform_gram_rescale():
    """Why sketch-space cross-terms may price unshrunk targets while the
    combine applies shrunk decodes: the Σγ=1 solve ignores a joint s²."""
    rng = np.random.RandomState(8)
    U = _t(rng.randn(4, 60).astype(np.float32))
    g = _t(rng.randn(60).astype(np.float32))
    G, c = gram_and_cross(U, g)
    cfg = SolveConfig(beta=3.0, ridge=1e-8, sum_to=1.0)
    gamma = solve_alpha(G, c, cfg)
    for s2 in (0.01, 0.3, 9.0):
        np.testing.assert_allclose(solve_alpha(s2 * G, s2 * c, cfg).numpy(),
                                   gamma.numpy(), rtol=1e-4, atol=1e-6)
    from repro.core.solve import solve_alpha as j_solve
    np.testing.assert_allclose(
        gamma.numpy(),
        np.asarray(j_solve(jnp.asarray(G.numpy()), jnp.asarray(c.numpy()),
                           JSolveConfig(beta=3.0, ridge=1e-8, sum_to=1.0))),
        rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------- error feedback

def test_error_feedback_telescopes_exactly_and_matches_reference():
    tef, jef = tc.ErrorFeedback(), jc.ErrorFeedback()
    tcomp, jcomp = tc.TopKCompressor(k=40), jc.TopKCompressor(k=40)
    total_in = torch.zeros(N)
    total_out = torch.zeros(N)
    for t in range(6):
        v = _vec(20 + t)
        _, dec = tef.step("gw", _t(v), tcomp, seed=t)
        _, jdec = jef.step("gw", jnp.asarray(v), jcomp, seed=t)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-6)
        total_in += _t(v)
        total_out += dec
    np.testing.assert_allclose((total_out + tef.residual["gw"]).numpy(),
                               total_in.numpy(), atol=1e-4)
    assert tef.residual_norm("gw") > 0
    assert tef.residual_norm("never-sent") == 0.0
    off = tc.ErrorFeedback(enabled=False)
    off.step("gw", _t(_vec(1)), tcomp)
    assert off.residual == {}
