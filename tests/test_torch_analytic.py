"""The port's analytic roofline (``repro_torch.launch.analytic``) and its
constants (``repro_torch.launch.hlo_analysis``) against ``repro``.

* Every count of ``analytic_roofline`` (``flops``, ``hbm_bytes``,
  ``coll_bytes``, ``model_flops``, ``useful_ratio``) and
  ``model_forward_flops`` equals the reference's at rel 1e-12, for every
  assigned arch × input shape, under the ``dp_only``, ``ring_kv`` and
  ``remat`` variants, both aggregators and a one-chip mesh.
* Each seconds term is the reference's times the ratio of the two
  constants (the H100's 989 TFLOP/s, 3.35 TB/s and 450 GB/s of NVLink
  against the TPU v5e's 197 TFLOP/s, 819 GB/s and four 50 GB/s links).
* The two analytic tests of ``tests/test_launch_steps.py`` on the port.
* ``hlo_analysis.roofline`` on the reference's arithmetic.
"""
import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as j_get_config
from repro.launch import analytic as janalytic
from repro.launch import hlo_analysis as jhlo
from repro.launch import shapes as jshapes
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch import analytic, hlo_analysis, shapes

torch.set_num_threads(1)

RTOL = 1e-12
COUNTS = ("flops", "hbm_bytes", "coll_bytes", "model_flops", "useful_ratio")
MESHES = [dict(), dict(data=1, model=1, pods=1), dict(data=16, model=16,
                                                      pods=2)]
VARIANTS = [dict(), dict(dp_only=True), dict(ring_kv=True),
            dict(remat=False), dict(remat="dots"),
            dict(aggregator="fedavg"), dict(gram_scope_bytes=1e8)]


def _pairs(arch):
    for name, s in shapes.INPUT_SHAPES.items():
        cfg = shapes.arch_for_shape(get_config(arch), s)
        jcfg = jshapes.arch_for_shape(j_get_config(arch),
                                      jshapes.INPUT_SHAPES[name])
        assert (cfg is None) == (jcfg is None)
        if cfg is not None:
            yield name, cfg, jcfg, s, jshapes.INPUT_SHAPES[name]


def test_assigned_is_the_reference_list():
    assert ASSIGNED == J_ASSIGNED


@pytest.mark.parametrize("arch", ASSIGNED)
def test_analytic_counts_equal_the_reference(arch):
    for name, cfg, jcfg, s, js in _pairs(arch):
        for window in (cfg.sliding_window, None, 4096):
            got = analytic.model_forward_flops(cfg, s, window)
            want = janalytic.model_forward_flops(jcfg, js, window)
            assert got == pytest.approx(want, rel=RTOL), (name, window)
        for mesh in MESHES:
            for var in VARIANTS:
                got = analytic.analytic_roofline(cfg, s, **mesh, **var)
                want = janalytic.analytic_roofline(jcfg, js, **mesh, **var)
                for key in COUNTS:
                    assert getattr(got, key) == pytest.approx(
                        getattr(want, key), rel=RTOL), (name, mesh, var, key)


@pytest.mark.parametrize("shape_name", list(shapes.INPUT_SHAPES))
def test_analytic_seconds_are_the_references_on_the_h100(shape_name):
    ratio = {"compute_s": jhlo.PEAK_FLOPS / hlo_analysis.PEAK_FLOPS,
             "memory_s": jhlo.HBM_BW / hlo_analysis.HBM_BW,
             "collective_s": jhlo.ICI_BW * 4 / hlo_analysis.LINK_BW}
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.PEAK_FLOPS_F32,
            hlo_analysis.HBM_BW, hlo_analysis.LINK_BW) == (
                989e12, 67e12, 3.35e12, 450e9)
    for arch in ASSIGNED:
        for name, cfg, jcfg, s, js in _pairs(arch):
            if name != shape_name:
                continue
            for mesh in MESHES:
                got = analytic.analytic_roofline(cfg, s, **mesh)
                want = janalytic.analytic_roofline(jcfg, js, **mesh)
                for key, r in ratio.items():
                    assert getattr(got, key) == pytest.approx(
                        getattr(want, key) * r, rel=RTOL), (arch, key)
                terms = {k: getattr(got, k) for k in ratio}
                assert got.bottleneck == max(terms, key=terms.get)[:-2]


# ---------------------------------- tests/test_launch_steps.py on the port

@pytest.mark.parametrize("shape_name", list(shapes.INPUT_SHAPES))
def test_analytic_roofline_all_pairs_finite(shape_name):
    shape = shapes.INPUT_SHAPES[shape_name]
    for arch in ASSIGNED:
        cfg = shapes.arch_for_shape(get_config(arch), shape)
        if cfg is None:
            continue
        r = analytic.analytic_roofline(cfg, shape)
        assert r.compute_s > 0 and r.memory_s > 0 and r.coll_bytes >= 0
        assert 0 < r.useful_ratio <= 1.2, (arch, shape_name, r.useful_ratio)


def test_analytic_variants_directionality():
    """dp_only must cut collectives; ring must cut decode memory; dots must
    cut train compute — the §Perf lever signs."""
    sh_t = shapes.INPUT_SHAPES["train_4k"]
    cfg = get_config("zamba2-1.2b")
    base = analytic.analytic_roofline(cfg, sh_t)
    dp = analytic.analytic_roofline(cfg, sh_t, dp_only=True)
    assert dp.collective_s < 0.2 * base.collective_s

    sh_d = shapes.INPUT_SHAPES["long_500k"]
    cham = shapes.arch_for_shape(get_config("chameleon-34b"), sh_d)
    full = analytic.analytic_roofline(cham, sh_d, ring_kv=False)
    ring = analytic.analytic_roofline(cham, sh_d, ring_kv=True)
    assert ring.memory_s < 0.6 * full.memory_s

    q = get_config("qwen2.5-32b")
    fullr = analytic.analytic_roofline(q, sh_t, remat="full")
    dots = analytic.analytic_roofline(q, sh_t, remat="dots")
    assert dots.compute_s < fullr.compute_s


# ------------------------------------------------------------ roofline()

def test_roofline_is_the_references_arithmetic_on_the_h100():
    cost = {"flops": 3.0e15, "bytes accessed": 2.0e12}
    coll = dict(hlo_analysis.empty_collectives(), total=5.0e10)
    got = hlo_analysis.roofline(cost, coll, 6.0e17, num_chips=256)
    want = jhlo.roofline(cost, coll, 6.0e17, num_chips=256)
    assert got.compute_s == pytest.approx(want.compute_s * 197 / 989)
    assert got.memory_s == pytest.approx(want.memory_s * 819e9 / 3.35e12)
    assert got.collective_s == pytest.approx(want.collective_s * 200 / 450)
    for key in ("flops", "hbm_bytes", "coll_bytes", "model_flops",
                "useful_ratio"):
        assert getattr(got, key) == pytest.approx(getattr(want, key))
    assert got.bottleneck == "compute" and want.bottleneck == "compute"
    assert set(hlo_analysis.empty_collectives()) == set(
        jhlo.collective_bytes(""))
