"""Roofline methodology on the port (``tests/test_roofline_calibration.py``'s
twin).

1. The reference's premise is reversed: XLA's ``cost_analysis`` counts a
   scanned layer once, while an eager trace (``FlopCounterMode`` on fake
   tensors) dispatches every layer, so L = 4 counts at least 3.5× L = 1
   once the head is taken out.
2. The reference's ``CAL_CASES`` hold at its tolerances: the analytic
   forward FLOPs (``repro_torch.launch.analytic.model_forward_flops``)
   against ``FlopCounterMode`` on the port's ``train_loss`` forward under
   ``launch.shapes.fake_mode()`` (one layer, f32, short sequences).
3. ``hlo_analysis.TraceCost`` counts the same FLOPs as ``FlopCounterMode``.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.analytic import model_forward_flops
from repro_torch.launch.dryrun import to_fake
from repro_torch.launch.shapes import InputShape, fake_mode, meta_params
from repro_torch.models import get_model

torch.set_num_threads(1)

# (arch, B, S, rel_tolerance) — the reference's, unchanged
CAL_CASES = [
    ("qwen3-14b", 2, 512, 0.5),
    ("gemma-7b", 2, 512, 0.5),
    ("olmoe-1b-7b", 2, 512, 0.6),
    ("rwkv6-1.6b", 2, 64, 0.8),
]


def _forward_flops(cfg, B, S, trace_cost=False) -> float:
    """FLOPs of one ``train_loss`` forward on fake tensors."""
    bundle = get_model(cfg)
    params = meta_params(cfg)
    spec = bundle.batch_spec(B, S)
    with fake_mode():
        p = to_fake(params)
        batch = {k: torch.empty(shp, dtype=dt, device="meta")
                 for k, (shp, dt) in spec.items()}
        if trace_cost:
            with hlo_analysis.TraceCost((p, batch)) as tc:
                bundle.train_loss(p, batch)
            return tc.cost["flops"]
        with FlopCounterMode(display=False) as fc:
            bundle.train_loss(p, batch)
    return float(fc.get_total_flops())


def _cal_cfg(arch, S, layers=1):
    cfg = get_config(arch).with_overrides(num_layers=layers, dtype="float32")
    if cfg.ssm_chunk:
        cfg = cfg.with_overrides(ssm_chunk=S)
    return cfg


@pytest.mark.parametrize("arch,B,S,tol", CAL_CASES)
def test_eager_trace_counts_every_layer(arch, B, S, tol):
    head = 2 * B * S * get_config(arch).d_model * get_config(arch).vocab_size
    one = _forward_flops(_cal_cfg(arch, S, 1), B, S) - head
    four = _forward_flops(_cal_cfg(arch, S, 4), B, S) - head
    assert one > 0 and four >= 3.5 * one, (arch, one, four)


@pytest.mark.parametrize("arch,B,S,tol", CAL_CASES)
def test_analytic_flops_calibrated_against_trace(arch, B, S, tol):
    cfg = _cal_cfg(arch, S)
    art = _forward_flops(cfg, B, S)
    shape = InputShape("cal", "train", S, B)
    ana = model_forward_flops(cfg, shape, cfg.sliding_window)
    # the trace counts the forward only (train_loss fwd); analytic fwd too
    ratio = ana / art
    assert (1 - tol) < ratio < (1 + tol) * 2.2, (arch, art, ana, ratio)


def test_trace_cost_counts_flop_counter_modes_flops():
    cfg = _cal_cfg("olmoe-1b-7b", 64).reduced()
    assert _forward_flops(cfg, 2, 64, trace_cost=True) == \
        _forward_flops(cfg, 2, 64)
