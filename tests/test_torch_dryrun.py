"""The port's dry run (``repro_torch.launch.dryrun``) and the ``meta``
backend of its kernel ops (``repro_torch.kernels.meta``), on the CPU.

* Each op's ``meta`` backend on ``meta`` tensors gives the plain version's
  output shapes and dtypes (the plain version on CPU tensors of the same
  shapes), reports its cost formula's FLOPs and bytes (each input byte
  read once, each output byte written once) and counts one ``op/meta``
  launch, with no plain version run.
* In a subprocess, the CLI on reduced olmoe-1b-7b over a fake 2×2 mesh
  prints its ``[ok  ]`` line for the placed step ("tp"): its all-gathers
  are the step's own (C scoped f32 rows of this rank's U columns, and the
  C f32 losses), its all-reduces hold each local leaf's combined update in
  f32, G and c besides the model-parallel sums, nothing is reduce-
  scattered or sent all-to-all (its heads divide over 'model'), its
  arguments are its blocks of the params and its cohort's rows, and its
  ``sharded_argument_bytes`` are Σ of the shard shapes by the reference's
  spec rules (which ``tests/test_torch_launch.py`` holds the port's to).
* A decode step's cache, written in place, counts once in the peak.
"""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.sharding import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_leaves_with_path
from repro_torch.kernels import (flash_decode, gram_and_cross,
                                 gram_block_and_cross, launch_counts,
                                 sign_sketch, sign_sketch_adjoint,
                                 sketch_apply, stream_stats, topk_select,
                                 weighted_combine)
from repro_torch.kernels.meta import cost_sink
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import emulated_mesh
from repro_torch.launch.shapes import InputShape, meta_params
from repro_torch.sharding import local_bytes, param_pspecs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32, BF16 = torch.float32, torch.bfloat16


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _flash_bytes(B, S, KV, G, hd, dt, window=None):
    live = min(S, window) if window else S
    return (2 * B * live * KV * hd * _nbytes((), dt) + _nbytes((B, KV, G, hd), dt)
            + 4 * B + 4 * B * KV * G * (hd + 1))


# (op, call, input shapes and dtypes, FLOPs, bytes)
CASES = [
    ("gram", gram_and_cross, [((5, 300), F32), ((300,), F32)],
     2 * 300 * (15 + 5), 6 * 300 * 4 + 30 * 4),
    ("gram", gram_and_cross, [((3, 64), BF16), ((64,), BF16)],
     2 * 64 * (6 + 3), 4 * 64 * 2 + 12 * 4),
    ("gram", gram_and_cross, [((70, 130), F32), ((130,), F32)],
     2 * 130 * (70 * 71 // 2 + 70), 71 * 130 * 4 + (4900 + 70) * 4),
    ("gram_block", gram_block_and_cross,
     [((4, 100), F32), ((3, 100), F32), ((100,), F32)],
     2 * 100 * 4 * 4, 8 * 100 * 4 + 16 * 4),
    ("gram_block", gram_block_and_cross,
     [((4, 96), BF16), ((3, 96), BF16), ((96,), BF16)],
     2 * 96 * 4 * 4, 8 * 96 * 2 + 16 * 4),
    ("stream_stats", stream_stats, [((3, 50), F32), ((3, 50), BF16)],
     2 * 50 * (6 + 9), 3 * 50 * 6 + 18 * 4),
    ("combine", weighted_combine, [((40,), BF16), ((4, 40), F32), ((4,), F32)],
     2 * 4 * 40 + 40, 2 * 40 * 2 + 4 * 40 * 4 + 16),
    ("sketch", sketch_apply, [((2, 77), F32), ((9, 77), F32)],
     2 * 77 * 2 * 9, 11 * 77 * 4 + 18 * 4),
    ("topk", lambda v: topk_select(v, 7), [((300,), F32)],
     0, 300 * 4 + 7 * 8),
    ("topk", lambda v: topk_select(v, 5), [((20000,), F32)],
     0, 20000 * 4 + 5 * 8),
    ("sign_sketch", lambda u: sign_sketch(u, 3, 16), [((2, 50), F32)],
     2 * 2 * 16 * 50, 2 * 50 * 4 + 2 * 16 * 4),
    ("sign_sketch_adjoint", lambda s: sign_sketch_adjoint(s, 3, 50),
     [((16,), F32)], 2 * 16 * 50, 16 * 4 + 50 * 4),
    ("flash_decode", lambda q, k, v, n: flash_decode(q, k, v, n),
     [((2, 2, 3, 64), BF16), ((2, 40, 2, 64), BF16), ((2, 40, 2, 64), BF16),
      ((2,), torch.int32)],
     4 * 2 * 40 * 2 * 3 * 64, _flash_bytes(2, 40, 2, 3, 64, BF16)),
    ("flash_decode", lambda q, k, v, n: flash_decode(q, k, v, n, window=16),
     [((1, 1, 2, 32), F32), ((1, 40, 1, 32), F32), ((1, 40, 1, 32), F32),
      ((1,), torch.int32)],
     4 * 16 * 2 * 32, _flash_bytes(1, 40, 1, 2, 32, F32, window=16)),
]


def _cpu_input(shape, dtype, rng):
    if dtype == torch.int32:
        return torch.full(shape, 7, dtype=dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_meta_backend_shapes_and_costs(case):
    op, call, specs, flops, nbytes = CASES[case]
    rng = np.random.default_rng(case)
    plain = call(*[_cpu_input(s, dt, rng) for s, dt in specs])
    seen = []
    before = launch_counts()
    with cost_sink(lambda *rec: seen.append(rec)):
        got = call(*[torch.empty(s, dtype=dt, device="meta")
                     for s, dt in specs])
    after = launch_counts()
    plain = plain if isinstance(plain, tuple) else (plain,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in plain]
    assert all(t.device.type == "meta" for t in got)
    assert seen == [(op, float(flops), float(nbytes))]
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {f"{op}/meta": 1}


def test_meta_combine_writes_in_place_and_stream_stats_adds():
    w = torch.empty(40, dtype=BF16, device="meta")
    seen = []
    with cost_sink(lambda *rec: seen.append(rec)):
        out = weighted_combine(w, torch.empty(4, 40, device="meta"),
                               torch.empty(4, device="meta"), out=w)
        acc = (torch.empty(3, 3, device="meta"),
               torch.empty(3, 3, device="meta"))
        res = stream_stats(torch.empty(3, 50, device="meta"),
                           torch.empty(3, 50, device="meta"), out=acc)
    assert out is w and res[0] is acc[0] and res[1] is acc[1]
    # combine: w read and written once; stream_stats: out read and written
    assert seen[0][2] == 2 * 40 * 2 + 4 * 40 * 4 + 16
    assert seen[1][2] == 2 * 3 * 50 * 4 + 2 * 2 * 9 * 4


# -------------------------------------------------------------- the dry run

def _duck(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _ref_sharded_bytes(jcfg, mesh_shape, B, S) -> int:
    """Σ of the shard shapes that the reference's rules put on one device
    of a (data, model) mesh: the params and the (B, S) int32 tokens."""
    m = _duck(mesh_shape, ("data", "model"))
    shapes = jax.eval_shape(j_get_model(jcfg).init, jax.random.PRNGKey(0))
    specs = jspecs.param_pspecs(jcfg, shapes, m, "tp")
    leaves = jax.tree_util.tree_leaves(shapes)
    pspecs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    items = [(leaf.shape, leaf.dtype.itemsize, tuple(spec))
             for leaf, spec in zip(leaves, pspecs)]
    items.append(((B, S), 4, tuple(jspecs.batch_pspec(m, B))))
    total = 0
    for shape, size, spec in items:
        spec = spec + (None,) * (len(shape) - len(spec))
        n = 1
        for dim, names in zip(shape, spec):
            names = () if names is None else (
                (names,) if isinstance(names, str) else names)
            n *= -(-dim // math.prod(m.shape[a] for a in names))
        total += n * size
    return total


# the replicated step (mode "dp") on the CLI's fake 2x2 group
_REPLICATED_2X2 = """
import json
from repro_torch.launch import dryrun
print(json.dumps(dryrun.dryrun_one("olmoe-1b-7b", "train_4k", False,
                                   extra={"mode": "dp"}, reduced=True,
                                   mesh_shape=(2, 2))))
"""


def _check_2x2_record(rec, cfg, B, S):
    mem = rec["memory"]
    assert mem["sharded_argument_bytes"] == _ref_sharded_bytes(
        j_get_config("olmoe-1b-7b").reduced(), (2, 2), B, S)
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] + \
        mem["output_size_in_bytes"]
    assert mem["fits"] is True
    r = rec["roofline"]
    assert r["num_chips"] == 4 and r["flops"] == rec["cost"]["flops"] > 0
    assert r["model_flops"] == pytest.approx(
        6 * cfg.active_param_count() * B * S / 4)


def test_cli_on_a_fake_2x2_mesh(tmp_path):
    """The placed step's collectives, exactly, and its arguments."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmoe-1b-7b", "--shape", "train_4k", "--reduced", "--mesh-shape",
         "2,2", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("[ok  ] olmoe-1b-7b|train_4k|2x2 "), \
        res.stdout
    rec = json.loads((tmp_path / "olmoe-1b-7b_train_4k_2x2.json").read_text())
    assert rec["placement"] == "tp" and rec["placement_note"] is None
    cfg = get_config("olmoe-1b-7b").reduced()
    mesh = emulated_mesh((2, 2), ("data", "model"))
    shapes = meta_params(cfg)
    blocks = local_bytes(shapes, param_pspecs(cfg, shapes, mesh, "tp"), mesh)
    leaves = tree_leaves_with_path(shapes)
    # rank 0 holds the first 'model' block of lm_head and final_norm whole
    scope = sum(blocks[name] // 4 for name, _ in leaves
                if "lm_head" in name or "final_norm" in name)
    C = 2                                     # the 'data' axis: 2 cohorts
    B, S = dryrun.REDUCED_BATCH, dryrun.REDUCED_SEQ
    L, k, hd = cfg.num_layers, cfg.experts_per_token, cfg.resolved_head_dim
    T = B // C * S                            # the cohort's tokens
    act = T * cfg.d_model * 4                 # one f32 activation
    # over 'model', forward: the embedding's lookup, each layer's attention
    # and MoE outputs, the loss's max, sum of exps and target logits
    # (S - 1 targets a row); backward: the head's input, and each layer's
    # attention output recomputed (remat "full", which stops before the
    # MoE's sum) and the grads of what enters a layer's parts: attention's
    # input, q_norm and k_norm, the MoE's tokens and top-k weights
    fwd = [act] * (1 + 2 * L) + [B // C * (S - 1) * 4] * 3
    bwd = [act] + [act, act, hd * 4, hd * 4, act, T * k * 4] * L
    # the aggregation: G and c over 'model', every local leaf's α-combined
    # update in f32 over 'data'
    agg = [C * C * 4, C * 4] + [blocks[name] for name, _ in leaves]
    coll = rec["collectives"]
    # all-gathers: U's scoped f32 rows and the losses
    assert coll["all-gather"] == C * scope * 4 + C * 4
    assert coll["all-reduce"] == sum(fwd + bwd + agg)
    assert coll["reduce-scatter"] == coll["all-to-all"] == 0
    assert coll["total"] == coll["all-gather"] + coll["all-reduce"]
    assert coll["count"] == 2 + len(fwd + bwd + agg)
    mem = rec["memory"]
    # this rank's blocks of the params and its cohort's rows of the batch
    assert mem["argument_size_in_bytes"] == \
        sum(blocks.values()) + B * S * 4 // C == mem["sharded_argument_bytes"]
    _check_2x2_record(rec, cfg, B, S)


def test_replicated_step_on_a_fake_2x2_mesh():
    """``mode="dp"``: the replicated step, every leaf whole."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _REPLICATED_2X2],
                         capture_output=True, text=True, timeout=240,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok"
    assert rec["placement"] == "replicated" and rec["placement_note"] is None
    cfg = get_config("olmoe-1b-7b").reduced()
    leaves = tree_leaves_with_path(meta_params(cfg))
    scope = sum(p.numel() for name, p in leaves
                if "lm_head" in name or "final_norm" in name)
    n = sum(p.numel() for _, p in leaves)
    C = 2                                     # the 'data' axis: 2 cohorts
    coll = rec["collectives"]
    # all-gathers: U's scoped f32 rows and the losses; the all-reduce: every
    # leaf's α-combined update in f32, over 'data'
    assert coll["all-gather"] == C * scope * 4 + C * 4
    assert coll["all-reduce"] == n * 4
    assert coll["total"] == coll["all-gather"] + coll["all-reduce"]
    assert coll["count"] == 2 + len(leaves)
    B, S = dryrun.REDUCED_BATCH, dryrun.REDUCED_SEQ
    params_bytes = sum(p.numel() * p.element_size() for _, p in leaves)
    assert rec["memory"]["argument_size_in_bytes"] == \
        params_bytes + B * S * 4
    _check_2x2_record(rec, cfg, B, S)


def test_decode_cache_in_place_counts_once():
    """The cache is an argument of the decode step, written in place: the
    step's temporaries stay below the cache's size and the output counts
    only the logits."""
    cfg = get_config("qwen3-14b").reduced()
    shape = InputShape("t", "decode", 256, 4)
    rec = dryrun.dryrun_step(cfg, emulated_mesh((1, 1), ("data", "model")),
                             shape)
    mem = rec["memory"]
    params = sum(p.numel() * p.element_size()
                 for _, p in tree_leaves_with_path(meta_params(cfg)))
    cache = mem["argument_size_in_bytes"] - params - 4 * 4
    assert cache > 0 and mem["temp_size_in_bytes"] < cache
    assert mem["output_size_in_bytes"] == 4 * cfg.vocab_size * 4
    assert rec["collectives"]["count"] == 0
