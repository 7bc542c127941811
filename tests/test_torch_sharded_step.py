"""The placed train step's parts (``repro_torch.sharding.specs``'
placement, ``core.distributed``'s model-parallel collectives, the models on
``model`` shards, ``launch.steps.build_train_step`` placed) against their
unplaced forms.

* One process: each rank's blocks are the specs' (``place_params``,
  ``shard_shape``, ``local_bytes`` = ``dryrun.sharded_bytes``), an axis a
  rule cannot split is refused, and the step's placement follows the
  mode, the family and the mesh.
* Four gloo ranks (one subprocess spawning them, a ``FileStore`` in the
  test's temporary directory), on (1, 4) and (2, 2) meshes: the vocab-
  parallel embedding and loss, the expert-parallel MoE layer (T = 320, so
  entries drop) and attention on row blocks (heads that do not divide over
  ``model``: a block of whole sequences and a run within one) equal their
  unplaced forms, loss and every grad, at 1e-5 relative to max(1, max |x|),
  and so do head-parallel Mamba2 and RWKV6; the placed step of the MoE, VLM,
  whisper (row-block self- and cross-attention, a whole vocabulary), tied-
  head, row-block attention, Zamba2 hybrid and RWKV6 models equals the
  unplaced step on an emulated mesh of the same shape, new params, α and G's
  mean diagonal (a leaf every ``model`` rank holds whole enters G once), and
  ``launch.train`` runs placed; the step and ``place_batch`` refuse a
  batch that is not split by cohort. The MoE parts are summed over ranks in
  another order than the unplaced layer adds them, so this is a tolerance,
  not bitwise.
* A reduced dry run on a fake (1, 4) group: the placed step's per-rank
  trace FLOPs and argument bytes fall below the replicated step's, and
  its all-to-all bytes are counted (row-block attention) or 0 (whole
  heads).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.distributed import (copy_to_model, gather_for_rows,
                                          model_shard, reduce_from_model)
from repro_torch.core.flatten import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, emulated_mesh
from repro_torch.launch.shapes import meta_params
from repro_torch.models.config import ArchConfig
from repro_torch.launch.steps import (_placed_layout, params_sds,
                                      placement_note, train_placement)
from repro_torch.sharding import (dropped_axes, local_bytes, param_pspecs,
                                  place_batch, place_params, shard_shape)
from repro_torch.sharding.specs import spec_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
ALPHA_RTOL, ALPHA_ATOL = 1e-3, 1e-4
RANKS = 4
TIMEOUT_S = 240


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


# the step's models, reduced: (name, config overrides, mesh shape)
STEP_CASES = {
    "moe": ("olmoe-1b-7b", dict(num_experts=8, experts_per_token=2),
            (2, 2)),
    "vlm": ("chameleon-34b", dict(num_image_tokens=4, num_heads=4,
                                  num_kv_heads=4, head_dim=32), (1, 4)),
    "tied": ("gemma-7b", dict(num_heads=4, num_kv_heads=4, head_dim=32),
             (1, 4)),
    "rows": ("qwen3-14b", dict(num_heads=6, num_kv_heads=2, head_dim=16),
             (1, 4)),
    "hybrid": ("zamba2-1.2b", dict(num_layers=3, attn_every=2,
                                   ssm_head_dim=16, num_heads=4,
                                   num_kv_heads=4, head_dim=16), (1, 4)),
    # 6 heads on 4 ranks (row blocks, the cross-attention's too) and a
    # vocabulary of 130 that stays whole over 'model'
    "audio": ("whisper-large-v3", dict(num_heads=6, num_kv_heads=6,
                                       head_dim=16, vocab_size=130), (1, 4)),
    "rwkv": ("rwkv6-1.6b", dict(rwkv_head_dim=16), (2, 2)),
}


def _step_cfg(case: str):
    name, over, _ = STEP_CASES[case]
    return get_config(name).reduced().with_overrides(
        **dict(dict(d_model=64, d_ff=64, vocab_size=128), **over))


# ------------------------------------------------------------ one process

@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_local_blocks_are_the_specs_blocks(case):
    cfg = _step_cfg(case)
    mesh = emulated_mesh((2, 2), ("data", "model"))
    shapes = meta_params(cfg)
    specs = param_pspecs(cfg, shapes, mesh, "tp")
    tree = _init(cfg)
    params = tree_leaves(tree)
    local = place_params(mesh, tree, specs)
    for (path, spec), p, blk in zip(spec_leaves(specs), params,
                                    tree_leaves(local)):
        assert tuple(blk.shape) == shard_shape(tuple(p.shape), spec, mesh)
        first = p
        for dim, name in enumerate(spec):
            if name is not None:
                first = first.narrow(dim, 0, blk.shape[dim])
        assert torch.equal(blk, first), path
    sizes = local_bytes(shapes, specs, mesh)
    assert sum(sizes.values()) == dryrun.sharded_bytes(
        params_sds(cfg, mesh)) < sum(p.numel() * p.element_size()
                                     for p in params)


def _init(cfg):
    from repro_torch.models import get_model
    return get_model(cfg).init(0, device="cpu")


def test_an_axis_that_does_not_divide_is_refused():
    cfg = _step_cfg("moe")
    mesh = emulated_mesh((1, 3), ("data", "model"))
    bad = dropped_axes(cfg, meta_params(cfg), mesh)
    assert ("embed", 0, "model") in bad              # 128 rows over 3
    assert all(axis == "model" for _, _, axis in bad)
    with pytest.raises(ValueError, match="needs every rule's axis"):
        _placed_layout(cfg, mesh)


def test_placement_follows_mode_family_and_mesh():
    ranked = Mesh((2, 2), ("data", "model"), device_mesh=object())
    dense = get_config("qwen3-14b")                  # ≥ 7 B: FSDP
    assert train_placement(dense, ranked) == "fsdp"
    assert train_placement(get_config("olmoe-1b-7b"), ranked) == "tp"
    assert train_placement(dense, ranked, mode="dp") == "replicated"
    assert train_placement(dense, ranked, dp_only=True) == "replicated"
    assert train_placement(dense, emulated_mesh((2, 2), ("data", "model"))
                           ) == "replicated"
    for name in ("zamba2-1.2b", "whisper-large-v3", "rwkv6-1.6b"):
        assert train_placement(get_config(name), ranked) == "tp"
    cfg = ArchConfig(name="lr", family="logreg", input_dim=8, num_classes=3)
    assert train_placement(cfg, ranked) == "replicated"
    assert "keeps the replicated step" in placement_note(cfg, "replicated")
    assert placement_note(dense, "fsdp") is None
    with pytest.raises(ValueError, match="placement mode"):
        train_placement(dense, ranked, mode="bogus")


def test_collectives_are_identities_outside_model_parallel():
    x = torch.randn(4, 6)
    assert model_shard() is None
    for fn in (copy_to_model, reduce_from_model, gather_for_rows):
        assert fn(x) is x


# ------------------------------------------------------------- gloo ranks




def _grads(loss, tensors):
    return torch.autograd.grad(loss, tensors)


def _vocab_checks(mesh, gen) -> dict:
    """The vocab-parallel embedding and weighted loss against the whole
    ones: loss, and the grads of this rank's embedding rows and head
    columns."""
    from repro_torch.core.distributed import model_parallel
    from repro_torch.models.layers import (cross_entropy_loss, embed_lookup,
                                           lm_logits)
    V, d = 128, 16
    m, r = mesh.shape["model"], mesh.coordinate("model")
    embed = torch.randn(V, d, generator=gen)
    head = torch.randn(d, V, generator=gen)
    tokens = torch.randint(0, V, (3, 10), generator=gen)
    labels = torch.randint(0, V, (3, 10), generator=gen)
    weights = (torch.rand(3, 10, generator=gen) > 0.3).float()
    e, h = (t.clone().requires_grad_() for t in (embed, head))
    want = cross_entropy_loss(lm_logits(embed_lookup(e, tokens, V), h, V),
                              labels, weights, vocab=V)
    ge, gh = _grads(want, (e, h))
    rows, cols = slice(r * V // m, (r + 1) * V // m), slice(r * V // m,
                                                            (r + 1) * V // m)
    e_loc = embed[rows].clone().requires_grad_()
    h_loc = head[:, cols].clone().requires_grad_()
    with model_parallel(mesh):
        got = cross_entropy_loss(lm_logits(embed_lookup(e_loc, tokens, V),
                                           h_loc, V), labels, weights,
                                 vocab=V)
        le, lh = _grads(got, (e_loc, h_loc))
    return {"vocab_loss": abs(float(got - want)),
            "vocab_embed_grad": _rel(le, ge[rows]),
            "vocab_head_grad": _rel(lh, gh[:, cols])}


def _moe_checks(mesh, gen) -> dict:
    """The expert-parallel MoE layer (T = 320: entries past the capacity
    drop) against the whole layer: output and every grad."""
    from repro_torch.core.distributed import model_parallel
    from repro_torch.models.moe import init_moe, moe_forward
    cfg = get_config("deepseek-moe-16b").reduced().with_overrides(
        d_model=32, d_ff=16, num_experts=8, experts_per_token=2,
        num_shared_experts=1)
    m, r = mesh.shape["model"], mesh.coordinate("model")
    p = init_moe(cfg, gen, torch.float32)
    x = torch.randn(2, 160, 32, generator=gen)
    names = sorted(k for k in p if k != "shared")
    whole = {k: p[k].clone().requires_grad_() for k in names}
    whole["shared"] = {k: v.clone().requires_grad_()
                       for k, v in p["shared"].items()}
    xw = x.clone().requires_grad_()
    out, aux = moe_forward(cfg, whole, xw)
    leaves = [xw] + [whole[k] for k in names] + [
        whole["shared"][k] for k in sorted(p["shared"])]
    want = _grads((out * out).sum() + aux, leaves)
    E = cfg.num_experts // m
    ff = p["shared"]["w_up"].shape[1] // m

    def block(path, t):
        if path in ("w_up", "w_gate", "w_down"):
            return t[r * E:(r + 1) * E]
        if path in ("shared/w_up", "shared/w_gate"):
            return t[:, r * ff:(r + 1) * ff]
        if path == "shared/w_down":
            return t[r * ff:(r + 1) * ff]
        return t
    paths = names + [f"shared/{k}" for k in sorted(p["shared"])]
    local = {k: block(k, p[k]).clone().requires_grad_() for k in names}
    local["shared"] = {k: block(f"shared/{k}", v).clone().requires_grad_()
                       for k, v in p["shared"].items()}
    xl = x.clone().requires_grad_()
    with model_parallel(mesh):
        got_out, got_aux = moe_forward(cfg, local, xl)
        got = _grads((got_out * got_out).sum() + got_aux,
                     [xl] + [local[k] for k in names] + [
                         local["shared"][k] for k in sorted(p["shared"])])
    res = {"moe_out": _rel(got_out.detach(), out.detach()),
           "moe_aux": abs(float(got_aux - aux)),
           "moe_grad_x": _rel(got[0], want[0])}
    for path, g, w in zip(paths, got[1:], want[1:]):
        res[f"moe_grad_{path}"] = _rel(g, block(path, w))
    return res


def _attention_checks(mesh, gen, B: int, S: int) -> dict:
    """Attention with 6 heads and 2 KV heads on 4 ``model`` ranks (row
    blocks of B·S/4 tokens) against the whole attention: output and the
    grads of x, of this rank's q/k/v columns and wo rows, and of the qk-norm
    weights."""
    from repro_torch.core.distributed import model_parallel
    from repro_torch.models.attention import (attention_forward,
                                              init_attention)
    cfg = get_config("qwen3-14b").reduced().with_overrides(
        d_model=32, num_heads=6, num_kv_heads=2, head_dim=16)
    m, r = mesh.shape["model"], mesh.coordinate("model")
    p = init_attention(cfg, gen, torch.float32)
    p["q_norm"] = 0.1 * torch.randn(16, generator=gen)
    p["k_norm"] = 0.1 * torch.randn(16, generator=gen)
    x = torch.randn(B, S, 32, generator=gen)
    pos = torch.arange(S)
    names = sorted(p)
    whole = {k: p[k].clone().requires_grad_() for k in names}
    xw = x.clone().requires_grad_()
    out = attention_forward(cfg, whole, xw, pos)
    want = _grads((out * out).sum(), [xw] + [whole[k] for k in names])

    def block(name, t):
        n = t.shape[-1] // m if name != "wo" else t.shape[0] // m
        if name in ("wq", "wk", "wv"):
            return t[:, r * n:(r + 1) * n]
        return t[r * n:(r + 1) * n] if name == "wo" else t
    local = {k: block(k, p[k]).clone().requires_grad_() for k in names}
    xl = x.clone().requires_grad_()
    with model_parallel(mesh):
        got_out = attention_forward(cfg, local, xl, pos)
        got = _grads((got_out * got_out).sum(),
                     [xl] + [local[k] for k in names])
    tag = f"attn_{B}x{S}"
    res = {f"{tag}_out": _rel(got_out.detach(), out.detach()),
           f"{tag}_grad_x": _rel(got[0], want[0])}
    for name, g, w in zip(names, got[1:], want[1:]):
        res[f"{tag}_grad_{name}"] = _rel(g, block(name, w))
    return res


def _mamba_checks(mesh, gen) -> dict:
    """Head-parallel Mamba2 (8 heads on 4 ``model`` ranks, two scan
    chunks) against the whole layer: output and every grad."""
    from repro_torch.core.distributed import model_parallel
    from repro_torch.models.ssd import init_mamba2, mamba2_forward
    cfg = get_config("zamba2-1.2b").reduced().with_overrides(
        d_model=32, ssm_head_dim=8)
    m, r = mesh.shape["model"], mesh.coordinate("model")
    p = init_mamba2(cfg, gen, torch.float32)
    p["norm"] = 0.1 * torch.randn(p["norm"].shape, generator=gen)
    p["dt_bias"] = 0.1 * torch.randn(p["dt_bias"].shape, generator=gen)
    x = torch.randn(2, 40, 32, generator=gen)
    names = sorted(p)
    whole = {k: p[k].clone().requires_grad_() for k in names}
    xw = x.clone().requires_grad_()
    out = mamba2_forward(cfg, whole, xw)[0]
    want = _grads((out * out).sum(), [xw] + [whole[k] for k in names])

    def block(name, t):
        if name == "in_proj":
            n = t.shape[1] // m
            return t[:, r * n:(r + 1) * n]
        if name == "out_proj":
            n = t.shape[0] // m
            return t[r * n:(r + 1) * n]
        return t
    local = {k: block(k, p[k]).clone().requires_grad_() for k in names}
    xl = x.clone().requires_grad_()
    with model_parallel(mesh):
        got_out = mamba2_forward(cfg, local, xl)[0]
        got = _grads((got_out * got_out).sum(),
                     [xl] + [local[k] for k in names])
    res = {"mamba_out": _rel(got_out.detach(), out.detach()),
           "mamba_grad_x": _rel(got[0], want[0])}
    for name, g, w in zip(names, got[1:], want[1:]):
        res[f"mamba_grad_{name}"] = _rel(g, block(name, w))
    return res


def _rwkv_checks(mesh, gen) -> dict:
    """Head-parallel RWKV6 (4 heads on 2 ``model`` ranks, two scan chunks)
    against the whole layer: output and every grad."""
    from repro_torch.core.distributed import model_parallel
    from repro_torch.models.rwkv import init_rwkv6, rwkv6_forward
    cfg = get_config("rwkv6-1.6b").reduced().with_overrides(
        d_model=64, d_ff=32, rwkv_head_dim=16)
    m, r = mesh.shape["model"], mesh.coordinate("model")
    p = init_rwkv6(cfg, gen, torch.float32)
    p["ln_x_b"] = 0.1 * torch.randn(p["ln_x_b"].shape, generator=gen)
    x = torch.randn(2, 40, 64, generator=gen)
    names = sorted(p)
    whole = {k: p[k].clone().requires_grad_() for k in names}
    xw = x.clone().requires_grad_()
    out = rwkv6_forward(cfg, whole, xw)[0]
    want = _grads((out * out).sum(), [xw] + [whole[k] for k in names])

    def block(name, t):
        if name in ("wr", "wk", "wv", "wg", "w_A", "ffn_k", "ffn_r"):
            n = t.shape[1] // m
            return t[:, r * n:(r + 1) * n]
        if name in ("wo", "w_B", "ffn_v"):
            n = t.shape[0] // m
            return t[r * n:(r + 1) * n]
        return t
    local = {k: block(k, p[k]).clone().requires_grad_() for k in names}
    xl = x.clone().requires_grad_()
    with model_parallel(mesh):
        got_out = rwkv6_forward(cfg, local, xl)[0]
        got = _grads((got_out * got_out).sum(),
                     [xl] + [local[k] for k in names])
    res = {"rwkv_out": _rel(got_out.detach(), out.detach()),
           "rwkv_grad_x": _rel(got[0], want[0])}
    for name, g, w in zip(names, got[1:], want[1:]):
        res[f"rwkv_grad_{name}"] = _rel(g, block(name, w))
    return res


def _step_checks(case: str, mesh) -> dict:
    """The placed step against the unplaced one on an emulated mesh of the
    same shape, from the same params and batch."""
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import get_model
    cfg = _step_cfg(case)
    bundle = get_model(cfg)
    params = bundle.init(0, device="cpu")
    gen = torch.Generator().manual_seed(11)
    B, S = 8, 16
    batch = {}
    for name, (shp, dt) in bundle.batch_spec(B, S).items():
        batch[name] = (torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                     dtype=dt) if dt == torch.int32
                       else torch.randn(shp, generator=gen).to(dt))
    shape = InputShape("t", "train", S, B)
    axes = ("data", "model")
    want_new, want = build_train_step(
        cfg, emulated_mesh(tuple(mesh.shape.values()), axes), shape,
        lr=0.05, remat="full")(params, batch)
    specs = param_pspecs(cfg, meta_params(cfg), mesh, "tp")
    step = build_train_step(cfg, mesh, shape, lr=0.05, remat="full")
    got_new, got = step(place_params(mesh, params, specs),
                        place_batch(mesh, batch))
    blocks = place_params(mesh, want_new, specs)
    return {f"step_{case}_placement": np.asarray(step.placement),
            f"step_{case}_params": max(
                _rel(a, b) for a, b in zip(tree_leaves(got_new),
                                           tree_leaves(blocks))),
            f"step_{case}_alpha": got["alpha"].numpy(),
            f"step_{case}_alpha_want": want["alpha"].numpy(),
            f"step_{case}_gram_diag": np.asarray([
                float(got["gram_diag_mean"]),
                float(want["gram_diag_mean"])]),
            f"step_{case}_bound": float(got["bound"])}


def _refusal_checks(mesh) -> dict:
    """The placed step takes only this rank's cohort of the batch, and a
    batch that does not divide into the cohorts is refused when the step
    is built and by ``place_batch``."""
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step
    cfg = _step_cfg("moe")
    params = place_params(mesh, _init(cfg),
                          param_pspecs(cfg, meta_params(cfg), mesh, "tp"))
    tokens = torch.zeros((8, 16), dtype=torch.int32)
    step = build_train_step(cfg, mesh, InputShape("t", "train", 16, 8))
    calls = {
        "global_batch": lambda: step(params, {"tokens": tokens}),
        "uneven_build": lambda: build_train_step(
            cfg, mesh, InputShape("t", "train", 16, 7)),
        "uneven_place": lambda: place_batch(mesh, {"tokens": tokens[:7]})}
    out = {}
    for key, call in calls.items():
        try:
            call()
            out[f"refuse_{key}"] = np.asarray("")
        except ValueError as e:
            out[f"refuse_{key}"] = np.asarray(str(e))
    return out


def _train_run_checks() -> dict:
    """``launch.train.run`` on the host mesh of the four ranks (1, 4): the
    placed step on each rank's blocks, two steps of the reduced olmoe."""
    from repro_torch.launch import train as tr
    from repro_torch.launch.shapes import meta_params
    out = tr.run(tr.parse_args(["--device", "cpu", "--reduced", "--steps",
                                "2", "--batch", "4", "--seq", "16"]))
    cfg, mesh = out["cfg"], out["mesh"]
    specs = param_pspecs(cfg, meta_params(cfg), mesh, "tp")
    blocks = all(tuple(p.shape) == shard_shape(tuple(w.shape), spec, mesh)
                 for p, w, (_, spec) in zip(tree_leaves(out["params"]),
                                            tree_leaves(meta_params(cfg)),
                                            spec_leaves(specs)))
    return {"run_placement": np.asarray(out["step"].placement),
            "run_blocks": np.asarray(blocks),
            "run_losses": np.asarray([h["loss"] for h in out["history"]]),
            "run_alpha": np.asarray([float(h["alpha"][0])
                                     for h in out["history"]])}


def rank_checks() -> dict:
    """Every check on this rank (a 4-rank gloo group)."""
    from repro_torch.launch.mesh import make_mesh
    one_axis = make_mesh((1, 4), ("data", "model"))
    two_axes = make_mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(5)
    res = {}
    res.update(_vocab_checks(one_axis, gen))
    res.update(_moe_checks(two_axes, gen))
    res.update(_attention_checks(one_axis, gen, 2, 8))    # a run of 4 rows
    res.update(_attention_checks(one_axis, gen, 8, 4))    # two sequences
    res.update(_mamba_checks(one_axis, gen))
    res.update(_rwkv_checks(two_axes, gen))
    res.update(_train_run_checks())
    res.update(_refusal_checks(two_axes))
    for case, (_, _, shape) in STEP_CASES.items():
        res.update(_step_checks(case, one_axis if shape == (1, 4)
                                else two_axes))
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, __file__, str(tmp)], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]


def test_vocab_parallel_embedding_and_loss(ranks):
    for res in ranks:
        assert res["vocab_loss"] <= TOL
        assert res["vocab_embed_grad"] <= TOL
        assert res["vocab_head_grad"] <= TOL


def test_expert_parallel_moe(ranks):
    for res in ranks:
        keys = [k for k in res if k.startswith("moe_")]
        assert len(keys) == 3 + 3 + 1 + 3    # out, aux, x; w_*, router; shared
        for k in keys:
            assert float(res[k]) <= TOL, k


@pytest.mark.parametrize("tag", ["attn_2x8", "attn_8x4"])
def test_attention_on_row_blocks(ranks, tag):
    for res in ranks:
        keys = [k for k in res if k.startswith(tag)]
        assert len(keys) == 2 + 6           # out, x; wq wk wv wo q/k_norm
        for k in keys:
            assert float(res[k]) <= TOL, k


def test_head_parallel_mamba2(ranks):
    for res in ranks:
        keys = [k for k in res if k.startswith("mamba_")]
        assert len(keys) == 2 + 8     # out, x; the eight leaves
        for k in keys:
            assert float(res[k]) <= TOL, k


def test_head_parallel_rwkv6(ranks):
    for res in ranks:
        keys = [k for k in res if k.startswith("rwkv_")]
        assert len(keys) == 2 + 16    # out, x; the sixteen leaves
        for k in keys:
            assert float(res[k]) <= TOL, k


def test_train_entry_point_places_its_params(ranks):
    """``python -m repro_torch.launch.train`` on four ranks: each holds its
    blocks, the losses are the same on every rank and finite, α = 1/(1 +
    ridge) at C = 1."""
    for res in ranks:
        assert str(res["run_placement"]) == "tp" and bool(res["run_blocks"])
        assert np.isfinite(res["run_losses"]).all()
        np.testing.assert_array_equal(res["run_losses"],
                                      ranks[0]["run_losses"])
        np.testing.assert_allclose(res["run_alpha"], 1 / (1 + 1e-6),
                                   rtol=1e-5)


@pytest.mark.parametrize("key, says", [
    ("global_batch", "this rank's cohort of 4 rows"),
    ("uneven_build", "batch of 7 rows into 2 cohorts"),
    ("uneven_place", "7 rows does not divide into 2 cohorts")])
def test_placed_step_refuses_a_batch_not_split_by_cohort(ranks, key, says):
    """A rank is never handed other cohorts' rows: the global batch, or a
    batch that does not divide over ``data``, raises."""
    for res in ranks:
        assert says in str(res[f"refuse_{key}"]), str(res[f"refuse_{key}"])


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_placed_step_equals_the_unplaced_step(ranks, case):
    """New params (each rank's blocks), α and g(α) < 0; G's mean diagonal
    equal, so a leaf whole on every 'model' rank (final_norm; the tied
    head's whole scope) enters G once."""
    for res in ranks:
        assert str(res[f"step_{case}_placement"]) == "tp"
        assert float(res[f"step_{case}_params"]) <= TOL
        np.testing.assert_allclose(res[f"step_{case}_alpha"],
                                   res[f"step_{case}_alpha_want"],
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
        got, want = res[f"step_{case}_gram_diag"]
        assert abs(got - want) <= 1e-5 * want
        assert float(res[f"step_{case}_bound"]) < 0


# ------------------------------------------------------------- the dry run

_DRYRUN = textwrap.dedent("""
    import json
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import InputShape
    mesh = dryrun.fake_mesh((1, 4))
    cfg = get_config("qwen3-14b").reduced()
    shape = InputShape("t", "train", 32, 8)
    out = {mode: dryrun.dryrun_step(cfg, mesh, shape, extra={"mode": mode})
           for mode in ("tp", "dp")}
    # 6 heads on 4 ranks: attention on row blocks, through all-to-alls
    out["rows"] = dryrun.dryrun_step(
        cfg.with_overrides(num_heads=6, num_kv_heads=2, head_dim=16), mesh,
        shape)
    print(json.dumps(out))
""")


def test_reduced_dry_run_placed_below_replicated():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DRYRUN], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    tp, dp = recs["tp"], recs["dp"]
    assert (tp["placement"], dp["placement"]) == ("tp", "replicated")
    assert tp["cost"]["flops"] < 0.5 * dp["cost"]["flops"]
    mem_tp, mem_dp = tp["memory"], dp["memory"]
    assert mem_tp["sharded_argument_bytes"] == mem_dp[
        "sharded_argument_bytes"]
    # 'data' is 1 wide: the batch's block is the whole batch
    assert mem_tp["argument_size_in_bytes"] == \
        mem_tp["sharded_argument_bytes"]
    assert mem_tp["argument_size_in_bytes"] < mem_dp["argument_size_in_bytes"]
    assert tp["collectives"]["count"] > dp["collectives"]["count"]
    # whole local heads send nothing all-to-all; row blocks do, q and the
    # output each way, forward, re-forward and backward
    assert tp["collectives"]["all-to-all"] == 0
    rows = recs["rows"]["collectives"]
    assert rows["all-to-all"] > 0 and rows["total"] == sum(
        rows[k] for k in ("all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute"))


def _rank_main(rank: int, world: int, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **rank_checks())
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(RANKS, sys.argv[1]), nprocs=RANKS,
                       start_method="spawn")
