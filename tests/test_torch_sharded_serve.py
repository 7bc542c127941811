"""The placed serve steps (``launch.steps.build_prefill_step`` /
``build_decode_step`` on a mesh of ranks) against the reference's
``bundle.prefill`` / ``bundle.decode``, and ``flash_decode`` on seq blocks.

* One process: the cache specs equal the reference's at the test shapes
  (a stacked 5-D state's heads under the KV seq axes: 'model', or
  ('data', 'model') at batch 1), ``serve_cache_shard`` reads them, the
  cache blocks are the specs', the steps' placement follows the mode and
  the family, a placed step refuses the global batch, and the plain
  ``flash_decode`` on 16 blocks with local lengths, merged by
  ``lse_merge``, equals the whole-cache call (rows with no live key in a
  block give o = 0, lse <= -1e30, no NaN; a window across a block edge).
* Eight gloo ranks (one subprocess spawning them, a ``FileStore`` in the
  test's temporary directory) run the placed prefill and decode of reduced
  f32 models — dense with heads that divide over ``model`` and with heads
  that do not, MoE, VLM, a window across a block edge, ring mode, RWKV6,
  Mamba2, the Zamba2 hybrid, a short prompt whose later seq blocks stay
  empty, batch 1 on a (2, 4) mesh (the cache's seq and the states' heads
  over ('data', 'model')), a (4, 2) mesh, and whisper (row blocks padded
  and cut across sequences; its cross K/V whole, and split over 'model'
  and merged) — while this process runs the
  reference (jitted, ``JAX_PLATFORMS=cpu``) on the same numpy weights and
  tokens.  Each rank's logits equal the reference's rows of its batch
  block, and each rank's cache block its slice of the reference's cache,
  within 1e-5 of max(1, max |x|).
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.launch.mesh import Mesh, emulated_mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import (build_decode_step, build_prefill_step,
                                      cache_shapes, serve_cache_shard)
from repro_torch.sharding import (batch_pspec, cache_block, cache_pspecs,
                                  place_cache, shard_shape)
from repro_torch.sharding.specs import map_with_path, spec_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
RANKS = 8
TIMEOUT_S = 240
AXES = ("data", "model")

# (arch, config overrides, mesh, batch, prompt, cache rows, decode steps);
# a prompt of 0 starts the decode from an empty cache of full rows
CASES = {
    "dense": ("qwen3-14b", dict(num_heads=8, num_kv_heads=4, head_dim=16),
              (2, 4), 4, 9, 32, 3),
    "rows": ("qwen3-14b", dict(num_heads=6, num_kv_heads=2, head_dim=16),
             (2, 4), 4, 8, 32, 3),
    "moe": ("olmoe-1b-7b", dict(num_experts=8, experts_per_token=2,
                                num_heads=4, num_kv_heads=4, head_dim=16),
            (2, 4), 4, 8, 32, 3),
    "vlm": ("chameleon-34b", dict(num_image_tokens=4, num_heads=4,
                                  num_kv_heads=4, head_dim=16),
            (2, 4), 4, 12, 32, 3),
    # 32 rows in blocks of 8, a window of 12: the live rows span two blocks
    "window": ("starcoder2-15b", dict(num_heads=8, num_kv_heads=4,
                                      head_dim=16, sliding_window=12),
               (2, 4), 4, 0, 32, 20),
    # a ring of 16 rows in blocks of 4, written past its end
    "ring": ("starcoder2-15b", dict(num_heads=8, num_kv_heads=4,
                                    head_dim=16, sliding_window=16),
             (2, 4), 4, 10, 32, 9),
    "rwkv": ("rwkv6-1.6b", dict(rwkv_head_dim=16), (2, 4), 4, 9, 32, 3),
    "mamba": ("zamba2-1.2b", dict(family="ssm", attn_every=0,
                                  ssm_head_dim=16), (2, 4), 4, 9, 32, 3),
    "hybrid": ("zamba2-1.2b", dict(num_layers=3, attn_every=2,
                                   ssm_head_dim=16, num_heads=4,
                                   num_kv_heads=4, head_dim=16),
               (2, 4), 4, 9, 32, 3),
    # blocks of 16 rows: the prompt and the steps stay in the first
    "short": ("qwen3-14b", dict(num_heads=8, num_kv_heads=4, head_dim=16),
              (2, 4), 4, 3, 64, 3),
    # the batch whole on every rank, the seq over ('data', 'model')
    "batch1": ("qwen3-14b", dict(num_heads=6, num_kv_heads=2, head_dim=16),
               (2, 4), 1, 9, 32, 3),
    "batch1_hybrid": ("zamba2-1.2b", dict(num_layers=3, attn_every=2,
                                          ssm_head_dim=16, num_heads=4,
                                          num_kv_heads=4, head_dim=16),
                      (2, 4), 1, 9, 32, 3),
    "mesh42": ("qwen3-14b", dict(num_heads=8, num_kv_heads=4, head_dim=16),
               (4, 2), 4, 9, 32, 3),
    # 6 heads on 4 ranks: the encoder's row blocks whole runs, the
    # decoder's 2 x 9 prompt rows padded to 20 and cut across a sequence's
    # end; 30 cross rows stay whole over 'model', a vocabulary of 130 too
    "whisper": ("whisper-large-v3", dict(num_heads=6, num_kv_heads=6,
                                         head_dim=16, vocab_size=130,
                                         max_source_positions=30),
                (2, 4), 4, 9, 32, 3),
    # whole heads a rank; 32 cross rows split over 'model' and merged
    "whisper_cross": ("whisper-large-v3", dict(num_heads=4, num_kv_heads=4,
                                               head_dim=16,
                                               max_source_positions=32),
                      (2, 4), 4, 9, 32, 3),
}
_BASE = dict(d_model=64, d_ff=64, vocab_size=128)


def _cfg(case):
    arch, over = CASES[case][:2]
    return get_config(arch).reduced().with_overrides(**dict(_BASE, **over))


def _params(case):
    """The port's init, its zero-init leaves (norms, biases) perturbed so
    that they count; the same on every rank and in this process."""
    from repro_torch.models import get_model
    params = get_model(_cfg(case)).init(0, device="cpu")
    gen = torch.Generator().manual_seed(7)

    def perturb(t):
        if t.is_floating_point() and not t.any():
            return 0.1 * torch.randn(t.shape, generator=gen).to(t.dtype)
        return t
    return tree_map(perturb, params)


def _inputs(case):
    """(prompt batch, decode tokens) from numpy, seeded."""
    from repro_torch.models import get_model
    cfg = _cfg(case)
    _, _, _, B, S, _, steps = CASES[case]
    rng = np.random.RandomState(3)
    batch = {}
    if S:
        for name, (shp, dt) in get_model(cfg).batch_spec(B, S).items():
            batch[name] = torch.from_numpy(
                rng.randint(0, cfg.vocab_size, shp).astype(np.int32)
                if dt == torch.int32 else rng.randn(*shp).astype(np.float32))
    tokens = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (B,))
                               .astype(np.int32)) for _ in range(steps)]
    return batch, tokens


def _empty_cache(case):
    from repro_torch.models.transformer import init_lm_cache
    _, _, _, B, _, rows, _ = CASES[case]
    return init_lm_cache(_cfg(case), B, rows, ring=False, device="cpu")


# ------------------------------------------------------------ one process

def _duck(shape):
    return types.SimpleNamespace(shape=dict(zip(AXES, shape)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_specs_are_the_references(case):
    """``cache_pspecs`` of the test shapes equal the reference's, every
    leaf (states, conv windows and token shifts included)."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import get_model as j_get_model
    from repro.sharding import specs as jspecs
    arch, over, mesh, B, _, rows, _ = CASES[case]
    jcfg = j_get_config(arch).reduced().with_overrides(**dict(_BASE, **over))
    bundle = j_get_model(jcfg)
    if bundle.init_cache is not None:
        jcache = jax.eval_shape(lambda: bundle.init_cache(B, rows))
    else:       # whisper: the cache from a prefill
        prompt = {"frames": jax.ShapeDtypeStruct(
            (B, jcfg.max_source_positions, jcfg.d_model), np.float32),
            "tokens": jax.ShapeDtypeStruct((B, 8), np.int32)}
        jcache = jax.eval_shape(
            lambda p, b: bundle.prefill(p, b, rows)[1],
            jax.eval_shape(bundle.init, jax.random.PRNGKey(0)), prompt)
    cfg = _cfg(case)
    meta = cache_shapes(cfg, InputShape("d", "decode", rows, B))
    want = [tuple(s) for s in jax.tree_util.tree_leaves(
        jspecs.cache_pspecs(jcfg, jcache, _duck(mesh), B),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]
    got = [tuple(s) for _, s in spec_leaves(
        cache_pspecs(cfg, meta, emulated_mesh(mesh, AXES), B))]
    assert got == want


def test_state_heads_take_the_kv_seq_axes():
    """The first ``ndim == 5`` rule places a stacked wkv / SSM state's
    head dim as a KV leaf's seq dim: over 'model', over ('data', 'model')
    when the batch is whole (batch 1), and whole where that does not
    divide (4 RWKV6 heads over 8 ranks)."""
    mesh = emulated_mesh((2, 4), AXES)
    for case, B, kv, st in (("hybrid", 4, ("model",), ("model",)),
                            ("batch1_hybrid", 1, ("data", "model"),
                             ("data", "model")),
                            ("rwkv", 4, (), ("model",)),
                            ("batch1", 1, ("data", "model"), ())):
        cfg = _cfg(case)
        shape = InputShape("d", "decode", CASES[case][5], B)
        specs = dict(spec_leaves(cache_pspecs(cfg, cache_shapes(cfg, shape),
                                              mesh, B)))
        cs = serve_cache_shard(cfg, mesh, shape)
        assert (cs.kv_axes, cs.state_axes) == (kv, st), case
        for path, spec in specs.items():
            if path in ("ssm/ssm", "ssm/wkv"):
                assert spec[2] == (st if len(st) > 1 else
                                   st[0] if st else None), (case, path)
            if path in ("ssm/conv", "ssm/shift", "ssm/shift_ffn"):
                assert all(n is None for n in spec[2:]), (case, path)
    rwkv = dict(spec_leaves(cache_pspecs(
        _cfg("rwkv"), cache_shapes(_cfg("rwkv"), InputShape(
            "d", "decode", 32, 1)), mesh, 1)))
    assert rwkv["ssm/wkv"] == (None, None, None, None, None)


def test_cache_blocks_are_the_specs_blocks():
    """``cache_block`` allocates each leaf's block alone, ``place_cache``
    cuts the same shapes out of a whole cache, and ``CacheShard.kv_start``
    is the first global row of a KV block."""
    cfg = _cfg("hybrid")
    mesh = Mesh((2, 4), AXES, device_mesh=_Coords((2, 4), 6))
    meta = cache_shapes(cfg, InputShape("d", "decode", 32, 4))
    specs = cache_pspecs(cfg, meta, mesh, 4)
    blk = cache_block(meta, specs, mesh, device="cpu")
    whole = map_with_path(meta, lambda _, t: torch.randn(t.shape)
                          if torch.is_tensor(t) else t)
    cut = place_cache(mesh, whole, specs)
    for (path, spec), (_, b), (_, c), (_, w) in zip(
            spec_leaves(specs), spec_leaves(blk), spec_leaves(cut),
            spec_leaves(whole)):
        if not torch.is_tensor(w):
            continue
        assert tuple(b.shape) == tuple(c.shape) == shard_shape(
            tuple(w.shape), spec, mesh), path
        assert not b.any()
    # rank 6 of (2, 4): data 1, model 2; the seq over 'model' alone
    cs = serve_cache_shard(cfg, mesh, InputShape("d", "decode", 32, 4))
    assert cs.kv_axes == ("model",) and cs.kv_start(8) == 16
    assert torch.equal(dict(spec_leaves(cut))["shared_kv/k"],
                       whole.shared_kv.k[:, 2:, 16:24])


def test_serve_steps_placement_follows_mode_and_family():
    """Placed on a mesh of ranks ("tp"; "fsdp" from 7 B params), replicated
    on an emulated mesh, with ``mode="dp"`` and for the logistic model;
    whisper's cross K/V rows take the KV seq axes where they divide."""
    from repro_torch.models.config import ArchConfig
    ranked = Mesh((2, 4), AXES, device_mesh=_Coords((2, 4), 0))
    shape = InputShape("d", "decode", 32, 4)
    cfg = _cfg("dense")
    assert build_decode_step(cfg, emulated_mesh((2, 4), AXES),
                             shape).placement == "replicated"
    assert build_prefill_step(cfg, ranked, shape,
                              mode="dp").placement == "replicated"
    assert build_decode_step(cfg, ranked, shape).placement == "tp"
    assert build_decode_step(get_config("qwen3-14b"), Mesh(
        (1, 8), AXES, device_mesh=_Coords((1, 8), 0)), shape
    ).placement == "fsdp"
    lr = ArchConfig(name="lr", family="logreg", input_dim=8, num_classes=3)
    assert build_decode_step(lr, ranked, shape).placement == "replicated"
    for case, cross in (("whisper", ()), ("whisper_cross", ("model",))):
        cs = serve_cache_shard(_cfg(case), ranked, shape)
        assert (cs.kv_axes, cs.cross_axes) == (("model",), cross), case


def test_placed_serve_step_refuses_the_global_batch():
    """A placed step takes this rank's rows of the batch only."""
    ranked = Mesh((2, 4), AXES, device_mesh=_Coords((2, 4), 0))
    step = build_decode_step(_cfg("dense"), ranked,
                             InputShape("d", "decode", 32, 4))
    with pytest.raises(ValueError, match="this rank's 2 of 4 rows"):
        step({}, torch.zeros(4, dtype=torch.int32), None)


class _Coords:
    """A duck ``DeviceMesh``: rank ``rank`` of a row-major grid."""

    def __init__(self, shape, rank):
        self.coords = dict(zip(AXES, np.unravel_index(rank, shape)))

    def get_local_rank(self, axis):
        return int(self.coords[axis])


def _blocks_case():
    """q, k, v of the ``decode_32k``-like head shape cut small (B 4, S 256,
    KV 2, G 5, hd 16) with lengths that leave later blocks empty."""
    gen = torch.Generator().manual_seed(0)
    B, S, KV, G, hd = 4, 256, 2, 5, 16
    q = torch.randn(B, KV, G, hd, generator=gen)
    k = torch.randn(B, S, KV, hd, generator=gen)
    v = torch.randn(B, S, KV, hd, generator=gen)
    lengths = torch.tensor([1, 17, 100, 256], dtype=torch.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("window", [None, 24, 40])
def test_plain_flash_decode_on_blocks_merges_to_the_whole(window):
    """16 blocks of 16 rows, each called with its local lengths and merged,
    equal one whole-cache call; a window of 24 or 40 ends inside a block
    and starts in another.  A row with no live key in a block gives o = 0
    and lse <= -1e30, no NaN."""
    q, k, v, lengths = _blocks_case()
    want_o, want_lse = kops.flash_decode(q, k, v, lengths, window=window,
                                         softcap=30.0)
    rows = 16
    o_parts, lse_parts = [], []
    for j in range(k.shape[1] // rows):
        o, lse = kops.flash_decode(q, k[:, j * rows:(j + 1) * rows],
                                   v[:, j * rows:(j + 1) * rows],
                                   lengths - j * rows, window=window,
                                   softcap=30.0)
        assert torch.isfinite(o).all() and not torch.isnan(lse).any()
        live = (lengths - j * rows > 0) & (
            (lengths - (window or 1 << 20)) < (j + 1) * rows)
        dead = ~live
        assert (o[dead] == 0).all() and (lse[dead] <= -1e30).all()
        o_parts.append(o)
        lse_parts.append(lse)
    o, lse = kops.lse_merge(torch.stack(o_parts), torch.stack(lse_parts))
    assert torch.allclose(o, want_o, rtol=0, atol=1e-6)
    assert torch.allclose(lse, want_lse, rtol=0, atol=1e-5)


def test_plain_flash_decode_empty_rows_are_zero():
    """Local lengths <= 0 (the block lies past the position): o = 0 and
    lse = -1e30 in f32, where the whole-cache masked score sum would give
    the mean of v."""
    q, k, v, _ = _blocks_case()
    o, lse = flash_decode_ref(q, k, v, torch.tensor([0, -5, -300, 0],
                                                    dtype=torch.int32))
    assert (o == 0).all() and (lse == torch.tensor(-1e30)).all()


# ------------------------------------------------------------- gloo ranks

def _placed_case(case, mesh) -> dict:
    """The placed prefill and decode steps on this rank's blocks: the
    logits of every call and the cache block after the last."""
    from repro_torch.launch.shapes import meta_params
    from repro_torch.models import get_model
    from repro_torch.sharding import local_shard, param_pspecs, place_params
    cfg = _cfg(case)
    _, _, _, B, S, rows, _ = CASES[case]
    params = place_params(mesh, _params(case),
                          param_pspecs(cfg, meta_params(cfg), mesh, "tp"))
    batch, tokens = _inputs(case)
    bspec = batch_pspec(mesh, B)
    out = {}
    decode = build_decode_step(cfg, mesh, InputShape("d", "decode", rows, B))
    if S:
        prefill = build_prefill_step(cfg, mesh,
                                     InputShape("p", "prefill", rows, B))
        logits, cache = prefill(params, {n: local_shard(x, bspec, mesh)
                                         for n, x in batch.items()})
        out["logits0"] = logits
        out["placement"] = np.asarray(prefill.placement)
    else:       # this rank's blocks of an empty cache of full rows
        meta = map_with_path(_empty_cache(case), lambda _, t: t.to("meta")
                             if torch.is_tensor(t) else t)
        cache = cache_block(meta, cache_pspecs(cfg, meta, mesh, B), mesh,
                            device="cpu")
        out["placement"] = np.asarray(decode.placement)
    for i, tok in enumerate(tokens):
        logits, cache = decode(params, local_shard(tok, bspec, mesh), cache)
        out[f"logits{i + 1}"] = logits
    out["position"] = np.asarray(cache.position)
    for path, t in spec_leaves(cache):
        if torch.is_tensor(t):
            out[f"cache/{path}"] = t
    return {f"{case}/{k}": (v.numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def rank_checks() -> dict:
    from repro_torch.launch.mesh import make_mesh
    meshes = {shape: make_mesh(shape, AXES)
              for shape in sorted({c[2] for c in CASES.values()})}
    res = {}
    for case, spec in CASES.items():
        res.update(_placed_case(case, meshes[spec[2]]))
    return res


def _reference(case) -> dict:
    """The reference's prefill and decode on the same weights and tokens
    (jitted, the config static): the logits of every call and the final
    cache as the port's ``LMCache``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import get_model as j_get_model
    from repro.models import transformer as jtf
    arch, over, _, B, S, rows, _ = CASES[case]
    jcfg = j_get_config(arch).reduced().with_overrides(**dict(_BASE, **over))
    bundle = j_get_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree_map(
        lambda t: t.numpy(), _params(case)))
    batch, tokens = _inputs(case)
    out = {}
    if S:
        logits, cache = jax.jit(lambda p, b: bundle.prefill(p, b, rows))(
            params, {n: jnp.asarray(x.numpy()) for n, x in batch.items()})
        out["logits0"] = np.asarray(logits)
    else:
        cache = jtf.init_lm_cache(jcfg, B, rows, ring=False)
    decode = jax.jit(bundle.decode)
    for i, tok in enumerate(tokens):
        logits, cache = decode(params, jnp.asarray(tok.numpy()), cache)
        out[f"logits{i + 1}"] = np.asarray(logits)
    out["cache"] = _port_cache(cache)
    return out


def _port_cache(tree):
    from repro_torch.models.attention import KVCache
    from repro_torch.models.encdec import WhisperCache
    from repro_torch.models.rwkv import RWKVState
    from repro_torch.models.ssd import SSMState
    from repro_torch.models.transformer import LMCache
    kinds = {"LMCache": LMCache, "KVCache": KVCache, "RWKVState": RWKVState,
             "SSMState": SSMState, "WhisperCache": WhisperCache}
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return kinds[type(tree).__name__](*(_port_cache(f) for f in tree))
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the reference's by case): the ranks run in a
    subprocess while this process runs the reference."""
    tmp = tmp_path_factory.mktemp("serve")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, __file__, str(tmp)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        refs = {case: _reference(case) for case in CASES}
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)], refs


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_serve_equals_the_reference(runs, case):
    """Every rank: its logits of the prefill and of each decode step are
    the reference's rows of its batch block, placed ("tp")."""
    ranks, refs = runs
    cfg = _cfg(case)
    _, _, shape, B, _, _, steps = CASES[case]
    ref = refs[case]
    for r, res in enumerate(ranks):
        assert str(res[f"{case}/placement"]) == "tp"
        mesh = Mesh(shape, AXES, device_mesh=_Coords(shape, r))
        spec = batch_pspec(mesh, B)
        names = [k for k in ref if k.startswith("logits")]
        assert len(names) == steps + (1 if CASES[case][4] else 0)
        for name in names:
            want = ref[name]
            if spec[0] is not None:
                rows = B // mesh.shape["data"]
                at = mesh.coordinate("data") * rows
                want = want[at:at + rows]
            assert res[f"{case}/{name}"].shape[-1] == cfg.vocab_size
            err = _rel(res[f"{case}/{name}"], want)
            assert err <= TOL, (case, r, name, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_block_is_the_references_slice(runs, case):
    """Every rank's block of every cache leaf equals its slice of the
    reference's cache under ``cache_pspecs``."""
    ranks, refs = runs
    cfg = _cfg(case)
    _, _, shape, B, _, _, _ = CASES[case]
    whole = refs[case]["cache"]
    for r, res in enumerate(ranks):
        mesh = Mesh(shape, AXES, device_mesh=_Coords(shape, r))
        want = place_cache(mesh, whole, cache_pspecs(cfg, whole, mesh, B))
        n = 0
        for path, w in spec_leaves(want):
            if not torch.is_tensor(w) or path == "position":
                continue
            err = _rel(res[f"{case}/cache/{path}"], w.float())
            assert err <= TOL, (case, r, path, err)
            n += 1
        assert n == sum(1 for k in res if k.startswith(f"{case}/cache/"))
        assert int(res[f"{case}/position"]) == int(whole.position)


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
