"""The port's collectives, sharded train step and fleet axis
(``repro_torch.core.distributed``, ``launch.steps``, ``sharding``) on an
8-rank gloo process group, against the reference's ``shard_map`` / GSPMD
programs on 8 forced host devices.

* Reference side: two subprocesses (``XLA_FLAGS`` forcing 8 host devices,
  ``JAX_PLATFORMS=cpu`` pinned, Auto-typed meshes), each writing one
  ``.npz``.  One runs ``contextual_combine_sharded`` on (4, 2),
  ``hierarchical_contextual_combine`` on (2, 2, 2) and
  ``build_train_step`` on (4, 2) at ``tests/test_distributed_spmd.py``'s
  size; the other the batched fleet cohort update of
  ``tests/test_fleet_scale.py`` (B = 20 over 8: padded) with its draws
  written out.
* Port side: one subprocess that spawns 8 gloo ranks (a ``FileStore`` in
  the test's temporary directory) running the port's twins on the same
  numpy inputs, each rank writing its results.  All three start together:
  the ranks wait for the reference's files.  Every rank equals the
  reference at 1e-5 relative to max(1, max |x|), α at rtol 1e-3 / atol
  1e-4 (``tests/test_distributed_spmd.py``'s bound).
* The placed step (params as each rank's blocks under ``param_pspecs``, the
  batch as its cohort's rows, the cohort split over ``model``) on (4, 2),
  and on (2, 2, 2) with every leaf also split over ``data``
  (``FSDP_THRESHOLD`` patched to 0 on the port's side alone): every rank's
  new blocks equal the same blocks of the reference's (4, 2) result, whose
  numbers no placement changes, and each rank holds only the blocks its
  specs name.
* One rank: the emulated (4, 2) step equals the 8-rank one; a one-rank
  fleet mesh and a one-rank streamed mesh give the mesh-free round (the
  streamed split on 8 ranks is ``tests/test_torch_streamed_mesh.py``'s).
* The collectives refuse an emulated mesh.

This file imports no JAX: the reference runs in its subprocess, and the
port's ranks import this module.
"""
import contextlib
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.distributed import (contextual_combine_sharded,
                                          hierarchical_contextual_combine)
from repro_torch.core.flatten import (tree_leaves, tree_leaves_with_path,
                                      tree_unflatten)
from repro_torch.data import VirtualFleetDataset
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.synthetic import make_synthetic
from repro_torch.edge import bimodal_fleet
from repro_torch.fl import run_hier_simulation
from repro_torch.fl.client import client_update, cohort_update
from repro_torch.hier import HierConfig, two_tier_topology
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import emulated_mesh, make_mesh
from repro_torch.launch.shapes import InputShape, meta_params
from repro_torch.launch.steps import build_train_step
from repro_torch.models import get_model
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)
from repro_torch.sharding import (fleet_mesh, param_pspecs, place_batch,
                                  place_params, shard_cohort_fn, shard_shape,
                                  stream_round_shardings)
from repro_torch.sharding import specs as tspecs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
ALPHA_RTOL, ALPHA_ATOL = 1e-3, 1e-4
RANKS = 8
TIMEOUT_S = 240
REFERENCE_FILES = ("reference_combine.npz", "reference_fleet.npz")
BETA, LR = 8.0, 0.05


def _train_cfg():
    return get_config("qwen3-14b").reduced().with_overrides(
        num_layers=1, d_model=64, d_ff=128, vocab_size=128, num_heads=2,
        num_kv_heads=2, head_dim=32)


_REFERENCE_HEAD = textwrap.dedent("""
    import os, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.configs import get_config
    from repro.core.distributed import (contextual_combine_sharded,
                                        hierarchical_contextual_combine)
    from repro.data.fleetgen import VirtualFleetDataset
    from repro.fl.simulation import _batched_client_update_fn
    from repro.launch.mesh import _axis_types_kwargs
    from repro.launch.shapes import InputShape
    from repro.launch.steps import build_train_step
    from repro.models import get_model
    from repro.models.config import ArchConfig
    from repro.models.logistic import logistic_loss
    from repro.sharding.specs import (_path_str, fleet_mesh,
                                      stream_round_shardings)

    assert jax.device_count() == 8
    out = {}
    def mesh(shape, axes):
        return jax.make_mesh(shape, axes, **_axis_types_kwargs(len(axes)))
""")

_REFERENCE_COMBINE = _REFERENCE_HEAD + textwrap.dedent("""
    rng = np.random.RandomState(0)
    BETA, LR = %(beta)r, %(lr)r

    # contextual_combine_sharded on (4, 2): cohort k = data coordinate k
    U = rng.normal(size=(4, 64)).astype(np.float32)
    g = rng.normal(size=64).astype(np.float32)
    def body(u, gs):
        comb, alpha = contextual_combine_sharded(u[0], gs, BETA, 1e-6)
        return comb[None], alpha[None]
    comb, alpha = jax.jit(shard_map(
        body, mesh=mesh((4, 2), ("data", "model")),
        in_specs=(P("data", "model"), P("model")),
        out_specs=(P("data", "model"), P("data", None))))(U, g)
    out.update(U=U, g=g, comb=np.asarray(comb), alpha=np.asarray(alpha))

    # hierarchical_contextual_combine on (2, 2, 2)
    gh = rng.normal(size=64).astype(np.float32)
    upd = (-0.1 * (gh[None, None] + 0.5 * rng.normal(size=(2, 2, 64)))
           ).astype(np.float32)
    def hbody(u, gs):
        h, ai, ap = hierarchical_contextual_combine(u[0, 0], gs, 10.0)
        return h[None, None], ai[None, None], ap[None, None]
    h, ai, ap = jax.jit(shard_map(
        hbody, mesh=mesh((2, 2, 2), ("pod", "data", "model")),
        in_specs=(P("pod", "data", "model"), P("model")),
        out_specs=(P("pod", "data", "model"), P("pod", "data", None),
                   P("pod", "data", None))))(upd, gh)
    out.update(upd=upd, gh=gh, hier=np.asarray(h), a_intra=np.asarray(ai),
               a_pods=np.asarray(ap))

    # the train step on (4, 2), tests/test_distributed_spmd.py's size
    cfg = get_config("qwen3-14b").reduced().with_overrides(
        num_layers=1, d_model=64, d_ff=128, vocab_size=128, num_heads=2,
        num_kv_heads=2, head_dim=32)
    m42 = mesh((4, 2), ("data", "model"))
    step = build_train_step(cfg, m42, InputShape("t", "train", 16, 8),
                            aggregator="contextual", lr=LR, remat=False)
    params = get_model(cfg).init(jax.random.PRNGKey(0))
    tokens = rng.randint(0, 128, (8, 16)).astype(np.int32)
    with m42:
        new, metrics = jax.jit(step)(params, {"tokens": jnp.asarray(tokens)})
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out["param_names"] = np.asarray([_path_str(p) for p, _ in flat])
    for i, (_, a) in enumerate(flat):
        out[f"p_{i}"] = np.asarray(a)
    for i, a in enumerate(jax.tree_util.tree_leaves(new)):
        out[f"new_{i}"] = np.asarray(a)
    out.update(tokens=tokens, step_alpha=np.asarray(metrics["alpha"]),
               step_loss=np.asarray(metrics["loss"]),
               step_bound=np.asarray(metrics["bound"]))

    np.savez(sys.argv[1] + ".tmp.npz", **out)
    os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1])
""") % {"beta": BETA, "lr": LR}

_REFERENCE_FLEET = _REFERENCE_HEAD + textwrap.dedent("""
    # the fleet cohort update (tests/test_fleet_scale.py): B = 20 over 8
    ds = VirtualFleetDataset(num_devices=64, samples_per_device=16, dim=8,
                             num_classes=3, seed=3)
    lp = get_model(ArchConfig(name="lr", family="logreg", input_dim=8,
                              num_classes=3)).init(jax.random.PRNGKey(0))
    fm = fleet_mesh()
    B = 20
    ids = jnp.arange(B)
    ns = jnp.full((B,), 4, jnp.int32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i)
                    )(jnp.arange(B, dtype=jnp.uint32))
    x, y, m = ds.materialize_arrays(np.arange(B))
    def draws(kk, mk):
        probs = mk / jnp.maximum(mk.sum(), 1.0)
        return jax.vmap(lambda sk: jax.random.choice(
            sk, 16, shape=(8,), p=probs))(jax.random.split(kk, 4))
    bidx = np.asarray(jax.vmap(draws)(keys, jnp.asarray(m)))
    batched = _batched_client_update_fn(logistic_loss, 4, 8, 0.1, 0.0, fm)
    o3 = batched(lp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), ns,
                 keys)
    for i, a in enumerate(jax.tree_util.tree_leaves(lp)):
        out[f"lp_{i}"] = np.asarray(a)
    for i, a in enumerate(jax.tree_util.tree_leaves(o3)):
        out[f"fleet_{i}"] = np.asarray(a)
    out.update(fx=x, fy=y, fm=m, fbidx=bidx)
    sh = stream_round_shardings(fm, {"m": jnp.zeros((16, 32)),
                                     "v": jnp.zeros((16,))})
    out["m_spec"], out["v_spec"] = str(sh["m"].spec), str(sh["v"].spec)
    np.savez(sys.argv[1] + ".tmp.npz", **out)
    os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1])
""")


def _run_together(jobs, tmp):
    """``(cmd, env, what)`` jobs started together, each in its own session
    with its output in a file, and all killed with their children at
    ``TIMEOUT_S``."""
    procs = []
    try:
        for i, (cmd, env, what) in enumerate(jobs):
            log = open(tmp / f"job{i}.log", "w+")
            procs.append((subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                text=True, start_new_session=True), log, what))
        deadline = time.monotonic() + TIMEOUT_S
        for proc, log, what in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{what} took more than {TIMEOUT_S} s")
            log.seek(0)
            assert proc.returncode == 0, \
                f"{what} failed:\n{log.read()[-4000:]}"
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference npz, [each rank's npz])``."""
    tmp = tmp_path_factory.mktemp("dist")
    jax_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    _run_together([
        ([sys.executable, "-c", _REFERENCE_COMBINE,
          str(tmp / REFERENCE_FILES[0])], jax_env,
         "the reference's 8-device combines and train step"),
        ([sys.executable, "-c", _REFERENCE_FLEET,
          str(tmp / REFERENCE_FILES[1])], jax_env,
         "the reference's 8-device fleet cohort"),
        ([sys.executable, __file__, str(tmp)], env, "the 8 gloo ranks")],
        tmp)
    return (_reference(tmp),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)])


def _reference(out) -> dict:
    """The reference's two files as one dict, once both are written."""
    ref = {}
    for name in REFERENCE_FILES:
        ref.update(np.load(os.path.join(out, name)))
    return ref


def _wait_for_reference(out) -> dict:
    deadline = time.monotonic() + TIMEOUT_S
    while not all(os.path.exists(os.path.join(out, name))
                  for name in REFERENCE_FILES):
        if time.monotonic() > deadline:
            raise TimeoutError("the reference's files never appeared")
        time.sleep(0.05)
    return _reference(out)


# ------------------------------------------------------------- the ranks

def _train_params(ref):
    like = get_model(_train_cfg()).init(0, device="cpu")
    names = [n for n, _ in tree_leaves_with_path(like)]
    assert names == [str(n) for n in ref["param_names"]]
    return tree_unflatten(like, [torch.from_numpy(ref[f"p_{i}"])
                                 for i in range(len(names))])


PLACED = {"tp": ((4, 2), ("data", "model")),
          "fsdp": ((2, 2, 2), ("pod", "data", "model"))}


@contextlib.contextmanager
def _fsdp_everywhere(on: bool):
    """``FSDP_THRESHOLD`` 0 (every leaf over 'data' too) in the port's spec
    rules and step while on."""
    old = tspecs.FSDP_THRESHOLD
    if on:
        tspecs.FSDP_THRESHOLD = tsteps.FSDP_THRESHOLD = 0
    try:
        yield
    finally:
        tspecs.FSDP_THRESHOLD = tsteps.FSDP_THRESHOLD = old


def _placed_specs(tag: str) -> list:
    """The port's specs of the placed run ``tag``, leaf by leaf."""
    shape, axes = PLACED[tag]
    cfg = _train_cfg()
    with _fsdp_everywhere(tag == "fsdp"):
        specs = param_pspecs(cfg, meta_params(cfg),
                             emulated_mesh(shape, axes), "tp")
    return [spec for _, spec in tspecs.spec_leaves(specs)]


def _placed_run(tag: str, mesh, ref) -> dict:
    """The placed step on this rank's blocks of the reference's params."""
    cfg = _train_cfg()
    with _fsdp_everywhere(tag == "fsdp"):
        specs = param_pspecs(cfg, meta_params(cfg), mesh, "tp")
        step = build_train_step(cfg, mesh, InputShape("t", "train", 16, 8),
                                lr=LR, remat="full")
        new, metrics = step(
            place_params(mesh, _train_params(ref), specs),
            place_batch(mesh, {"tokens": torch.from_numpy(ref["tokens"])}))
    res = {f"{tag}_new_{i}": a.numpy() for i, a in enumerate(tree_leaves(new))}
    res.update({f"{tag}_placement": np.asarray(step.placement),
                f"{tag}_coords": np.asarray([mesh.coordinate(a)
                                             for a in mesh.axis_names]),
                f"{tag}_alpha": metrics["alpha"].numpy(),
                f"{tag}_loss": metrics["loss"].numpy(),
                f"{tag}_bound": metrics["bound"].numpy()})
    return res


def _block(a: np.ndarray, spec, shape: dict, coords: dict) -> np.ndarray:
    """The block of ``a`` that ``spec`` puts at ``coords`` of a mesh of
    axis sizes ``shape``."""
    for dim, names in enumerate(tuple(spec)):
        if names is None:
            continue
        names = (names,) if isinstance(names, str) else names
        ways, at = 1, 0
        for n in names:
            ways, at = ways * shape[n], at * shape[n] + coords[n]
        size = a.shape[dim] // ways
        a = np.take(a, range(at * size, (at + 1) * size), axis=dim)
    return a


def _rank_main(rank: int, world: int, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    ref = _wait_for_reference(out)
    res = {}
    # contextual_combine_sharded: this rank's cohort row, its model slice
    m42 = make_mesh((4, 2), ("data", "model"))
    d, m = m42.coordinate("data"), m42.coordinate("model")
    cols = slice(m * 32, (m + 1) * 32)
    comb, alpha = contextual_combine_sharded(
        m42, torch.from_numpy(ref["U"][d, cols]),
        torch.from_numpy(ref["g"][cols]), BETA, 1e-6)
    res.update(comb=comb.numpy(), alpha=alpha.numpy(),
               coord=np.asarray([d, m]))
    # hierarchical_contextual_combine on (2, 2, 2)
    m222 = make_mesh((2, 2, 2), ("pod", "data", "model"))
    p, d2, m2 = (m222.coordinate(a) for a in ("pod", "data", "model"))
    cols = slice(m2 * 32, (m2 + 1) * 32)
    h, ai, ap = hierarchical_contextual_combine(
        m222, torch.from_numpy(ref["upd"][p, d2, cols]),
        torch.from_numpy(ref["gh"][cols]), 10.0)
    res.update(hier=h.numpy(), a_intra=ai.numpy(), a_pods=ap.numpy(),
               coord3=np.asarray([p, d2, m2]))
    # the train step on (4, 2): replicated params, this rank's cohort
    step = build_train_step(_train_cfg(), m42, InputShape("t", "train", 16,
                                                          8),
                            lr=LR, remat="full", mode="dp")
    new, metrics = step(_train_params(ref),
                        {"tokens": torch.from_numpy(ref["tokens"])})
    for i, a in enumerate(tree_leaves(new)):
        res[f"new_{i}"] = a.numpy()
    res.update(step_alpha=metrics["alpha"].numpy(),
               step_loss=metrics["loss"].numpy(),
               step_bound=metrics["bound"].numpy())
    # the placed steps: tensor-parallel on (4, 2), FSDP on (2, 2, 2)
    res.update(_placed_run("tp", m42, ref))
    res.update(_placed_run("fsdp", m222, ref))
    # the fleet axis: the batched cohort update on the reference's shards
    # and draws, and the virtual one against itself without the mesh
    fm = fleet_mesh()
    lp = tree_unflatten(init_logistic(ArchConfig(
        name="lr", family="logreg", input_dim=8, num_classes=3), 0,
        device="cpu"), [torch.from_numpy(ref[f"lp_{i}"]) for i in range(2)])
    steps = torch.full((20,), 4, dtype=torch.long)

    def batched(params, xs, ys, ms, ns, bidx):
        return client_update(logistic_loss, params, xs, ys, ms, ns, bidx,
                             lr=0.1)

    got = shard_cohort_fn(fm, batched, 5)(
        lp, torch.from_numpy(ref["fx"]), torch.from_numpy(ref["fy"]).long(),
        torch.from_numpy(ref["fm"]), steps,
        torch.from_numpy(ref["fbidx"]).long())
    for i, a in enumerate(tree_leaves(got)):
        res[f"fleet_{i}"] = a.numpy()
    ds = VirtualFleetDataset(num_devices=64, samples_per_device=16, dim=8,
                             num_classes=3, seed=3)
    shard = ds.shard_fn("cpu")
    bidx = torch.randint(0, 16, (20, 4, 8),
                         generator=torch.Generator().manual_seed(7))

    def virtual(params, ids, ns, bi):
        return cohort_update(logistic_loss, params, shard, ids, ns, bi,
                             lr=0.1)

    ids = torch.arange(20)
    a = virtual(lp, ids, steps, bidx)
    b = shard_cohort_fn(fm, virtual, 3)(lp, ids, steps, bidx)
    res["fleet_virtual_diff"] = np.asarray(max(
        float((x - y).abs().max()) for x, y in
        zip(tree_leaves(a), tree_leaves(b))))
    sh = stream_round_shardings(fm, {"m": torch.zeros(16, 32),
                                     "v": torch.zeros(16)})
    res["m_spec"], res["v_spec"] = repr(sh["m"].spec), repr(sh["v"].spec)
    res["m_placements"] = repr(sh["m"].placements)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


# ----------------------------------------------------------------- tests

def test_contextual_combine_sharded_matches_reference(runs):
    ref, ranks = runs
    for res in ranks:
        d, m = res["coord"]
        np.testing.assert_allclose(res["alpha"], ref["alpha"][d],
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
        assert _rel(res["comb"], ref["comb"][d, m * 32:(m + 1) * 32]) <= TOL


def test_hierarchical_combine_matches_reference(runs):
    ref, ranks = runs
    for res in ranks:
        p, d, m = res["coord3"]
        assert _rel(res["hier"], ref["hier"][p, d, m * 32:(m + 1) * 32]) \
            <= TOL
        np.testing.assert_allclose(res["a_intra"], ref["a_intra"][p, d],
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
        np.testing.assert_allclose(res["a_pods"], ref["a_pods"][p, d],
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)


def test_train_step_on_eight_ranks_matches_reference(runs):
    ref, ranks = runs
    n = len(ref["param_names"])
    for res in ranks:
        np.testing.assert_allclose(res["step_alpha"], ref["step_alpha"],
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
        assert _rel(res["step_loss"], ref["step_loss"]) <= TOL
        assert float(res["step_bound"]) < 0
        for i in range(n):
            assert _rel(res[f"new_{i}"], ref[f"new_{i}"]) <= TOL, \
                ref["param_names"][i]


@pytest.mark.parametrize("tag", sorted(PLACED))
def test_placed_step_on_eight_ranks_matches_reference(runs, tag):
    """Every rank's new blocks are the reference's new params' blocks
    under the port's specs (each a proper block: a rank holds no more than
    its spec names), α at the reference's bound, g(α) < 0; "fsdp" puts
    every leaf over 'data' too."""
    ref, ranks = runs
    shape, axes = PLACED[tag]
    mesh_shape = dict(zip(axes, shape))
    specs = _placed_specs(tag)
    n = len(ref["param_names"])
    assert len(specs) == n
    split = [str(sp) for sp in specs if "model" in str(sp)]
    assert split and all(("data" in sp) == (tag == "fsdp") for sp in split)
    for res in ranks:
        assert str(res[f"{tag}_placement"]) == tag
        coords = dict(zip(axes, (int(c) for c in res[f"{tag}_coords"])))
        np.testing.assert_allclose(res[f"{tag}_alpha"], ref["step_alpha"],
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
        assert _rel(res[f"{tag}_loss"], ref["step_loss"]) <= TOL
        assert float(res[f"{tag}_bound"]) < 0
        for i in range(n):
            got = res[f"{tag}_new_{i}"]
            whole = ref[f"new_{i}"]
            assert got.shape == shard_shape(whole.shape, specs[i],
                                            emulated_mesh(shape, axes))
            assert _rel(got, _block(whole, specs[i], mesh_shape, coords)) \
                <= TOL, (tag, ref["param_names"][i], specs[i])


def test_fleet_cohort_on_eight_ranks_matches_reference(runs):
    """B = 20 over 8 ranks (padded to 24): every rank holds the whole
    cohort's (deltas, grads), equal to the reference's shard_mapped update
    on its own shards and draws; the virtual cohort equals itself without
    the mesh (the reference's own such check is
    tests/test_fleet_scale.py's); the round shardings' specs are the
    reference's."""
    ref, ranks = runs
    for res in ranks:
        for i in range(4):
            assert _rel(res[f"fleet_{i}"], ref[f"fleet_{i}"]) <= TOL
        assert float(res["fleet_virtual_diff"]) < 1e-5
        assert str(res["m_spec"]) == str(ref["m_spec"]) \
            == "PartitionSpec('fleet', None)"
        assert str(res["v_spec"]) == str(ref["v_spec"]) \
            == "PartitionSpec('fleet',)"
        assert str(res["m_placements"]) == "(Shard(dim=0),)"


def test_emulated_step_equals_the_eight_rank_step(runs):
    """All four cohorts on this rank (an emulated (4, 2) mesh) give the
    8-rank step's new params and α."""
    ref, ranks = runs
    step = build_train_step(_train_cfg(),
                            emulated_mesh((4, 2), ("data", "model")),
                            InputShape("t", "train", 16, 8), lr=LR,
                            remat=False)
    new, metrics = step(_train_params(ref),
                        {"tokens": torch.from_numpy(ref["tokens"])})
    np.testing.assert_allclose(metrics["alpha"].numpy(),
                               ranks[0]["step_alpha"], rtol=1e-4, atol=1e-5)
    for i, a in enumerate(tree_leaves(new)):
        assert _rel(a.numpy(), ranks[0][f"new_{i}"]) <= TOL


# ------------------------------------------------------------ one rank

@pytest.fixture(scope="module")
def hier_problem():
    xs, ys = make_synthetic(1.0, 1.0, num_devices=12, samples_per_device=30,
                            dim=20, seed=5)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 20)[:150], ys.reshape(-1)[:150], 10)
    cfg = ArchConfig(name="lr", family="logreg", input_dim=20,
                     num_classes=10)
    params = init_logistic(cfg, 0, device="cpu")
    topo = two_tier_topology(bimodal_fleet(12, slowdown=5.0,
                                           dropout_slow=0.0, seed=0), 3)
    hcfg = HierConfig(aggregator="hier_contextual", lr=0.2, batch_size=10,
                      min_epochs=1, max_epochs=2)
    return ds, params, topo, hcfg


def _hier(problem, **kw):
    ds, params, topo, hcfg = problem
    return run_hier_simulation("m", logistic_loss, logistic_apply, params,
                               ds, hcfg, topo, 2, device="cpu", **kw)


@pytest.mark.parametrize("engine", ["fused", "streamed"])
def test_one_rank_fleet_mesh_gives_the_mesh_free_round(hier_problem, engine):
    base = _hier(hier_problem, engine=engine)
    got = _hier(hier_problem, engine=engine, mesh=fleet_mesh())
    assert got.train_loss == base.train_loss and got.times == base.times


def test_one_rank_streamed_mesh_gives_the_mesh_free_round(hier_problem):
    """tests/test_streamed_engine.py's one-device chunk-axis mesh: it
    places nothing and the round is unchanged."""
    base = _hier(hier_problem, engine="streamed")
    got = _hier(hier_problem, engine="streamed",
                mesh=make_mesh((1,), ("data",)))
    assert got.train_loss == base.train_loss


def test_collectives_refuse_an_emulated_mesh():
    mesh = emulated_mesh((4, 2), ("data", "model"))
    u = torch.ones(8)
    with pytest.raises(ValueError, match="need 4 ranks"):
        contextual_combine_sharded(mesh, u, u, BETA)
    # a one-coordinate emulated mesh needs no collective
    one = emulated_mesh((1, 1, 1), ("pod", "data", "model"))
    comb, a, ap = hierarchical_contextual_combine(one, u, -u, BETA)
    assert torch.isfinite(comb).all() and a.shape == (1,) == ap.shape


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(RANKS, sys.argv[1]), nprocs=RANKS,
                       start_method="spawn")
