"""The streamed round engine split across ranks
(``repro_torch.hier.streamed`` on a mesh of ranks) against the reference's
``StreamedRoundEngine(mesh=...)`` on 8 forced host devices, and against
the port's one-rank engine.

* Inputs: numpy, from a seed, written once by the test for both sides: a
  stacked tree of P = 8 rows with a (P, 10) leaf (10 does not divide 8),
  a (P, 3, 7) leaf narrower than 8 × 256 columns (seven empty windows),
  widths that are no multiple of 8 (4 102, 3 977), and (P, a, b) leaves;
  and a Synthetic(1, 1) dataset of 12 devices at dim 300 (the 3 000-column
  weight splits over six ranks, the bias sits on rank 0 alone).
* Reference side: one subprocess (``XLA_FLAGS`` forcing 8 host devices,
  ``JAX_PLATFORMS=cpu``, Auto-typed meshes).  It first writes the
  mini-batch draws of its hier runs, then the stages of one streamed round
  on ('data',) 8, ('fleet', 'data') 2 × 4 and ('pod', 'data', 'model')
  2 × 2 × 2 (and a robust engine on ('data',) 8), then two rounds of
  ``run_hier_simulation(engine="streamed")`` on the first two meshes for
  uncompressed, ``topk``, ``sign_sketch`` and robust (``HierConfig.robust``)
  tiers.
* Port side: one subprocess that spawns 8 gloo ranks (a ``FileStore`` in
  the test's temporary directory), which wait for the reference's draws
  and run the same on the port, replaying those draws through
  ``batch_indices``.  Each rank records every ``stream_stats``,
  ``mix_rows`` and ``weighted_combine`` call's window (monkeypatched in
  ``repro_torch.hier.streamed``).
* Tolerances, set before the first run.  A split sums (G, C) in a new
  order, so nothing is held bitwise across the split but the ranks
  against each other:
  - (G, C), every stage's info, the materialized vectors and the applied
    parameters at 1e-5 relative to max(1, max |x|), against the reference
    and against the port's one-rank engine; α (and γ) at rtol 1e-3 /
    atol 1e-4 against the reference (``tests/test_distributed_spmd.py``'s
    bound) and at 1e-5 against the one-rank engine.  The norm of each
    solve's residual c + β G α (``stationarity_residual``) is held to the
    other side's within RESIDUAL_REL of ||β G α|| (recorded on the port's
    side at each solve), the f32 rounding of forming the residual from its
    terms: where a solve has no constraint the residual is that rounding
    itself (~1e-6 of ||β G α|| here), where it has one (the merge and the
    cloud: Σ = 1) it is the multiplier's (~0.07), and both are held so;
  - the hier runs: losses at rtol 1e-4 and parameters at 1e-4 relative to
    max(1, max |p|) against the reference's 8-device run (the replayed
    runs' bound in ``tests/test_torch_robust.py``), at 1e-5 against the
    port's mesh-free run; times and bytes exactly;
  - every rank's parameters bitwise equal to rank 0's.
* Windows: on each rank every call reads one window of its slab; over the
  8 ranks the windows tile each slab once, none wider than
  ceil(width / 8) + 256 columns; an empty window launches nothing.

This file imports no JAX: the reference runs in its subprocess, and the
port's ranks import this module.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.compress import CompressConfig
from repro_torch.core.solve import SolveConfig
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.synthetic import make_synthetic
from repro_torch.edge import bimodal_fleet
from repro_torch.fl import run_hier_simulation
from repro_torch.hier import HierConfig, streamed, two_tier_topology
from repro_torch.hier.streamed import StreamedRoundEngine
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.logistic import logistic_apply, logistic_loss
from repro_torch.robust import RobustConfig
from repro_torch.sharding.specs import column_windows

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RANKS = 8
TIMEOUT_S = 240
TOL = 1e-5
ALPHA_RTOL, ALPHA_ATOL = 1e-3, 1e-4
RESIDUAL_REL = 1e-6
# the solves of a stage round, in call order (each records its ||β G α||)
SOLVES = ("gw0", "gw1", "gw2", "merge", "cloud", "raw")
RUN_RTOL = 1e-4
MESHES = {"data": ((8,), ("data",)),
          "fleet": ((2, 4), ("fleet", "data")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}
STAGE_RUNS = ("data", "fleet", "pod", "robust")   # robust: on ('data',) 8
RUN_MESHES = ("data", "fleet")
CONFIGS = ("contextual", "topk", "sign_sketch", "robust")
P = 8
LEAVES = {"bias": (10,), "narrow": (3, 7), "odd": (2, 2051),
          "wide": (41, 97), "even": (12, 64)}
COHORTS = ([0, 1, 2], [3, 4, 5], [6, 7])
BETA = 2.0
DIM, CLASSES, DEVICES, ROUNDS, SEED = 300, 10, 12, 2, 11
BASE = dict(lr=0.2, batch_size=10, min_epochs=1, max_epochs=2)
MAX_STEPS = 2 * (30 // 10)
INPUTS, DRAWS, REFERENCE = "inputs.npz", "draws.npz", "reference.npz"


def _write_inputs(path: Path) -> None:
    rng = np.random.RandomState(0)
    out = {}
    for name, shape in LEAVES.items():
        out[f"d_{name}"] = rng.randn(P, *shape).astype(np.float32)
        out[f"g_{name}"] = rng.randn(P, *shape).astype(np.float32)
        out[f"p_{name}"] = rng.randn(*shape).astype(np.float32)
    xs, ys = make_synthetic(1.0, 1.0, num_devices=DEVICES,
                            samples_per_device=30, dim=DIM,
                            num_classes=CLASSES, seed=5)
    out.update(xs=xs, ys=ys,
               w=(0.01 * rng.randn(DIM, CLASSES)).astype(np.float32))
    np.savez(path, **out)


# ------------------------------------------------------------- reference

_REFERENCE = textwrap.dedent("""
    import os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.compress import CompressConfig
    from repro.core.solve import SolveConfig
    from repro.data.federated import FederatedDataset
    from repro.edge import bimodal_fleet
    from repro.fl.simulation import run_hier_simulation
    from repro.hier import HierConfig, two_tier_topology
    from repro.hier.streamed import StreamedRoundEngine
    from repro.launch.mesh import _axis_types_kwargs
    from repro.models.logistic import logistic_apply, logistic_loss
    from repro.robust import RobustConfig

    assert jax.device_count() == 8
    tmp = sys.argv[1]
    inp = dict(np.load(os.path.join(tmp, %(inputs)r)))
    MESHES, CONFIGS = %(meshes)r, %(configs)r
    LEAVES, COHORTS, P = %(leaves)r, %(cohorts)r, %(P)r
    BETA, SEED, ROUNDS, BASE = %(beta)r, %(seed)r, %(rounds)r, %(base)r
    MAX_STEPS, DEVICES = %(max_steps)r, %(devices)r

    def save(name, out):
        np.savez(os.path.join(tmp, name + ".tmp.npz"), **out)
        os.replace(os.path.join(tmp, name + ".tmp.npz"),
                   os.path.join(tmp, name))

    def mesh(tag):
        shape, axes = MESHES[tag]
        return jax.make_mesh(shape, axes, **_axis_types_kwargs(len(axes)))

    # the hier runs' mini-batch draws: participant i of round t trains on
    # fold_in(PRNGKey(SEED), t * P + i), every mask row all ones
    # (repro.fl.client._sample_batch's draw)
    @jax.jit
    def draws(keys):
        mask = jnp.ones((30,), jnp.float32)
        probs = mask / jnp.maximum(mask.sum(), 1.0)
        def per_client(kk):
            return jax.vmap(lambda sk: jax.random.choice(
                sk, 30, shape=(10,), p=probs))(
                jax.random.split(kk, MAX_STEPS))
        return jax.vmap(per_client)(keys)
    base = jax.random.PRNGKey(SEED)
    save(%(draws)r, {f"draws_{t}": np.asarray(draws(jax.vmap(
        jax.random.fold_in, (None, 0))(base, jnp.arange(
            t * DEVICES, (t + 1) * DEVICES, dtype=jnp.uint32))))
        for t in range(ROUNDS)})

    out = {}
    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}_{k}"] = np.asarray(v)

    D = {k: jnp.asarray(inp["d_" + k]) for k in LEAVES}
    GM = {k: jnp.asarray(inp["g_" + k]) for k in LEAVES}
    params = {k: jnp.asarray(inp["p_" + k]) for k in LEAVES}
    counts = [float(len(c)) for c in COHORTS]
    for tag in %(stage_runs)r:
        robust = RobustConfig(2.0, "mom") if tag == "robust" else None
        eng = StreamedRoundEngine(params, SolveConfig(beta=BETA),
                                  "contextual", robust=robust,
                                  mesh=mesh("data" if robust else tag))
        ctx = eng.begin_round(D, GM)
        out[tag + "_G"], out[tag + "_C"] = np.asarray(ctx.G), np.asarray(ctx.C)
        gws = [ctx.gateway(c) for c in COHORTS]
        for i, g in enumerate(gws):
            out[f"{tag}_gw{i}_alpha"] = np.asarray(g["alpha"])
            put(f"{tag}_gw{i}_info", g["info"])
        ghat = ctx.compose_grads([g["ghat"] for g in gws], counts)
        m = ctx.merge([g["u_bar"] for g in gws[:2]],
                      [g["ghat"] for g in gws[:2]], counts[:2])
        out[tag + "_merge_alpha"] = np.asarray(m["alpha"])
        put(tag + "_merge_info", m["info"])
        delta, info = ctx.cloud_combo([g["u_bar"] for g in gws], counts, ghat)
        put(tag + "_cloud_info", info)
        _, info = ctx.cloud_raw(list(range(P)), "raw")
        put(tag + "_raw_info", info)
        out[tag + "_u0"] = np.asarray(ctx.materialize(gws[0]["u_bar"]))
        out[tag + "_ghat"] = np.asarray(ctx.materialize(ghat))
        out[tag + "_delta"] = np.asarray(ctx.materialize(delta))
        for k, v in ctx.apply(params, delta).items():
            out[f"{tag}_new_{k}"] = np.asarray(v)

    ds = FederatedDataset(inp["xs"], inp["ys"],
                          np.ones(inp["ys"].shape, np.float32),
                          inp["xs"].reshape(-1, inp["xs"].shape[-1])[:150],
                          inp["ys"].reshape(-1)[:150], 10)
    init = {"b": jnp.zeros((10,), jnp.float32), "w": jnp.asarray(inp["w"])}
    topo = two_tier_topology(bimodal_fleet(DEVICES, slowdown=5.0,
                                           dropout_slow=0.0, seed=0), 3)
    sketch = dict(aggregator="hier_contextual_sketch", **BASE)
    cfgs = {"contextual": HierConfig(aggregator="hier_contextual", **BASE),
            "topk": HierConfig(compress=CompressConfig(
                scheme="topk", ratio=3.4, u_frac=0.75), **sketch),
            "sign_sketch": HierConfig(compress=CompressConfig(
                scheme="sign_sketch", ratio=4.0), **sketch),
            "robust": HierConfig(aggregator="hier_contextual",
                                 robust=RobustConfig(2.0, "mom"), **BASE)}
    for tag in %(run_meshes)r:
        for name in CONFIGS:
            pub = []
            r = run_hier_simulation(
                f"{tag}_{name}", logistic_loss, logistic_apply, init, ds,
                cfgs[name], topo, ROUNDS, selection_seed=SEED, eval_every=1,
                engine="streamed", mesh=mesh(tag),
                publish_fn=lambda t, p: pub.append(
                    {k: np.asarray(v) for k, v in p.items()}))
            key = f"run_{tag}_{name}"
            out[key + "_loss"] = np.asarray(r.train_loss)
            out[key + "_nll"] = np.asarray(r.test_nll)
            out[key + "_times"] = np.asarray(r.times)
            out[key + "_bytes"] = np.asarray([r.cloud_uplink_bytes,
                                              r.total_bytes])
            for k, v in pub[-1].items():
                out[f"{key}_p_{k}"] = v
    save(%(reference)r, out)
""") % {"inputs": INPUTS, "draws": DRAWS, "reference": REFERENCE,
        "meshes": MESHES, "configs": CONFIGS, "leaves": LEAVES,
        "cohorts": COHORTS, "P": P, "beta": BETA, "seed": SEED,
        "rounds": ROUNDS, "base": BASE, "max_steps": MAX_STEPS,
        "devices": DEVICES, "stage_runs": STAGE_RUNS,
        "run_meshes": RUN_MESHES}


# ------------------------------------------------------- both port sides

def _stacked(inp):
    D = {k: torch.from_numpy(inp["d_" + k]) for k in LEAVES}
    GM = {k: torch.from_numpy(inp["g_" + k]) for k in LEAVES}
    params = {k: torch.from_numpy(inp["p_" + k]) for k in LEAVES}
    return D, GM, params


def _stage_round(tag: str, inp, mesh) -> dict:
    """One streamed round's stages through the context API (the
    reference side's sequence), as numpy."""
    robust = RobustConfig(2.0, "mom") if tag == "robust" else None
    D, GM, params = _stacked(inp)
    eng = StreamedRoundEngine(params, SolveConfig(beta=BETA), "contextual",
                              robust=robust, mesh=mesh)
    scales = []
    diagnostics = streamed.solve_diagnostics

    def scaled(G, c, alpha, beta):
        # the size of the terms of the solve's residual c + β G α
        scales.append(float(beta * torch.linalg.vector_norm(G @ alpha)))
        return diagnostics(G, c, alpha, beta)
    streamed.solve_diagnostics = scaled
    try:
        out = _stages(tag, eng, D, GM, params)
    finally:
        streamed.solve_diagnostics = diagnostics
    assert len(scales) == len(SOLVES)
    out[f"{tag}_scales_residual"] = np.asarray(scales)
    return out


def _stages(tag: str, eng, D, GM, params) -> dict:
    ctx = eng.begin_round(D, GM)
    out = {f"{tag}_G": ctx.G.numpy(), f"{tag}_C": ctx.C.numpy()}

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}_{k}"] = np.asarray(v)

    counts = [float(len(c)) for c in COHORTS]
    gws = [ctx.gateway(c) for c in COHORTS]
    for i, g in enumerate(gws):
        out[f"{tag}_gw{i}_alpha"] = g["alpha"].numpy()
        put(f"{tag}_gw{i}_info", g["info"])
    ghat = ctx.compose_grads([g["ghat"] for g in gws], counts)
    m = ctx.merge([g["u_bar"] for g in gws[:2]],
                  [g["ghat"] for g in gws[:2]], counts[:2])
    out[f"{tag}_merge_alpha"] = m["alpha"].numpy()
    put(f"{tag}_merge_info", m["info"])
    delta, info = ctx.cloud_combo([g["u_bar"] for g in gws], counts, ghat)
    put(f"{tag}_cloud_info", info)
    _, info = ctx.cloud_raw(list(range(P)), "raw")
    put(f"{tag}_raw_info", info)
    out[f"{tag}_u0"] = ctx.materialize(gws[0]["u_bar"]).numpy()
    out[f"{tag}_ghat"] = ctx.materialize(ghat).numpy()
    out[f"{tag}_delta"] = ctx.materialize(delta).numpy()
    for k, v in ctx.apply(params, delta).items():
        out[f"{tag}_new_{k}"] = v.numpy()
    return out


def _hier_problem(inp):
    xs, ys = inp["xs"], inp["ys"]
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, DIM)[:150], ys.reshape(-1)[:150],
                          CLASSES)
    init = {"b": torch.zeros(CLASSES), "w": torch.from_numpy(inp["w"])}
    topo = two_tier_topology(bimodal_fleet(DEVICES, slowdown=5.0,
                                           dropout_slow=0.0, seed=0), 3)
    sketch = dict(aggregator="hier_contextual_sketch", **BASE)
    cfgs = {"contextual": HierConfig(aggregator="hier_contextual", **BASE),
            "topk": HierConfig(compress=CompressConfig(
                scheme="topk", ratio=3.4, u_frac=0.75), **sketch),
            "sign_sketch": HierConfig(compress=CompressConfig(
                scheme="sign_sketch", ratio=4.0), **sketch),
            "robust": HierConfig(aggregator="hier_contextual",
                                 robust=RobustConfig(2.0, "mom"), **BASE)}
    return ds, init, topo, cfgs


def _hier_run(key: str, inp, draws, cfg_name: str, mesh) -> dict:
    """Two streamed rounds on the reference's replayed draws: losses, nll,
    times, bytes and the last round's published params."""
    ds, init, topo, cfgs = _hier_problem(inp)

    def batch_indices(t, part_dev, max_steps):
        assert len(part_dev) == DEVICES
        return torch.from_numpy(draws[f"draws_{t}"][:, :max_steps]).long()

    pub = []
    r = run_hier_simulation(
        key, logistic_loss, logistic_apply, init, ds, cfgs[cfg_name], topo,
        ROUNDS, selection_seed=SEED, eval_every=1, engine="streamed",
        device="cpu", mesh=mesh, batch_indices=batch_indices,
        publish_fn=lambda t, p: pub.append({k: v.clone()
                                            for k, v in p.items()}))
    out = {f"{key}_loss": np.asarray(r.train_loss),
           f"{key}_nll": np.asarray(r.test_nll),
           f"{key}_times": np.asarray(r.times),
           f"{key}_bytes": np.asarray([r.cloud_uplink_bytes, r.total_bytes])}
    for k, v in pub[-1].items():
        out[f"{key}_p_{k}"] = v.numpy()
    return out


# ------------------------------------------------------------- the ranks

class _Windows:
    """Records each windowed call's (row stride, start column, columns) in
    ``repro_torch.hier.streamed`` while installed."""

    NAMES = ("stream_stats", "mix_rows", "weighted_combine")

    def __init__(self):
        self.calls = {name: [] for name in self.NAMES}
        self.saved = {name: getattr(streamed, name) for name in self.NAMES}

    def __enter__(self):
        for name in self.NAMES:
            fn, calls = self.saved[name], self.calls[name]

            def rec(*args, _fn=fn, _calls=calls, **kw):
                # the slab window: stream_stats' and mix_rows' second
                # argument is the grads / leaf, weighted_combine's the rows
                m = args[1]
                _calls.append((m.stride(0), m.storage_offset(), m.shape[1]))
                return _fn(*args, **kw)
            setattr(streamed, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(streamed, name, fn)
        return False


def _wait_for(path: str) -> dict:
    deadline = time.monotonic() + TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    return dict(np.load(path))


def _rank_main(rank: int, world: int, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    inp = dict(np.load(os.path.join(out, INPUTS)))
    res = {}
    meshes = {tag: make_mesh(*MESHES[tag]) for tag in MESHES}
    for tag in STAGE_RUNS:
        with _Windows() as w:
            res.update(_stage_round(tag, inp, meshes.get(tag, meshes["data"])))
        for name, calls in w.calls.items():
            res[f"{tag}_calls_{name}"] = np.asarray(calls,
                                                    np.int64).reshape(-1, 3)
    draws = _wait_for(os.path.join(out, DRAWS))
    for tag in RUN_MESHES:
        for name in CONFIGS:
            res.update(_hier_run(f"run_{tag}_{name}", inp, draws, name,
                                 meshes[tag]))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------- fixture

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
    """``(inputs, draws, reference npz, [each rank's npz])``."""
    tmp = tmp_path_factory.mktemp("streamed_mesh")
    _write_inputs(tmp / INPUTS)
    jax_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    _run_together([
        ([sys.executable, "-c", _REFERENCE, str(tmp)], jax_env,
         "the reference's 8-device streamed rounds"),
        ([sys.executable, __file__, str(tmp)], env, "the 8 gloo ranks")],
        tmp)
    return (dict(np.load(tmp / INPUTS)), dict(np.load(tmp / DRAWS)),
            dict(np.load(tmp / REFERENCE)),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)])


@pytest.fixture(scope="module")
def one_rank(runs):
    """The port's engine without a mesh on the same inputs and draws: the
    stage round of each engine and the two-round runs of each config."""
    inp, draws, _, _ = runs
    out = {}
    for tag in ("data", "robust"):
        out.update(_stage_round(tag, inp, None))
    for name in CONFIGS:
        out.update(_hier_run(f"run_{name}", inp, draws, name, None))
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _stage_keys(res: dict, tag: str) -> list:
    return sorted(k for k in res if k.startswith(tag + "_")
                  and "_calls_" not in k and "_scales_" not in k)


def _is_alpha(key: str) -> bool:
    """α-like keys: the solves' weights."""
    return key.endswith(("_alpha", "_gamma", "_clip_scale"))


def _residual_bound(res: dict, tag: str, key: str):
    """RESIDUAL_REL of ||β G α|| of the solve a ``stationarity_residual``
    key belongs to (the bound on two sides' difference), or None for any
    other key."""
    if not key.endswith("_stationarity_residual"):
        return None
    solve = key[len(tag) + 1:].split("_")[0]
    return RESIDUAL_REL * res[f"{tag}_scales_residual"][SOLVES.index(solve)]


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("tag", STAGE_RUNS)
def test_stages_on_eight_ranks_match_reference(runs, tag):
    """(G, C), each stage's α and info, the materialized vectors and the
    applied parameters on every rank against the reference's engine on
    the same mesh; the keys are the reference's."""
    _, _, ref, ranks = runs
    for res in ranks:
        keys = _stage_keys(res, tag)
        assert keys == _stage_keys(ref, tag)
        for key in keys:
            bound = _residual_bound(res, tag, key)
            if bound is not None:
                assert abs(res[key] - ref[key]) <= bound, key
            elif _is_alpha(key):
                np.testing.assert_allclose(res[key], ref[key],
                                           rtol=ALPHA_RTOL, atol=ALPHA_ATOL,
                                           err_msg=key)
            else:
                assert _rel(res[key], ref[key]) <= TOL, key


@pytest.mark.parametrize("tag", STAGE_RUNS)
def test_stages_on_eight_ranks_match_one_rank(runs, one_rank, tag):
    """The same against the port's engine without a mesh, α included at
    1e-5: the split changes only the order of the (G, C) sums."""
    _, _, _, ranks = runs
    base = "data" if tag != "robust" else "robust"
    for res in ranks:
        for key in _stage_keys(res, tag):
            want = one_rank[base + key[len(tag):]]
            bound = _residual_bound(res, tag, key)
            if bound is not None:
                assert abs(res[key] - want) <= bound, key
            else:
                assert _rel(res[key], want) <= TOL, key


@pytest.mark.parametrize("tag", STAGE_RUNS)
def test_ranks_end_with_the_same_bits(runs, tag):
    """Every rank's (G, C), materialized vectors and new parameters are
    bitwise rank 0's: the ranks would drift apart otherwise."""
    _, _, _, ranks = runs
    for res in ranks[1:]:
        for key in _stage_keys(res, tag):
            np.testing.assert_array_equal(res[key], ranks[0][key],
                                          err_msg=key)


@pytest.mark.parametrize("tag", STAGE_RUNS)
def test_each_rank_reads_only_its_windows(runs, tag):
    """Each call reads one window of its slab; over the ranks the windows
    of each pass tile every slab once (each scoped slab's columns summed
    once into (G, C)), none wider than ceil(width / 8) + 256, and the
    windows are the plan's; no call is handed an empty window."""
    _, _, _, ranks = runs
    widths = [int(np.prod(s)) for _, s in sorted(LEAVES.items())]
    # begin_round: one stream_stats per slab; materialize three vectors
    # (u0, ĝ, Δ), each one mix_rows per slab; apply one combine per slab
    passes = {"stream_stats": 1, "mix_rows": 3, "weighted_combine": 1}
    for name, times in passes.items():
        seen = {width: Counter() for width in widths}
        for r, res in enumerate(ranks):
            for stride, start, cols in res[f"{tag}_calls_{name}"]:
                assert cols > 0
                assert cols <= -(-stride // RANKS) + 256
                assert (start, start + cols) == \
                    column_windows(stride, RANKS)[r]
                seen[stride][(start, start + cols)] += 1
        for width, windows in seen.items():
            cover = sorted(windows)
            assert set(windows.values()) == {times}, (name, width, windows)
            assert cover[0][0] == 0 and cover[-1][1] == width
            assert all(a[1] == b[0] for a, b in zip(cover, cover[1:])), \
                (name, width, cover)
    # the (P, 3, 7) slab of 21 columns: rank 0 alone; ranks 1-7 launch
    # nothing for it
    assert all(21 not in res[f"{tag}_calls_stream_stats"][:, 0]
               for res in ranks[1:])


@pytest.mark.parametrize("tag", RUN_MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_hier_runs_on_eight_ranks_match_reference(runs, one_rank, tag,
                                                  name):
    """Two ``run_hier_simulation(engine="streamed")`` rounds on the mesh,
    on the reference's draws: times and bytes exactly, losses and the
    last published parameters against the reference's 8-device run and
    the port's mesh-free run, bitwise equal across the ranks."""
    _, _, ref, ranks = runs
    key, base = f"run_{tag}_{name}", f"run_{name}"
    for res in ranks:
        np.testing.assert_array_equal(res[key + "_times"],
                                      ref[key + "_times"])
        np.testing.assert_array_equal(res[key + "_bytes"],
                                      ref[key + "_bytes"])
        for part in ("_loss", "_nll"):
            np.testing.assert_allclose(res[key + part], ref[key + part],
                                       rtol=RUN_RTOL)
            np.testing.assert_allclose(res[key + part],
                                       one_rank[base + part], rtol=TOL)
        for leaf in ("b", "w"):
            got = res[f"{key}_p_{leaf}"]
            assert _rel(got, ref[f"{key}_p_{leaf}"]) <= RUN_RTOL, leaf
            assert _rel(got, one_rank[f"{base}_p_{leaf}"]) <= TOL, leaf
            np.testing.assert_array_equal(got, ranks[0][f"{key}_p_{leaf}"])


def test_window_plan():
    """The plan's edges: 256-column multiples, the last window short and
    any after it empty, a slab narrower than a granule on place 0."""
    assert column_windows(4102, 8) == [(0, 768), (768, 1536), (1536, 2304),
                                       (2304, 3072), (3072, 3840),
                                       (3840, 4102), (4102, 4102),
                                       (4102, 4102)]
    assert column_windows(10, 8) == [(0, 10)] + [(10, 10)] * 7
    assert column_windows(1 << 23, 8)[3] == (3 << 20, 4 << 20)
    assert column_windows(0, 4) == [(0, 0)] * 4
    assert column_windows(7, 1) == [(0, 7)]


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(RANKS, sys.argv[1]), nprocs=RANKS,
                       start_method="spawn")
