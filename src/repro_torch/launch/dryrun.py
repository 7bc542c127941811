"""Multi-pod dry run of the port (``repro.launch.dryrun``).

For every (architecture × input shape × mesh) combination this traces the
port's own step function (``launch.steps``) once on fake tensors — the
parameters, batch and caches made from ``params_sds``, ``input_specs`` and
``cache_sds`` under ``shapes.fake_mode()``: shapes and dtypes on the
``meta`` device, nothing allocated, no card — and records, per rank:

  * the peak of live bytes (``hlo_analysis.TraceCost``), the arguments the
    step is handed, and whether the peak fits the card's 80 GB;
  * the FLOPs and bytes the eager program dispatches, kernel ops through
    their ``meta`` backends (``kernels.meta``);
  * the collectives' result bytes by kind;
  * the roofline terms on the H100's published peaks, and the trace's wall
    time (``trace_s``, in place of the reference's lower / compile times).

The production mesh is a real ``DeviceMesh`` over a fake process group of
256 ranks (512 with ``--mesh multi``) at rank 0
(``torch.testing._internal.distributed.fake_pg``: collectives are issued
and return at once, nothing is sent) — the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``.  The group is
process-global: it is made by :func:`dryrun_one` (the CLI's process, or a
test's subprocess), never at import.

Every step is placed as the reference's GSPMD program is
(``launch.steps.train_placement``, the serve steps' too): rank 0 is handed
its blocks of the params under ``param_pspecs`` and splits the compute
with the other ranks of its ``model`` axis ("tp"; from 7 B params the
leaves are also split over ``data`` and gathered for the step: "fsdp");
a prefill or decode step is also handed its rows of the inputs under
``batch_pspec`` and its block of every cache leaf under ``cache_pspecs``
(KV seq over 'model', or over every axis at batch 1).  A family whose
models do not run on shards (``launch.steps.TP_FAMILIES``) keeps the
replicated step: each record's ``placement`` says which ("tp" / "fsdp" /
"replicated") and ``placement_note`` why a step replicates.
``sharded_argument_bytes`` is what the specs place on one device (the
reference's ``memory_analysis`` argument size); a placed step's
``argument_size_in_bytes`` is that (its blocks of the params, its rows of
the inputs and its blocks of the cache).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
      --out build/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --reduced --mesh-shape 2,2     # a CPU check, seconds
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch

from ..configs import ASSIGNED, get_config
from ..models.config import ArchConfig
from ..sharding.specs import map_with_path, shard_shape, spec_leaves
from . import hlo_analysis
from .mesh import Mesh, make_mesh, make_production_mesh
from .shapes import (INPUT_SHAPES, InputShape, TensorSpec, arch_for_shape,
                     fake_mode, input_specs)
from .steps import (build_decode_step, build_prefill_step, build_train_step,
                    cache_sds, params_sds, placement_note)

REDUCED_BATCH = 8          # --reduced: the shape cut to this batch
REDUCED_SEQ = 32           # and this sequence


def init_fake_process_group(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks, replacing any group it had."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def fake_mesh(shape: Sequence[int]) -> Mesh:
    """A ``DeviceMesh`` of ``shape`` (axes ('data', 'model'), or ('pod',
    'data', 'model') for three) over a fake group of that many ranks."""
    axes = ("pod", "data", "model")[-len(shape):]
    init_fake_process_group(math.prod(shape))
    return make_mesh(tuple(shape), axes)


def _block(a: TensorSpec) -> tuple:
    return shard_shape(tuple(a.shape), a.sharding.spec, a.sharding.mesh)


def to_fake(tree, local: bool = False):
    """Each :class:`TensorSpec` or tensor leaf as an empty tensor of its
    shape and dtype on ``meta`` — a fake tensor when called under
    ``fake_mode()``; ``local``: a :class:`TensorSpec` as the block its spec
    places on one rank."""
    def fake(path, a):
        if not isinstance(a, (TensorSpec, torch.Tensor)):
            return a
        shape = _block(a) if local and isinstance(a, TensorSpec) else a.shape
        return torch.empty(shape, dtype=a.dtype, device="meta")
    return map_with_path(tree, fake)


def sharded_bytes(tree) -> int:
    """Σ over the :class:`TensorSpec` leaves of the bytes of the shard that
    its spec places on one device (each sharded dim cut by the product of
    its axes, rounded up)."""
    return sum(math.prod(_block(leaf)) * leaf.tensor.element_size()
               for _, leaf in spec_leaves(tree)
               if isinstance(leaf, TensorSpec))


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata
            for t in hlo_analysis.tensor_leaves(tree)}


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); prefill 2·N·D;
    decode D = batch·1 — the reference's."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def dryrun_step(cfg: ArchConfig, mesh: Mesh, shape: InputShape,
                aggregator: str = "contextual",
                extra: Optional[dict] = None) -> dict:
    """Trace one step of ``shape`` on ``mesh`` (as rank 0 of its group, or
    every cohort on this rank for a mesh with no ``DeviceMesh``); returns
    the record's measured fields."""
    extra = dict(extra or {})
    p_mode = "dp" if extra.get("dp_only") else "tp"
    specs = {"params": params_sds(cfg, mesh, mode=p_mode)}
    if shape.kind == "decode":
        specs["token"] = input_specs(cfg, shape, mesh)["token"]
        specs["cache"] = cache_sds(cfg, mesh, shape)
    else:
        specs["batch"] = input_specs(cfg, shape, mesh)
    if shape.kind == "train":
        step = build_train_step(cfg, mesh, shape, aggregator=aggregator,
                                **extra)
    else:
        step = (build_prefill_step if shape.kind == "prefill"
                else build_decode_step)(cfg, mesh, shape, mode=p_mode)
    placement = step.placement
    note = placement_note(cfg, placement)
    placed = placement != "replicated"
    with fake_mode():
        args = tuple(to_fake(tree, local=placed) for tree in specs.values())
        with hlo_analysis.TraceCost(args) as tc:
            t0 = time.perf_counter()
            out = step(*args)
            trace_s = time.perf_counter() - t0
        arg_bytes = hlo_analysis.tensor_bytes(args)
        held = _storages(args)
        out_bytes = sum(t.numel() * t.element_size()
                        for t in hlo_analysis.tensor_leaves(out)
                        if t.untyped_storage()._cdata not in held)
        del out, args
    peak = tc.peak_bytes
    terms = hlo_analysis.roofline(tc.cost, tc.collectives,
                                  model_flops(cfg, shape),
                                  num_chips=mesh.size)
    return {
        "status": "ok", "placement": placement, "placement_note": note,
        "window_variant": cfg.sliding_window,
        "trace_s": round(trace_s, 2), "cost": tc.cost,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "sharded_argument_bytes": sharded_bytes(specs),
                   "output_size_in_bytes": out_bytes,
                   "peak_bytes": peak,
                   "temp_size_in_bytes": peak - arg_bytes,
                   "fits": peak <= hlo_analysis.HBM_CAPACITY},
        "collectives": tc.collectives,
        "roofline": dict(terms.to_dict(), num_chips=mesh.size),
        "dispatched_ops": tc.ops}


def reduced_shape(shape: InputShape) -> InputShape:
    return InputShape(shape.name, shape.kind,
                      min(shape.seq_len, REDUCED_SEQ),
                      min(shape.global_batch, REDUCED_BATCH))


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               aggregator: str = "contextual",
               extra: Optional[dict] = None, reduced: bool = False,
               mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """Trace one combination on the production mesh (``mesh_shape``: a
    mesh of that shape over a fake group instead; ``reduced``: the
    config's ``.reduced()`` at a cut shape); returns the result record."""
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(get_config(arch), shape)
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "multi" if multi_pod else "single")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "aggregator": aggregator, "status": "skip", "skip_reason": None}
    if cfg is None:
        rec["skip_reason"] = ("long_500k inapplicable (shapes.arch_for_shape:"
                              " whisper decoder ctx 448)")
        return rec
    if reduced:
        cfg, shape = cfg.reduced(), reduced_shape(shape)
    if mesh_shape:
        mesh = fake_mesh(mesh_shape)
    else:
        init_fake_process_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    rec["variant"] = dict(extra) if extra else "baseline"
    rec.update(dryrun_step(cfg, mesh, shape, aggregator, extra))
    return rec


def _line(rec: dict) -> str:
    tag = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
    detail = ""
    if rec["status"] == "ok":
        r, m = rec["roofline"], rec["memory"]
        detail = (f" compute={r['compute_s']:.3e}s "
                  f"memory={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s "
                  f"bottleneck={r['bottleneck']} "
                  f"peak={m['peak_bytes'] / 2**30:.2f}GiB fits={m['fits']} "
                  f"placement={rec['placement']} "
                  f"trace={rec['trace_s']}s")
    elif rec["status"] == "fail":
        detail = " " + rec["error"].splitlines()[0][:160]
    return f"[{rec['status']:4s}] {tag}{detail}"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape)")
    ap.add_argument("--aggregator", default="contextual",
                    choices=["contextual", "fedavg"])
    ap.add_argument("--out", default=None, help="output dir for JSON records")
    ap.add_argument("--dp-only", action="store_true",
                    help="replicate params; all axes as data parallel (§Perf)")
    ap.add_argument("--remat", default=None,
                    choices=["full", "dots", "none"],
                    help="activation-checkpoint policy for train steps")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--reduced", action="store_true",
                    help="a CPU check: each config's .reduced(), the shape "
                         f"cut to batch <= {REDUCED_BATCH}, seq <= "
                         f"{REDUCED_SEQ}")
    ap.add_argument("--mesh-shape", default=None,
                    help="a mesh of this shape over a fake group in place of "
                         "the production mesh, e.g. 2,2 (data, model) or "
                         "2,2,2 (pod, data, model)")
    args = ap.parse_args(argv)
    extra: Dict = {}
    if args.dp_only:
        extra["dp_only"] = True
    if args.remat:
        extra["remat"] = False if args.remat == "none" else args.remat
    mesh_shape = (tuple(int(s) for s in args.mesh_shape.split(","))
                  if args.mesh_shape else None)

    archs = ASSIGNED if args.all or args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or args.shape is None \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh] if not mesh_shape else [False]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                try:
                    rec = dryrun_one(arch, shape_name, mp,
                                     aggregator=args.aggregator, extra=extra,
                                     reduced=args.reduced,
                                     mesh_shape=mesh_shape)
                except Exception as e:                       # noqa: BLE001
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": ("x".join(map(str, mesh_shape))
                                    if mesh_shape else
                                    "multi" if mp else "single"),
                           "status": "fail", "error": str(e)[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                print(_line(rec), flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{arch}_{shape_name}_{rec['mesh']}{args.tag}.json"
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(rec, f, indent=1)
    if failures:
        raise SystemExit(f"{failures} combination(s) failed")


if __name__ == "__main__":
    main()
