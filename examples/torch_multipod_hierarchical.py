"""Hierarchical multi-pod contextual aggregation on a 2x2x2 (pod, data,
model) mesh of 8 gloo ranks on the CPU (the twin of
``examples/multipod_hierarchical.py``, whose 8 forced host devices become
8 processes here).

Shows the two-stage combine: contextual aggregation of cohort updates
WITHIN each pod, then a second contextual combine ACROSS pods.  Each rank
holds its cohort's update slice for its model shard, as inside the
reference's ``shard_map``; the process group's store is a file in a
temporary directory.

  python examples/torch_multipod_hierarchical.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.distributed import (contextual_combine_sharded,
                                          hierarchical_contextual_combine)
from repro_torch.launch.mesh import make_mesh

N = 1024           # parameter slice per example
BETA = 10.0


def rank_main(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    p, d, m = (mesh.coordinate(a) for a in ("pod", "data", "model"))
    # 4 cohorts (2 pods x 2 data) each with an update; sharded over model
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(N, generator=gen)
    noise = torch.randn((2, 2, N), generator=gen)
    updates = -0.1 * (g[None, None, :] + 0.5 * noise)
    cols = slice(m * N // 2, (m + 1) * N // 2)
    u, gs = updates[p, d, cols], g[cols]
    flat, alpha = contextual_combine_sharded(mesh, u, gs, BETA,
                                             data_axis="data",
                                             model_axis="model")
    hier, a_intra, a_pods = hierarchical_contextual_combine(mesh, u, gs,
                                                            BETA)
    # the norms of the whole vectors: the model shards' squares summed
    sq = torch.stack([flat.square().sum(), hier.square().sum()])
    dist.all_reduce(sq, group=mesh.group("model"))
    alphas = [torch.empty(2) for _ in range(2)]
    dist.all_gather(alphas, alpha, group=mesh.group("pod"))
    assert torch.isfinite(hier).all()
    if rank == 0:
        print("mesh:", mesh.shape)
        print("intra-pod alpha (per pod):", torch.stack(alphas).numpy())
        print("cross-pod alpha:", a_pods.numpy())
        # both combines live in span(updates); hierarchical applies a
        # second contextual reweighting across pods
        print("flat combine norm:   ", float(sq[0].sqrt()))
        print("hierarchical norm:   ", float(sq[1].sqrt()))
        print("ok: two-stage (pod -> cross-pod) contextual aggregation ran "
              "on a multi-pod mesh")
    dist.barrier()
    dist.destroy_process_group()


def main():
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(8, os.path.join(tmp, "store")),
                           nprocs=8, start_method="spawn")


if __name__ == "__main__":
    main()
