"""Virtual wall-clock accounting: rounds-to-accuracy → time-to-accuracy.

Synchronous and asynchronous FL are not comparable on a per-round axis (an
async "round" is one buffer flush, a sync round waits for its slowest
client).  The common currency is *virtual wall-clock*: the simulated time at
which the server's model reached each evaluation point.

For the async runtime this is just the event scheduler's clock.  For the
synchronous baseline, :func:`sync_round_durations` replays the simulation's
host-side randomness (``sample_round`` on the same selection seed — the
paper's §IV-A3 protocol makes this exact) and charges each round
``max_k task_time(k)``: the straggler gates the round.  Dropped-out devices
in sync cost the server the full straggler wait as well (we charge the
round's max regardless — the usual timeout model, mildly sync-favouring).

Workload model: a local SGD step on batch B costs ≈ 6·B·|w| FLOPs
(fwd + bwd ≈ 3× the 2·B·|w| forward MACs); one task moves the |w|-float32
model down and the update back up.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np

from ..core.flatten import tree_size
from ..fl.server import ServerConfig, sample_round
from .profiles import Fleet

Tree = Any


def model_payload_bytes(params: Tree) -> float:
    """float32 over-the-wire size of one model/update."""
    return 4.0 * tree_size(params)


def model_flops_per_step(params: Tree, batch_size: int) -> float:
    """≈ FLOPs of one local mini-batch SGD step (fwd+bwd ≈ 6·B·|w|)."""
    return 6.0 * batch_size * tree_size(params)


@dataclass
class WallclockCurve:
    """A (virtual time → metric) curve; the async/sync comparison axis."""
    name: str
    times: List[float] = field(default_factory=list)      # seconds, increasing
    test_acc: List[float] = field(default_factory=list)
    train_loss: List[float] = field(default_factory=list)

    def time_to_accuracy(self, level: float) -> Optional[float]:
        """First virtual time at which test accuracy reaches ``level``."""
        for t, acc in zip(self.times, self.test_acc):
            if acc >= level:
                return t
        return None

    def accuracy_at(self, time: float) -> Optional[float]:
        """Best accuracy achieved by virtual ``time`` (step-function read)."""
        i = bisect.bisect_right(self.times, time)
        if i == 0:
            return None
        return max(self.test_acc[:i])


def sync_round_durations(fleet: Fleet, cfg: ServerConfig,
                         steps_per_epoch: int, num_rounds: int,
                         flops_per_step: float, payload_bytes: float,
                         selection_seed: int = 1234,
                         timing_seed: int = 0) -> np.ndarray:
    """Per-round durations of a *synchronous* run on ``fleet``.

    Replays ``sample_round`` with the run's own selection seed, so the
    replayed (selection, step-budget) pairs are exactly those the simulation
    executed; each round costs the max task time over its K participants."""
    if fleet.num_devices != cfg.num_devices:
        raise ValueError(f"fleet has {fleet.num_devices} devices, config "
                         f"expects {cfg.num_devices}")
    sel_rng = np.random.RandomState(selection_seed)
    timing_rng = np.random.RandomState(timing_seed)
    durations = np.zeros(num_rounds)
    for t in range(num_rounds):
        sel, _, num_steps = sample_round(sel_rng, cfg, steps_per_epoch)
        durations[t] = max(
            fleet[int(d)].task_time(int(n) * flops_per_step, payload_bytes,
                                    timing_rng)
            for d, n in zip(sel, num_steps))
    return durations


def sync_wallclock_curve(result, fleet: Fleet, cfg: ServerConfig,
                         steps_per_epoch: int, num_rounds: int,
                         eval_every: int, flops_per_step: float,
                         payload_bytes: float, selection_seed: int = 1234,
                         timing_seed: int = 0) -> WallclockCurve:
    """Attach virtual times to a sync :class:`~repro_torch.fl.SimulationResult`'s
    eval points (which ``run_simulation`` records every ``eval_every`` rounds
    plus the final round)."""
    durations = sync_round_durations(fleet, cfg, steps_per_epoch, num_rounds,
                                     flops_per_step, payload_bytes,
                                     selection_seed, timing_seed)
    cumulative = np.cumsum(durations)
    eval_rounds = [t for t in range(num_rounds)
                   if (t + 1) % eval_every == 0 or t == num_rounds - 1]
    if len(eval_rounds) != len(result.test_acc):
        raise ValueError(
            f"eval schedule mismatch: replay expects {len(eval_rounds)} eval "
            f"points, result has {len(result.test_acc)}")
    return WallclockCurve(name=result.name,
                          times=[float(cumulative[t]) for t in eval_rounds],
                          test_acc=list(result.test_acc),
                          train_loss=list(result.train_loss))
