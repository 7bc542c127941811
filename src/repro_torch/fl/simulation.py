"""End-to-end synchronous FL simulation (the paper's experiments).

``run_simulation`` runs T synchronous rounds of a configured algorithm on a
:class:`FederatedDataset`, keeping the host-side randomness (device
selection, epoch heterogeneity) on a dedicated numpy seed so different
algorithms see *identical* selections — the paper's §IV-A3 protocol, and
the same selections as ``repro.fl.simulation.run_simulation``.  The whole
dataset goes to ``device`` once per run; mini-batch draws come from a
``torch.Generator`` on that device seeded with ``selection_seed``.

Each round opens the spans ``round`` > ``update_aggregate`` and ``eval``
on the active tracker (``repro_torch.obs``), as the reference does.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.flatten import tree_map
from ..data.federated import FederatedDataset
from ..device import DeviceLike, resolve_device
from ..obs import current_tracker, spans
from .metrics import evaluate_classifier, global_train_loss
from .server import ServerConfig, build_round_fn, init_server, sample_round

Tree = Any

# how much per-round α history the result keeps:
#   True — unbounded; False — none; int N — a rolling window of N entries
RecordHistory = Union[bool, int]


def _history_buffer(record_history: RecordHistory):
    if record_history is True or record_history is False \
            or record_history == 0:
        return []
    return deque(maxlen=int(record_history))


def _history_push(hist, item: Any, record_history: RecordHistory) -> None:
    if record_history is False or record_history == 0:
        return
    hist.append(item)      # deque(maxlen) evicts the oldest entry itself


def _vec_stats(prefix: str, v) -> Dict[str, float]:
    """Flat summary stats of a weight vector for one tracker event."""
    a = np.asarray(v, np.float64)
    if a.size == 0:
        return {}
    return {f"{prefix}_mean": float(a.mean()), f"{prefix}_std": float(a.std()),
            f"{prefix}_min": float(a.min()), f"{prefix}_max": float(a.max())}


@dataclass
class SimulationResult:
    name: str
    train_loss: List[float] = field(default_factory=list)
    test_acc: List[float] = field(default_factory=list)
    test_nll: List[float] = field(default_factory=list)
    alpha_history: List[np.ndarray] = field(default_factory=list)
    wall_time: float = 0.0

    def rounds_to_accuracy(self, level: float) -> Optional[int]:
        """First round index whose test accuracy reaches ``level`` (fig. 6)."""
        for i, acc in enumerate(self.test_acc):
            if acc >= level:
                return i + 1
        return None

    def loss_volatility(self) -> float:
        """Mean |Δ loss| between consecutive rounds after round 5."""
        arr = np.asarray(self.train_loss[5:])
        if len(arr) < 2:
            return 0.0
        return float(np.mean(np.abs(np.diff(arr))))


def run_simulation(name: str, loss_fn: Callable, apply_fn: Callable,
                   init_params: Tree, dataset: FederatedDataset,
                   cfg: ServerConfig, num_rounds: int,
                   selection_seed: int = 1234, eval_every: int = 1,
                   collect_alpha: bool = False,
                   record_history: RecordHistory = True,
                   device: DeviceLike = "cuda") -> SimulationResult:
    dev = resolve_device(device)
    round_fn = build_round_fn(loss_fn, cfg, dataset.samples_per_device,
                              device=dev)
    steps_per_epoch = max(dataset.samples_per_device // cfg.batch_size, 1)

    state = init_server(tree_map(
        lambda a: torch.as_tensor(a, device=dev), init_params))
    data = (torch.as_tensor(dataset.x, device=dev),
            torch.as_tensor(dataset.y, dtype=torch.long, device=dev),
            torch.as_tensor(dataset.mask, device=dev))
    test_x = torch.as_tensor(dataset.test_x, device=dev)
    test_y = torch.as_tensor(dataset.test_y, dtype=torch.long, device=dev)
    sel_rng = np.random.RandomState(selection_seed)  # shared across algorithms
    gen = torch.Generator(device=dev)
    gen.manual_seed(selection_seed)

    tr = current_tracker().scope(f"sync/{name}")
    if tr.active:
        tr.jot(runtime="sync", run=name, aggregator=cfg.aggregator,
               num_rounds=num_rounds, device=str(dev))
    result = SimulationResult(name=name)
    result.alpha_history = _history_buffer(record_history)
    t0 = time.time()
    for t in range(num_rounds):
        with spans.span("round", round=t):
            sel, grad_sel, num_steps = sample_round(sel_rng, cfg,
                                                    steps_per_epoch)
            with spans.span("update_aggregate"):
                state, info = round_fn(state, data, sel, grad_sel, num_steps,
                                       gen)
            alpha = (info["alpha"].cpu().numpy()
                     if "alpha" in info and (collect_alpha or tr.active)
                     else None)
            if collect_alpha and alpha is not None:
                _history_push(result.alpha_history, alpha, record_history)
            event: Dict[str, Any] = {"round": t} if tr.active else {}
            if tr.active and alpha is not None:
                event.update(_vec_stats("alpha", alpha))
            if (t + 1) % eval_every == 0 or t == num_rounds - 1:
                with spans.span("eval"):
                    loss = global_train_loss(loss_fn, state.params, *data)
                    nll, acc = evaluate_classifier(apply_fn, state.params,
                                                   test_x, test_y)
                result.train_loss.append(loss)
                result.test_acc.append(acc)
                result.test_nll.append(nll)
                if tr.active:
                    event.update(train_loss=loss, test_acc=acc, test_nll=nll)
            if tr.active:
                tr.log(event, step=t)
    result.wall_time = time.time() - t0
    if tr.active and result.train_loss:
        tr.log_summary({"final_train_loss": result.train_loss[-1],
                        "final_test_acc": result.test_acc[-1],
                        "wall_time_s": result.wall_time})
    return result
