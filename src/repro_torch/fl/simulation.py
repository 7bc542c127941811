"""End-to-end FL simulation (the paper's experiments).

``run_simulation`` runs T synchronous rounds of a configured algorithm on a
:class:`FederatedDataset`, keeping the host-side randomness (device
selection, epoch heterogeneity) on a dedicated numpy seed so different
algorithms see *identical* selections — the paper's §IV-A3 protocol, and
the same selections as ``repro.fl.simulation.run_simulation``.  The whole
dataset goes to ``device`` once per run; mini-batch draws come from a
``torch.Generator`` on that device seeded with ``selection_seed``.

Each round opens the spans ``round`` > ``update_aggregate`` and ``eval``
on the active tracker (``repro_torch.obs``), as the reference does.

``run_async_simulation`` drives the same datasets and metrics through the
event-driven edge runtime (``repro_torch.edge``): devices train at
profile-dependent speeds, updates arrive asynchronously, and the server
flushes buffers of (possibly stale) updates through ``contextual_async``
(the ``gram`` and ``combine`` kernels on the card), ``fedbuff`` or
``fedasync`` (``combine``).  The event stream is a pure function of the
fleet and the seed, bit-identical to the reference's, so aggregators stay
comparable on one virtual clock.

``run_hier_simulation`` runs synchronous rounds over a ``repro_torch.hier``
multi-tier topology on the event scheduler (``repro_torch.edge``): every hop
is an event, so round times are multi-hop critical paths, and the per-tier
byte ledger measures the uplink the hierarchy saves.  The round's array math
runs on the fused engine (``repro_torch.hier.fused``), whose Gram reductions
launch the ``gram`` kernel on the card, or, for models too wide for dense
(P, n) round matrices, on the streamed engine (``repro_torch.hier.streamed``:
the ``stream_stats`` kernel per leaf slab, ``combine`` for the apply);
compressed summaries go through the ``topk`` and ``sign_sketch`` kernels.
At fleet scale (10⁵-10⁶ devices a round) a ``VirtualFleetDataset``'s shards
are generated on the card inside the cohort pass
(``fl.client.cohort_update``), and ``scheduler_mode="cohort"`` settles the
whole cohort from one vectorized dispatch with no per-device events.
Its spans are ``round`` > ``client_update``, ``begin_round``,
``event_loop`` > ``gateway`` / ``merge`` / ``cloud``, and ``eval``, as in
the reference.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field, replace as dc_replace
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.flatten import tree_map, tree_size
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


def _adversary_noise(dev: torch.device, *seed: int) -> Callable:
    """``noise(*key, deltas, grads)``: the adversary's standard-normal draws
    from a generator of its own on ``dev``, seeded from ``seed`` and the
    key (round, arrival, stream tag) alone — never the mini-batch
    generator, so the honest clients' draws are those of the clean run."""
    from ..robust.attacks import generator_noise, stream_seed

    def noise(*args):
        *key, deltas, grads = args
        gen = torch.Generator(device=dev)
        gen.manual_seed(stream_seed(*seed, *key))
        return generator_noise(gen)(deltas, grads)
    return noise


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
    if (cfg.attack is not None and cfg.attack.corrupts_data
            and cfg.malicious):
        # label-flip adversaries poison their shards before the run; the
        # update-space attacks corrupt inside the round instead
        from ..robust.attacks import poison_labels
        dataset = poison_labels(dataset, cfg.malicious)
    attack_noise = (None if cfg.attack is None
                    else _adversary_noise(dev, selection_seed))

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
                state, info = round_fn(
                    state, data, sel, grad_sel, num_steps, gen,
                    attack_noise=None if attack_noise is None
                    else partial(attack_noise, t))
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


@dataclass
class AsyncSimulationResult:
    """Metrics of an async run, indexed by *virtual wall-clock* eval points."""
    name: str
    times: List[float] = field(default_factory=list)       # virtual seconds
    versions: List[int] = field(default_factory=list)      # model version
    train_loss: List[float] = field(default_factory=list)
    test_acc: List[float] = field(default_factory=list)
    test_nll: List[float] = field(default_factory=list)
    staleness_mean: List[float] = field(default_factory=list)  # per flush
    alpha_history: List[np.ndarray] = field(default_factory=list)
    updates_per_device: Optional[np.ndarray] = None   # arrivals aggregated
    dispatched: int = 0
    arrived: int = 0
    dropped: int = 0
    wall_time: float = 0.0                                 # real seconds

    def time_to_accuracy(self, level: float) -> Optional[float]:
        """First virtual time at which test accuracy reaches ``level``."""
        return self.to_curve().time_to_accuracy(level)

    def to_curve(self):
        from ..edge.wallclock import WallclockCurve
        return WallclockCurve(name=self.name, times=list(self.times),
                              test_acc=list(self.test_acc),
                              train_loss=list(self.train_loss))


def run_async_simulation(name: str, loss_fn: Callable, apply_fn: Callable,
                         init_params: Tree, dataset: FederatedDataset,
                         cfg, fleet, num_aggregations: int,
                         selection_seed: int = 1234, eval_every: int = 1,
                         collect_alpha: bool = False,
                         record_history: RecordHistory = True,
                         attack=None, churn=None,
                         batch_indices: Optional[
                             Callable[[int, int, int], torch.Tensor]] = None,
                         attack_noise: Optional[Callable] = None,
                         device: DeviceLike = "cuda"
                         ) -> AsyncSimulationResult:
    """Event-driven async FL (``cfg`` is a :class:`repro_torch.edge.AsyncConfig`),
    as ``repro.fl.simulation.run_async_simulation``.

    The server keeps up to ``cfg.concurrency`` tasks in flight (default: one
    per device); devices without a task wait in a FIFO queue, so a
    concurrency cap rotates work across the whole fleet.  Each ARRIVAL is
    trained against the params it was *dispatched* with (``client_update``
    with K = 1), buffered, and the buffer is flushed through the configured
    aggregator (``contextual_async`` / ``fedbuff`` / ``fedasync``) once
    ``cfg.buffer_size`` updates are present.  Dropouts lose their work; the
    freed slot goes to the next waiting device.  Runs until
    ``num_aggregations`` buffer flushes have been applied.

    The host randomness (epoch draws, the FIFO queue, the event scheduler)
    is numpy and bit-identical to the reference, so virtual times, versions
    and counts match it exactly.  Mini-batch draws come from a
    ``torch.Generator`` on ``device`` seeded with ``selection_seed``, or from
    ``batch_indices(seq, device_id, max_steps)``, which returns the
    ``(1, max_steps, batch_size)`` sample indices of the arrival with event
    sequence number ``seq`` (the tests replay the reference's draws that
    way).

    ``attack`` (a :class:`repro_torch.robust.AttackModel`) corrupts each
    arrival from a device in ``fleet.malicious`` before it enters the
    buffer (label-flip attacks poison the malicious shards up front
    instead); its noise comes from a generator seeded from
    ``selection_seed`` and the arrival's ``seq``, or from
    ``attack_noise(seq, deltas, grads)`` (K = 1 stacked trees; the tests
    replay the reference's draws that way).  ``churn`` (a
    :class:`repro_torch.robust.ChurnSchedule`) rides on the event
    scheduler: tasks dispatched inside an active wave drop out.

    Spans: ``client_update`` per arrival, ``aggregate`` per flush, ``eval``,
    all on the scheduler's virtual clock.
    """
    # imported here: repro_torch.edge imports repro_torch.fl at module scope
    from ..edge.async_server import AsyncBuffer, BufferedUpdate
    from ..edge.events import EventKind, EventScheduler
    from ..edge.wallclock import model_flops_per_step, model_payload_bytes
    from .client import client_update, draw_batch_indices

    if fleet.num_devices != cfg.num_devices:
        raise ValueError(f"fleet has {fleet.num_devices} devices, config "
                         f"expects {cfg.num_devices}")
    if dataset.num_devices < cfg.num_devices:
        raise ValueError(f"dataset has {dataset.num_devices} device shards, "
                         f"need {cfg.num_devices}")
    dev = resolve_device(device)

    malicious = frozenset(getattr(fleet, "malicious", ()))
    if attack is not None and attack.corrupts_data and malicious:
        from ..robust.attacks import poison_labels
        dataset = poison_labels(dataset, malicious)
    live_attack = (attack if attack is not None
                   and not attack.corrupts_data and malicious else None)
    if live_attack is not None and attack_noise is None:
        attack_noise = _adversary_noise(dev, selection_seed, 0x0BAD)

    steps_per_epoch = max(dataset.samples_per_device // cfg.batch_size, 1)
    max_steps = cfg.max_epochs * steps_per_epoch

    params = tree_map(lambda a: torch.as_tensor(a, device=dev), init_params)
    x = torch.as_tensor(dataset.x, device=dev)
    y = torch.as_tensor(dataset.y, dtype=torch.long, device=dev)
    mask = torch.as_tensor(dataset.mask, device=dev)
    test_x = torch.as_tensor(dataset.test_x, device=dev)
    test_y = torch.as_tensor(dataset.test_y, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(selection_seed)

    scheduler = EventScheduler(
        fleet, seed=selection_seed,
        flops_per_step=model_flops_per_step(params, cfg.batch_size),
        payload_bytes=model_payload_bytes(params), churn=churn)
    buffer = AsyncBuffer(cfg)
    epoch_rng = np.random.RandomState(selection_seed + 1)

    version = 0
    in_flight: Dict[int, tuple] = {}     # device_id -> (params snapshot, version)
    idle = deque(range(fleet.num_devices))   # devices waiting for a task

    def dispatch_next() -> None:
        device_id = idle.popleft()
        epochs = int(epoch_rng.randint(cfg.min_epochs, cfg.max_epochs + 1))
        scheduler.dispatch(device_id, epochs * steps_per_epoch, version)
        in_flight[device_id] = (params, version)

    concurrency = (fleet.num_devices if cfg.concurrency is None
                   else min(cfg.concurrency, fleet.num_devices))
    for _ in range(concurrency):
        dispatch_next()

    tr = current_tracker().scope(f"async/{name}")
    if tr.active:
        tr.jot(runtime="async", run=name, aggregator=cfg.aggregator,
               num_aggregations=num_aggregations,
               buffer_size=cfg.buffer_size, device=str(dev))
    result = AsyncSimulationResult(
        name=name, updates_per_device=np.zeros(fleet.num_devices, np.int64))
    result.alpha_history = _history_buffer(record_history)
    max_events = 1000 + 50 * num_aggregations * cfg.buffer_size
    aggs = 0
    events_processed = 0
    t0 = time.time()
    with spans.use_virtual_clock(lambda: scheduler.now):
        while aggs < num_aggregations:
            if events_processed >= max_events:
                raise RuntimeError(f"exceeded {max_events} events before reaching "
                                   f"{num_aggregations} aggregations")
            events_processed += 1
            evt = scheduler.pop()
            if evt is None:
                raise RuntimeError("event queue exhausted before reaching "
                                   f"{num_aggregations} aggregations")
            disp_params, disp_version = in_flight.pop(evt.device_id)
            idle.append(evt.device_id)      # back of the queue either way
            if evt.kind == EventKind.DROPOUT:
                dispatch_next()             # lost work; slot goes to next waiter
                continue
            d = evt.device_id
            with spans.span("client_update", device=d,
                            staleness=version - disp_version):
                if batch_indices is None:
                    idx = draw_batch_indices(mask[d:d + 1], max_steps,
                                             cfg.batch_size, gen)
                else:
                    idx = batch_indices(evt.seq, d, max_steps).to(dev)
                    if tuple(idx.shape) != (1, max_steps, cfg.batch_size):
                        raise ValueError(
                            f"batch_indices returned {tuple(idx.shape)}, "
                            f"want {(1, max_steps, cfg.batch_size)}")
                deltas, grads = client_update(
                    loss_fn, disp_params, x[d:d + 1], y[d:d + 1],
                    mask[d:d + 1],
                    torch.tensor([evt.num_steps], device=dev), idx,
                    lr=cfg.lr, mu=cfg.mu)
            delta = tree_map(lambda t: t[0], deltas)
            grad = tree_map(lambda t: t[0], grads)
            if live_attack is not None and d in malicious:
                from ..robust.attacks import corrupt_one
                delta, grad = corrupt_one(
                    live_attack, delta, grad,
                    partial(attack_noise, evt.seq))
            buffer.add(BufferedUpdate(delta, grad, disp_version, d))
            result.updates_per_device[d] += 1
            if buffer.ready():
                with spans.span("aggregate", flush=aggs + 1):
                    params, info = buffer.flush(params, version)
                version += 1
                aggs += 1
                stale = float(np.mean(info["staleness"]))
                result.staleness_mean.append(stale)
                alpha = (_host(info["alpha"]) if "alpha" in info
                         and (collect_alpha or tr.active) else None)
                if collect_alpha and alpha is not None:
                    _history_push(result.alpha_history, alpha, record_history)
                event: Dict[str, Any] = {}
                if tr.active:
                    event = {"flush": aggs, "t_virtual": scheduler.now,
                             "version": version, "staleness_mean": stale,
                             "staleness_max": float(np.max(info["staleness"]))}
                    if alpha is not None:
                        event.update(_vec_stats("alpha", alpha))
                if aggs % eval_every == 0 or aggs == num_aggregations:
                    with spans.span("eval"):
                        loss = global_train_loss(loss_fn, params, x, y, mask)
                        nll, acc = evaluate_classifier(apply_fn, params,
                                                       test_x, test_y)
                    result.times.append(scheduler.now)
                    result.versions.append(version)
                    result.train_loss.append(loss)
                    result.test_acc.append(acc)
                    result.test_nll.append(nll)
                    if tr.active:
                        event.update(train_loss=loss, test_acc=acc, test_nll=nll)
                if tr.active:
                    tr.log(event, step=aggs)
            dispatch_next()                 # fresh task on the freshest model
    result.wall_time = time.time() - t0
    result.dispatched = scheduler.stats.dispatched
    result.arrived = scheduler.stats.arrived
    result.dropped = scheduler.stats.dropped
    if tr.active:
        tr.log_summary({"dispatched": result.dispatched,
                        "arrived": result.arrived,
                        "dropped": result.dropped,
                        "t_virtual_end": scheduler.now,
                        "wall_time_s": result.wall_time})
    return result


@dataclass
class HierSimulationResult:
    """Metrics of a hierarchical run, indexed by virtual wall-clock."""
    name: str
    times: List[float] = field(default_factory=list)       # round-end seconds
    train_loss: List[float] = field(default_factory=list)
    test_acc: List[float] = field(default_factory=list)
    test_nll: List[float] = field(default_factory=list)
    gamma_history: List[np.ndarray] = field(default_factory=list)
    comm: Dict[str, Dict[str, float]] = field(default_factory=dict)
    cloud_uplink_bytes: float = 0.0
    total_bytes: float = 0.0
    dispatched: int = 0         # device tasks only (backhaul transfers are
    arrived: int = 0            # scheduler events but not counted here)
    dropped: int = 0
    rounds_skipped: int = 0     # rounds where every participant dropped out
    wall_time: float = 0.0
    # engine_name, round-matrix bytes, and the real wall-clock split:
    # first round, median of the rest, all rounds
    engine: Dict[str, Any] = field(default_factory=dict)

    def time_to_accuracy(self, level: float) -> Optional[float]:
        return self.to_curve().time_to_accuracy(level)

    def to_curve(self):
        from ..edge.wallclock import WallclockCurve
        return WallclockCurve(name=self.name, times=list(self.times),
                              test_acc=list(self.test_acc),
                              train_loss=list(self.train_loss))


def _host(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def run_hier_simulation(name: str, loss_fn: Callable, apply_fn: Callable,
                        init_params: Tree, dataset: FederatedDataset,
                        cfg, topology, num_rounds: int,
                        selection_seed: int = 1234, eval_every: int = 1,
                        collect_gamma: bool = False,
                        engine: str = "auto",
                        stream_chunk: Optional[int] = None, mesh=None,
                        record_history: RecordHistory = True,
                        attack=None, churn=None,
                        scheduler_mode: str = "auto",
                        rng_stream: str = "v1",
                        eval_device_cap: int = 4096,
                        cohort_chunk: Optional[int] = None,
                        publish_fn: Optional[Callable[[int, Tree], None]]
                        = None,
                        batch_generator: Optional[torch.Generator] = None,
                        batch_indices: Optional[Callable] = None,
                        attack_noise: Optional[Callable] = None,
                        device: DeviceLike = "cuda") -> HierSimulationResult:
    """Synchronous rounds over a multi-tier topology (``cfg`` a
    :class:`repro_torch.hier.HierConfig`, ``topology`` a
    :class:`repro_torch.hier.Topology`), as
    ``repro.fl.simulation.run_hier_simulation``.

    Per round the model broadcast flows down the backhaul links, every
    gateway's (fan-in-sampled) devices train at profile speed, each
    aggregation node completes when its last member's terminal event pops
    (dropouts still gate it), and its summary rides the uplink as a
    scheduled event; the round ends when the cloud's last child reports.
    With ``cfg.compress`` set, summary uplinks carry error-feedback
    compressed payloads (``repro_torch.compress``) and the cloud's γ stage
    solves on sketched cross-terms.  The host randomness (selection, epoch
    draws, the scheduler) is numpy and bit-identical to the reference, so
    times, bytes and counts match it exactly; mini-batch draws come from a
    ``torch.Generator`` on ``device`` seeded with ``selection_seed``.

    ``engine`` picks the round engine: ``"fused"`` (dense (P, n) round
    matrices, fastest at small width), ``"streamed"`` (per-leaf passes
    through the ``stream_stats`` and ``combine`` kernels, no (P, n) matrix
    — big models), or ``"auto"``: streamed when the dense footprint
    2·P·n·4 bytes would exceed ``REPRO_DENSE_ROUND_BYTES`` (default 1 GiB).
    Device-uplink compression needs the dense matrices: ``"auto"`` then
    picks the fused engine and ``"streamed"`` raises.  ``stream_chunk`` is
    the streamed engine's column chunk (its reported memory model).

    ``attack`` (a :class:`repro_torch.robust.AttackModel`) corrupts the
    cohort's stacked rows of malicious devices after local training
    (label-flip attacks poison the malicious shards up front instead); its
    noise comes from a generator seeded from ``selection_seed + 7919`` and
    the round, or from ``attack_noise(round, deltas, grads)``.  ``churn``
    (a :class:`repro_torch.robust.ChurnSchedule`) rides on the event
    scheduler, and ``cfg.robust`` hardens the tier solves of either engine.

    Fleet scale.  ``topology`` may be a
    :class:`repro_torch.hier.StackedTopology` (no per-device nodes) and
    ``dataset`` a :class:`repro_torch.data.VirtualFleetDataset`: the
    round's shards are generated on ``device`` from the participants' ids
    (``fl.client.cohort_update``), at most ``cohort_chunk`` of them at a
    time, and the loss is evaluated over ``eval_device_ids(N,
    eval_device_cap)`` (every device when the fleet fits the cap).
    ``scheduler_mode``: ``"event"`` — one event per device task;
    ``"cohort"`` — one vectorized batch dispatch with no per-device events,
    each gateway completing at its members' latest terminal time, gateways
    taken in completion order and only the backhaul transfers drained as
    events (virtual times equal the event path's on two-tier trees;
    incompatible with ``CompressConfig(device_uplink=True)``); ``"auto"``
    — cohort from 4096 participants a round, else event.  ``rng_stream``
    picks the scheduler's draws (``"v1"`` sequential, ``"v2"``
    counter-based).  ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) with
    a ``'fleet'`` axis splits the cohort's local training over its ranks
    (``sharding.shard_cohort_fn``: params replicated, each rank its block of
    rows, the results all-gathered); a mesh of ranks of any axes splits the
    streamed engine's passes over its ranks' column windows
    (``sharding.stream_windows``), and every rank ends each round with the
    same parameters.  A mesh without a process group (one rank, or
    emulated) runs the round whole on this rank.

    ``publish_fn(round, params)`` is called with each round's aggregated
    params the moment the cloud stage applies them; skipped rounds publish
    nothing.

    ``batch_generator``, if given, draws the mini-batch indices instead (on
    its own device; they then move to ``device``), so that runs on two
    devices can train on the same batches.  ``batch_indices(round,
    part_dev, max_steps)``, if given, returns them outright as a
    ``(P, max_steps, batch_size)`` tensor for the round's participants
    ``part_dev`` (the tests replay the reference's draws that way).  Both
    are drawn once for the whole cohort, before any chunking.
    """
    from ..compress import ErrorFeedback, payload_gram
    from ..edge.events import EventKind, EventScheduler
    from ..edge.wallclock import model_flops_per_step, model_payload_bytes
    from ..hier.comm import (CommLedger, compressed_summary_bytes,
                             summary_bytes, update_bytes)
    from ..hier.fused import HierRoundEngine
    from ..hier.gateway import CompressedSummary, GatewaySummary
    from ..hier.hier_server import blockdiag_diagnostics
    from ..hier.streamed import StreamedRoundEngine, dense_round_bytes
    from .client import client_update, cohort_update, draw_batch_indices

    if mesh is not None:
        from ..launch.mesh import Mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh must be a repro_torch.launch.mesh.Mesh (make_mesh, "
                f"sharding.fleet_mesh), got {type(mesh).__name__}")
    dev = resolve_device(device)
    fleet = topology.fleet
    virtual = bool(getattr(dataset, "virtual", False))
    if dataset.num_devices < fleet.num_devices:
        raise ValueError(f"dataset has {dataset.num_devices} device shards, "
                         f"topology needs {fleet.num_devices}")

    # -- adversarial wiring: label_flip poisons shards up front; update-space
    # attacks corrupt the cohort's stacked rows after local training, with
    # noise from a generator of the adversary's own
    malicious = np.asarray(sorted(getattr(fleet, "malicious", ())), np.int64)
    if attack is not None and attack.corrupts_data and malicious.size:
        if virtual:
            raise ValueError(
                "data-poisoning attacks need materialized shards; a "
                "VirtualFleetDataset generates data inside the cohort pass "
                "(materialize() a subset, or use an update-space attack)")
        from ..robust.attacks import poison_labels
        dataset = poison_labels(dataset, malicious)
    live_attack = (attack if attack is not None
                   and not attack.corrupts_data and malicious.size else None)
    if live_attack is not None and attack_noise is None:
        attack_noise = _adversary_noise(dev, selection_seed + 7919)

    steps_per_epoch = max(dataset.samples_per_device // cfg.batch_size, 1)
    max_steps = cfg.max_epochs * steps_per_epoch
    params = tree_map(lambda a: torch.as_tensor(a, device=dev), init_params)
    if virtual:
        # the loss over a capped, evenly-strided subsample generated on the
        # card: exact whenever the fleet fits the cap
        from ..data.fleetgen import eval_device_ids
        shard = dataset.shard_fn(dev)
        x, y, mask = dataset.materialize_arrays(
            eval_device_ids(fleet.num_devices, eval_device_cap), dev)
        test_x, test_y = dataset.test_set(dev)
        ones = torch.ones((1, dataset.samples_per_device), device=dev)
    else:
        x, y, mask = dataset.x, dataset.y, dataset.mask
        test_x, test_y = dataset.test_x, dataset.test_y
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, dtype=torch.long, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    test_x = torch.as_tensor(test_x, device=dev)
    test_y = torch.as_tensor(test_y, dtype=torch.long, device=dev)
    gen = batch_generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(selection_seed)

    # the cohort's local training; a mesh with a 'fleet' axis splits it
    # over the ranks (params replicated, each rank its block of rows, the
    # results all-gathered)
    def virtual_update(params, ids, steps, bidx):
        return cohort_update(loss_fn, params, shard, ids, steps, bidx,
                             lr=cfg.lr, mu=cfg.mu, chunk=cohort_chunk)

    def batched_update(params, xs, ys, ms, steps, bidx):
        return client_update(loss_fn, params, xs, ys, ms, steps, bidx,
                             lr=cfg.lr, mu=cfg.mu)

    if mesh is not None and "fleet" in mesh.shape:
        from ..sharding.specs import shard_cohort_fn
        virtual_update = shard_cohort_fn(mesh, virtual_update, 3)
        batched_update = shard_cohort_fn(mesh, batched_update, 5)

    n_model = tree_size(params)
    mbytes = model_payload_bytes(params)
    scheduler = EventScheduler(
        fleet, seed=selection_seed,
        flops_per_step=model_flops_per_step(params, cfg.batch_size),
        payload_bytes=mbytes, churn=churn, rng_stream=rng_stream)
    tr = current_tracker().scope(f"hier/{name}")
    if tr.active:
        tr.jot(runtime="hier", run=name, aggregator=cfg.aggregator,
               depth=topology.depth, num_rounds=num_rounds, device=str(dev))
    ledger = CommLedger(topology.depth, tracker=tr.scope("comm"),
                        clock=lambda: scheduler.now)
    sel_rng = np.random.RandomState(selection_seed)

    gateways = topology.gateways            # tier-1 nodes (the cloud, if star)
    solve_cfg = cfg.solve_config()
    relay = cfg.aggregator == "hier_relay"
    tier_mode = cfg.tier_mode
    cloud_kind = "fedavg" if cfg.aggregator == "hier_fedavg" else "combo"

    # -- engine and scheduler selection (P per round is fixed by the
    # topology and fan_in)
    P_round = sum(min(cfg.fan_in, len(gw.children)) if cfg.fan_in is not None
                  else len(gw.children) for gw in gateways)
    dense_bytes = dense_round_bytes(P_round, n_model)
    if engine not in ("auto", "fused", "streamed"):
        raise ValueError(f"unknown engine '{engine}' (auto|fused|streamed)")
    device_decodes = cfg.compressing and cfg.compress.device_uplink
    if engine == "streamed" and device_decodes:
        raise ValueError("engine='streamed' is incompatible with "
                         "CompressConfig(device_uplink=True): decoded "
                         "device rows need the dense round matrices "
                         "(use engine='fused' or 'auto')")
    if engine == "auto":
        budget = float(os.environ.get("REPRO_DENSE_ROUND_BYTES", 1 << 30))
        engine = ("fused" if device_decodes or dense_bytes <= budget
                  else "streamed")
    if scheduler_mode not in ("auto", "event", "cohort"):
        raise ValueError(f"unknown scheduler_mode '{scheduler_mode}' "
                         "(auto|event|cohort)")
    cohort_mode = (scheduler_mode == "cohort"
                   or (scheduler_mode == "auto" and P_round >= 4096))
    if cohort_mode and device_decodes:
        if scheduler_mode == "cohort":
            raise ValueError("scheduler_mode='cohort' is incompatible with "
                             "CompressConfig(device_uplink=True): per-arrival "
                             "error feedback needs per-device events")
        cohort_mode = False
    if engine == "streamed":
        eng = StreamedRoundEngine(params, solve_cfg, tier_mode,
                                  cfg.gram_scope, chunk=stream_chunk,
                                  donate_params=True, robust=cfg.robust,
                                  mesh=mesh)
        # the streamed apply updates the parameters in place (the reference
        # donates them): copy once so that no round writes into the
        # caller's init_params
        params = tree_map(torch.clone, params)
    else:
        eng = HierRoundEngine(params, solve_cfg, tier_mode, cfg.gram_scope,
                              robust=cfg.robust)

    # summary compression: per-sender error-feedback residuals persist
    # across rounds; linear sketches share one per-round seed so the cloud's
    # Gram stage runs in sketch space (payload_gram)
    compressing = cfg.compressing
    if compressing:
        comp_u_c, comp_g_c = cfg.compress.build_pair(n_model)
        ef = ErrorFeedback(enabled=cfg.compress.error_feedback)
        compress_devices = cfg.compress.device_uplink

    def broadcast_path(gw):
        path, node = [], gw
        while node.parent is not None:
            path.append(node)
            node = topology.nodes[node.parent]
        return list(reversed(path))         # cloud-side hop first

    result = HierSimulationResult(name=name)
    result.gamma_history = _history_buffer(record_history)
    round_walls: List[float] = []
    t0 = time.time()
    with spans.use_virtual_clock(lambda: scheduler.now):
        for t in range(num_rounds):
            with spans.span("round", round=t):
                round_t0 = time.perf_counter()
                round_start = scheduler.now
                # -- selection (one shared RNG): per-gateway contiguous
                # blocks of participant rows
                groups: List[np.ndarray] = []
                for gw in gateways:
                    devs = np.asarray(gw.children, np.int64)
                    if cfg.fan_in is not None and cfg.fan_in < len(devs):
                        devs = np.sort(sel_rng.choice(devs, cfg.fan_in,
                                                      replace=False))
                    groups.append(devs)
                gw_sizes = np.asarray([len(g) for g in groups], np.int64)
                gw_start = np.zeros(len(groups), np.int64)
                np.cumsum(gw_sizes[:-1], out=gw_start[1:])
                part_dev = np.concatenate(groups)
                P = int(part_dev.size)
                epochs = sel_rng.randint(cfg.min_epochs, cfg.max_epochs + 1,
                                         size=P)
                num_steps = (epochs * steps_per_epoch).astype(np.int32)

                # -- downlink broadcast, then one batched dispatch at each
                # gateway's model arrival (no per-device events in cohort
                # mode)
                down_delay = np.zeros(len(gateways))
                for gi, gw in enumerate(gateways):
                    delay = 0.0
                    for hop in broadcast_path(gw):
                        dl = hop.uplink.downlink_time(mbytes)
                        ledger.record_down(hop.tier, mbytes, dl)
                        delay += dl
                    down_delay[gi] = delay
                ledger.record_down(0, mbytes, count=P)
                batch = scheduler.dispatch_batch(
                    part_dev, num_steps, version=t,
                    at=round_start + np.repeat(down_delay, gw_sizes),
                    enqueue=not cohort_mode)

                # -- local training of the whole cohort (batched over P; a
                # virtual cohort's shards are generated here, by chunks)
                with spans.span("client_update", participants=P):
                    sel = torch.as_tensor(part_dev, device=dev)
                    cm = ones.expand(P, -1) if virtual else mask[sel]
                    if batch_indices is None:
                        batch_idx = draw_batch_indices(
                            cm.to(gen.device), max_steps, cfg.batch_size,
                            gen).to(dev)
                    else:
                        batch_idx = batch_indices(t, part_dev,
                                                  max_steps).to(dev)
                        if tuple(batch_idx.shape) != (P, max_steps,
                                                      cfg.batch_size):
                            raise ValueError(
                                f"batch_indices returned "
                                f"{tuple(batch_idx.shape)}, want "
                                f"{(P, max_steps, cfg.batch_size)}")
                    steps_t = torch.as_tensor(num_steps, dtype=torch.long,
                                              device=dev)
                    if virtual:
                        deltas, grads = virtual_update(params, sel, steps_t,
                                                       batch_idx)
                    else:
                        deltas, grads = batched_update(params, x[sel],
                                                       y[sel], cm, steps_t,
                                                       batch_idx)
                mal_rows = np.isin(part_dev, malicious)
                if live_attack is not None and mal_rows.any():
                    from ..robust.attacks import corrupt_stacked
                    deltas, grads = corrupt_stacked(
                        live_attack, deltas, grads,
                        torch.as_tensor(mal_rows, device=dev),
                        partial(attack_noise, t))
                with spans.span("begin_round", engine=eng.name):
                    ctx = eng.begin_round(deltas, grads)

                # -- event loop: device terminals, then multi-hop transfers.
                # Contextual tiers with gateway_grad="global" run a gradient
                # pre-pass: each gateway ships its ĝ_g up first, the cloud
                # broadcasts the global ĝ back down, and only then do the
                # gateways solve and ship (ū_g, G_g, c_g).
                use_prepass = (topology.depth >= 2 and not relay
                               and tier_mode == "contextual"
                               and cfg.gateway_grad == "global")
                interior = [n for tier in range(2, topology.depth + 1)
                            for n in topology.tier_nodes(tier)]
                out_grad = {n.node_id: len(n.children) for n in interior}
                out_sum = {n.node_id: len(n.children) for n in interior}
                recv_grad: Dict[int, list] = {n.node_id: [] for n in interior}
                recv_sum: Dict[int, list] = {n.node_id: [] for n in interior}
                node_ghat: Dict[int, Any] = {}
                gw_idxs: Dict[int, np.ndarray] = {}
                meta: Dict[int, tuple] = {}     # event seq -> (kind, node, payload)
                ghat_global = None
                cloud_done = False
                round_info: Dict[str, Any] = {}
                if not cohort_mode:
                    # device id -> cohort row / gateway index
                    idx_of = np.full(fleet.num_devices, -1, np.int64)
                    idx_of[part_dev] = np.arange(P)
                    part_gw = np.repeat(np.arange(len(gateways)), gw_sizes)
                    out_dev = {gw.node_id: int(gw_sizes[gi])
                               for gi, gw in enumerate(gateways)}
                    survivors: Dict[int, List[int]] = {
                        gw.node_id: [] for gw in gateways}

                def send_up(kind, node, payload, nbytes):
                    parent = topology.nodes[node.parent]
                    dt = node.uplink.uplink_time(nbytes)
                    ledger.record_up(parent.tier, nbytes, dt)
                    evt = scheduler.schedule(dt, node.node_id, version=t)
                    meta[evt.seq] = (kind, node.node_id, payload)

                def send_ghat_down(child_id, ghat):
                    child = topology.nodes[child_id]
                    nbytes = update_bytes(n_model)
                    dt = child.uplink.downlink_time(nbytes)
                    ledger.record_down(child.tier, nbytes, dt)
                    evt = scheduler.schedule(dt, child_id, version=t)
                    meta[evt.seq] = ("ghat", child_id, ghat)

                def gone_up(nid, out_map, complete_fn):
                    """Subtree has nothing to report: release the parent's
                    count."""
                    pid = topology.nodes[nid].parent
                    out_map[pid] -= 1
                    if out_map[pid] == 0:
                        complete_fn(pid)

                def gateway_done(gid, idxs):
                    node = topology.nodes[gid]
                    idxs = np.sort(np.asarray(idxs, np.int64))  # stable order
                    gw_idxs[gid] = idxs
                    if node.parent is None:      # star: the cloud is the gateway
                        finish_cloud(idxs.tolist() if idxs.size else None)
                        return
                    if not idxs.size:
                        if use_prepass:
                            gone_up(gid, out_grad, on_grad_complete)
                        gone_up(gid, out_sum, on_sum_complete)
                        return
                    if relay:
                        send_up("summary", node, idxs.tolist(),
                                len(idxs) * update_bytes(n_model))
                    elif use_prepass:
                        send_up("grad", node, (ctx.mean_grad(idxs), len(idxs)),
                                update_bytes(n_model))
                    else:   # solve against the cohort's own ĝ_g, which
                            # rides up inside the summary
                        s = _gateway_summary(gid, idxs, None)
                        if compressing:
                            send_up("summary", node, *_compress_summary(s, gid))
                        else:
                            send_up("summary", node, s,
                                    summary_bytes(len(idxs), n_model,
                                                  include_grad=True))

                def _gateway_summary(gid, idxs, solve_grad):
                    # §III-C at the gateway tier: a fan-in-sampled cohort
                    # prices the pool it was drawn from
                    pool = len(topology.nodes[gid].children)
                    pool_scale = ((pool - 1) / max(len(idxs) - 1, 1)
                                  if cfg.fan_in is not None
                                  and cfg.fan_in < pool
                                  and tier_mode == "contextual" else 1.0)
                    with spans.span("gateway", node=gid, members=len(idxs)):
                        out = ctx.gateway(idxs, solve_grad=solve_grad,
                                          pool_scale=pool_scale)
                    return GatewaySummary(
                        node_id=gid, num_updates=len(idxs),
                        member_ids=part_dev[np.asarray(idxs, np.int64)],
                        G=out["G"], c=out["c"], alpha=out["alpha"],
                        u_bar=out["u_bar"], grad_est=out["ghat"],
                        info=out["info"])

                def _merge_summaries(nid, kids, solve_grad):
                    """Parent-tier merge over what arrived: the children's ū
                    become this node's members (Σγ = 1)."""
                    counts = np.asarray([s.num_updates for s in kids],
                                        np.float32)
                    with spans.span("merge", node=nid, children=len(kids)):
                        out = ctx.merge([s.u_bar for s in kids],
                                        [s.grad_est for s in kids], counts,
                                        solve_grad=solve_grad)
                    return GatewaySummary(
                        node_id=nid, num_updates=int(counts.sum()),
                        member_ids=np.asarray([s.node_id for s in kids],
                                              np.int64),
                        G=out["G"], c=out["c"], alpha=out["alpha"],
                        u_bar=out["u_bar"], grad_est=out["ghat"],
                        info=out["info"])

                def _compress_summary(s, nid):
                    """EF-compress one summary's (ū, ĝ) for its uplink hop;
                    returns (payload, wire bytes).  One per-round sketch seed
                    for every node and both vectors; residuals per (vector,
                    node)."""
                    comp_u, u_hat = ef.step(("u", nid), ctx.materialize(s.u_bar),
                                            comp_u_c, seed=t)
                    comp_g, g_hat = ef.step(("g", nid),
                                            ctx.materialize(s.grad_est),
                                            comp_g_c, seed=t)
                    decoded = dc_replace(s, u_bar=u_hat, grad_est=g_hat)
                    nbytes = compressed_summary_bytes(comp_u.nbytes
                                                      + comp_g.nbytes)
                    return CompressedSummary(decoded, comp_u, comp_g), nbytes

                def on_grad_complete(nid):
                    nonlocal ghat_global
                    node = topology.nodes[nid]
                    entries = recv_grad[nid]     # [(sender, ĝ ref, count)]
                    if not entries:
                        if node.parent is not None:
                            gone_up(nid, out_grad, on_grad_complete)
                        return
                    counts = np.asarray([c for _, _, c in entries], np.float64)
                    ghat = ctx.compose_grads([g for _, g, _ in entries], counts)
                    if node.parent is None:      # cloud: broadcast the global ĝ
                        ghat_global = ghat
                        for sender, _, _ in entries:
                            send_ghat_down(sender, ghat)
                    else:
                        send_up("grad", node, (ghat, int(counts.sum())),
                                update_bytes(n_model))

                def on_ghat(nid, ghat):
                    node = topology.nodes[nid]
                    node_ghat[nid] = ghat
                    if node.tier == 1:           # gateway: solve and ship
                        idxs = gw_idxs[nid]
                        send_up("summary", node,
                                _gateway_summary(nid, idxs, ghat),
                                summary_bytes(len(idxs), n_model))
                    else:                        # regional: fan the broadcast out
                        for sender, _, _ in recv_grad[nid]:
                            send_ghat_down(sender, ghat)

                def on_sum_complete(nid):
                    node = topology.nodes[nid]
                    kids = recv_sum[nid]
                    if node.parent is None:
                        if not kids:
                            finish_cloud(None)
                        else:
                            finish_cloud(sum(kids, []) if relay else kids)
                        return
                    if not kids:
                        gone_up(nid, out_sum, on_sum_complete)
                        return
                    if relay:
                        fwd = sum(kids, [])
                        send_up("summary", node, fwd,
                                len(fwd) * update_bytes(n_model))
                    elif compressing:
                        # merge over the decodes, then re-compress with this
                        # node's own error-feedback state
                        s = _merge_summaries(nid, [p.summary for p in kids],
                                             node_ghat.get(nid))
                        send_up("summary", node, *_compress_summary(s, nid))
                    else:
                        s = _merge_summaries(nid, kids, node_ghat.get(nid))
                        send_up("summary", node, s,
                                summary_bytes(len(kids), n_model,
                                              include_grad=not use_prepass))

                def finish_cloud(payload):
                    nonlocal cloud_done, round_info, params
                    if payload is None:          # every participant dropped out
                        result.rounds_skipped += 1
                    else:
                        with spans.span("cloud"):
                            delta, round_info = _cloud_stage(payload)
                            params = ctx.apply(params, delta)
                        if publish_fn is not None:
                            publish_fn(t, params)
                    cloud_done = True

                def _cloud_stage(payload):
                    if isinstance(payload, list) and isinstance(
                            payload[0], (int, np.integer)):
                        # raw updates (star / relay); a star cloud is the
                        # fleet's one gateway, so fan-in sampling prices its
                        # pool here too
                        pool = len(topology.nodes[topology.cloud_id].children)
                        scale = ((pool - 1) / max(len(payload) - 1, 1)
                                 if cfg.fan_in is not None and cfg.fan_in < pool
                                 and not relay and tier_mode == "contextual"
                                 else 1.0)
                        kind = ("fedavg" if cfg.aggregator == "hier_fedavg"
                                else "raw")
                        return ctx.cloud_raw(payload, kind, solve_scale=scale)
                    if compressing:              # compressed child summaries
                        csums = payload
                        summaries = [p.summary for p in csums]
                        counts = [s.num_updates for s in summaries]
                        # the P×P stage runs on the sketched cross-terms; the
                        # combine applies the decodes
                        G2c2 = payload_gram(comp_u_c,
                                            [p.comp_u for p in csums],
                                            [p.comp_g for p in csums],
                                            np.asarray(counts, np.float64))
                        ghat = ctx.compose_grads([s.grad_est for s in summaries],
                                                 counts)
                        return ctx.cloud_combo([s.u_bar for s in summaries],
                                               counts, ghat, kind="combo",
                                               override=G2c2)
                    summaries = payload          # top-tier child summaries
                    counts = [s.num_updates for s in summaries]
                    ghat = (ghat_global if ghat_global is not None else
                            ctx.compose_grads([s.grad_est for s in summaries],
                                              counts))
                    delta, info = ctx.cloud_combo([s.u_bar for s in summaries],
                                                  counts, ghat, kind=cloud_kind)
                    info = dict(info)
                    info.update(blockdiag_diagnostics(summaries, info["gamma"],
                                                      cfg.smoothness))
                    return delta, info

                def on_transfer(kind, sender, payload):
                    if kind == "grad":
                        pid = topology.nodes[sender].parent
                        recv_grad[pid].append((sender,) + payload)
                        out_grad[pid] -= 1
                        if out_grad[pid] == 0:
                            on_grad_complete(pid)
                    elif kind == "ghat":
                        on_ghat(sender, payload)
                    else:                        # summary
                        pid = topology.nodes[sender].parent
                        recv_sum[pid].append(payload)
                        out_sum[pid] -= 1
                        if out_sum[pid] == 0:
                            on_sum_complete(pid)

                if cohort_mode:
                    # -- cohort device phase, no per-device events: each
                    # gateway completes at its members' latest terminal time
                    # (dropouts still gate it); gateways are settled in
                    # completion order, then the backhaul transfers drain
                    # as events (the clock may rewind to transfers that
                    # earlier gateways scheduled)
                    max_events = 8 * len(topology.nodes) + 64
                    with spans.span("event_loop"):
                        t_complete = np.maximum.reduceat(batch.t_end, gw_start)
                        for gi in np.argsort(t_complete, kind="stable"):
                            scheduler.advance_to(float(t_complete[gi]))
                            s0 = int(gw_start[gi])
                            e0 = s0 + int(gw_sizes[gi])
                            alive = s0 + np.flatnonzero(~batch.dropped[s0:e0])
                            result.arrived += int(alive.size)
                            result.dropped += e0 - s0 - int(alive.size)
                            gid = gateways[int(gi)].node_id
                            ledger.record_up(topology.nodes[gid].tier,
                                             update_bytes(n_model),
                                             count=int(alive.size))
                            gateway_done(gid, alive)
                        scheduler.complete_batch(batch)
                        for _ in range(max_events):
                            if cloud_done:
                                break
                            evt = scheduler.pop()
                            if evt is None or evt.seq not in meta:
                                raise RuntimeError(
                                    f"round {t}: non-transfer event in the "
                                    "cohort drain")
                            on_transfer(*meta.pop(evt.seq))
                else:
                    max_events = 8 * (P + len(topology.nodes)) + 64
                    with spans.span("event_loop"):
                        for _ in range(max_events):
                            if cloud_done:
                                break
                            evt = scheduler.pop()
                            if evt is None:
                                raise RuntimeError(f"round {t}: event queue "
                                                   "exhausted before the "
                                                   "cloud completed")
                            if evt.seq in meta:  # backhaul transfer arrival
                                on_transfer(*meta.pop(evt.seq))
                                continue
                            pi = int(idx_of[evt.device_id])  # device terminal
                            gid = gateways[int(part_gw[pi])].node_id
                            if evt.kind == EventKind.ARRIVAL:
                                survivors[gid].append(pi)
                                result.arrived += 1
                                if compressing and compress_devices:
                                    # per-device error feedback on BOTH
                                    # streams (the solves consume the
                                    # gradient too)
                                    comp_d, vhat = ef.step(
                                        ("dev", evt.device_id), ctx.D[pi],
                                        comp_u_c, seed=t)
                                    comp_dg, ghat = ef.step(
                                        ("devg", evt.device_id), ctx.GM[pi],
                                        comp_g_c, seed=t)
                                    ctx.add_decoded_row(pi, vhat, ghat)
                                    ledger.record_up(
                                        topology.nodes[gid].tier,
                                        comp_d.nbytes + comp_dg.nbytes)
                                else:
                                    ledger.record_up(topology.nodes[gid].tier,
                                                     update_bytes(n_model))
                            else:
                                result.dropped += 1
                            out_dev[gid] -= 1
                            if out_dev[gid] == 0:
                                gateway_done(gid, survivors[gid])
                if not cloud_done:
                    raise RuntimeError(f"round {t}: exceeded {max_events} "
                                       "events")
                result.dispatched += P
                round_walls.append(time.perf_counter() - round_t0)

                gamma = (_host(round_info["gamma"]) if "gamma" in round_info
                         and (collect_gamma or tr.active) else None)
                if collect_gamma and gamma is not None:
                    _history_push(result.gamma_history, gamma, record_history)
                event: Dict[str, Any] = {}
                if tr.active:
                    event = {"round": t, "t_virtual": scheduler.now,
                             "round_virtual_s": scheduler.now - round_start,
                             "round_wall_s": round_walls[-1],
                             "participants": P,
                             "rounds_skipped": result.rounds_skipped}
                    if gamma is not None:
                        event.update(_vec_stats("gamma", gamma))
                if (t + 1) % eval_every == 0 or t == num_rounds - 1:
                    with spans.span("eval"):
                        loss = global_train_loss(loss_fn, params, x, y, mask)
                        nll, acc = evaluate_classifier(apply_fn, params,
                                                       test_x, test_y)
                    result.times.append(scheduler.now)
                    result.train_loss.append(loss)
                    result.test_acc.append(acc)
                    result.test_nll.append(nll)
                    if tr.active:
                        event.update(train_loss=loss, test_acc=acc,
                                     test_nll=nll)
                if tr.active:
                    tr.log(event, step=t)
    result.wall_time = time.time() - t0
    result.comm = ledger.report()
    result.cloud_uplink_bytes = ledger.cloud_uplink_bytes
    result.total_bytes = ledger.total_bytes()
    # compressed summary tiers are dense above the encode hop: the largest
    # summary-level fan-in bounds the (members, n) stacks the streamed
    # engine's fused fallback stages hold (0 when uncompressed or fused)
    dense_members = 0
    if compressing and eng.name == "streamed":
        dense_members = max((len(nd.children)
                             for tier in range(2, topology.depth + 1)
                             for nd in topology.tier_nodes(tier)), default=0)
    result.engine = {
        "engine_name": eng.name,
        "round_matrix_peak_bytes": eng.peak_round_bytes(
            P_round, dense_fallback_members=dense_members),
        "dense_round_matrix_bytes": dense_bytes,
        "dense_fallback_members": dense_members,
    }
    if round_walls:
        steady = round_walls[1:] if len(round_walls) > 1 else round_walls
        result.engine.update({
            "compile_wall_time_s": round_walls[0],
            "steady_wall_time_per_round_s": float(np.median(steady)),
            "rounds_wall_time_s": float(np.sum(round_walls)),
        })
    if tr.active:
        tr.log_summary({**result.engine,
                        "cloud_uplink_bytes": result.cloud_uplink_bytes,
                        "total_bytes": result.total_bytes,
                        "t_virtual_end": scheduler.now,
                        "wall_time_s": result.wall_time})
    return result
