"""Slot-based continuous-batching decode engine with hot-swapped models
(``repro.serve.engine``).

One persistent KV cache (``init_lm_cache(..., ring=False)``) holds
``num_slots`` resident requests; each batch row is an independent request at
its own depth, tracked by per-slot ``positions``/``stop_at`` device tensors
that feed ``flash_decode``'s length masking.  Token generation runs as a
loop of ``scan_chunk`` decode steps on device tensors: no step reads a value
back to the host.  The chunk's emissions and active masks are stacked into
one (2, T, B) tensor and copied to the host once per chunk.  The cache is
written in place (the reference donates it to the jitted chunk).

Requests are admitted and retired at chunk boundaries.  Prompts prefill in
fixed-size chunks (:func:`repro_torch.models.transformer.prefill_chunk`), one
chunk per engine step, so a long prompt never stalls resident decoders for
more than one chunk.  Rows of a slot at index ≥ its length may hold
retired-request or padded-prefill garbage; they are never attended because
``flash_decode`` masks ``kpos < length`` and decode writes row ``p``
exactly when the slot's position reaches ``p`` (write-before-read).
Inactive slots (``pos >= stop_at`` — retired, fresh, or mid-chunked-
prefill) write nothing, so a slot's stale device position can never clobber
rows a new request is being chunk-prefilled into while other slots decode.

Model hot-swap: the engine re-snapshots its :class:`~repro_torch.serve.bus.
ModelBus` at every step boundary.  A decode chunk runs entirely on one
published tree — a request may span versions, but a single forward pass
never sees a mixed tree.  Swap stall (publish→adopt wall latency) is
recorded as a ``serve/model_swap`` span; every completion carries the model
versions it was admitted and finished under.

Greedy decoding takes ``argmax`` (the first index on ties, as
``jnp.argmax``); sampling draws from a device ``torch.Generator`` seeded by
``seed`` (``jax.random.categorical``'s stream cannot be reproduced).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.flatten import tree_leaves
from ..device import DeviceLike, resolve_device
from ..models.config import ArchConfig
from ..models.transformer import (check_family, decode_slots, init_lm_cache,
                                  prefill_chunk)
from ..obs import spans
from .bus import ModelBus

Pytree = Any


@dataclass
class Request:
    """A generation request: prompt token ids plus a generation budget."""
    rid: int
    prompt: Sequence[int]
    max_new: int
    t_submit_wall: float = 0.0
    t_submit_virtual: Optional[float] = None


@dataclass
class Completion:
    """A finished request with its provenance across model versions."""
    rid: int
    prompt_len: int
    tokens: List[int]                 # all generated ids (len == max_new)
    admit_version: int
    final_version: int
    t_submit_wall: float
    t_admit_wall: float
    t_finish_wall: float
    t_submit_virtual: Optional[float] = None
    t_finish_virtual: Optional[float] = None


@dataclass
class _Prefill:
    """Progress of the one in-flight chunked prefill."""
    req: Request
    slot: int
    tokens: np.ndarray                # full prompt, int32
    offset: int = 0                   # tokens already written to the cache
    t_admit_wall: float = 0.0


@dataclass
class _SlotInfo:
    """Host-side record for one occupied slot."""
    req: Request
    prompt_len: int
    emitted: List[int] = field(default_factory=list)
    admit_version: int = 0
    t_admit_wall: float = 0.0
    remaining: int = 0                # decode emissions still owed


class DecodeEngine:
    """Continuous-batching decoder over a KV-cache family (dense / moe).

    ``step()`` advances the engine by one scheduling quantum: adopt the
    newest published model, feed at most one prefill chunk, run one
    ``scan_chunk``-step decode chunk, and retire finished requests.
    """

    def __init__(self, cfg: ArchConfig, bus: ModelBus, *, num_slots: int = 4,
                 max_seq: int = 256, scan_chunk: int = 8,
                 prefill_chunk_tokens: int = 32, greedy: bool = True,
                 seed: int = 0, window: Optional[int] = None,
                 prefill_chunks_per_step: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        if cfg.family not in ("dense", "moe"):
            raise ValueError("DecodeEngine needs a KV-cache family "
                             f"(dense/moe), got {cfg.family!r}")
        check_family(cfg)
        self.cfg = cfg
        self.bus = bus
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self.scan_chunk = int(scan_chunk)
        # a chunk wider than the cache cannot be written in one slice
        self.prefill_chunk_tokens = min(int(prefill_chunk_tokens),
                                        self.max_seq)
        self.greedy = bool(greedy)
        self.window = window if window is not None else cfg.sliding_window
        # admission burst: how many prefill chunks one step may feed (short
        # prompts admit in bursts after a retire wave; a long prompt still
        # gets at most one chunk per step so decoders never stall behind it)
        self.prefill_chunks_per_step = (int(prefill_chunks_per_step)
                                        if prefill_chunks_per_step is not None
                                        else self.num_slots)

        snap = bus.snapshot()
        self._check_params(snap.params, snap.version)
        self._params = snap.params
        self.model_version = snap.version

        self._cache = init_lm_cache(cfg, self.num_slots, self.max_seq,
                                    ring=False, device=self.device)
        zeros = lambda: torch.zeros((self.num_slots,),  # noqa: E731
                                    dtype=torch.int32, device=self.device)
        self._tokens, self._positions, self._stop_at = zeros(), zeros(), zeros()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        # host mirrors — slot scheduling never reads device tensors
        self._pos_host = np.zeros(self.num_slots, np.int64)
        self._stop_host = np.zeros(self.num_slots, np.int64)
        self._slots: Dict[int, _SlotInfo] = {}

        self.pending: List[Request] = []
        self._prefilling: Optional[_Prefill] = None
        self._next_rid = 0

        self.stats: Dict[str, float] = {
            "decode_chunks": 0, "decode_steps": 0, "tokens_emitted": 0,
            "prefill_chunks": 0, "prefill_tokens": 0, "swaps": 0,
            "swap_stall_s_total": 0.0, "swap_stall_s_max": 0.0,
            "occupancy_steps": 0.0,   # sum over decode steps of occupied/B
        }

    def _check_params(self, params: Pytree, version: int) -> None:
        """A published tree must already live on the engine's device: the
        engine never moves one (29.5 GB at full qwen3-14b width)."""
        for leaf in tree_leaves(params):
            if isinstance(leaf, torch.Tensor) and leaf.device != self.device:
                raise ValueError(
                    f"published model v{version} has a leaf on {leaf.device}"
                    f"; the engine runs on {self.device} and does not move "
                    "parameters")

    # ------------------------------------------------------------- stepping

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Next ids (int32) from logits (..., V), on the device."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float(), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        ids = torch.multinomial(flat, 1, generator=self._gen)
        return ids.reshape(probs.shape[:-1]).to(torch.int32)

    def _decode_steps(self) -> torch.Tensor:
        """``scan_chunk`` decode steps; returns the (2, T, B) int32 tensor
        of emitted ids and active masks, still on the device."""
        cfg, params, window = self.cfg, self._params, self.window
        tok, pos, stop = self._tokens, self._positions, self._stop_at
        toks, actives = [], []
        for _ in range(self.scan_chunk):
            active = pos < stop
            logits, self._cache = decode_slots(cfg, params, tok, self._cache,
                                               pos, window=window,
                                               active=active)
            tok = torch.where(active, self._sample(logits), tok)
            pos = pos + active.to(torch.int32)
            toks.append(tok)
            actives.append(active.to(torch.int32))
        self._tokens, self._positions = tok, pos
        return torch.stack([torch.stack(toks), torch.stack(actives)])

    # ------------------------------------------------------------ admission

    def submit(self, prompt: Sequence[int], max_new: int,
               rid: Optional[int] = None) -> int:
        """Queue a request; returns its rid.  Prompt + generation must fit
        the slot's row space (``prompt_len + max_new <= max_seq``)."""
        plen = len(prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if plen + max_new > self.max_seq:
            raise ValueError(f"prompt_len({plen}) + max_new({max_new}) "
                             f"exceeds max_seq({self.max_seq})")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        self.pending.append(Request(
            rid=rid, prompt=list(prompt), max_new=int(max_new),
            t_submit_wall=time.perf_counter(),
            t_submit_virtual=spans.virtual_now()))
        return rid

    def _free_slots(self) -> List[int]:
        busy = set(self._slots)
        if self._prefilling is not None:
            busy.add(self._prefilling.slot)
        return [s for s in range(self.num_slots) if s not in busy]

    def _maybe_adopt_model(self) -> None:
        snap = self.bus.snapshot()
        if snap.version == self.model_version:
            return
        self._check_params(snap.params, snap.version)
        stall = time.perf_counter() - snap.t_publish_wall
        self._params = snap.params
        self.model_version = snap.version
        self.stats["swaps"] += 1
        self.stats["swap_stall_s_total"] += stall
        self.stats["swap_stall_s_max"] = max(self.stats["swap_stall_s_max"],
                                             stall)
        spans.record_span("serve/model_swap",
                          t0_virtual=spans.virtual_now() or 0.0,
                          dur_virtual_s=0.0, version=snap.version,
                          stall_s=stall)

    def _start_prefill_if_ready(self) -> None:
        if self._prefilling is not None or not self.pending:
            return
        free = self._free_slots()
        if not free:
            return
        req = self.pending.pop(0)
        self._prefilling = _Prefill(
            req=req, slot=free[0],
            tokens=np.asarray(req.prompt, np.int32),
            t_admit_wall=time.perf_counter())

    def _prefill_one_chunk(self) -> Optional[Completion]:
        """Feed one chunk of the in-flight prompt; on the last chunk sample
        the first generated token and activate the slot.  Returns the
        completion when the request's whole budget was the prefill token
        (``max_new == 1``)."""
        pf = self._prefilling
        if pf is None:
            return None
        C = self.prefill_chunk_tokens
        plen = len(pf.tokens)
        start, end = pf.offset, min(pf.offset + C, plen)
        # the last chunk is zero-padded to the static width; the padded
        # rows' garbage K/V sit above the slot's length and decode
        # overwrites row p before any step can attend it (write-before-read)
        padded = np.zeros(C, np.int32)
        padded[:end - start] = pf.tokens[start:end]
        last = end >= plen
        with spans.span("serve/prefill", slot=pf.slot, rid=pf.req.rid,
                        start=start, tokens=int(end - start), last=last):
            logits, self._cache = prefill_chunk(
                self.cfg, self._params,
                torch.from_numpy(padded).to(self.device), self._cache,
                pf.slot, start, window=self.window)
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += end - start
        pf.offset = end
        if not last:
            return None
        # sample the first generated token from the prompt's final row
        tok0 = int(self._sample(logits[plen - 1 - start]))
        slot, req = pf.slot, pf.req
        stop = plen + req.max_new - 1   # decode owes max_new - 1 emissions
        self._tokens[slot] = tok0
        self._positions[slot] = plen
        self._stop_at[slot] = stop
        self._pos_host[slot] = plen
        self._stop_host[slot] = stop
        self._slots[slot] = _SlotInfo(
            req=req, prompt_len=plen, emitted=[tok0],
            admit_version=self.model_version,
            t_admit_wall=pf.t_admit_wall, remaining=req.max_new - 1)
        self._prefilling = None
        return self._retire_if_done(slot)   # max_new==1 finishes here

    # -------------------------------------------------------------- decode

    def _decode_chunk(self) -> List[Completion]:
        occupied = [s for s, info in self._slots.items() if info.remaining]
        if not occupied:
            return []
        with spans.span("serve/decode_chunk", steps=self.scan_chunk,
                        occupied=len(occupied), version=self.model_version):
            # the chunk's one device -> host copy: (2, T, B) ids + active mask
            emitted = self._decode_steps().cpu().numpy()
            toks, actives = emitted[0], emitted[1].astype(bool)
        self.stats["decode_chunks"] += 1
        self.stats["decode_steps"] += self.scan_chunk
        self.stats["occupancy_steps"] += (
            self.scan_chunk * len(occupied) / self.num_slots)

        done: List[Completion] = []
        for slot in occupied:
            mask = actives[:, slot]
            info = self._slots[slot]
            info.emitted.extend(int(t) for t in toks[mask, slot])
            info.remaining -= int(mask.sum())
            self._pos_host[slot] += int(mask.sum())
            self.stats["tokens_emitted"] += int(mask.sum())
            c = self._retire_if_done(slot)
            if c is not None:
                done.append(c)
        return done

    def _retire_if_done(self, slot: int) -> Optional[Completion]:
        info = self._slots.get(slot)
        if info is None or info.remaining > 0:
            return None
        req = info.req
        comp = Completion(
            rid=req.rid, prompt_len=info.prompt_len,
            tokens=list(info.emitted),
            admit_version=info.admit_version,
            final_version=self.model_version,
            t_submit_wall=req.t_submit_wall,
            t_admit_wall=info.t_admit_wall,
            t_finish_wall=time.perf_counter(),
            t_submit_virtual=req.t_submit_virtual,
            t_finish_virtual=spans.virtual_now())
        del self._slots[slot]
        self._stop_host[slot] = 0
        self._pos_host[slot] = 0
        return comp

    # ------------------------------------------------------------- driving

    @property
    def idle(self) -> bool:
        return (not self.pending and self._prefilling is None
                and not self._slots)

    def step(self) -> List[Completion]:
        """One scheduling quantum; returns requests completed this step."""
        self._maybe_adopt_model()
        done: List[Completion] = []
        for _ in range(self.prefill_chunks_per_step):
            if self._prefilling is None:
                self._start_prefill_if_ready()
                if self._prefilling is None:
                    break                   # no pending work or no free slot
            c = self._prefill_one_chunk()
            if c is not None:
                done.append(c)
            if self._prefilling is not None:
                break                       # long prompt mid-prefill: one
                                            # chunk per step, decode now
        done.extend(self._decode_chunk())
        return done

    def run(self, max_steps: int = 100_000) -> List[Completion]:
        """Step until drained (or ``max_steps``); returns all completions."""
        out: List[Completion] = []
        steps = 0
        while not self.idle and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out
