"""Mixture-of-Experts feed-forward (DeepSeekMoE / OLMoE style), the port
of ``repro.models.moe``.

Fine-grained routed experts (top-k, softmax gate, renormalised) plus
optional always-on shared experts, with the reference's sort-based
capacity dispatch, step by step:

  1. :func:`route` — f32 router logits, softmax, top-k in
     ``jax.lax.top_k``'s order (a stable descending sort: on equal
     probabilities the lower expert index comes first), renormalised;
  2. :func:`dispatch` — a stable sort of the flat (T·k,) expert ids gives
     each entry its position in its expert; entries past the capacity C are
     dropped as in the reference;
  3. :func:`experts` — three ``torch.bmm`` over the (E, C, d) buffer;
  4. :func:`combine` — each token's k weighted contributions, added in
     ascending expert order in ``x.dtype``, plus the shared experts.

The layer never waits on the device: every shape is a function of
(T, k, E, C) alone, each expert's first sorted entry comes from
``searchsorted`` (no ``bincount``, boolean-mask indexing or ``nonzero``),
and nothing is accumulated with float atomics.  The reference's
``buf.at[slot].add`` sends a dropped entry to (e, C−1) with a zero weight;
here it goes to one trash row past E·C, so the buffer is written by a
plain index assignment over unique slots.  The reference's combine
``yt.at[st].add(contrib)`` becomes a gather back to (T, k, d) and k − 1
adds, in the order the reference's sorted scatter adds them.

Inside ``core.distributed.model_parallel`` the experts are split over
``model`` (``w_up`` / ``w_gate`` / ``w_down`` hold this rank's E/m
experts): the router, its aux loss and the dispatch's positions run on
every rank's whole token set alike, the (E/m, C, d) buffer holds only this
rank's experts, each token's contributions from them are added in
ascending expert order, and the parts (with the shared MLP's) are summed
over ``model`` — a sum in another order than the one-rank layer's.

Two behaviours of the reference are kept on purpose: the gated branch is
``silu(gate) * up`` for ``activation == "geglu"`` too, and the ungated
branch is the tanh GELU (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.distributed import (copy_to_model, model_shard,
                                reduce_from_model)
from .config import ArchConfig
from .layers import _gelu_tanh, dense_init
from .mlp import init_mlp, mlp_partial


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype: torch.dtype
             ) -> Dict:
    """The reference's tree: ``router`` (f32 whatever ``dtype``),
    ``w_up``/``w_down`` (and ``w_gate`` for a gated activation) stacked
    over the E experts, and ``shared``, an MLP of width
    ``d_ff · num_shared_experts``, when the config has shared experts."""
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    dev = gen.device

    def stacked(rows, cols):
        w = torch.randn((E, rows, cols), generator=gen, device=dev)
        return (w * rows ** -0.5).to(dtype)
    p = {"router": dense_init(gen, d, E, torch.float32, scale=0.02),
         "w_up": stacked(d, ff),
         "w_down": stacked(ff, d)}
    if cfg.activation in ("silu", "geglu"):
        p["w_gate"] = stacked(d, ff)
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(cfg, gen, dtype,
                               d_ff=cfg.d_ff * cfg.num_shared_experts)
    return p


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for T tokens, in the reference's float order; at
    T ≤ 256 (decode, the engine's prefill chunks) at least T, so no entry
    is dropped."""
    cap = int(T * cfg.experts_per_token / cfg.num_experts
              * cfg.moe_capacity_factor) + 1
    return max(cap, T) if T <= 256 else cap


def route(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) → (probs (T, E) f32, top_p (T, k) f32 renormalised,
    top_e (T, k) int64), top-k in ``jax.lax.top_k``'s order."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def aux_loss(cfg: ArchConfig, probs: torch.Tensor, top_e: torch.Tensor
             ) -> torch.Tensor:
    """Switch load-balance loss, f32: ``E · Σ_e (f_e / k) · P_e``."""
    E, k = cfg.num_experts, cfg.experts_per_token
    experts = torch.arange(E, device=top_e.device)
    chosen = (top_e[:, :, None] == experts).sum(1, dtype=torch.float32)
    pos_frac = chosen.mean(0)                                   # (E,)
    return E * torch.sum(pos_frac / k * probs.mean(0))


class Dispatch(NamedTuple):
    """Where each flat entry (t, j) of the top-k lands: ``slot`` (T·k,)
    its row of the (E·C, d) buffer (clamped to the expert's last row when
    dropped, as the reference's), ``keep`` (T·k,) bool (kept, and held by
    this rank's experts), and ``asc`` (T, k) each token's choices in
    ascending expert order."""
    slot: torch.Tensor
    keep: torch.Tensor
    asc: torch.Tensor


def dispatch(cfg: ArchConfig, xt: torch.Tensor, top_e: torch.Tensor,
             held: Optional[Tuple[int, int]] = None
             ) -> Tuple[torch.Tensor, Dispatch]:
    """Scatter the tokens into the (E, C, d) expert buffer; ``held`` =
    (first, count) (every expert by default) makes it the (count, C, d)
    buffer of experts [first, first + count) (each entry's position in its
    expert is still counted over all entries)."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    first, held_e = held or (0, E)
    cap = capacity(cfg, T)
    dev = xt.device
    flat_e = top_e.reshape(-1)                                  # (T·k,)
    # ties by flat index t·k + j, as jnp.argsort(stable=True)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos_sorted = torch.arange(T * k, device=dev) - starts[se]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted                    # a permutation: unique rows
    keep = (pos < cap) & (flat_e >= first) & (flat_e < first + held_e)
    E, flat_e = held_e, (flat_e - first).clamp(0, held_e - 1)
    rows = xt[:, None].expand(T, k, d).reshape(T * k, d)     # entry t·k + j
    buf = torch.zeros((E * cap + 1, d), dtype=xt.dtype, device=dev)
    # kept rows are unique; every dropped entry lands in the trash row E·C
    buf[torch.where(keep, flat_e * cap + pos, E * cap)] = rows
    slot = flat_e * cap + pos.clamp_max(cap - 1)
    asc = torch.argsort(top_e, dim=-1)         # a token's experts differ
    return buf[:E * cap].view(E, cap, d), Dispatch(slot, keep, asc)


def experts(params: Dict, buf: torch.Tensor) -> torch.Tensor:
    """(E, C, d) → (E·C, d): every expert's MLP on its C rows."""
    up = torch.bmm(buf, params["w_up"])
    if "w_gate" in params:
        # silu for geglu too, as the reference
        up = F.silu(torch.bmm(buf, params["w_gate"])) * up
    else:
        up = _gelu_tanh(up)
    return torch.bmm(up, params["w_down"]).reshape(-1, buf.shape[-1])


def combine(out_buf: torch.Tensor, top_p: torch.Tensor, placed: Dispatch
            ) -> torch.Tensor:
    """(E·C, d) → (T, d): each token's contributions weighted by
    ``keep · p`` in ``out_buf.dtype`` and added one at a time in ascending
    expert order (the reference's sorted scatter-add)."""
    T, k = top_p.shape
    dt = out_buf.dtype
    weight = placed.keep.to(dt) * top_p.reshape(-1).to(dt)
    contrib = (out_buf[placed.slot] * weight[:, None]).view(T, k, -1)
    tok = torch.arange(T, device=out_buf.device)[:, None]
    ordered = contrib[tok, placed.asc]                           # (T, k, d)
    yt = ordered[:, 0]
    for j in range(1, k):
        yt = yt + ordered[:, j]
    return yt


def moe_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (out (B, S, d), aux_loss f32)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    probs, top_p, top_e = route(cfg, params["router"], xt)
    aux = aux_loss(cfg, probs, top_e)
    shard = model_shard()
    held = params["w_up"].shape[0]            # this rank's E/m experts
    first = shard.rank * held if shard is not None else 0
    xin = copy_to_model(xt)
    buf, placed = dispatch(cfg, xin, top_e, (first, held))
    yt = combine(experts(params, buf), copy_to_model(top_p), placed)
    if cfg.num_shared_experts:
        yt = yt + mlp_partial(cfg, params["shared"], xin)
    return reduce_from_model(yt).reshape(B, S, d), aux
