"""RWKV6 ("Finch") block of the port (``repro.models.rwkv``): linear
attention with data-dependent per-channel decay, plus the channel-mix FFN.

Time-mix recurrence per head (key/value dim P, state S ∈ R^{P×P}):

    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t
    y_t = r_t · (diag(u) · (k_t ⊗ v_t) + S_{t-1})

with w_t ∈ (0,1)^P from the token-shifted LoRA decay path.

A full sequence is evaluated chunk-parallel: within a chunk the pairwise
decay products are materialised per channel on (Q, Q, P) tiles, and a
Python loop over the chunks carries the f32 state (the reference's
``lax.scan``).  Decode is the O(1) recurrence.  r, k and v are lifted to f32
inside the scan; ``w0`` and ``u`` are f32 leaves whatever the model dtype.

Inside ``core.distributed.model_parallel`` :func:`rwkv6_forward` is
head-parallel: ``wr`` / ``wk`` / ``wv`` / ``wg``, ``w_A``, ``ffn_k`` and
``ffn_r`` hold this rank's columns, ``wo``, ``w_B`` and ``ffn_v`` its rows;
the token-shifted mixes are whole on every rank, the wkv scan runs on its
H/m heads, the output layer norm sums its moments over ``model``, and the
LoRA decay, ``wo`` and ``ffn_v`` parts are summed.  A state it continues
or returns (the placed prefill and decode steps) holds this rank's heads'
``wkv`` and the whole token shifts; :func:`rwkv6_decode` steps the same
way, and is that one step on all heads outside it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.distributed import (ModelShard, copy_to_model,
                                gather_from_model, model_shard,
                                reduce_from_model, sum_for_parts)
from .config import ArchConfig
from .layers import dense_init


class RWKVState(NamedTuple):
    shift: torch.Tensor      # (B, d) previous token's features (token shift)
    wkv: torch.Tensor        # (B, H, P, P) f32 linear-attention state
    shift_ffn: torch.Tensor  # (B, d) token shift for channel-mix


def init_rwkv6(cfg: ArchConfig, gen: torch.Generator,
               dtype: torch.dtype) -> Dict:
    """The reference's tree, drawn from ``gen`` on its device."""
    d, P = cfg.d_model, cfg.rwkv_head_dim
    H = cfg.rwkv_num_heads
    lora = max(d // 16, 32)
    dev = gen.device

    def mu(rows):
        u = torch.rand((rows, d), generator=gen, device=dev)
        return (u * 0.5 + 0.25).to(dtype)
    p = {"mu": mu(5)}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, d, d, dtype)
    p["w0"] = torch.full((d,), -6.0, dtype=torch.float32, device=dev)
    p["w_A"] = dense_init(gen, d, lora, dtype)
    p["w_B"] = dense_init(gen, lora, d, dtype, scale=0.01)
    p["u"] = torch.randn((H, P), generator=gen, device=dev) * 0.1
    p["ln_x_w"] = torch.ones((d,), dtype=dtype, device=dev)
    p["ln_x_b"] = torch.zeros((d,), dtype=dtype, device=dev)
    p["mu_ffn"] = mu(2)
    p["ffn_k"] = dense_init(gen, d, cfg.d_ff, dtype)
    p["ffn_v"] = dense_init(gen, cfg.d_ff, d, dtype)
    p["ffn_r"] = dense_init(gen, d, d, dtype)
    return p


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) -> x shifted right by one, first slot = prev (B,d)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_chunked(r, k, v, logw, u, chunk: int, init_state):
    """r,k,v,logw: (B,S,H,P) (logw ≤ 0, f32); u: (H,P).
    Returns (y (B,S,H,P) f32, final_state (B,H,P,P) f32)."""
    B, S, H, P = r.shape
    pad = (-S) % chunk
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, z), F.pad(k, z), F.pad(v, z)
        logw = F.pad(logw, z)   # log 1 = 0: identity decay on the padding
    nc = (S + pad) // chunk
    rc, kc, vc, lw = (t.reshape(B, nc, chunk, H, P) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)              # (B,nc,Q,H,P) inclusive
    strict = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(-1)
    u32 = u.float()
    state = init_state.float()
    ys = []
    for c in range(nc):
        rq, kq, vq = rc[:, c].float(), kc[:, c].float(), vc[:, c].float()
        cumq, lwq = cum[:, c], lw[:, c]
        # y_q reads S_{q-1}: pair (q, s), s < q, decays by w_{s+1}..w_{q-1}
        # = exp(cum_{q-1} - cum_s) = exp((cum_q - logw_q) - cum_s)
        cum_pre = cumq - lwq
        # valid (s < q) exponents are ≤ 0; the clamp keeps masked pairs
        # from overflowing (inf·0 would be NaN in a backward pass)
        dec = torch.exp(torch.clamp(
            cum_pre[:, :, None] - cumq[:, None], max=0.0))   # (B,q,s,H,P)
        att = ((rq[:, :, None] * dec) * kq[:, None]).sum(-1)  # (B,q,s,H)
        att = torch.where(strict[None, :, :, None], att, 0.0)
        # the diagonal "bonus" term diag(u)
        diag = (rq * kq * u32).sum(-1)                       # (B,q,H)
        y_intra = torch.einsum("bqsh,bshj->bqhj", att, vq) + diag[..., None] * vq
        # inter-chunk: y += (r_q · exp(cum_{q-1})) @ state (state before q)
        y_inter = torch.einsum("bqhi,bhij->bqhj", rq * torch.exp(cum_pre),
                               state)
        # state' = diag(exp(cum_Q)) state + Σ_s exp(cum_Q - cum_s) k_s ⊗ v_s
        total = cumq[:, -1]                                  # (B,H,P)
        wk = kq * torch.exp(total[:, None] - cumq)
        state = state * torch.exp(total)[..., None] + torch.einsum(
            "bqhi,bqhj->bhij", wk, vq)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, nc * chunk, H, P)[:, :S]
    return y, state


def _decay_log(params: Dict, xw: torch.Tensor, cols: slice) -> torch.Tensor:
    """log w = -exp(w0 + tanh(xw A) B) of the channels ``cols``, f32, ≤ 0
    (inside ``model_parallel`` the LoRA's parts summed over ``model``)."""
    lora = sum_for_parts(torch.tanh(xw @ params["w_A"]) @ params["w_B"])
    return -torch.exp(copy_to_model(params["w0"])[cols]
                      + lora[..., cols].float())


def _ln_x(cfg: ArchConfig, params: Dict, y: torch.Tensor, cols: slice,
          d: int) -> torch.Tensor:
    """The output layer norm over all d channels of y, which holds the
    channels ``cols``, f32: its mean and variance summed over ``model``
    inside ``model_parallel``, in two passes as ``layer_norm``'s."""
    y = y.float()
    mean = sum_for_parts(y.sum(dim=-1, keepdim=True)) / d
    var = sum_for_parts((y - mean).square().sum(dim=-1, keepdim=True)) / d
    return ((y - mean) * torch.rsqrt(var + cfg.norm_eps)
            * copy_to_model(params["ln_x_w"])[cols].float()
            + copy_to_model(params["ln_x_b"])[cols].float())


def _channel_mix(params: Dict, x: torch.Tensor,
                 shifted: torch.Tensor) -> torch.Tensor:
    """The channel mix; inside ``model_parallel`` ``ffn_k`` / ``ffn_r``
    column-parallel, ``ffn_v`` row-parallel."""
    xk, xr = (copy_to_model(x + (shifted - x) * params["mu_ffn"][i])
              for i in range(2))
    kf = torch.square(torch.relu(xk @ params["ffn_k"]))
    return gather_from_model(torch.sigmoid(xr @ params["ffn_r"])) \
        * reduce_from_model(kf @ params["ffn_v"])


def _head_split(cfg: ArchConfig, d: int, shard) -> Tuple[int, slice, slice]:
    """This rank's (H/m, its d/m channels, its heads) of an RWKV6 layer."""
    H = cfg.rwkv_num_heads
    m, r = shard.size, shard.rank
    if H % m:
        raise NotImplementedError(
            f"{H} RWKV6 heads do not divide over {m} 'model' ranks")
    h, dl = H // m, d // m
    return h, slice(r * dl, (r + 1) * dl), slice(r * h, (r + 1) * h)


def rwkv6_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                  init_state: Optional[RWKVState] = None
                  ) -> Tuple[torch.Tensor, RWKVState]:
    """Time-mix + channel-mix for a full sequence. x: (B,S,d), from zero
    state or ``init_state``.  Inside ``model_parallel`` on this rank's H/m
    heads (``init_state`` and the returned state: whole token shifts, this
    rank's heads' wkv): the mixes are whole on every rank and enter each
    column-parallel product through ``copy_to_model``; the scan's per-head
    leaves (``w0``, ``u``, ``ln_x_*``) are sliced to this rank's channels
    after it."""
    B, S, d = x.shape
    P = cfg.rwkv_head_dim
    shard = model_shard() or ModelShard(None, 1, 0)
    h, cols, heads = _head_split(cfg, d, shard)
    dl = d // shard.size
    if init_state is None:
        prev = prev_f = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        state0 = torch.zeros((B, h, P, P), dtype=torch.float32,
                             device=x.device)
    else:
        prev, state0, prev_f = init_state
    xs = _token_shift(x, prev)
    xr, xk, xv, xg, xw = (copy_to_model(x + (xs - x) * params["mu"][i])
                          for i in range(5))
    r_ = (xr @ params["wr"]).reshape(B, S, h, P)
    k = (xk @ params["wk"]).reshape(B, S, h, P)
    v = (xv @ params["wv"]).reshape(B, S, h, P)
    g = F.silu(xg @ params["wg"])
    logw = _decay_log(params, xw, cols).reshape(B, S, h, P)
    y, wkv = _wkv_chunked(r_, k, v, logw, copy_to_model(params["u"])[heads],
                          max(cfg.ssm_chunk // 4, 16), state0)
    y = _ln_x(cfg, params, y.reshape(B, S, dl).to(x.dtype), cols,
              d).to(x.dtype) * g
    out = reduce_from_model(y @ params["wo"])
    xs_f = xs if init_state is None else _token_shift(x, prev_f)
    ffn = _channel_mix(params, x, xs_f)
    last = x[:, -1, :]
    return out + ffn, RWKVState(last, wkv, last)


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                    device=None) -> RWKVState:
    H, P = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    shift = lambda: torch.zeros((batch, cfg.d_model), dtype=dtype,  # noqa: E731
                                device=device)
    return RWKVState(shift(), torch.zeros((batch, H, P, P),
                                          dtype=torch.float32, device=device),
                     shift())


def rwkv6_decode(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                 state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    """Single-token step. x: (B, 1, d).  Inside ``model_parallel`` on this
    rank's H/m heads: ``state``'s wkv is theirs, its token shifts whole;
    r, k, v, g and the decay of its channels; the LoRA decay's, ``wo``'s
    and ``ffn_v``'s parts and the layer norm's moments summed over
    ``model``."""
    B, _, d = x.shape
    P = cfg.rwkv_head_dim
    h, cols, heads = _head_split(cfg, d, model_shard() or ModelShard(None, 1,
                                                                     0))
    xt = x[:, 0]
    mix = lambda i: xt + (state.shift - xt) * params["mu"][i]  # noqa: E731
    r = (mix(0) @ params["wr"]).reshape(B, h, P).float()
    k = (mix(1) @ params["wk"]).reshape(B, h, P).float()
    v = (mix(2) @ params["wv"]).reshape(B, h, P).float()
    g = F.silu(mix(3) @ params["wg"])
    w = torch.exp(_decay_log(params, mix(4), cols).reshape(B, h, P))
    kv = k[..., :, None] * v[..., None, :]                    # (B,h,P,P)
    y = torch.einsum("bhi,bhij->bhj", r,
                     params["u"][heads][None, :, :, None] * kv + state.wkv)
    wkv_new = state.wkv * w[..., None] + kv
    y = _ln_x(cfg, params, y.reshape(B, -1).to(x.dtype), cols,
              d).to(x.dtype) * g
    out = reduce_from_model(y @ params["wo"])
    ffn = _channel_mix(params, xt, state.shift_ffn)
    return (out + ffn)[:, None, :], RWKVState(xt, wkv_new, xt)
