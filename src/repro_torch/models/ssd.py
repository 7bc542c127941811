"""Mamba2 block of the port (``repro.models.ssd``), in the State-Space
Duality form.

The SSD recurrence per head (state N, head dim P):

    s_t = a_t · s_{t-1} + dt_t · (B_t ⊗ x_t)       a_t = exp(dt_t · A) ∈ (0,1)
    y_t = C_t · s_t + D · x_t

is evaluated chunk-parallel (chunk Q): within a chunk the contribution is an
attention-like masked product, and a Python loop over the chunks carries
the (B, H, P, N) f32 state (the reference's ``lax.scan``).

Dtypes follow the reference op by op: the full-sequence causal conv runs in
the model dtype, the decode step's conv in f32 cast back; the scan lifts x,
B and C to f32; ``A_log``, ``D`` and ``dt_bias`` are f32 leaves whatever
the model dtype.  ``F.softplus`` returns x itself above 20 where
``jax.nn.softplus`` is ``logaddexp(x, 0)``; over the whole range the two
stay within two f32 ulps (``tests/test_torch_recurrent.py`` holds it).

Inside ``core.distributed.model_parallel`` :func:`mamba2_forward` is
head-parallel: ``in_proj``'s column block and ``out_proj``'s row block
are this rank's; the projection is gathered whole, each rank runs the
conv and the scan on its H/m heads' channels (B and C whole), the gated
norm sums its squares over ``model``, and the output projection's parts
are summed.  A state it continues or returns (the placed prefill and
decode steps) holds the whole conv window and this rank's heads' SSM
state; :func:`mamba2_decode` steps the same way, and is that one step
on all heads outside it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.distributed import (ModelShard, copy_to_model, gather_for_rows,
                                gather_from_model, model_shard,
                                reduce_from_model, sum_for_parts)
from .config import ArchConfig
from .layers import dense_init


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_channels) rolling conv input window
    ssm: torch.Tensor    # (B, H, P, N) f32 recurrent state


def init_mamba2(cfg: ArchConfig, gen: torch.Generator,
                dtype: torch.dtype) -> Dict:
    """The reference's tree, drawn from ``gen`` on its device."""
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    H = cfg.ssm_num_heads
    conv_ch = di + 2 * N
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv_w = torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen,
                         device=dev) * 0.2
    return {
        # order: [z (di), x (di), B (N), C (N), dt (H)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * N + H, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. u: (B, S, C), w: (W, C)."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return out + b


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh (B,S,H,P), dt (B,S,H) f32, A (H,) negative, Bm/Cm (B,S,N).

    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        # dt = 0 on the padding: identity decay and no state input
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = xh.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    Bc = Bm.reshape(B, nc, chunk, N)
    Cc = Cm.reshape(B, nc, chunk, N)
    cum = torch.cumsum(dtc * A, dim=2)       # (B,nc,Q,H) ≤ 0, inclusive
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    state = init_state.float()
    ys = []
    for c in range(nc):
        xq, dtq, cumq = xc[:, c].float(), dtc[:, c], cum[:, c]
        Bq, Cq = Bc[:, c].float(), Cc[:, c].float()
        # intra-chunk: M[b,q,s,h] = exp(cum_q - cum_s)·dt_s·(C_q·B_s), s ≤ q
        CB = torch.einsum("bqn,bsn->bqs", Cq, Bq)
        # valid (s ≤ q) exponents are ≤ 0, so the clamp is exact there and
        # keeps masked pairs from overflowing (inf·0 = NaN in a backward)
        decay = torch.exp(torch.clamp(
            cumq[:, :, None, :] - cumq[:, None, :, :], max=0.0))  # (B,q,s,H)
        M = torch.where(causal[None, :, :, None], decay, 0.0) \
            * CB[:, :, :, None] * dtq[:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", M, xq)
        # inter-chunk: y_inter[q] = exp(cum_q) · C_q · state
        y_inter = torch.einsum("bqn,bhpn->bqhp", Cq, state) \
            * torch.exp(cumq)[..., None]
        # s' = exp(cum_Q)·s + Σ_s exp(cum_Q - cum_s)·dt_s·x_s⊗B_s
        total = cumq[:, -1, :]                                   # (B,H)
        w_s = torch.exp(total[:, None, :] - cumq) * dtq          # (B,Q,H)
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bqhp,bqn->bhpn", w_s[..., None] * xq, Bq)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, nc * chunk, H, P)[:, :S]
    return y, state


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    return torch.split(proj, [di, di, N, N, cfg.ssm_num_heads], dim=-1)


def _gate_out(cfg: ArchConfig, params: Dict, y: torch.Tensor,
              z: torch.Tensor, cols: slice) -> torch.Tensor:
    """The gated RMS norm over all di channels, then ``out_proj``: y and z
    hold the channels ``cols`` (this rank's inside ``model_parallel``, its
    Σ y² and ``out_proj``'s parts summed over ``model``; else all)."""
    g = (y * F.silu(z)).float()
    var = sum_for_parts(g.square().sum(dim=-1, keepdim=True)) \
        / cfg.ssm_d_inner
    g = g * torch.rsqrt(var + cfg.norm_eps)
    g = (g * (1.0 + copy_to_model(params["norm"])[cols].float())
         ).to(y.dtype)
    return reduce_from_model(g @ params["out_proj"])


def mamba2_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                   init_state: Optional[SSMState] = None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence forward. x: (B, S, d) → (out (B,S,d), final SSMState).
    ``init_state`` continues the causal conv across a segment boundary: its
    W−1 carried inputs are prepended in place of zero padding."""
    shard = model_shard()
    if shard is not None:
        return _mamba2_sharded(cfg, params, x, shard, init_state)
    B, S, d = x.shape
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    H, P = cfg.ssm_num_heads, cfg.ssm_head_dim
    W = cfg.ssm_conv_width
    z, xin, Bm, Cm, dt_raw = _split_proj(cfg, x @ params["in_proj"])
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    if init_state is not None:
        hist = torch.cat([init_state.conv.to(conv_in.dtype), conv_in], dim=1)
        conv_out = F.silu(_causal_conv(hist, params["conv_w"],
                                       params["conv_b"]))[:, W - 1:]
    else:
        hist = F.pad(conv_in, (0, 0, max(W - 1 - S, 0), 0))
        conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                       params["conv_b"]))
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xin.reshape(B, S, H, P)
    state0 = (init_state.ssm if init_state is not None else
              torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    y, state = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, state0)
    y = y + params["D"][None, None, :, None] * xh.float()
    out = _gate_out(cfg, params, y.reshape(B, S, di).to(x.dtype), z,
                    slice(None))
    return out, SSMState(hist[:, -(W - 1):, :].to(x.dtype), state)


def _head_split(cfg: ArchConfig, shard) -> Tuple[int, slice, slice]:
    """This rank's (H/m, its di/m channels, its heads) of a Mamba2 layer."""
    H = cfg.ssm_num_heads
    m, r = shard.size, shard.rank
    if H % m:
        raise NotImplementedError(
            f"{H} Mamba2 heads do not divide over {m} 'model' ranks")
    h, dl = H // m, cfg.ssm_d_inner // m
    return h, slice(r * dl, (r + 1) * dl), slice(r * h, (r + 1) * h)


def _mamba2_sharded(cfg: ArchConfig, params: Dict, x: torch.Tensor, shard,
                    init_state: Optional[SSMState] = None
                    ) -> Tuple[torch.Tensor, SSMState]:
    """:func:`mamba2_forward` on this rank's H/m heads, from zero state or
    ``init_state`` (the whole conv window, this rank's heads' SSM state):
    every tensor after the gathered projection is a per-rank part, so the
    whole weights it reads (conv, ``A_log``, ``D``, ``dt_bias``, ``norm``)
    enter through ``copy_to_model`` and the projection's grads are summed
    back (``gather_for_rows``).  Returns the whole conv window and this
    rank's heads' final state."""
    B, S, d = x.shape
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    P, W = cfg.ssm_head_dim, cfg.ssm_conv_width
    h, cols, heads = _head_split(cfg, shard)
    dl = di // shard.size
    z, xin, Bm, Cm, dt_raw = _split_proj(
        cfg, gather_for_rows(copy_to_model(x) @ params["in_proj"]))
    w, b = copy_to_model(params["conv_w"]), copy_to_model(params["conv_b"])
    full = torch.cat([xin, Bm, Cm], dim=-1)          # every conv channel
    if init_state is not None:
        hist = torch.cat([init_state.conv.to(full.dtype), full], dim=1)
    else:
        hist = F.pad(full, (0, 0, W - 1, 0))
    mine = torch.cat([hist[..., cols], hist[..., di:]], dim=-1)
    conv_out = F.silu(_causal_conv(
        mine, torch.cat([w[:, cols], w[:, di:]], dim=1),
        torch.cat([b[cols], b[di:]])))[:, W - 1:]
    xin, Bm, Cm = torch.split(conv_out, [dl, N, N], dim=-1)
    dt = F.softplus(dt_raw[..., heads].float()
                    + copy_to_model(params["dt_bias"])[heads])
    A = -torch.exp(copy_to_model(params["A_log"])[heads])
    xh = xin.reshape(B, S, h, P)
    state0 = (init_state.ssm if init_state is not None else
              torch.zeros((B, h, P, N), dtype=torch.float32, device=x.device))
    y, state = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, state0)
    y = y + copy_to_model(params["D"])[heads][None, None, :, None] \
        * xh.float()
    out = _gate_out(cfg, params, y.reshape(B, S, dl).to(x.dtype),
                    z[..., cols], cols)
    return out, SSMState(hist[:, -(W - 1):].to(x.dtype), state)


def init_ssm_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device=None) -> SSMState:
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return SSMState(
        torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype,
                    device=device),
        torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), dtype=torch.float32, device=device))


def mamba2_decode(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                  state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Single-token decode. x: (B, 1, d).  Inside ``model_parallel`` on
    this rank's shards and H/m heads: the projection gathered whole, the
    conv window stepped whole (it is the state's, whole over ``model``),
    the SSM step on this rank's heads (``state.ssm``), the gated norm's
    squares and ``out_proj``'s parts summed over ``model``."""
    B = x.shape[0]
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    P = cfg.ssm_head_dim
    shard = model_shard() or ModelShard(None, 1, 0)
    h, cols, heads = _head_split(cfg, shard)
    z, xin, Bm, Cm, dt_raw = _split_proj(
        cfg, gather_from_model(x[:, 0] @ params["in_proj"]))
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                 # (B, C)
    window = torch.cat([state.conv, conv_in[:, None, :]], dim=1)  # (B,W,C)
    conv_out = F.silu(
        torch.einsum("bwc,wc->bc", window.float(), params["conv_w"].float())
        + params["conv_b"].float()).to(x.dtype)
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt_raw[:, heads].float() + params["dt_bias"][heads])
    A = -torch.exp(params["A_log"][heads])
    a = torch.exp(dt * A)                                      # (B,h)
    xh = xin[:, cols].reshape(B, h, P).float()
    s_new = state.ssm * a[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bm.float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), s_new)
    y = y + params["D"][heads][None, :, None] * xh
    out = _gate_out(cfg, params, y.reshape(B, -1).to(x.dtype), z[:, cols],
                    cols)
    return out[:, None, :], SSMState(window[:, 1:], s_new)
