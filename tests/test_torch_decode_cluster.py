"""flash_decode's cluster body (``csrc/decode_attn_cluster.cu``) and its
host path (``repro_torch.kernels.decode_attn``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here: its split plan (:func:`decode_cluster_splits`) against every row's
live window, the cluster cap and one wave, and against the two-launch
body's plan at ``chip_smoke.py``'s decode shapes; its arithmetic, emulated
in f32 (each split's normalised (o_j, lse_j), merged in split order as the
blocks of a cluster merge them), against ``flash_decode_pallas`` in
interpret mode within the card's 1e-4; the validation pass's refusals,
which are ``_check``'s of the two-launch host path; the plan cache; and
the ``ClusterPlan`` layout and launch signatures against the source.
"""
import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import flash_decode_pallas
from repro_torch.kernels import _build, decode_attn, ref
from repro_torch.kernels.decode_attn import (ClusterPlan, _mma_eligible,
                                            _validate, decode_cluster_splits,
                                            decode_mma_splits)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/decode_attn_cluster.cu"
# the card's gate on the kernel against the plain version
DECODE_TOL = 1e-4


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_consts",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()
_BLOCKS = _SMOKE.DECODE_BLOCKS
# (name, B, S, KV, hd, window) of every decode row chip_smoke.py times
SMOKE_ROWS = (
    [("path", *_SMOKE.DECODE_PATH[:3], _SMOKE.DECODE_PATH[4],
      _SMOKE.DECODE_PATH[5]),
     ("moe", *_SMOKE.DECODE_MOE[:3], _SMOKE.DECODE_MOE[4],
      _SMOKE.DECODE_MOE[5]),
     ("blocks", _BLOCKS["B"], _BLOCKS["S"] // _BLOCKS["blocks"],
      _BLOCKS["KV"], _BLOCKS["hd"], None),
     ("long", *_SMOKE.DECODE_LONG[:3], _SMOKE.DECODE_LONG[4],
      _SMOKE.DECODE_LONG[5])]
    + [(f"placed{i}", B, S, KV, hd, w)
       for i, (B, S, KV, G, hd, w, _) in enumerate(_SMOKE.DECODE_PLACED)]
    + [(f"model{i}", B, S, KV, hd, w)
       for i, (B, S, KV, G, hd, w, _) in enumerate(_SMOKE.DECODE_MODEL)
       if hd in decode_attn.MMA_HEAD_DIMS])


def _split_rows(length, S, window, split, rows):
    """``[start, end)``: the rows split ``split`` of a batch row of
    ``length`` reads, as the kernel computes them (empty when start >=
    end)."""
    hi = min(length, S)
    lo = max(0, length - window) if window else 0
    start = lo + split * rows
    return start, min(hi, start + rows)


def _lengths(S, window):
    cand = {-3, 0, 1, 2, 63, 64, 65, 127, 128, 129, S // 2, S - 1, S}
    if window:
        cand |= {window - 1, window, window + 1}
    cand |= set(np.linspace(1, S, 9).astype(int).tolist())
    return sorted(x for x in cand if x <= S)


@pytest.mark.parametrize("row", SMOKE_ROWS, ids=lambda r: r[0])
@pytest.mark.parametrize("resident", [132, 264, 528])
@pytest.mark.parametrize("cap", [8, 16])
def test_cluster_splits_cover_each_rows_live_window(row, resident, cap):
    """From the shapes alone: whole 64-row splits, at most ``cap`` (one
    cluster a head), at most one wave (or one split a head), and for every
    length (local ones <= 0 too) the splits read the live rows [lo, len)
    exactly once; where the cap does not bind, the two-launch body's plan."""
    _, B, S, KV, hd, window = row
    splits, rows = decode_cluster_splits(B, S, KV, resident, cap, window)
    live = min(S, window) if window else S
    assert rows % 64 == 0 and 1 <= splits <= cap
    assert (splits - 1) * rows < live <= splits * rows
    assert B * KV * splits <= max(resident, B * KV)
    mma = decode_mma_splits(B, S, KV, resident, window)
    if mma[0] <= cap:
        assert (splits, rows) == mma
    else:                    # the fewest whole 64-row splits of <= cap
        assert rows == -(-(-(-live // cap)) // 64) * 64
    for length in _lengths(S, window):
        lo = max(0, length - window) if window else 0
        at, end = lo, max(lo, min(length, S))
        for j in range(splits):
            start, stop = _split_rows(length, S, window, j, rows)
            assert start == lo + j * rows
            if start < stop:
                assert start == at
                at = stop
        assert at == end, (length, splits, rows)


@pytest.mark.parametrize("name,want", [
    ("path", (4, 64)), ("moe", (4, 64)), ("blocks", (4, 512)),
    ("placed0", (7, 4736)), ("placed1", (4, 8192)), ("model0", (4, 8192)),
    ("model2", (11, 384)), ("long", (16, 8192))])
def test_cluster_plans_at_the_smoke_rows(name, want):
    """On an H100's table (two blocks an SM at hd 128, four at hd 64): the
    cap binds where a cluster a head no longer fits the card's co-scheduled
    clusters (the placed qwen3-14b's 32 heads: 7; starcoder2's 16: 12) and
    at the long row's 16; elsewhere the plan is the two-launch body's."""
    _, B, S, KV, hd, window = next(r for r in SMOKE_ROWS if r[0] == name)
    resident = H100_CLUSTERS[hd][1]
    cap = H100_CLUSTERS[hd]
    top = max(s for s in range(2, 17) if cap[s] >= B * KV)
    assert decode_cluster_splits(B, S, KV, resident, top, window) == want
    mma = decode_mma_splits(B, S, KV, resident, window)
    assert (mma == want) == (name not in ("placed0", "model2", "long"))
    if name == "long":
        assert mma[0] == 33


# ------------------------------------------------- the arithmetic, emulated

def _cluster_emulation(q, k, v, lengths, window, softcap, resident, cap):
    """The cluster body's arithmetic on the CPU in f32: the plan of
    :func:`decode_cluster_splits`; each split's 64-row tiles dealt 16 rows a
    warp to 4 warps, S = Q Kᵀ (exact bf16 products, f32 sums) times
    hd^-1/2, the cap, an online softmax per warp, P into O in three bf16
    parts; the warps merged in warp order into the split's normalised
    (o_j, lse_j), l clamped to 1e-30; then the splits merged in split order
    as a cluster's blocks merge them: M = max lse_j, w_j = exp(lse_j - M),
    den += w_j, A = A + o_j·w_j, den clamped to 1e-30, lse = M + log(den).
    q (B, KV, G, hd), k, v (B, S, KV, hd) bf16; lengths any ints."""
    B, S, KV, hd = k.shape
    G = q.shape[2]
    splits, rows = decode_cluster_splits(B, S, KV, resident, cap, window)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    o = torch.zeros(B, KV, G, hd)
    lse = torch.zeros(B, KV, G, 1)
    for b in range(B):
        qf = q[b].float()
        o_j, lse_j = [], []
        for j in range(splits):
            s0, s1 = _split_rows(int(lengths[b]), S, window, j, rows)
            warps = []
            for w in range(4):
                m = torch.full((KV, G), -1e30)
                l = torch.zeros(KV, G)
                acc = torch.zeros(KV, G, hd)
                for t0 in range(s0 + 16 * w, s1, 64):
                    t1 = min(t0 + 16, s1)
                    kk = k[b, t0:t1].float().transpose(0, 1)
                    vv = v[b, t0:t1].float().transpose(0, 1)
                    sc = (qf @ kk.transpose(1, 2)) * scale
                    if softcap is not None:
                        sc = torch.tanh(sc / softcap) * softcap
                    mx = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp(m - mx)
                    p = torch.exp(sc - mx[..., None])
                    l = l * corr + p.sum(-1)
                    rest, pv = p, []
                    for _ in range(3):
                        part = rest.bfloat16().float()
                        rest = rest - part
                        pv.append(part @ vv)
                    acc = acc * corr[..., None] + sum(reversed(pv))
                    m = mx
                warps.append((m, l, acc))
            M = torch.stack([w_[0] for w_ in warps]).amax(0)
            L = sum(w_[1] * torch.exp(w_[0] - M) for w_ in warps)
            A = sum(w_[2] * torch.exp(w_[0] - M)[..., None] for w_ in warps)
            Lc = L.clamp(min=1e-30)
            o_j.append(A / Lc[..., None])
            lse_j.append(M + torch.log(Lc))
        if splits == 1:
            o[b], lse[b] = o_j[0], lse_j[0][..., None]
            continue
        M = torch.full((KV, G), float("-inf"))
        for x in lse_j:
            M = torch.maximum(M, x)
        den = torch.zeros(KV, G)
        A = torch.zeros(KV, G, hd)
        for x, y in zip(lse_j, o_j):
            w = torch.exp(x - M)
            den = den + w
            A = A + y * w[..., None]
        dc = den.clamp(min=1e-30)
        o[b], lse[b] = A / dc[..., None], (M + torch.log(dc))[..., None]
    return o, lse, splits


def _inputs(B, S, KV, G, hd, lengths, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape).astype(np.float32)
            for shape in ((B, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd))]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    return q, k, v, np.asarray(lengths, np.int32)


def _rel_err(got, want) -> float:
    want = torch.as_tensor(np.asarray(want, np.float64))
    scale = max(1.0, float(want.abs().max()))
    return float((got.double() - want).abs().max()) / scale


@pytest.mark.parametrize("name,B,S,KV,G,hd,window,softcap,lengths,cap", [
    ("serve", 4, 256, 8, 5, 128, None, None, [1, 97, 200, 256], 16),
    ("moe", 4, 256, 16, 1, 128, None, None, [1, 97, 200, 256], 16),
    ("starcoder2_window", 2, 640, 2, 12, 128, 300, None, [640, 301], 16),
    ("cap_binds", 2, 640, 1, 3, 64, None, 30.0, [640, 5], 4),
    ("no_live_key", 4, 512, 2, 5, 128, 100, None, [0, -7, 1, 512], 16)])
def test_cluster_emulation_matches_pallas(name, B, S, KV, G, hd, window,
                                          softcap, lengths, cap):
    """The cluster body's arithmetic, emulated, against
    ``flash_decode_pallas`` in interpret mode within the card's 1e-4 on the
    rows with a live key; a row with none gives o = 0 and lse = -1e30."""
    import jax.numpy as jnp
    q, k, v, ln = _inputs(B, S, KV, G, hd, lengths, seed=S + G + KV)
    resident = 264                 # two blocks an SM of an H100's 132
    o, lse, splits = _cluster_emulation(q, k, v, ln, window, softcap,
                                        resident, cap)
    assert splits > 1
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    po, plse = flash_decode_pallas(jq, jk, jv, jnp.asarray(np.maximum(ln, 0)),
                                   block_s=128, window=window,
                                   softcap=softcap, interpret=True)
    live = ln > 0
    assert _rel_err(o[live], np.asarray(po)[live]) <= DECODE_TOL
    assert _rel_err(lse[live], np.asarray(plse)[live]) <= DECODE_TOL
    dead = torch.from_numpy(~live)
    assert (o[dead] == 0).all() and (lse[dead] <= -1e30).all()
    plain = ref.flash_decode_ref(q, k, v, torch.from_numpy(ln),
                                 window=window, softcap=softcap)
    assert _rel_err(o[torch.from_numpy(live)],
                    plain[0][torch.from_numpy(live)].numpy()) <= DECODE_TOL


# -------------------------------------------------------- the validation

class _OnCard:
    """A CPU tensor that reports itself on CUDA device ``dev``: what the
    validation pass reads (dtype, shape, strides, pointer, device)."""

    is_cuda = True

    def __init__(self, t: torch.Tensor, dev: int = 0, ptr_shift: int = 0):
        self.t, self.dev, self.ptr_shift = t, dev, ptr_shift

    def get_device(self):
        return self.dev

    @property
    def device(self):
        return torch.device("cuda", self.dev)

    @property
    def shape(self):
        return self.t.shape

    @property
    def dtype(self):
        return self.t.dtype

    def dim(self):
        return self.t.dim()

    def stride(self, *d):
        return self.t.stride(*d)

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return 1 << 20 if self.ptr_shift == 0 else (1 << 20) + self.ptr_shift


def _case(B=2, S=33, KV=4, G=5, hd=128, dtype=torch.bfloat16):
    q = torch.zeros(B, KV, G, hd, dtype=dtype)
    k = torch.zeros(B, S, KV, hd, dtype=dtype)
    ln = torch.ones(B, dtype=torch.int32)
    return [_OnCard(q), _OnCard(k), _OnCard(k.clone()), _OnCard(ln)]


def _bad(case):
    q, k, v, ln = _case()
    kw = {}
    if case == "cpu_q":
        q = q.t
    elif case == "cpu_lengths":
        ln = ln.t
    elif case == "other_card":
        v = _OnCard(v.t, dev=1)
    elif case == "q_3d":
        q = _OnCard(q.t[0])
    elif case == "v_shape":
        v = _OnCard(torch.zeros(2, 34, 4, 128, dtype=torch.bfloat16))
    elif case == "q_heads":
        q = _OnCard(torch.zeros(2, 3, 5, 128, dtype=torch.bfloat16))
    elif case == "hd96":
        q, k, v, ln = _case(hd=96)
    elif case == "G17":
        q = _OnCard(torch.zeros(2, 4, 17, 128, dtype=torch.bfloat16))
    elif case == "G16_hd256":
        q, k, v, ln = _case(G=16, hd=256)
    elif case == "f16":
        q, k, v, ln = _case(dtype=torch.float16)
    elif case == "v_f32":
        v = _OnCard(v.t.float())
    elif case == "q_view":
        q = _OnCard(torch.zeros(2, 4, 5, 256, dtype=torch.bfloat16)[..., :128])
    elif case == "lengths_int64":
        ln = _OnCard(ln.t.long())
    elif case == "lengths_shape":
        ln = _OnCard(torch.ones(3, dtype=torch.int32))
    elif case == "k_last_dim":
        k = _OnCard(torch.zeros(2, 33, 4, 256, dtype=torch.bfloat16)[..., ::2])
    elif case == "k_row_stride":
        k = _OnCard(torch.zeros(2, 33, 4, 129,
                                dtype=torch.bfloat16)[..., :128])
    elif case == "v_pointer":
        v = _OnCard(v.t, ptr_shift=4)
    elif case == "window":
        kw["window"] = 0
    elif case == "softcap":
        kw["softcap"] = -1.0
    return (q, k, v, ln), kw


REFUSALS = [
    ("cpu_q", ValueError, "needs CUDA tensors; q is on cpu"),
    ("cpu_lengths", ValueError, "needs CUDA tensors; lengths is on cpu"),
    ("other_card", ValueError, "v on cuda:1, k on cuda:0"),
    ("q_3d", ValueError, r"want q \(B, KV, G, hd\)"),
    ("v_shape", ValueError, r"want q \(B, KV, G, hd\)"),
    ("q_heads", ValueError, "does not match k"),
    ("hd96", ValueError, "head_dim 96"),
    ("G17", ValueError, "G=17"),
    ("G16_hd256", ValueError, "G=16 with head_dim 256"),
    ("f16", TypeError, "want"),
    ("v_f32", TypeError, "k is torch.bfloat16, v torch.float32"),
    ("q_view", ValueError, "q must be contiguous"),
    ("lengths_int64", ValueError, "int32"),
    ("lengths_shape", ValueError, r"contiguous \(B,\) int32"),
    ("k_last_dim", ValueError, "k needs a contiguous last dim"),
    ("k_row_stride", ValueError, "k needs a contiguous last dim"),
    ("v_pointer", ValueError, "v needs a contiguous last dim"),
    ("window", ValueError, "window 0 < 1"),
    ("softcap", ValueError, "softcap -1.0 <= 0")]


@pytest.mark.parametrize("case,exc,match", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_validation_refuses_what_the_kernels_cannot_take(case, exc, match):
    """Each of ``_check``'s refusals, raised by the one validation pass with
    its type and message."""
    args, kw = _bad(case)
    with pytest.raises(exc, match=match):
        _validate(*args, kw.get("window"), kw.get("softcap"))


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtypes", ["bf16", "f32", "f32_q", "f32_kv"])
@pytest.mark.parametrize("q_shift", [0, 2])
def test_validation_routes_as_mma_eligible(hd, dtypes, q_shift):
    """On inputs it accepts, the pass's tensor-core verdict is
    ``_mma_eligible``'s: bf16 q, k, v at hd 64 or 128 with q 16-byte
    aligned."""
    q, k, v, ln = _case(hd=hd, G=4)
    if dtypes in ("f32", "f32_q"):
        q = _OnCard(q.t.float())
    if dtypes in ("f32", "f32_kv"):
        k, v = _OnCard(k.t.float()), _OnCard(v.t.float())
    q.ptr_shift = q_shift
    idx, tc = _validate(q, k, v, ln, None, None)
    assert idx == 0
    assert tc == (dtypes == "bf16" and hd != 256 and q_shift == 0)
    if q_shift == 0:
        assert tc == _mma_eligible(q.t, k.t, v.t)


# ------------------------------------------------------- the plan cache

# cudaOccupancyMaxActiveClusters of the cluster body on an H100 SXM (132
# SMs; two blocks an SM at hd 128, four at hd 64), by cluster size, under
# the launch's load-balancing scheduling policy
H100_CLUSTERS = {
    128: {1: 264, 2: 132, 3: 83, 4: 66, 5: 47, 6: 39, 7: 32, 8: 30, 9: 24,
          10: 22, 11: 17, 12: 17, 13: 15, 14: 15, 15: 15, 16: 15},
    64: {1: 528, 2: 264, 3: 171, 4: 132, 5: 98, 6: 83, 7: 73, 8: 66, 9: 54,
         10: 47, 11: 39, 12: 39, 13: 32, 14: 32, 15: 30, 16: 30}}


def _h100_config(hd, size, dev):
    return H100_CLUSTERS[hd][1], H100_CLUSTERS[hd][size]


class _FakeLib:
    flash_decode_cluster_launch = "cluster"
    flash_decode_mma_launch = "mma"
    flash_decode_launch = "cuda_core"


@pytest.fixture
def fake_library(monkeypatch):
    """``_plan`` on the CPU: the library's functions and occupancy queries
    stood in for by an H100's numbers (two blocks an SM at hd 128, a cap of
    16); the cache cleared before and after."""
    monkeypatch.setattr(_build, "load_library", lambda: _FakeLib)
    monkeypatch.setattr(decode_attn, "cluster_launch_config", _h100_config)
    monkeypatch.setattr(decode_attn, "mma_resident_blocks",
                        lambda hd, dev: 264 if hd == 128 else 528)
    monkeypatch.setattr(decode_attn, "resident_blocks",
                        lambda hd, G, bf16, dev: 396)
    decode_attn._plan.cache_clear()
    yield
    decode_attn._plan.cache_clear()


def _key(body="cluster", B=4, S=256, KV=8, G=5, hd=128, window=None,
         softcap=None, row=None):
    row = row or KV * hd
    kst = (S * row, row, hd, 1)
    return (body, B, S, KV, G, hd, True, True, kst, kst, window, softcap, 0)


@pytest.mark.parametrize("body", ["cluster", "mma", "cuda_core"])
def test_plan_cache_gives_one_plan_for_equal_keys(fake_library, body):
    p = decode_attn._plan(*_key(body))
    assert decode_attn._plan(*_key(body)) is p
    other = decode_attn._plan(*_key(body, row=2 * 8 * 128))
    assert other is not p and other.splits == p.splits
    assert p.fn == body
    assert p.o_view == ((4, 8, 5, 128), (5120, 640, 128, 1))
    assert p.lse_view == ((4, 8, 5, 1), (40, 5, 1, 1), 4 * 8 * 5 * 128)


def test_cluster_plan_holds_the_launch_constants(fake_library):
    """The serve row's plan: 4 splits of 64 rows, no scratch, and its
    ClusterPlan's fields in the source's order, passed by address."""
    p = decode_attn._plan(*_key("cluster", window=200, softcap=30.0))
    assert (p.splits, p.rows) == (4, 64) and p.floats == 4 * 8 * 5 * 129
    c = p.plan
    assert ctypes.addressof(c) == p.consts[0] and len(p.consts) == 1
    assert (c.ks_b, c.ks_s, c.ks_h, c.vs_b, c.vs_s, c.vs_h) == \
        (256 * 1024, 1024, 128, 256 * 1024, 1024, 128)
    assert (c.lse_offset, c.B, c.S, c.KV, c.G, c.hd) == \
        (4 * 8 * 5 * 128, 4, 256, 8, 5, 128)
    assert (c.splits, c.split_rows, c.has_window, c.window, c.has_cap) == \
        (4, 64, 1, 200, 1)
    assert c.scale == np.float32(128 ** -0.5) and c.cap == 30.0


def test_two_launch_plans_keep_their_scratch_in_the_one_buffer(fake_library):
    """The mma and CUDA-core bodies' split partials follow o and lse in the
    call's one allocation, from a 256-byte boundary."""
    p = decode_attn._plan(*_key("mma"))
    n_o, n_lse = 4 * 8 * 5 * 128, 4 * 8 * 5
    at = -(-(n_o + n_lse) // 64) * 64
    assert p.splits == 4
    assert p.part_offsets == (4 * at, 4 * (at + 4 * n_o))
    assert p.floats == at + 4 * (n_o + n_lse)
    one = decode_attn._plan(*_key("mma", S=64))
    assert one.splits == 1 and one.part_offsets == (0, 4 * n_o)
    assert one.floats == n_o + n_lse


@pytest.mark.parametrize("hd,heads,want", [
    (128, 1, 16), (128, 15, 16), (128, 16, 12), (128, 17, 12), (128, 32, 7),
    (128, 33, 6), (128, 64, 4), (128, 66, 4), (128, 67, 3), (128, 132, 2),
    (128, 133, 1), (64, 30, 16), (64, 128, 4), (64, 133, 3), (64, 264, 2),
    (64, 600, 1)])
def test_cluster_cap_is_the_largest_cluster_one_a_head(hd, heads, want):
    """On an H100's table: the largest cluster of which the card
    co-schedules one for every (batch row, kv head), so that a call's
    clusters run in one wave."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode_attn, "cluster_launch_config", _h100_config)
        assert decode_attn.cluster_cap(hd, heads, 0) == want


def test_cluster_cap_is_8_where_16_is_refused(monkeypatch):
    table = {**H100_CLUSTERS[128], **{s: 0 for s in range(9, 17)}}
    monkeypatch.setattr(decode_attn, "cluster_launch_config",
                        lambda hd, size, dev: (264, table[size]))
    assert decode_attn.cluster_cap(128, 1, 0) == 8
    assert decode_attn.cluster_cap(128, 30, 0) == 8
    assert decode_attn.cluster_cap(128, 31, 0) == 7
    assert decode_attn.cluster_cap(128, 133, 0) == 1


# ------------------------------------------- the source and its bindings

_CTYPE = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
          "float": ctypes.c_float}


def test_cluster_plan_matches_the_source_struct():
    """``ClusterPlan``'s fields are the source's, in order and type, with
    no padding (104 bytes)."""
    src = SOURCE.read_text()
    body = re.search(r"struct ClusterPlan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, names = re.match(r"(long long|int|float)\s+(.*);",
                                line).groups()
        fields += [(n.strip(), _CTYPE[ctype]) for n in names.split(",")]
    assert [(n, t) for n, t in ClusterPlan._fields_] == fields
    assert ctypes.sizeof(ClusterPlan) == 104
    assert ClusterPlan.B.offset == 56 and ClusterPlan.scale.offset == 96


@pytest.mark.parametrize("name", ["flash_decode_cluster_launch",
                                  "flash_decode_cluster_launch_config"])
def test_launch_signatures_match_the_source(name):
    src = SOURCE.read_text()
    params = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                       re.S).group(1)
    kinds = []
    for p in params.split(","):
        p = p.strip()
        kinds.append(ctypes.c_void_p if "void*" in p else
                     ctypes.POINTER(ctypes.c_int) if "int*" in p else
                     ctypes.c_int)
    assert _build._SIGNATURES[name] == kinds


def test_bodies_and_their_tally():
    assert decode_attn.BODIES == ("cluster", "mma", "cuda_core")
    decode_attn.reset_body_launches()
    assert decode_attn.body_launches() == {"cluster": 0, "mma": 0,
                                           "cuda_core": 0}
