#!/usr/bin/env python3
"""How far each ``flash_decode`` body of the PyTorch/CUDA port strays from an
f64 attention inside one full-width decode step, and what that does to the
step's logits.  Needs one CUDA card and the CUDA toolkit; imports no JAX.

    python3 benchmarks/torch_decode_bias.py

It builds the full qwen3-14b (40 layers, bf16, weights from a seeded
generator on the card), fills a 4-slot, 256-row KV cache with normal noise,
and runs one decode step at depths 200-230 through ``models.transformer.
decode_slots`` with each attention: the tensor-core body
(``csrc/decode_attn_mma.cu``), the CUDA-core body (``csrc/decode_attn.cu``),
the plain version (``kernels.ref``, f32) and the plain arithmetic in f64.
It prints:

  * the logits of every pair, as max |a - b| / max |b| (the statistic that
    ``chip_smoke.py``'s serve phase gates at 3.02e-2, there on the cache
    the served requests left);
  * for the 40 layers' attention inputs of the tensor-core run, each body's
    and the plain version's output against the f64 attention: the largest
    error, the mean signed error along the output's own sign over its mean
    magnitude (below zero: the output shrinks), and the share of entries
    whose bf16 rounding differs from the f64 output's.

The last line is one JSON object with those numbers and the card's name
and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SLOTS, MAX_SEQ = 4, 256
DEPTHS = (200, 210, 220, 230)


def exact_attention(q, k, v, lengths):
    """The f64 attention of bf16 (or f32) q, k, v with a length mask."""
    import torch
    S, hd = k.shape[1], k.shape[3]
    s = torch.einsum("bkgd,bskd->bkgs", q.double() * hd ** -0.5, k.double())
    kpos = torch.arange(S, device=k.device)[None, None, None, :]
    s = s.masked_fill(~(kpos < lengths.long()[:, None, None, None]),
                      float("-inf"))
    return torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v.double())


def error_stats(o, exact) -> dict:
    e = o.double() - exact
    return {"max_abs": float(e.abs().max()),
            "bias": float((e * exact.sign()).mean() / exact.abs().mean()),
            "bf16_flips": float((o.bfloat16() != exact.bfloat16())
                                .double().mean())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_bias: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn, force_backend, ops, ref
    from repro_torch.models import get_model
    from repro_torch.models import transformer as ttf
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    cfg = get_config("qwen3-14b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = get_model(cfg).init(gen)
    cache = ttf.init_lm_cache(cfg, SLOTS, MAX_SEQ, ring=False, device="cuda")
    gen.manual_seed(3)
    for t in cache.kv:
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    saved = [t.clone() for t in cache.kv]
    pos = torch.tensor(DEPTHS, dtype=torch.int32, device="cuda")
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    active = torch.ones(SLOTS, dtype=torch.bool, device="cuda")
    captured = []

    def body(name, record=False):
        def attend(q, k, v, lengths, *, window=None, softcap=None,
                   backend=None):
            if record:
                captured.append((q.clone(), k.clone(), v.clone(),
                                 lengths.clone()))
            return decode_attn.flash_decode_cuda(q, k, v, lengths,
                                                 window=window,
                                                 softcap=softcap, body=name)
        return attend

    def f64(q, k, v, lengths, *, window=None, softcap=None, backend=None):
        return exact_attention(q, k, v, lengths).float(), None

    def step(attend):
        for t, s in zip(cache.kv, saved):
            t.copy_(s)
        if attend is None:
            with force_backend("torch", "flash_decode"):
                out, _ = ttf.decode_slots(cfg, params, tok, cache, pos,
                                          active=active)
            return out.float()
        keep, ops.flash_decode = ops.flash_decode, attend
        try:
            out, _ = ttf.decode_slots(cfg, params, tok, cache, pos,
                                      active=active)
        finally:
            ops.flash_decode = keep
        return out.float()

    logits = {"mma": step(body("mma", record=True)),
              "cuda_core": step(body("cuda_core")),
              "plain": step(None), "f64": step(f64)}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    pairs = {f"{a}_vs_{b}": rel(logits[a], logits[b])
             for a in logits for b in logits if a < b}
    for name, err in pairs.items():
        print(f"logits {name}: {err:.3e} of max |logit|")

    layers = {"mma": [], "cuda_core": [], "plain": []}
    for q, k, v, lengths in captured:
        exact = exact_attention(q, k, v, lengths)
        outs = {"mma": decode_attn.flash_decode_cuda(q, k, v, lengths)[0],
                "cuda_core": decode_attn.flash_decode_cuda(
                    q, k, v, lengths, body="cuda_core")[0],
                "plain": ref.flash_decode_ref(q, k, v, lengths)[0]}
        for name, o in outs.items():
            layers[name].append(error_stats(o, exact))
    summary = {name: {key: statistics.mean(r[key] for r in rows)
                      for key in ("max_abs", "bias", "bf16_flips")}
               for name, rows in layers.items()}
    for name, s in summary.items():
        print(f"attention vs f64 over {len(captured)} layers, {name}: max "
              f"|err| {s['max_abs']:.3e}, bias {s['bias']:+.3e}, bf16 "
              f"flips {s['bf16_flips']:.3e} (means over layers)")
    print(json.dumps({"nvidia_smi": smi, "logits": pairs,
                      "attention_vs_f64": summary,
                      "layers": len(captured)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
