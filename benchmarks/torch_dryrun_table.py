"""The dry run's records as PERF.md's table rows: one line a combination.

Reads the JSON records that ``python -m repro_torch.launch.dryrun ... --out
DIR`` writes and prints, per record: the placement, a rank's peak (GiB, and
whether it fits the card's 80 GB), the sharded argument GiB, the trace's
TFLOP beside the analytic per-device TFLOP of ``launch.analytic`` (on the
same window variant, at the record's mesh) and their ratio, the collectives'
GB by kind (all-gather / all-reduce / reduce-scatter / all-to-all) and the
trace seconds; a failed record its first error line.

    PYTHONPATH=src python benchmarks/torch_dryrun_table.py build/dryrun
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def row(rec: dict) -> str:
    from repro_torch.configs import get_config
    from repro_torch.launch.analytic import analytic_roofline
    from repro_torch.launch.shapes import INPUT_SHAPES, arch_for_shape
    tag = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |"
    if rec["status"] != "ok":
        why = rec.get("error") or rec.get("skip_reason") or ""
        return f"{tag} {rec['status']}: {why.splitlines()[0][:120]} |"
    shape = INPUT_SHAPES[rec["shape"]]
    cfg = arch_for_shape(get_config(rec["arch"]), shape)
    a = analytic_roofline(cfg, shape, pods=2 if rec["mesh"] == "multi"
                          else 1)
    m, c = rec["memory"], rec["collectives"]
    flops = rec["cost"]["flops"]
    coll = " / ".join(f"{c[k] / 1e9:.3f}" for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"))
    return (f"{tag} {rec['placement']} | {m['peak_bytes'] / 2**30:.2f} "
            f"({'fits' if m['fits'] else 'no'}) | "
            f"{m['sharded_argument_bytes'] / 2**30:.3f} | "
            f"{flops / 1e12:.4f} / {a.flops / 1e12:.4f} "
            f"({flops / a.flops:.2f}×) | {coll} | {rec['trace_s']} |")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="directories of JSON records")
    args = ap.parse_args()
    print("| Arch | Shape | Mesh | Placement | Peak GiB (fits 80 GB) | "
          "Sharded GiB | TFLOP / analytic (×) | Collective GB: AG / AR / RS"
          " / A2A | Trace s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for d in args.dirs:
        for path in sorted(Path(d).glob("*.json")):
            print(row(json.loads(path.read_text())))


if __name__ == "__main__":
    main()
