"""Aggregate the dry-run's JSONs into the dry-run and roofline tables.

Counterpart of ``repro/launch/report.py``: the same three tables from the
records ``launch.dryrun`` writes, with the HBM column against the H100's
80 GB (``fits_h100_hbm``) and the trace's seconds where the reference shows
its compile's.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import os

from ..configs.base import SHAPES
from ..configs.registry import ARCH_IDS

__all__ = ["load", "dryrun_table", "roofline_table", "interesting_cells", "main"]

HBM = 80 * 10**9   # the H100 SXM5's 80 GB


def fmt_b(x):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(x) < 1024:
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}PB"


def load(dirname):
    recs = {}
    for f in os.listdir(dirname):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(dirname, f)) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | status | HBM need/dev | fits 80G | trace s |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_IDS:
        for s in SHAPES:
            for mesh in ("16x16", "2x16x16"):
                r = recs.get((a, s, mesh))
                if r is None:
                    lines.append(f"| {a} | {s} | {mesh} | MISSING | | | |")
                    continue
                st = r["status"]
                if st != "ok":
                    short = "skip (full-attn @500k)" if st.startswith("skip") else st[:40]
                    lines.append(f"| {a} | {s} | {mesh} | {short} | - | - | - |")
                    continue
                need = r.get("hbm_need_bytes", 0)
                secs = r.get("t_trace_s", 0) or r.get("t_probe_s", 0)
                lines.append(
                    f"| {a} | {s} | {mesh} | ok | {fmt_b(need)} | "
                    f"{'yes' if r.get('fits_h100_hbm') else 'NO'} | "
                    f"{secs:.0f} |"
                )
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | t_comp s | t_mem s | t_coll s | bottleneck | "
        "model TFLOP | useful frac | MFU bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_IDS:
        for s in SHAPES:
            r = recs.get((a, s, "16x16"))
            if r is None or r["status"] != "ok":
                continue
            lines.append(
                f"| {a} | {s} | {r['t_compute_s']:.4g} | {r['t_memory_s']:.4g} | "
                f"{r['t_collective_s']:.4g} | **{r['bottleneck']}** | "
                f"{r['model_flops']/1e12:.3g} | {r['useful_fraction']:.3f} | "
                f"{r['mfu_bound']:.4f} |"
            )
    return "\n".join(lines)


def interesting_cells(recs) -> str:
    """Rank cells for the hillclimb: worst MFU bound / most collective-bound."""
    rows = [r for r in recs.values()
            if r.get("status") == "ok" and r["mesh"] == "16x16"]
    rows.sort(key=lambda r: r.get("mfu_bound", 0))
    out = ["worst roofline fraction (MFU bound):"]
    for r in rows[:5]:
        out.append(f"  {r['arch']} x {r['shape']}: mfu_bound={r['mfu_bound']:.4f} "
                   f"bottleneck={r['bottleneck']}")
    coll = sorted(rows, key=lambda r: -(r["t_collective_s"] /
                                        max(r["t_compute_s"] + r["t_memory_s"], 1e-12)))
    out.append("most collective-bound (t_coll / (t_comp+t_mem)):")
    for r in coll[:5]:
        ratio = r["t_collective_s"] / max(r["t_compute_s"] + r["t_memory_s"], 1e-12)
        out.append(f"  {r['arch']} x {r['shape']}: ratio={ratio:.2f}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--what", default="all", choices=["all", "dryrun", "roofline",
                                                      "interesting"])
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.what in ("all", "dryrun"):
        print("## Dry-run grid\n")
        print(dryrun_table(recs))
        print()
    if args.what in ("all", "roofline"):
        print("## Roofline (single-pod 16x16, H100)\n")
        print(roofline_table(recs))
        print()
    if args.what in ("all", "interesting"):
        print("## Hillclimb candidates\n")
        print(interesting_cells(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
