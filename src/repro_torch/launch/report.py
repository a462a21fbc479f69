"""Render the dry run's tables from its JSON records.

Usage: python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
Prints the summary, the roofline table (H100 peaks, one card; the traced
cells) and the memory table (per device, one row per cell and mesh).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT_DIR


def load(d: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_s(x: float) -> str:
    return f"{x * 1e3:,.2f}" if x < 1 else f"{x * 1e3:,.0f}"


def _gb(x) -> str:
    return "—" if x is None else f"{x / 1e9:.2f}"


def roofline_table(recs: list[dict]) -> str:
    rows = sorted((r for r in recs if r.get("ok") and "roofline" in r),
                  key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | compute ms | memory ms | collective ms | "
           "bottleneck | MODEL_FLOPS/counted | step ms |",
           "|---|---|---:|---:|---:|---|---:|---:|"]
    for r in rows:
        ro = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(ro['compute_s'])} | "
            f"{fmt_s(ro['memory_s'])} | {fmt_s(ro['collective_s'])} | "
            f"{ro['bottleneck']} | {r.get('model_flops_ratio', 0):.2f} | "
            f"{fmt_s(ro['step_time_s'])} |")
    return "\n".join(out)


def dryrun_table(recs: list[dict]) -> str:
    rows = sorted((r for r in recs if r.get("ok")),
                  key=lambda r: (r["arch"], r["shape"], r.get("mesh", "1")))
    out = ["| arch | shape | mesh | params GB | packed GB | state GB | "
           "cache GB | fits one card | ops traced | trace s |",
           "|---|---|---|---:|---:|---:|---:|---|---:|---:|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('mesh', '1')} | "
            f"{_gb(r.get('param_bytes_per_device'))} | "
            f"{_gb(r.get('packed_bytes_per_device'))} | "
            f"{_gb(r.get('state_bytes_per_device'))} | "
            f"{_gb(r.get('cache_bytes_per_device'))} | "
            f"{'yes' if r.get('fits') else 'no'} | "
            f"{r.get('count', {}).get('ops', 0):,} | "
            f"{r.get('trace_s', 0):.0f} |")
    return "\n".join(out)


def summary(recs: list[dict]) -> str:
    ok = [r for r in recs if r.get("ok")]
    bn: dict[str, int] = {}
    for r in ok:
        if "roofline" not in r:
            continue
        key = r["roofline"]["bottleneck"]
        bn[key] = bn.get(key, 0) + 1
    fits = sum(bool(r.get("fits")) for r in ok)
    failed = [f"{r['arch']} × {r['shape']}: {r.get('error', '')[:120]}"
              for r in recs if not r.get("ok")]
    return (f"{sum(bn.values())}/{len(recs)} cells traced on one card; "
            f"{fits} fit its memory; bottlenecks: {bn}"
            + "".join(f"\n  failed: {f}" for f in failed))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Summary\n")
    print(summary(recs))
    print("\n## Roofline (one H100: 989 TFLOP/s bf16, 3.35 TB/s)\n")
    print(roofline_table(recs))
    print("\n## Dry-run memory (one card)\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
