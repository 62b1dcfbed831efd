"""Summarize the port's dry-run reports (``reports/dryrun_torch/*.json``, written
by ``repro_torch.launch.dryrun``) into the roofline table, the reference's
``launch/summarize.py`` table over the port's reports.

PYTHONPATH=src python -m repro_torch.launch.summarize [--mesh single]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import roofline

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"


def load(mesh: str | None = None, reports: Path | None = None) -> list[dict]:
    rows = []
    for p in sorted((reports or REPORTS).glob("*.json")):
        r = json.loads(p.read_text())
        if mesh and r.get("mesh") != mesh:
            continue
        rows.append(r)
    return rows


def fmt_ms(x: float) -> str:
    return f"{x*1e3:.1f}" if x < 10 else f"{x*1e3:.0f}"


def table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute ms | memory ms | coll ms | "
           "bound | useful | fits | note |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rows = sorted(rows, key=lambda r: (r["arch"],
                                       order.get(r["shape"], 9),
                                       r.get("mesh", "")))
    for r in rows:
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                       f"| — | skip | — | — | {r['reason'][:40]} |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                       f"| — | FAIL | — | — | {r.get('error','')[:40]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_ms(r['t_compute'])} | {fmt_ms(r['t_memory'])} "
            f"| {fmt_ms(r['t_collective'])} | {r['bottleneck']} "
            f"| {r['useful_ratio']:.2f} | {'Y' if r['fits'] else 'N'} "
            f"| zero3={r['zero3']} M={r['microbatches']} |")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--reports", type=Path, default=REPORTS)
    args = ap.parse_args(argv)
    rows = load(args.mesh, args.reports)
    print(table(rows))
    ok = [r for r in rows if r["status"] == "ok"]
    fit = sum(1 for r in ok if r["fits"])
    print(f"\n{len(ok)} ok cells, {fit} fit in {roofline.HBM_BYTES / 1e9:g} GB; "
          f"{sum(1 for r in rows if r['status']=='skip')} skips; "
          f"{sum(1 for r in rows if r['status']=='fail')} failures")


if __name__ == "__main__":
    main()
