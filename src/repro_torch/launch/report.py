"""The dry run's two tables (cells, roofline) from its artifacts.

The port of `repro/launch/report.py`, over `artifacts/dryrun_torch/`:

    PYTHONPATH=src python -m repro_torch.launch.report [--artifacts DIR]

Prints markdown to stdout. Every number is modelled: per-rank counts of
the torch ops one rank dispatches on meta tensors, scored at an H100 SXM's
data-sheet rates; nothing is measured on a card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import roofline as rl

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")

HW_NOTE = (
    f"GPUs: H100 SXM (data sheet, dense, 700 W) — {rl.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
    f"{rl.HBM_BW / 1e12:.2f} TB/s HBM, {rl.NVLINK_BW / 1e9:.0f} GB/s NVLink a direction inside "
    f"a node of {rl.NODE_SIZE}, {rl.NET_BW / 1e9:.0f} GB/s a GPU across nodes. Terms are "
    "seconds per step, per rank, modelled from the per-op count of one rank's eager step "
    "(see `repro_torch/launch/step_analysis.py`), not measured."
)


def _load(mesh, art):
    recs = {}
    for f in sorted(glob.glob(os.path.join(art, f"*__{mesh}.json"))):
        with open(f) as fh:
            recs[os.path.basename(f).replace(f"__{mesh}.json", "")] = json.load(fh)
    return recs


def _fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.1f}"


def dryrun_table(art=ART):
    print("### Dry-run results (one traced step per cell)\n")
    for mesh, label in (("single", "16x16 (256 GPUs)"), ("multi", "2x16x16 (512 GPUs)")):
        recs = _load(mesh, art)
        ok = sum(1 for r in recs.values() if r["status"] == "ok")
        sk = sum(1 for r in recs.values() if r["status"] == "skipped")
        er = sum(1 for r in recs.values() if r["status"] == "error")
        print(f"**Mesh {label}** — {ok} traced, {sk} skipped, {er} errors\n")
        print("| cell | status | params | trace s | temp GiB/GPU | args GiB/GPU "
              "| collective ops (intra / inter-node GB/GPU) |")
        print("|---|---|---|---|---|---|---|")
        for key, r in recs.items():
            if r["status"] == "skipped":
                print(f"| {key} | skipped: {r['reason'][:40]}... | | | | | |")
                continue
            if r["status"] == "error":
                print(f"| {key} | ERROR {r['error'][:60]} | | | | | |")
                continue
            mem = r["memory"]
            coll = r["collectives"]
            kinds = ",".join(f"{k}:{v['count']}" for k, v in coll["by_kind"].items())
            print(
                f"| {key} | ok | {r['n_params']/1e9:.2f}B | {r['trace_s']} "
                f"| {_fmt_bytes(mem['temp_size_in_bytes'])} "
                f"| {_fmt_bytes(mem['argument_size_in_bytes'])} "
                f"| {kinds} ({coll['ici_bytes']/1e9:.1f} / {coll['dcn_bytes']/1e9:.1f}) |"
            )
        print()


def roofline_table(art=ART):
    print("### Roofline (single-pod 16x16, per GPU per step)\n")
    print(HW_NOTE + "\n")
    print("| cell | t_compute | t_memory | t_collective | bottleneck | roofline frac "
          "| MODEL/counted flops | one-line lever |")
    print("|---|---|---|---|---|---|---|---|")
    for key, r in _load("single", art).items():
        if r["status"] != "ok":
            print(f"| {key} | {r['status']} | | | | | | |")
            continue
        rf = r["roofline"]
        t = max(rf["t_compute"], rf["t_memory"], rf["t_collective"])
        frac = rf["t_compute"] / t if t else 0.0
        print(
            f"| {key} | {rf['t_compute']:.3e} | {rf['t_memory']:.3e} | {rf['t_collective']:.3e} "
            f"| {rf['bottleneck']} | {frac:.2f} | {rf['useful_ratio']:.2f} | {_lever(rf)} |"
        )
    print()


def _lever(rf):
    if rf["bottleneck"] == "collective":
        return "cut per-layer activation gathers (sharding/wire-dtype)"
    if rf["bottleneck"] == "memory":
        if rf["useful_ratio"] < 0.2:
            return "raise arithmetic intensity (fuse/batch small ops)"
        return "cut activation traffic (remat policy / dtype)"
    return "compute-bound: close MODEL/counted gap (less remat)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=ART)
    args = ap.parse_args(argv)
    dryrun_table(args.artifacts)
    roofline_table(args.artifacts)


if __name__ == "__main__":
    main()
