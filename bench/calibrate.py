#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 bench/calibrate.py --workload sk2000.anneal --seeds 101 102 ... --control-seeds 1 2 3

For each seed: the cell built from it, its first `check_jobs` jobs run
through the program at the cell's own sizes, and the numbers of the
comparison with the plain reference (the lower readings: the largest over
the seeds bounds what sound runs give). For each control seed: the same
jobs with the control, the reference computed in the precision below the
configuration's, in the program's place (where a job starts from the
program's own state, as CD's do, from that state) (the upper readings: the smallest
over the seeds). One JSON line a seed, then the extremes. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, control: bool, device: str = "cuda", root: Path = ROOT) -> dict:
    """The numbers compared for `seed`'s first check_jobs jobs, from the
    program (or from the control standing in for it)."""
    from bench import harness
    from bench.common import load_module

    s = harness.spec(root, name)
    entry = load_module("entries", s.traffic["entry"], root / "bench")
    cell = entry.Cell(s.config, s.traffic, seed, device, root / "bench")
    kept = {j: cell.job(j) for j in range(s.traffic["check_jobs"])}
    cell.release()
    return cell.compare(kept, control=control)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lower, upper = {}, {}
    for control, seeds, into, pick in ((False, args.seeds, lower, max),
                                       (True, args.control_seeds, upper, min)):
        for seed in seeds:
            t = time.perf_counter()
            got = readings(args.workload, seed, control)
            print(json.dumps({"workload": args.workload, "control": control, "seed": seed,
                              "numbers": got, "s": round(time.perf_counter() - t, 3)}), flush=True)
            for k, v in got.items():
                into[k] = pick(into.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
