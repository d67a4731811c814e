#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`) on NVIDIA cards.

    python3 bench/run.py --workload sk2000.anneal --seed 7 --seconds 30 --trace 0

from the root of a checkout. One run of one cell of `BENCHMARK.json`: set-up
(the instance from the seed, one warm job of the cell's shapes), a closed
loop of jobs for `--seconds`, the comparison with the plain reference that
decides `correct`, and, as the last line of standard output, one JSON object
with `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks` (each number compared beside its limit, also
the last lines of standard error). Exits nonzero, printing no result, on a
machine with fewer CUDA devices than the cell asks for, or when a module of
JAX or of the JAX package `repro` was loaded. See `bench/harness.py`.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up runs from here to the first timed job

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    # every cache a run writes stays at a fixed path inside the checkout (the
    # program's kernels build into src/repro_torch/kernels/_build)
    cache = ROOT / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")  # one client, few threads
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
