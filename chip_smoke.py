#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, no arguments

Phases, each printed as one JSON line; any failure raises and the script
exits nonzero without printing the final result line:

  1. device   — the card's name and power limit (nvidia-smi), its compute
                capability (must be 9.0), and the nvcc build of the kernels
                in src/repro_torch/kernels/csrc (one nvcc per source, run
                together).
  2. check    — each kernel against its plain PyTorch version on the card at
                (B, N) = (1,5) (8,64) (3,130) (64,300) (256,2048) (3,4099),
                asymmetric random int8 J: dense_field's int32 accumulators
                exactly, its fields within 1 ulp; tau_leap_step's spins equal
                except where |u - p| <= 1e-6 (p from the plain version).
  3. timing   — CUDA-event median of each kernel at (256, 2048), beside its
                plain version, torch._int_mm (the library int8 product,
                timed here only) and the device-memory/tensor-core bound.
  4. main     — sampler_api.run(TauLeap(dt=0.1), backend="cuda") on SK
                n=2048 seed 0, 256 chains x 2000 steps, geometric(0.3, 3.0)
                annealing, with and without first_hit, and the same run on
                backend="ref"; then the int8 fields of the final states
                through ops.dense_field. Launch counters are zeroed before
                and read after each path.
  5. stats    — a grid-exact n=5 problem through the tau_leap_step kernel,
                64 chains x 16000 steps: TV distance to exact enumeration.

The last two lines are the kernels summary and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

CHECK_SHAPES = [(1, 5), (8, 64), (3, 130), (64, 300), (256, 2048), (3, 4099)]
TIME_SHAPE = (256, 2048)
P_BAND = 1e-6  # spins may differ only where the uniform is this close to p


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for the work on one H100 and what bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, n: int = 100, warmup: int = 10) -> float:
    """Median CUDA-event time of one call of `fn` over n calls.

    A sleep kernel queued first keeps the device behind the host, so every
    event pair brackets device work only, not host enqueue time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for i in range(n):
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke.py: {SRC / 'repro_torch'} not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels need an H100",
              file=sys.stderr)
        return 2

    from repro_torch.core import ising, problems
    from repro_torch.core.sampler_api import TauLeap, geometric, run
    from repro_torch.kernels import _build, dense_field, ops, ref, tau_leap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, the kernels need (9, 0)")
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in (build_dir / f"{name}.log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name in _build.LAUNCHERS
    }
    emit({"phase": "device", "nvidia_smi": smi, "capability": list(cap),
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # -- 2. kernels against their plain versions ----------------------------
    rng = np.random.default_rng(0)
    scale = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=dev)
    dt = torch.tensor(0.3, dtype=torch.float32, device=dev)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    err = {"dense_field": 0.0, "tau_leap_step": 0.0}
    mism = {"dense_field": 0, "tau_leap_step": 0}
    near = 0
    for B, N in CHECK_SHAPES:
        s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, N)).astype(np.float32), device=dev)
        s_i8 = s.to(torch.int8)
        J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
        b = torch.as_tensor(rng.normal(0.0, 0.2, N).astype(np.float32), device=dev)
        u = torch.as_tensor(rng.random((B, N)).astype(np.float32), device=dev)
        beta = torch.as_tensor(rng.uniform(0.3, 3.0, B).astype(np.float32), device=dev)

        acc_k = dense_field.dense_field(s_i8, J, torch.zeros_like(b), one)
        acc_r = ref.dense_acc_ref(s_i8, J)
        n_acc = int((acc_k != acc_r.to(torch.float32)).sum())  # |acc| < 2^24: exact in f32
        h_k = dense_field.dense_field(s_i8, J, b, scale).cpu().numpy()
        h_r = ref.dense_field_ref(s_i8, J, b, scale).cpu().numpy()
        ulps = np.testing.assert_array_max_ulp(h_k, h_r, maxulp=1)
        if n_acc:
            raise AssertionError(f"dense_field ({B},{N}): {n_acc} int32 accumulators differ")
        err["dense_field"] = max(err["dense_field"], float(np.max(np.abs(h_k - h_r))))
        mism["dense_field"] += int(np.count_nonzero(ulps))

        out_k = tau_leap.tau_leap_step(s, J, b, scale, u, dt, beta)
        p = ref.tau_leap_flip_prob_ref(s, J, beta[:, None] * b, (beta * scale)[:, None], dt)
        out_r = torch.where(u < p, -s, s)
        differ = out_k != out_r
        in_band = (u - p).abs() <= P_BAND
        bad = int((differ & ~in_band).sum())
        if bad:
            raise AssertionError(f"tau_leap_step ({B},{N}): {bad} spins differ outside the band")
        err["tau_leap_step"] = max(
            err["tau_leap_step"], float(((out_k - out_r).abs() * ~in_band).max())
        )
        mism["tau_leap_step"] += int(differ.sum())
        near += int(in_band.sum())
        emit({"phase": "check", "B": B, "N": N, "dense_field_max_ulp": int(ulps.max()),
              "dense_field_acc_mismatches": n_acc,
              "tau_leap_mismatches": int(differ.sum()), "tau_leap_in_band": int(in_band.sum())})
    torch.cuda.synchronize()

    # -- 3. timings at the main path's shape --------------------------------
    B, N = TIME_SHAPE
    s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, N)).astype(np.float32), device=dev)
    s_i8 = s.to(torch.int8)
    J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
    b = torch.zeros(N, dtype=torch.float32, device=dev)
    u = torch.rand((B, N), device=dev)
    beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
    ms = {
        "dense_field": time_ms(torch, lambda: dense_field.dense_field(s_i8, J, b, scale)),
        "dense_field_plain": time_ms(torch, lambda: ref.dense_field_ref(s_i8, J, b, scale)),
        "tau_leap_step": time_ms(
            torch, lambda: tau_leap.tau_leap_step(s, J, b, scale, u, dt, beta)),
        "tau_leap_step_plain": time_ms(
            torch, lambda: ops.tau_leap_step(s, J, b, scale, u, dt, beta=beta, mode="reference")),
        "int_mm": time_ms(torch, lambda: torch._int_mm(s_i8, J.t())),
    }
    bounds = {
        "dense_field": bound(N * N + B * N + 4 * N + 4 + 4 * B * N, 2.0 * B * N * N),
        "tau_leap_step": bound(N * N + 3 * 4 * B * N + 4 * N + 4 * B + 8, 2.0 * B * N * N),
    }
    emit({"phase": "timing", "B": B, "N": N, "ms": ms,
          "bound_ms": {k: v[0] for k, v in bounds.items()}, "nvidia_smi": smi})

    # -- 4. the main path ---------------------------------------------------
    n, n_steps, n_chains = 2048, 2000, 256
    prob = problems.sk_instance(n, 0)
    kw = dict(n_steps=n_steps, n_chains=n_chains, schedule=geometric(0.3, 3.0),
              sample_every=100, timeit=True)
    main = {}
    for label, backend, first_hit in (("cuda_first_hit", "cuda", -0.70 * n),
                                      ("cuda", "cuda", None),
                                      ("ref_first_hit", "ref", -0.70 * n)):
        tau_leap.launches = dense_field.launches = 0
        res = run(prob, TauLeap(dt=0.1), 0, first_hit=first_hit, backend=backend, **kw)
        counts = {"tau_leap_step": tau_leap.launches, "dense_field": dense_field.launches}
        e_final = prob.energy(res.s)
        if not bool(torch.isfinite(res.energies).all()) or not bool(torch.isfinite(e_final).all()):
            raise AssertionError(f"{label}: non-finite energies")
        want = 2 * n_steps if backend == "cuda" else 0  # timeit runs two passes
        if counts["tau_leap_step"] != want:
            raise AssertionError(f"{label}: tau_leap_step launched {counts['tau_leap_step']} "
                                 f"times, expected {want} ({n_steps} per pass)")
        main[label] = {
            "backend": backend, "first_hit": first_hit, "launches": counts,
            "chain_steps_per_s": res.timing.chain_steps_per_s,
            "spin_updates_per_s": res.timing.chain_steps_per_s * n,
            "wall_s": res.timing.wall_s, "compile_s": res.timing.compile_s,
            "hit_fraction": None if res.hit is None else float(res.hit.float().mean()),
            "final_energy_per_spin": float(e_final.mean()) / n,
            "final_state": res.s,
        }
    for label, m in main.items():
        if m["final_energy_per_spin"] >= -0.6:
            raise AssertionError(f"{label}: final energy per spin "
                                 f"{m['final_energy_per_spin']} is not below -0.6")
    path_launches = main["cuda_first_hit"]["launches"]

    # The int8 fields of the final states through ops.dense_field: the
    # quantized energy 0.5 s.h + b.s must agree with the float energy.
    s_fin = main["cuda_first_hit"]["final_state"]
    j_i8, j_scale = ops.quantize_dense(prob.J)
    tau_leap.launches = dense_field.launches = 0
    h = ops.dense_field(s_fin.to(torch.int8), j_i8, torch.zeros_like(prob.b), j_scale)
    fields_launches = dense_field.launches
    if fields_launches != 1:
        raise AssertionError(f"ops.dense_field launched {fields_launches} kernels, expected 1")
    e_q = 0.5 * (s_fin * h).sum(-1) + (prob.b * s_fin).sum(-1)
    rel = float(((e_q - prob.energy(s_fin)).abs() / prob.energy(s_fin).abs()).max())
    if not rel < 1e-2:
        raise AssertionError(f"quantized energy of the final states is off by {rel}")
    for m in main.values():
        del m["final_state"]
    emit({"phase": "main", "problem": "sk_instance(2048, seed=0)", "n_steps": n_steps,
          "n_chains": n_chains, "runs": main, "fields_path": {
              "launches": {"dense_field": fields_launches}, "max_rel_energy_err": rel},
          "nvidia_smi": smi})

    # -- 5. statistics through the kernel -----------------------------------
    srng = np.random.default_rng(0)
    n5 = 5
    codes = np.triu(srng.integers(-126, 127, (n5, n5)), 1)
    codes = codes + codes.T
    codes[0, 1] = codes[1, 0] = 127  # pin max-abs: quantization is lossless
    small = ising.DenseIsing.from_numpy(codes / 127.0, srng.normal(0, 0.2, n5))
    tau_leap.launches = 0
    # |J| reaches 1 and chains relax slowly: 4000 steps do not reliably
    # reach the bound (TV 0.016-0.070 over 4 seeds on CPU), 16000 do
    res5 = run(small, TauLeap(dt=0.05), 1, n_steps=16000, n_chains=64, sample_every=4,
               backend="cuda")
    stats_launches = tau_leap.launches
    _, p_exact = ising.enumerate_boltzmann(small)
    bits = (res5.samples.reshape(-1, n5).cpu().numpy() > 0).astype(np.int64)
    hist = np.bincount(bits @ (1 << np.arange(n5)), minlength=2**n5)
    tv = 0.5 * float(np.abs(hist / hist.sum() - p_exact).sum())
    if not tv < 0.06:
        raise AssertionError(f"TV distance {tv} to exact enumeration is not below 0.06")
    emit({"phase": "stats", "n": n5, "n_chains": 64, "n_steps": 16000, "tv": tv,
          "launches": {"tau_leap_step": stats_launches}})

    # -- summary -------------------------------------------------------------
    def entry(name, source, replaces, launches, bkey, plain_key):
        bms, by = bounds[bkey]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err[bkey], "mismatches": mism[bkey],
                "ms": ms[bkey], "plain_ms": ms[plain_key], "bound_ms": bms, "bound_by": by,
                "library_ms": ms["int_mm"]}

    emit({"kernels": [
        entry("tau_leap_step", "src/repro_torch/kernels/csrc/tau_leap.cu",
              "src/repro/kernels/tau_leap.py:82", path_launches["tau_leap_step"],
              "tau_leap_step", "tau_leap_step_plain"),
        entry("dense_field", "src/repro_torch/kernels/csrc/dense_field.cu",
              "src/repro/kernels/dense_field.py:72", fields_launches,
              "dense_field", "dense_field_plain"),
    ], "tau_leap_in_band": near})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
