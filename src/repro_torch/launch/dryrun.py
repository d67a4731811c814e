"""Dry run of the production meshes on meta tensors.

The port of `repro/launch/dryrun.py`. For every (architecture x input
shape) cell and each production mesh (single-pod 16x16, multi-pod
2x16x16), in a fake process-group world of 256 or 512 ranks whose rank 0
this process is:

    state / params, batch, caches = meta-device DTensors placed by rules_for
    with StepCounter():  run the step once   -> per-rank counts
    roofline terms at the H100's rates        -> artifacts/dryrun_torch/

Shapes run the production steps: train_4k the FULL train step (forward,
backward, AdamW update), prefill_32k `prefill` (attention through the
kernel's plain version, `mode="reference"`: shapes only, never a route on a
CUDA tensor), the decode shapes `decode_step` (one token against a
seq_len KV cache, written at position seq_len - 1).

Where the JAX package lowers and compiles, this traces eagerly: `trace_s`
takes the place of `compile_s`. The memory record holds
`argument_size_in_bytes`, the bytes of this rank's shards of the step's
inputs; `temp_size_in_bytes` and the other sizes of XLA's memory analysis
are null (nothing here measures a peak of temporaries).

Results are cached per cell in artifacts/dryrun_torch/<cell>.json, so the
sweep is resumable; a cell that raises is recorded as an error with its
exception and the sweep goes on; so is a cell that traces longer than
`CELL_TIMEOUT_S` seconds (DTensor's redistribution planner searches a
graph of placements whose size grows with the mesh's dimensions: on the
3-D multi-pod mesh some cells do not finish). One arch on one mesh is
traced in this process (the fake world is its default process group); a
sweep of more (no `--arch`, or `--mesh both`) runs each arch and mesh in a
child process of its own, as many at once as the host has cores (`sweep`).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a] [--shape s]
        [--mesh single|multi|both] [--force] [--list] [--artifacts DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cell_skip_reason, get_config, list_archs
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.step_analysis import StepCounter
from repro_torch.models import model
from repro_torch.sharding import partition
from repro_torch.train import train_step as ts

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")
CELL_TIMEOUT_S = 240  # seconds a cell may trace before it is recorded as an error


def _placed(tensors: dict, axes: dict, mesh, rules) -> dict:
    pl = partition.struct_shardings(tensors, axes, mesh, rules)
    return {k: partition.distribute(v, mesh, pl[k]) for k, v in tensors.items()}


def _placed_caches(caches: list, axes: list, mesh, rules) -> list:
    out = []
    for state, ax in zip(caches, axes):
        fields = _placed(state._asdict(), ax._asdict(), mesh, rules)
        out.append(type(state)(**fields))
    return out


def _local_bytes(tensors) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in tensors)


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str):
    """Trace one cell on the meta device under the step counter; returns
    the result record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = cell_skip_reason(cfg, shape)
    if skip:
        return {"status": "skipped", "reason": skip}
    cfg = sp.serve_overrides(cfg, shape)
    rules = sp.rules_for(cfg, shape, mesh)
    t0 = time.time()

    with partition.axis_rules(mesh, rules):
        batch = sp.batch_specs(cfg, shape)
        if shape.kind == "train":
            tcfg = ts.TrainConfig()
            state = ts.init_state(cfg, tcfg, 0, sp.META, mesh=mesh, rules=rules)
            batch = _placed(batch, sp.batch_axes(cfg, shape), mesh, rules)
            step_fn = ts.make_train_step(cfg, tcfg, param_axes=ts.state_axes(state).params)
            args = [*state.params.parameters(), *state.opt.mu.values(), *state.opt.nu.values(),
                    *batch.values()]
            with StepCounter() as counter:
                step_fn(state, batch, torch.Generator().manual_seed(0))
            n_params = rl.count_params(state.params)
        else:
            m = model.init_params(cfg, 0, sp.META)
            ts.shard_params(m, mesh, rules)
            caches = _placed_caches(sp.cache_specs(cfg, shape), model.cache_axes(cfg), mesh, rules)
            args = [*m.parameters(), *(t for c in caches for t in c)]
            if shape.kind == "prefill":
                batch = _placed(batch, sp.batch_axes(cfg, shape), mesh, rules)
                args += list(batch.values())
                extra = {k: v for k, v in batch.items() if k in ("patch_embeds", "frames")}
                with StepCounter() as counter, ts.sharded_step():
                    m.prefill(batch["tokens"], caches, mode="reference", **extra)
            else:
                tokens = _placed({"tokens": sp._meta((shape.global_batch,), torch.int32)},
                                 {"tokens": ("kv_batch",)}, mesh, rules)["tokens"]
                args.append(tokens)
                with StepCounter() as counter, ts.sharded_step():
                    m.decode_step(tokens, shape.seq_len - 1, caches)
            n_params = rl.count_params(m)
        t_trace = time.time() - t0

    summary = counter.summary()
    n_chips = partition.mesh_size(mesh)
    mf_global = rl.model_flops(get_config(arch), shape, n_params)
    terms = rl.compute_terms_from_summary(summary, mf_global / n_chips)
    mem = {"temp_size_in_bytes": None, "argument_size_in_bytes": _local_bytes(args),
           "output_size_in_bytes": None, "alias_size_in_bytes": None,
           "generated_code_size_in_bytes": None}
    return {
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": int(n_chips),
        "n_params": int(n_params),
        "trace_s": round(t_trace, 1),
        "memory": mem,
        "cost_raw": {k: v for k, v in (("flops", summary.flops),
                                        ("bytes accessed", summary.hbm_bytes)) if v},
        "collectives": {
            "ici_bytes": summary.ici_bytes,
            "dcn_bytes": summary.dcn_bytes,
            "by_kind": summary.coll_by_kind,
            "n_while": summary.n_while,
        },
        "hbm_bytes_upper": summary.hbm_bytes_upper,
        "roofline": terms.to_dict(),
    }


def fake_world(mesh_name: str):
    """Initialise a fake process group of the mesh's size (this process is
    rank 0) and return the production mesh over it, on the CPU."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run's fake world needs a process of its own")
    shape, axes = production_shape(mesh_name == "multi")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(torch.tensor(shape).prod()))
    return partition.make_mesh_compat(shape, axes, "cpu")


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise TimeoutError in the main thread after `seconds`."""
    def expire(signum, frame):
        raise TimeoutError(f"the cell traced for more than {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch, shape_name, mesh_name, mesh, force=False, art_dir=ART_DIR):
    os.makedirs(art_dir, exist_ok=True)
    path = os.path.join(art_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            print(f"[cached] {arch} x {shape_name} x {mesh_name}: {rec['status']}")
            return rec
    print(f"[trace ] {arch} x {shape_name} x {mesh_name} ...", flush=True)
    try:
        with _time_limit(CELL_TIMEOUT_S):
            rec = lower_cell(arch, shape_name, mesh, mesh_name)
    except Exception as e:  # a cell that fails is recorded; the sweep goes on
        rec = {
            "status": "error",
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_name,
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-3000:],
        }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (
            f" trace={rec['trace_s']}s bottleneck={r['bottleneck']}"
            f" t=(c {r['t_compute']:.3e}, m {r['t_memory']:.3e}, x {r['t_collective']:.3e})"
        )
    elif status == "error":
        extra = " " + rec["error"][:160]
    print(f"[{status:6}] {arch} x {shape_name} x {mesh_name}{extra}", flush=True)
    return rec


def sweep(cells, force=False, art_dir=ART_DIR) -> list[dict]:
    """Trace `cells`, (arch, shape or None for all four, mesh name)
    triples, each in a child process of its own (a fake world needs its
    own process), as many at once as the host has cores. Each child's lines
    are printed as it ends, then the tally; returns the cells' records.
    Raises if a child exits non-zero, with its stderr."""
    from concurrent.futures import ThreadPoolExecutor

    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")

    def run(cell):
        arch, shape, mesh_name = cell
        shapes = [shape] if shape else list(SHAPES)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             *(["--shape", shape] if shape else []), "--mesh", mesh_name,
             *(["--force"] if force else []), "--artifacts", art_dir],
            capture_output=True, text=True, env=env,
            timeout=len(shapes) * CELL_TIMEOUT_S + 300)
        if proc.returncode:
            raise RuntimeError(f"dry run of {arch} x {shape or 'every shape'} x {mesh_name} "
                               f"exited {proc.returncode}: {proc.stderr[-3000:]}")
        recs = []
        for s in shapes:
            with open(os.path.join(art_dir, f"{arch}__{s}__{mesh_name}.json")) as f:
                recs.append(json.load(f))
        return proc.stdout, recs

    records = []
    with ThreadPoolExecutor(max(1, min(len(cells), os.cpu_count() or 1))) as pool:
        for out, recs in pool.map(run, cells):
            print("\n".join(ln for ln in out.splitlines() if ln.startswith("[")
                            and not ln.startswith("[trace")), flush=True)
            records += recs
    results = {"ok": 0, "skipped": 0, "error": 0}
    for rec in records:
        results[rec["status"]] += 1
    print(f"\ndone: {results}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--artifacts", default=ART_DIR, help="where the cell records go")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    if args.list:
        for a in archs:
            for s in shapes:
                skip = cell_skip_reason(get_config(a), SHAPES[s])
                print(f"{a:22} {s:12} {'SKIP: ' + skip if skip else 'runnable'}")
        return

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if len(archs) * len(meshes) > 1:
        sweep([(a, args.shape, m) for m in meshes for a in archs], args.force, args.artifacts)
        return

    import torch.distributed as dist

    mesh = fake_world(args.mesh)
    try:
        results = {"ok": 0, "skipped": 0, "error": 0}
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, args.mesh, mesh, force=args.force, art_dir=args.artifacts)
                results[rec["status"]] = results.get(rec["status"], 0) + 1
        print(f"\ndone: {results}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
