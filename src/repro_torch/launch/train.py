"""Training entry point: the token pipeline, the train step and the
checkpoint/restart loop, on one device or sharded over a DeviceMesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \
        --steps 50 --batch 8 --seq 64 --device cpu
    python -m repro_torch.launch.train --arch gemma-2b --steps 10 --batch 4 --seq 1024 \
        --ckpt-dir <fresh dir>   # full width on the card
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...  # sharded

The port of `repro/launch/train.py`, with its flags, defaults (full width
unless `--reduced`; lr 3e-3; a checkpoint every 20 steps and at the last
step into `--ckpt-dir`, by default `repro_train_ckpt` in the temporary
directory) and printed lines, plus `--device` (default cuda; it raises
without a card).

Sharding: `--mesh DxM` (axes data, model) or `PxDxM` (pod, data, model),
`--production-mesh` (16x16, with `--multi-pod` 2x16x16; `--multi-pod`
alone is refused). Under torchrun (WORLD_SIZE set) the process group is
initialised from torchrun's environment (NCCL on cuda, gloo on the CPU),
each rank takes the card of its LOCAL_RANK, and the mesh must have exactly
WORLD_SIZE devices, or the driver exits with an error. Without torchrun
only a one-device mesh is accepted, and it runs the unsharded step. `train(..., mesh=DeviceMesh)` is the sharded path
at any size, 1x1 included: the state is placed by the logical-axis rules of
`launch.specs.rules_for`, the step runs under `partition.axis_rules`, and
each rank builds the pipeline's global batch and distributes it along the
batch axes (JAX's jit shards `pipe.global_batch(i)` so). Rank 0 prints and
writes the checkpoints, gathered to whole tensors in the same format.

Fault tolerance: the data pipeline is a pure function of the step, a
checkpoint commits atomically, and a run restores the newest committed
step in `--ckpt-dir` and replays from there (into the mesh's placements
when sharded). Every run that should start from scratch needs a fresh
`--ckpt-dir`.

`train(...)` is the loop under `main`; both return a summary: the losses,
grad norms and walls of the steps run, the tokens a step, the device's peak
memory, and the final state.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.ising import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_test_mesh, production_shape
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.sharding import partition
from repro_torch.train import checkpoint
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step, state_axes

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_train_ckpt")


def parse_mesh(spec: str) -> dict[str, int]:
    """'DxM' or 'PxDxM' -> the axes' sizes, named as the JAX driver names them."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in (2, 3):
        raise ValueError(f"mesh {spec!r}: expected 'DxM' or 'PxDxM'")
    return dict(zip(("data", "model") if len(dims) == 2 else ("pod", "data", "model"), dims))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1", help='"DxM" or "PxDxM", e.g. 16x16')
    ap.add_argument("--production-mesh", action="store_true", help="use the 16x16 pod mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.multi_pod and not args.production_mesh:
        ap.error("--multi-pod picks the production mesh's shape; it needs --production-mesh")
    if args.production_mesh:
        shape, axes = production_shape(args.multi_pod)
        dims = dict(zip(axes, shape))
    else:
        try:
            dims = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))

    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        warmup_steps=max(2, args.steps // 20),
        microbatch=args.microbatch,
        compress_grads=args.compress_grads,
    )
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if not world:
        if math.prod(dims.values()) != 1:
            ap.error(f"mesh {dims}: {math.prod(dims.values())} devices need as many ranks; "
                     "run under torchrun --nproc-per-node N")
        return train(cfg, tcfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     device=args.device, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if math.prod(dims.values()) != world:
        ap.error(f"mesh {dims} has {math.prod(dims.values())} devices; torchrun launched "
                 f"{world} ranks")
    import torch.distributed as dist

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_test_mesh(tuple(dims.values()), tuple(dims), dev.type)
        return train(cfg, tcfg, steps=args.steps, batch=args.batch, seq=args.seq, device=dev,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, mesh=mesh)
    finally:
        dist.destroy_process_group()


def batch_at(cfg, pipe: TokenPipeline, step: int) -> dict:
    """The pipeline's global batch at `step`, with zero image patches for a
    vlm and zero frames for the audio family, as the JAX drivers add them."""
    batch = pipe.global_batch(step)
    B = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model), device=pipe.device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), device=pipe.device)
    return batch


def _host(t) -> float:
    """A metric's value on the host (a DTensor's whole value)."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def train(cfg, tcfg: TrainConfig, *, steps: int, batch: int, seq: int, device=None,
          ckpt_dir: str | None = None, ckpt_every: int = 20, mesh=None) -> dict:
    """Train `steps` steps from seed 0, or from the newest committed step in
    `ckpt_dir` (None: no checkpoints), saving every `ckpt_every` steps and
    at the last. The step's generator (the Boltzmann router's) is seeded
    with the step, as the JAX driver keys it. With `mesh` (a DeviceMesh on
    `device`'s type) the state and the batches are sharded by the rules of
    `specs.rules_for` (module docstring)."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for a {dev.type} device")
    rank = 0 if mesh is None else mesh.get_rank()
    log = print if rank == 0 else (lambda *a, **k: None)
    rules = sp.rules_for(cfg, ShapeConfig("cli", seq, batch, "train"), mesh) if mesh else None
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
                         dev)
    with (partition.axis_rules(mesh, rules) if mesh is not None else contextlib.nullcontext()):
        state = init_state(cfg, tcfg, 0, dev, mesh=mesh, rules=rules)
        step_fn = make_train_step(cfg, tcfg,
                                  param_axes=state_axes(state).params if mesh else None)
        place = _batch_placement(cfg, pipe, mesh, rules) if mesh is not None else None

        start = 0
        latest = checkpoint.latest_step(ckpt_dir) if ckpt_dir else None
        if latest is not None:
            state = convert.load_train_state(cfg, state, checkpoint.restore(ckpt_dir, latest))
            start = latest
            log(f"[recovery] resumed from committed step {latest}")

        n_params = sum(p.numel() for p in state.params.parameters())
        shape = partition.mesh_shape(mesh) if mesh is not None else {"data": 1, "model": 1}
        log(f"arch={cfg.name} params={n_params/1e6:.1f}M mesh={shape} steps {start}..{steps}")
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        losses, grad_norms, step_s = [], [], []
        t0 = time.time()
        for i in range(start, steps):
            t = time.perf_counter()
            b = batch_at(cfg, pipe, i)
            if place is not None:
                b = {k: partition.distribute(v, mesh, place[k]) for k, v in b.items()}
            state, metrics = step_fn(state, b, torch.Generator(device=dev).manual_seed(i))
            losses.append(_host(metrics["loss"]))
            grad_norms.append(_host(metrics["grad_norm"]))
            step_s.append(time.perf_counter() - t)
            if (i + 1) % 10 == 0 or i == start:
                log(f"step {i+1:5d} loss {losses[-1]:.4f} "
                    f"gnorm {grad_norms[-1]:.3f} "
                    f"{(time.time()-t0)/(i-start+1)*1e3:.0f} ms/step")
            if ckpt_dir and ((i + 1) % ckpt_every == 0 or i + 1 == steps):
                tree = convert.train_state_to_jax(cfg, state)  # every rank: the gathers
                if rank == 0:
                    checkpoint.save(ckpt_dir, i + 1, tree)
    log("done.")
    return {"arch": cfg.name, "device": str(dev), "n_params": n_params, "start": start,
            "steps": steps, "tokens_per_step": batch * seq, "losses": losses,
            "grad_norms": grad_norms, "step_ms": [1e3 * s for s in step_s],
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "mesh": shape, "rules": rules, "state": state}


def _batch_placement(cfg, pipe: TokenPipeline, mesh, rules) -> dict:
    """The DTensor placements of the batch's tensors along their batch axis."""
    b = batch_at(cfg, pipe, 0)
    axes = {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in b.items()}
    return partition.struct_shardings(b, axes, mesh, rules)


if __name__ == "__main__":
    main()
