"""Training entry point: the token pipeline, the train step and the
checkpoint/restart loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \
        --steps 50 --batch 8 --seq 64 --device cpu
    python -m repro_torch.launch.train --arch gemma-2b --steps 10 --batch 4 --seq 1024 \
        --ckpt-dir <fresh dir>   # full width on the card

The port of `repro/launch/train.py`, with its flags, defaults (full width
unless `--reduced`; lr 3e-3; a checkpoint every 20 steps and at the last
step into `--ckpt-dir`, by default `repro_train_ckpt` in the temporary
directory) and printed lines, plus `--device` (default cuda; it raises
without a card). One device only: `--mesh` other than one device,
`--production-mesh` and `--multi-pod` are refused until `sharding/` is
ported.

Fault tolerance: the data pipeline is a pure function of the step, a
checkpoint commits atomically, and a run restores the newest committed
step in `--ckpt-dir` and replays from there. Every run that should start
from scratch needs a fresh `--ckpt-dir`.

`train(...)` is the loop under `main`; both return a summary: the losses,
grad norms and walls of the steps run, the tokens a step, the device's peak
memory, and the final state.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.ising import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.train import checkpoint
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

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
    ap.add_argument("--mesh", default="1x1", help='"DxM" or "PxDxM"; one device only')
    ap.add_argument("--production-mesh", action="store_true", help="not ported")
    ap.add_argument("--multi-pod", action="store_true", help="not ported")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        mesh = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if args.production_mesh or args.multi_pod or math.prod(mesh.values()) != 1:
        ap.error("the port trains on one device: a mesh needs sharding/, which is not "
                 "ported (ROADMAP queue 1)")

    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        warmup_steps=max(2, args.steps // 20),
        microbatch=args.microbatch,
        compress_grads=args.compress_grads,
    )
    return train(cfg, tcfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 device=args.device, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 mesh=mesh)


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


def train(cfg, tcfg: TrainConfig, *, steps: int, batch: int, seq: int, device=None,
          ckpt_dir: str | None = None, ckpt_every: int = 20, mesh=None) -> dict:
    """Train `steps` steps from seed 0, or from the newest committed step in
    `ckpt_dir` (None: no checkpoints), saving every `ckpt_every` steps and
    at the last. The step's generator (the Boltzmann router's) is seeded
    with the step, as the JAX driver keys it."""
    dev = resolve_device(device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
                         dev)
    state = init_state(cfg, tcfg, 0, dev)
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    latest = checkpoint.latest_step(ckpt_dir) if ckpt_dir else None
    if latest is not None:
        state = convert.load_train_state(cfg, state, checkpoint.restore(ckpt_dir, latest))
        start = latest
        print(f"[recovery] resumed from committed step {latest}")

    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M mesh={mesh or {'data': 1, 'model': 1}} "
          f"steps {start}..{steps}")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, grad_norms, step_s = [], [], []
    t0 = time.time()
    for i in range(start, steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, batch_at(cfg, pipe, i),
                                 torch.Generator(device=dev).manual_seed(i))
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t)
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i+1:5d} loss {losses[-1]:.4f} "
                  f"gnorm {grad_norms[-1]:.3f} "
                  f"{(time.time()-t0)/(i-start+1)*1e3:.0f} ms/step")
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or i + 1 == steps):
            checkpoint.save(ckpt_dir, i + 1, convert.train_state_to_jax(cfg, state))
    print("done.")
    return {"arch": cfg.name, "device": str(dev), "n_params": n_params, "start": start,
            "steps": steps, "tokens_per_step": batch * seq, "losses": losses,
            "grad_norms": grad_norms, "step_ms": [1e3 * s for s in step_s],
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "state": state}


if __name__ == "__main__":
    main()
