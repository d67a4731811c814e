"""Train an LM from the architecture registry end to end on the synthetic
Zipf pipeline, with checkpointing and crash-safe resume. The port of
`examples/train_lm.py`: the reduced config by default (`--full` for the
assigned one), any arch through `--arch`.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch gemma-2b --steps 60 \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch olmoe-1b-7b --steps 40 \
        --router boltzmann     # the PASS-inspired sampled MoE router

As the JAX script does, it resumes from the newest checkpoint in
`--ckpt-dir` (by default `repro_lm_ckpt` in the temporary directory) and
saves every `--ckpt-every` steps (not at the last). It returns the first
and last loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.ising import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.train import batch_at
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.train import checkpoint
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true", help="use the full (assigned) config")
    ap.add_argument("--router", default=None, choices=[None, "topk", "boltzmann"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=not args.full)
    if args.router and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_mode=args.router))
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        warmup_steps=max(2, args.steps // 20),
        microbatch=args.microbatch,
        compress_grads=args.compress_grads,
    )
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                    global_batch=args.batch), dev)
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    latest = checkpoint.latest_step(args.ckpt_dir)
    state = init_state(cfg, tcfg, 0, dev)
    if latest is not None:
        state = convert.load_train_state(cfg, state, checkpoint.restore(args.ckpt_dir, latest))
        start = latest
        print(f"resumed from checkpoint step {latest}")

    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M steps={start}..{args.steps}")

    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        state, metrics = step_fn(state, batch_at(cfg, pipe, i),
                                 torch.Generator(device=dev).manual_seed(i))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 10 == 0 or i == start:
            print(
                f"step {i+1:4d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"{(time.time()-t0)/(i-start+1)*1000:.0f} ms/step"
            )
        if (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, i + 1, convert.train_state_to_jax(cfg, state))
            print(f"checkpointed step {i+1}")
    print("done.")
    return {"device": str(dev), "arch": cfg.name, "start": start, "steps": args.steps,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None, "wall_s": time.time() - t0}


if __name__ == "__main__":
    main()
