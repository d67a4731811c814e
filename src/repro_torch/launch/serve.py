"""Serving entry point: random-init weights on the device, the continuous-batching
engine, and a synthetic request workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch phi4-mini-3p8b --no-reduced  # on the card

The port of `repro/launch/serve.py`, with its flags and defaults, except:
  * `--arch` defaults to phi4-mini-3p8b, a family the port serves (the JAX
    default, xlstm-125m, is an ssm, not ported yet);
  * `--reduced/--no-reduced` (the JAX flag cannot be turned off, so the JAX
    entry point never serves full width; the default is still reduced);
  * `--device` (default cuda; it raises without a card);
  * `--ckpt-dir` is rejected until the training slice brings checkpoints.
`main` returns a summary: the completions, their tokens and walls, and the
weights' size.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.ising import resolve_device
from repro_torch.models import model
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi4-mini-3p8b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a train checkpoint (not ported yet)")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        ap.error("--ckpt-dir needs train/checkpoint.py and train_step.init_state, which come "
                 "with the training slice (ROADMAP queue 1)")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = model.init_params(cfg, 0, dev)
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())

    eng = Engine(cfg, params, n_slots=args.slots, max_len=args.max_len, seed=0, device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(np.int32)
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new,
                           temperature=args.temperature))
    done = eng.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for c in done)
    print(f"{len(done)} completions, {tokens} tokens, {dt:.1f}s ({tokens / dt:.1f} tok/s)")
    return {"arch": args.arch, "reduced": args.reduced, "device": str(params.device),
            "weight_bytes": weight_bytes, "requests": args.requests,
            "completions": [{"uid": c.uid, "tokens": c.tokens} for c in done],
            "tokens": tokens, "wall_s": dt, "tokens_per_s": tokens / dt,
            "prefill_ms": [1e3 * s for s in eng.prefill_s],
            "decode_ms": [1e3 * s for s in eng.decode_s],
            "decode_ms_median": 1e3 * statistics.median(eng.decode_s) if eng.decode_s else None,
            "nonfinite_logits": int(eng.nonfinite_logits)}


if __name__ == "__main__":
    main()
