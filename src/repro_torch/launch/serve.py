"""Serving entry point: random-init weights on the device, the continuous-batching
engine, and a synthetic request workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch phi4-mini-3p8b --no-reduced  # on the card

The port of `repro/launch/serve.py`, with its flags and defaults (`--arch`
xlstm-125m), except:
  * `--reduced/--no-reduced` (the JAX flag cannot be turned off, so the JAX
    entry point never serves full width; the default is still reduced);
  * `--device` (default cuda; it raises without a card);
  * `--ckpt-dir` is rejected until the training slice brings checkpoints.
Every arch is served. Like the JAX driver `main` submits no `extras`: no
image patches for a vlm arch, and no frames for whisper-medium, whose
prefill then raises a KeyError as the JAX one does (reference quirks,
ROADMAP). `serve` takes requests with `extras` for both, for example

    serve(cfg, params, [Request(uid=0, prompt=prompt, extras={"frames": frames})],
          slots=4, max_len=128)   # frames (encoder_seq, d_model)

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
    ap.add_argument("--arch", default="xlstm-125m", choices=list_archs())
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
    rng = np.random.default_rng(0)
    requests = []
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(np.int32)
        requests.append(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new,
                                temperature=args.temperature))
    out = serve(cfg, params, requests, slots=args.slots, max_len=args.max_len)
    print(f"{len(out['completions'])} completions, {out['tokens']} tokens, {out['wall_s']:.1f}s "
          f"({out['tokens_per_s']:.1f} tok/s)")
    return {"arch": args.arch, "reduced": args.reduced, **out}


def serve(cfg, params: model.DecoderLM, requests: list, *, slots: int, max_len: int) -> dict:
    """Serve `requests` through an `Engine` on the model's device (seed 0)
    and return the summary `main` returns, without the arch."""
    eng = Engine(cfg, params, n_slots=slots, max_len=max_len, seed=0, device=params.device)
    t0 = time.perf_counter()
    for req in requests:
        eng.submit(req)
    done = eng.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for c in done)
    return {"device": str(params.device),
            "weight_bytes": sum(p.numel() * p.element_size() for p in params.parameters()),
            "requests": len(requests),
            "completions": [{"uid": c.uid, "tokens": c.tokens} for c in done],
            "tokens": tokens, "wall_s": dt, "tokens_per_s": tokens / dt,
            "prefill_ms": [1e3 * s for s in eng.prefill_s],
            "decode_ms": [1e3 * s for s in eng.decode_s],
            "decode_ms_median": 1e3 * statistics.median(eng.decode_s) if eng.decode_s else None,
            "nonfinite_logits": int(eng.nonfinite_logits)}


if __name__ == "__main__":
    main()
