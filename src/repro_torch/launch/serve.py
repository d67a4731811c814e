"""Serving entry point: random-init (or checkpoint-restored) weights on the
device, the continuous-batching engine, and a synthetic request workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch phi4-mini-3p8b --no-reduced  # on the card

The port of `repro/launch/serve.py`, with its flags and defaults (`--arch`
xlstm-125m), except:
  * `--reduced/--no-reduced` (the JAX flag cannot be turned off, so the JAX
    entry point never serves full width; the default is still reduced);
  * `--device` (default cuda; it raises without a card).
`--ckpt-dir` restores the params of the newest committed step of a
training checkpoint (`repro_torch.train.checkpoint`, the JAX package's
format) and prints "restored params from step N"; without a committed step
the random init stays, silently, as in the JAX driver. Every arch is
served. Like the JAX driver `main` submits no `extras`: no image patches
for a vlm arch, and no frames for whisper-medium, whose prefill then
raises a KeyError as the JAX one does (reference quirks, ROADMAP). `serve` takes requests with `extras` for both, for example

    serve(cfg, params, [Request(uid=0, prompt=prompt, extras={"frames": frames})],
          slots=4, max_len=128)   # frames (encoder_seq, d_model)

`main` returns a summary: the completions, their tokens and walls, the
weights' size, and the restored step (None if none).
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.ising import resolve_device
from repro_torch.models import convert, model
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import checkpoint


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
    ap.add_argument("--ckpt-dir", default=None, help="restore params from a train checkpoint")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = model.init_params(cfg, 0, dev)
    step = checkpoint.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if step is not None:
        tree = checkpoint.restore(args.ckpt_dir, step)
        params.load_state_dict(convert.params_from_jax(cfg, tree["params"]), strict=True)
        print(f"restored params from step {step}")
    out = serve(cfg, params, requests(cfg, args.requests, args.max_new, args.temperature),
                slots=args.slots, max_len=args.max_len)
    print(f"{len(out['completions'])} completions, {out['tokens']} tokens, {out['wall_s']:.1f}s "
          f"({out['tokens_per_s']:.1f} tok/s)")
    return {"arch": args.arch, "reduced": args.reduced, "restored_step": step, **out}


def requests(cfg, n: int, max_new: int, temperature: float) -> list:
    """main's synthetic workload: n prompts of 4 to 15 random tokens from a
    numpy generator seeded 0, as the JAX driver draws them."""
    rng = np.random.default_rng(0)
    out = []
    for uid in range(n):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(np.int32)
        out.append(Request(uid=uid, prompt=prompt, max_new_tokens=max_new,
                           temperature=temperature))
    return out


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
