"""Serve a small model with batched requests through the continuous-batching
engine (prefill -> slot insert -> fused batched decode). The port of
`examples/serve_lm.py`, at the reduced configs as there.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch xlstm-125m --requests 6
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.ising import resolve_device
from repro_torch.models import model
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> dict:
    """Serve the requests; print each completion and the throughput, and
    return the completions and the token count."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m", choices=list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    params = model.init_params(cfg, 0, dev)
    eng = Engine(cfg, params, n_slots=args.slots, max_len=128, seed=0, device=dev)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12)).astype(np.int32)
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new,
                           temperature=args.temperature))
    done = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in done)
    for c in sorted(done, key=lambda c: c.uid):
        print(f"request {c.uid}: {c.tokens}")
    print(f"\n{len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s on {dev.type.upper()}, {args.slots} slots)")
    return {"device": str(dev), "arch": args.arch, "requests": len(done),
            "tokens": total_tokens, "wall_s": dt,
            "completions": {c.uid: c.tokens for c in done}}


if __name__ == "__main__":
    main()
