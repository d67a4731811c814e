"""Batched serving engine: slot-based continuous batching over a fixed
decode batch.

The port of `repro/serve/engine.py`. The engine owns `n_slots` sequence
slots. Requests are queued, prefilled one at a time (prompt lengths vary),
their caches inserted into the slot dimension of the batched decode cache,
then all active slots advance together through one `decode_step` per token.
Finished slots (EOS or max-tokens) are evicted and refilled from the queue —
continuous batching.

A request's `extras` go to the prefill: a vlm's `patch_embeds` (P, D), the
image embeddings put before its prompt, or an encoder-decoder's `frames`
(encoder_seq, D), which its encoder reads. The length check counts the prompt
and the new tokens, not the patches, as the JAX engine does (a reference
quirk, ROADMAP): a vlm request with patches needs a `max_len` that holds
them as well, or its prefill or its decode writes run past the cache.

Decode positions are global per engine step: every slot decodes at the
largest position of the active slots. A slot whose prompt was shorter keeps
zero-filled cache rows between its prompt and that position, and the decode
mask counts them as valid. This is the JAX package's behaviour, kept as it
is (a reference quirk, ROADMAP).

Sampling: greedy is the argmax (the first index on ties, as in JAX); with a
temperature above 0 the token is a Gumbel-max draw from the engine's own
`torch.Generator`, since torch cannot replay JAX's threefry stream.

The engine keeps the wall time of each prefill (`prefill_s`, per request)
and of each decode step (`decode_s`); both end on the host reading the
sampled token, which waits for the device. `nonfinite_logits` counts, on
the device, the non-finite logits of every prefill and step. With
`keep_logits`, `sampled_logits[uid]` holds, in float32 on the device, the
logits row of each token sampled for request `uid`, in order.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ising import resolve_device
from repro_torch.models import model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0    # 0 = greedy
    extras: Optional[dict] = None  # patch_embeds (P, D) for vlm; frames (T, D) for audio


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list[int]


class Engine:
    """Serves `params` (a DecoderLM or EncoderDecoderLM) on its device, which must be `device`
    (None: the CUDA device). `mode` goes to the prefill attention
    (`ops.flash_attention`: "auto" | "kernel" | "reference"); `keep_logits`
    keeps every sampled logits row (module docstring)."""

    def __init__(self, cfg, params: model.DecoderLM, n_slots: int = 4, max_len: int = 256,
                 eos_id: int = -1, seed: int = 0, device=None, mode: str = "auto",
                 keep_logits: bool = False):
        dev = resolve_device(device)
        if params.device.type != dev.type:
            raise ValueError(f"the model lies on {params.device}, the engine was given {dev}")
        self.device = params.device
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.mode = mode
        self.keep_logits = keep_logits
        self.sampled_logits: dict[int, list[torch.Tensor]] = {}
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: list[Request] = []
        self.slots: list[Optional[dict]] = [None] * n_slots
        self.caches = model.init_caches(cfg, n_slots, max_len, self.device)
        self.prefill_s: list[float] = []
        self.decode_s: list[float] = []
        self.nonfinite_logits = torch.zeros((), dtype=torch.int64, device=self.device)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    @torch.inference_mode()
    def run(self) -> list[Completion]:
        """Drain the queue; returns completions in finish order."""
        done: list[Completion] = []
        while self.queue or any(s is not None for s in self.slots):
            self._fill_slots()
            self._step(done)
        return done

    # -- internals ----------------------------------------------------------

    def _fill_slots(self):
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self._insert(i, req)

    def _insert(self, slot: int, req: Request):
        t0 = time.perf_counter()
        S = len(req.prompt)
        if S + req.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.uid}: {S} prompt + {req.max_new_tokens} new tokens "
                             f"exceed the engine's max_len {self.max_len}")
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None], device=self.device)
        extras = {k: torch.as_tensor(np.asarray(v)[None], device=self.device)
                  for k, v in (req.extras or {}).items()}
        one_cache = model.init_caches(self.cfg, 1, self.max_len, self.device)
        logits, one_cache = self.params.prefill(tokens, one_cache, self.mode, **extras)
        # place this request's cache into the batched cache at `slot`
        _insert_slot(self.caches, one_cache, slot)
        self.nonfinite_logits += (~torch.isfinite(logits)).sum()
        tok = self._sample(logits[0], req)
        self.slots[slot] = {"req": req, "pos": S, "tokens": [tok], "last": tok}
        self.prefill_s.append(time.perf_counter() - t0)

    def _sample(self, logits, req: Request) -> int:
        if self.keep_logits:
            self.sampled_logits.setdefault(req.uid, []).append(logits.float())
        temperature = req.temperature
        if temperature <= 0:
            return int(torch.argmax(logits))
        # Gumbel-max: G = -log(-log u), u uniform in [0, 1) (u = 0 gives -inf)
        u = torch.rand(logits.shape, generator=self.gen, device=logits.device)
        return int(torch.argmax(logits.to(torch.float32) / temperature - torch.log(-torch.log(u))))

    def _step(self, done: list[Completion]):
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        t0 = time.perf_counter()
        # All slots share the engine position clock: the max active pos.
        pos = max(self.slots[i]["pos"] for i in active)
        tokens = torch.tensor([s["last"] if s else 0 for s in self.slots], dtype=torch.int64,
                              device=self.device)
        logits, self.caches = self.params.decode_step(tokens, pos, self.caches)
        self.nonfinite_logits += (~torch.isfinite(logits)).sum()
        for i in active:
            s = self.slots[i]
            tok = self._sample(logits[i], s["req"])
            s["tokens"].append(tok)
            s["pos"] = pos + 1
            s["last"] = tok
            if tok == self.eos_id or len(s["tokens"]) >= s["req"].max_new_tokens:
                done.append(Completion(uid=s["req"].uid, tokens=s["tokens"]))
                self.slots[i] = None
        self.decode_s.append(time.perf_counter() - t0)


def _insert_slot(full: list, one: list, slot: int) -> list:
    """Write `one`'s batch entry 0 into `full` at batch index `slot`, in
    place, for every tensor of every layer's state (batch on axis 0 of each).
    The JAX engine tells a layer-stacked leaf from an unstacked one by
    comparing their first axes, which misreads an unstacked (1, R) state at
    one slot (ROADMAP, deliberate differences); here the axis is known."""
    for full_state, one_state in zip(full, one):
        for f, o in zip(full_state, one_state):
            f[slot] = o[0]
    return full
