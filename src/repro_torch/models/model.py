"""Decoder-only LMs (the dense, MoE, vlm, hybrid and ssm families) for serving.

The port of the serving half of `repro/models/model.py`:

    model = init_params(cfg, seed, device)            # a DecoderLM
    caches = init_caches(cfg, batch, max_len, device)  # a state per layer
    logits, caches = model.prefill(tokens, caches)     # last-position (B, V)
    logits, caches = model.decode_step(tokens, pos, caches)

A vlm prefill takes `patch_embeds` (B, n_patches, D), the stub frontend's
image embeddings, prepended to the text; its positions run over patches and
text, and `decode_step` offsets the text position by n_patches, as in the
JAX package, whether or not the prompt had patches.

`prefill` and `decode_step` run under `torch.inference_mode()` and write
the caches in place. `mode` ("auto" | "kernel" | "reference") is passed to
`ops.flash_attention` for the prefill attention: "auto" is the hand-written
kernel on a CUDA device and its plain version on the CPU, with no fallback.

The audio family (an encoder-decoder) is not ported yet and raises
(ROADMAP queue 1).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.ising import resolve_device
from repro_torch.models import layers, transformer

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")
_LATER = {"audio": "the audio encoder-decoder slice (the encoder, cross-attention and its cache)"}


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER.get(cfg.family, 'a later slice')} (ROADMAP queue 1)")


class DecoderLM(nn.Module):
    """embed (vocab, D); layers; final_norm; lm_head (D -> vocab) unless
    the embedding is tied, when the head is the embedding itself."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        _check_family(cfg)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.layers = transformer.init_decoder_layers(gen, cfg, dtype)
        self.final_norm = layers.Norm(cfg.d_model, dtype, gen.device)
        self.lm_head = (None if cfg.tie_embeddings
                        else layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, scale=0.02))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed_inputs(self, tokens, patch_embeds=None):
        """tokens (B, S) -> (x (B, S', D), positions (B, S') int32). A vlm's
        patch_embeds (B, P, D) go before the text (S' = P + S); the text is
        where positions >= P (JAX also returns that mask; serving needs none)."""
        x = layers.embed_lookup(self.embed, tokens, self.cfg.embed_scale)
        if self.cfg.family == "vlm" and patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        return x, positions

    def _final_logits(self, x):
        x = layers.apply_norm(self.cfg.norm, self.final_norm, x)
        w_out = self.embed if self.lm_head is None else self.lm_head.weight
        return layers.unembed(x, w_out, self.cfg.logit_softcap)

    @torch.inference_mode()
    def prefill(self, tokens, caches: list, mode: str = "auto", patch_embeds=None):
        """Prompt pass over tokens (B, S), after a vlm's patch_embeds (B, P, D)
        if given. Returns (last-position logits (B, V), caches) with every
        layer's state written for the prompt."""
        x, positions = self._embed_inputs(tokens, patch_embeds)
        x, caches = transformer.decoder_prefill(self.layers, x, self.cfg, positions, caches, mode)
        return self._final_logits(x[:, -1:])[:, 0], caches

    @torch.inference_mode()
    def decode_step(self, tokens, pos: int, caches: list):
        """tokens: (B,) next input ids at text position `pos` (an int; a vlm
        adds n_patches). Returns (logits (B, V), caches) with every layer's
        state advanced by one token."""
        if self.cfg.family == "vlm":
            pos = pos + self.cfg.n_patches
        x = layers.embed_lookup(self.embed, tokens[:, None], self.cfg.embed_scale)
        x, caches = transformer.decoder_decode(self.layers, x, self.cfg, pos, caches)
        return self._final_logits(x)[:, 0], caches


def init_params(cfg, seed: int = 0, device=None) -> DecoderLM:
    """A DecoderLM with random weights drawn on `device` (None: the CUDA
    device) by a generator seeded with `seed`."""
    dev = resolve_device(device)
    return DecoderLM(cfg, torch.Generator(device=dev).manual_seed(seed))


def init_caches(cfg, batch: int, max_len: int, device=None) -> list:
    _check_family(cfg)
    return transformer.decoder_caches(cfg, batch, max_len, resolve_device(device))
