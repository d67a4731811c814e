"""Decoder-only LMs (the dense and MoE families) for serving.

The port of the serving half of `repro/models/model.py`:

    model = init_params(cfg, seed, device)            # a DecoderLM
    caches = init_caches(cfg, batch, max_len, device)  # a KVCache
    logits, caches = model.prefill(tokens, caches)     # last-position (B, V)
    logits, caches = model.decode_step(tokens, pos, caches)

`prefill` and `decode_step` run under `torch.inference_mode()` and write
the caches in place. `mode` ("auto" | "kernel" | "reference") is passed to
`ops.flash_attention` for the prefill attention: "auto" is the hand-written
kernel on a CUDA device and its plain version on the CPU, with no fallback.

The vlm, hybrid, ssm and audio families are not ported yet and raise
(ROADMAP queue 1).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.ising import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.attention import KVCache

FAMILIES = ("dense", "moe")
_LATER = {
    "vlm": "the vlm slice (image patches and their position offset)",
    "hybrid": "the hybrid and ssm slice (rglru, xlstm, attn_local)",
    "ssm": "the hybrid and ssm slice (rglru, xlstm, attn_local)",
    "audio": "the audio encoder-decoder slice (cross-attention)",
}


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

    def _embed_inputs(self, tokens):
        """tokens (B, S) -> (x (B, S, D), positions (B, S) int32)."""
        x = layers.embed_lookup(self.embed, tokens, self.cfg.embed_scale)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        return x, positions

    def _final_logits(self, x):
        x = layers.apply_norm(self.cfg.norm, self.final_norm, x)
        w_out = self.embed if self.lm_head is None else self.lm_head.weight
        return layers.unembed(x, w_out, self.cfg.logit_softcap)

    @torch.inference_mode()
    def prefill(self, tokens, caches: KVCache, mode: str = "auto"):
        """Prompt pass over tokens (B, S). Returns (last-position logits
        (B, V), caches) with the prompt's K/V written into caches[:, :, :S]."""
        x, positions = self._embed_inputs(tokens)
        x, caches = transformer.decoder_prefill(self.layers, x, self.cfg, positions, caches, mode)
        return self._final_logits(x[:, -1:])[:, 0], caches

    @torch.inference_mode()
    def decode_step(self, tokens, pos: int, caches: KVCache):
        """tokens: (B,) next input ids at position `pos` (an int). Returns
        (logits (B, V), caches) with their K/V written at pos."""
        x = layers.embed_lookup(self.embed, tokens[:, None], self.cfg.embed_scale)
        x, caches = transformer.decoder_decode(self.layers, x, self.cfg, pos, caches)
        return self._final_logits(x)[:, 0], caches


def init_params(cfg, seed: int = 0, device=None) -> DecoderLM:
    """A DecoderLM with random weights drawn on `device` (None: the CUDA
    device) by a generator seeded with `seed`."""
    dev = resolve_device(device)
    return DecoderLM(cfg, torch.Generator(device=dev).manual_seed(seed))


def init_caches(cfg, batch: int, max_len: int, device=None) -> KVCache:
    _check_family(cfg)
    return transformer.decoder_caches(cfg, batch, max_len, resolve_device(device))
