"""The models: decoder-only LMs (the dense, MoE, vlm, hybrid and ssm
families) and the audio encoder-decoder, for training and for serving.

The port of `repro/models/model.py`:

    model = init_params(cfg, seed, device)            # a DecoderLM or EncoderDecoderLM
    loss, metrics = model.train_forward(batch, gen)    # the training forward
    caches = init_caches(cfg, batch, max_len, device)  # a state per layer
    logits, caches = model.prefill(tokens, caches)     # last-position (B, V)
    logits, caches = model.decode_step(tokens, pos, caches)

`train_forward` takes the JAX batch dict ({"tokens", "labels"} (B, S) int,
plus "patch_embeds" (B, P, D) for a vlm, "frames" (B, T, D) for the audio
family) and returns (ce + aux, {"ce_loss", "aux_loss"}): the mean
cross-entropy of the text positions through `train.loss.chunked_ce` (8
chunks) and the MoE channels' load-balance loss. It runs in plain
differentiable torch ops (attention through `attention.attn_train`, never
the flash kernel) with every unit of layers under `transformer.remat`. The
Boltzmann router's Gumbel draws come from `gen`, one tensor per MoE layer
drawn before the layers run, or are given outright (`gumbels`).

A vlm prefill takes `patch_embeds` (B, n_patches, D), the stub frontend's
image embeddings, prepended to the text; its positions run over patches and
text, and `decode_step` offsets the text position by n_patches, as in the
JAX package, whether or not the prompt had patches.

`prefill` and `decode_step` run under `torch.inference_mode()` (under
`no_grad` where a mesh is active: the dry run's) and write the caches in
place. `mode` ("auto" | "kernel" | "reference") is passed to
`ops.flash_attention` for the prefill attention: "auto" is the hand-written
kernel on a CUDA device and its plain version on the CPU, with no fallback.

The audio family (whisper) is an `EncoderDecoderLM`: its prefill takes
`frames` (B, T, D), the stub frontend's embeddings (serving gives
encoder_seq of them), runs the encoder (sinusoidal positions, non-causal
layers without RoPE), then the decoder over the text (sinusoidal
positions; self-attention with RoPE, as the JAX package's serving path has
it, then cross-attention over the encoder), and returns each decoder
layer's cross K/V of T rows in place of the given cross states.
Its decode takes the text position's row of a 4096-row sinusoid table (the
row clamped to 4095, as the JAX package's gather clamps). Its training
forward runs the encoder in plain torch ops (dense non-causal attention, no
RoPE) and the decoder's self-attention without RoPE, as the JAX
`_decoder_encdec` does (a reference quirk: serving applies it), each layer
under `transformer.remat`.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.core.ising import resolve_device
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.sharding.partition import active_mesh, constrain
from repro_torch.train import loss as train_loss

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
DECODE_POSITIONS = 4096  # rows of the encoder-decoder's decode sinusoid table


def _serving(fn):
    """Run `fn` under `torch.inference_mode()`, or under `no_grad` where a
    mesh is active (the dry run's sharded prefill and decode: DTensor
    refuses inference tensors)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.no_grad() if active_mesh() is not None else torch.inference_mode():
            return fn(*args, **kwargs)

    return wrapper


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r}; have {FAMILIES}")


class DecoderLM(nn.Module):
    """embed (vocab, D); layers; final_norm; lm_head (D -> vocab) unless
    the embedding is tied, when the head is the embedding itself."""

    AXES = {"embed": ("vocab", "fsdp"), "lm_head.weight": ("vocab", "fsdp")}

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        _check_family(cfg)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.layers = transformer.init_decoder_layers(gen, cfg, dtype)
        self.final_norm = layers.Norm(cfg.d_model, dtype, layers.device_of(gen))
        self.lm_head = (None if cfg.tie_embeddings
                        else layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, scale=0.02))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_axes(self) -> dict[str, tuple]:
        """{parameter name: logical axes} (`layers.param_axes`)."""
        return layers.param_axes(self)

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

    def _w_out(self) -> torch.Tensor:
        """The unembedding (vocab, D): the embedding itself when tied."""
        return self.embed if self.lm_head is None else self.lm_head.weight

    def _final_logits(self, x):
        x = layers.apply_norm(self.cfg.norm, self.final_norm, x)
        return layers.unembed(x, self._w_out(), self.cfg.logit_softcap)

    def router_draws(self, n_tokens: int, gen: torch.Generator | None):
        """The Boltzmann router's Gumbel draws for n_tokens tokens: one
        (G, gs, E) tensor per layer with an MoE channel (None for the
        others), drawn from `gen` in layer order; None when the config
        draws nothing."""
        cfg = self.cfg
        if not (cfg.moe and cfg.moe.router_mode == "boltzmann"):
            return None
        if gen is None:
            raise ValueError(f"{cfg.name}: the boltzmann router draws from a generator; none given")
        shape = moe.router_shape(cfg, n_tokens)
        return [moe.draw_gumbel(gen, shape, self.device)
                if transformer._has_channel(block.kind, cfg) else None for block in self.layers]

    def _train_loss(self, x, labels, aux):
        """(ce + aux, metrics) of the last hidden states x (B, S', D): a
        vlm's patch positions (the first S' - S) are not scored."""
        x = layers.apply_norm(self.cfg.norm, self.final_norm, x)
        x = x[:, x.shape[1] - labels.shape[1]:]
        ce = train_loss.chunked_ce(x, self._w_out(), labels, n_chunks=8,
                                   softcap=self.cfg.logit_softcap)
        return ce + aux, {"ce_loss": ce, "aux_loss": aux}

    def train_forward(self, batch: dict, gen: torch.Generator | None = None, gumbels=None):
        """The training forward of a batch dict (module docstring). Returns
        (loss, {"ce_loss", "aux_loss"}), float32 scalars. Under a mesh the
        embedding, final norm and head are gathered over their fsdp axis
        for the call, each layer's parameters in its layer
        (`layers.fsdp_gathered`)."""
        with layers.fsdp_gathered(self):
            x, positions = self._embed_inputs(batch["tokens"], batch.get("patch_embeds"))
            x = constrain(x, ("batch", "seq", "embed"))
            if gumbels is None:
                gumbels = self.router_draws(x.shape[0] * x.shape[1], gen)
            x, aux = transformer.decoder_train(self.layers, x, self.cfg, positions, gumbels)
            return self._train_loss(x, batch["labels"], aux)

    @_serving
    def prefill(self, tokens, caches: list, mode: str = "auto", patch_embeds=None):
        """Prompt pass over tokens (B, S), after a vlm's patch_embeds (B, P, D)
        if given. Returns (last-position logits (B, V), caches) with every
        layer's state written for the prompt."""
        x, positions = self._embed_inputs(tokens, patch_embeds)
        x, caches = transformer.decoder_prefill(self.layers, x, self.cfg, positions, caches, mode)
        return self._final_logits(x[:, -1:])[:, 0], caches

    @_serving
    def decode_step(self, tokens, pos: int, caches: list):
        """tokens: (B,) next input ids at text position `pos` (an int; a vlm
        adds n_patches). Returns (logits (B, V), caches) with every layer's
        state advanced by one token."""
        if self.cfg.family == "vlm":
            pos = pos + self.cfg.n_patches
        x = layers.embed_lookup(self.embed, tokens[:, None], self.cfg.embed_scale)
        x, caches = transformer.decoder_decode(self.layers, x, self.cfg, pos, caches)
        return self._final_logits(x)[:, 0], caches


class CrossLayer(nn.Module):
    """A decoder layer's cross-attention: its norm and attn (wq, wk, wv, wo)."""

    def __init__(self, gen, cfg, dtype):
        super().__init__()
        self.norm = layers.Norm(cfg.d_model, dtype, layers.device_of(gen))
        self.attn = attention.attn_init(gen, cfg, dtype)


class EncoderDecoderLM(DecoderLM):
    """The audio family: a DecoderLM (embed, the decoder layers, final_norm,
    lm_head) with enc_layers (n_encoder_layers attention blocks), enc_norm,
    and cross (one CrossLayer per decoder layer)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__(cfg, gen)
        dtype = getattr(torch, cfg.dtype)
        self.enc_layers = nn.ModuleList(transformer.block_init(gen, "attn_global", cfg, dtype)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_norm = layers.Norm(cfg.d_model, dtype, layers.device_of(gen))
        self.cross = nn.ModuleList(CrossLayer(gen, cfg, dtype) for _ in range(cfg.n_layers))

    def _positions(self, S: int, dtype) -> torch.Tensor:
        return layers.sinusoidal_positions(S, self.cfg.d_model, dtype, self.device)

    @_serving
    def encode(self, frames, mode: str = "auto"):
        """frames (B, T, D), the stub frontend's embeddings -> (B, T, D):
        sinusoidal positions, then each encoder layer's non-causal attention
        (no RoPE) and MLP, then enc_norm."""
        cfg = self.cfg
        x = frames.to(self.embed.dtype)
        x = x + self._positions(x.shape[1], x.dtype)[None]
        for block in self.enc_layers:
            h = layers.apply_norm(cfg.norm, block.norm1, x)
            x = x + attention.attn_encoder(block.attn, h, cfg, mode)
            x = transformer._channel(block, "attn_global", x, cfg)
        return layers.apply_norm(cfg.norm, self.enc_norm, x)

    def _encode_train(self, frames):
        """The encoder's training forward: as `encode`, in plain torch ops
        (dense non-causal attention over all frames, no RoPE), each layer
        under `transformer.remat`."""
        cfg = self.cfg
        x = frames.to(self.embed.dtype)
        x = x + self._positions(x.shape[1], x.dtype)[None]

        def layer(block, x):
            with layers.fsdp_gathered(block):
                h = layers.apply_norm(cfg.norm, block.norm1, x)
                x = layers.residual(x, attention.attn_train(block.attn, h, cfg, None,
                                                            causal=False, rope=False))
                return transformer._channel(block, "attn_global", x, cfg)

        wrap = transformer.remat(cfg)
        for block in self.enc_layers:
            x = wrap(functools.partial(layer, block))(x)
        return layers.apply_norm(cfg.norm, self.enc_norm, x)

    def _decoder_layer_train(self, block, cross, x, enc_out):
        """One decoder layer's training forward: causal self-attention
        without RoPE (the JAX package's quirk), cross-attention, the MLP."""
        cfg = self.cfg
        with layers.fsdp_gathered(block), layers.fsdp_gathered(cross):
            h = layers.apply_norm(cfg.norm, block.norm1, x)
            x = layers.residual(x, attention.attn_train(block.attn, h, cfg, None, rope=False))
            hc = layers.apply_norm(cfg.norm, cross.norm, x)
            kv = attention.cross_kv(cross.attn, enc_out, cfg)
            x = layers.residual(x, attention.attn_cross(cross.attn, hc, kv, cfg))
            return transformer._channel(block, "attn_global", x, cfg)

    def train_forward(self, batch: dict, gen: torch.Generator | None = None, gumbels=None):
        """The training forward from batch["frames"] (B, T, D) and the text
        (module docstring); the aux loss is zero (no MoE). Returns (loss,
        {"ce_loss", "aux_loss"}), gathered as `DecoderLM.train_forward`."""
        cfg = self.cfg
        with layers.fsdp_gathered(self):
            enc_out = self._encode_train(batch["frames"])
            tokens = batch["tokens"]
            x = layers.embed_lookup(self.embed, tokens, cfg.embed_scale)
            x = x + self._positions(tokens.shape[1], x.dtype)[None]
            wrap = transformer.remat(cfg)
            for block, cross in zip(self.layers, self.cross):
                x = wrap(functools.partial(self._decoder_layer_train, block, cross))(x, enc_out)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            return self._train_loss(x, batch["labels"], aux)

    def _check_frames(self, frames) -> None:
        if frames is None:  # the JAX prefill reads batch["frames"]: a KeyError
            raise KeyError(f"frames: {self.cfg.name} prefills from frames (B, T, "
                           f"{self.cfg.d_model}); none were given")
        if frames.ndim != 3 or frames.shape[2] != self.cfg.d_model:
            raise ValueError(f"frames of shape {tuple(frames.shape)}; {self.cfg.name} takes "
                             f"(B, T, d_model = {self.cfg.d_model})")

    @_serving
    def prefill(self, tokens, caches: list, mode: str = "auto", frames=None):
        """Encode `frames` (B, T, D), any T, then the prompt tokens (B, S)
        through the decoder. Returns (last-position logits (B, V), caches):
        each decoder layer's KV cache written for the prompt in place, and
        after them one `CrossKV` (B, T, K, hd) per decoder layer of the
        encoder's output, in place of the given cross states (the JAX
        prefill returns the `cross_kv` its scan built from the frames).
        Serving gives encoder_seq frames, the length of `init_caches`'
        cross states."""
        self._check_frames(frames)
        cfg = self.cfg
        enc_out = self.encode(frames, mode)
        x = layers.embed_lookup(self.embed, tokens, cfg.embed_scale)
        B, S = tokens.shape
        x = x + self._positions(S, x.dtype)[None]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        L = cfg.n_layers
        cross_kvs = []
        for block, cross, cache in zip(self.layers, self.cross, caches[:L]):
            h = layers.apply_norm(cfg.norm, block.norm1, x)
            delta, _ = attention.attn_prefill(block.attn, h, cfg, positions, cache, mode=mode)
            x = x + delta
            hc = layers.apply_norm(cfg.norm, cross.norm, x)
            kv = attention.cross_kv(cross.attn, enc_out, cfg)
            cross_kvs.append(kv)
            x = x + attention.attn_cross_prefill(cross.attn, hc, kv, cfg, mode)
            x = transformer._channel(block, "attn_global", x, cfg)
        return self._final_logits(x[:, -1:])[:, 0], caches[:L] + cross_kvs

    @_serving
    def decode_step(self, tokens, pos: int, caches: list):
        """tokens: (B,) next input ids at text position `pos` (an int; its
        sinusoid row is min(pos, 4095)). Returns (logits (B, V), caches)
        with each self-attention cache advanced by one token; the cross
        states, of whatever length, are read only."""
        cfg = self.cfg
        x = layers.embed_lookup(self.embed, tokens[:, None], cfg.embed_scale)
        row = min(pos, DECODE_POSITIONS - 1)
        x = x + self._positions(DECODE_POSITIONS, x.dtype)[row][None, None]
        L = cfg.n_layers
        for block, cross, cache, cross_cache in zip(self.layers, self.cross, caches[:L],
                                                    caches[L:]):
            h = layers.apply_norm(cfg.norm, block.norm1, x)
            delta, _ = attention.attn_decode(block.attn, h, cfg, pos, cache)
            x = x + delta
            hc = layers.apply_norm(cfg.norm, cross.norm, x)
            x = x + attention.attn_cross(cross.attn, hc, cross_cache, cfg)
            x = transformer._channel(block, "attn_global", x, cfg)
        return self._final_logits(x)[:, 0], caches


def cross_entropy(logits, labels):
    """The mean cross-entropy of logits (..., V) in float32 against labels."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def init_params(cfg, seed: int = 0, device=None) -> DecoderLM:
    """A DecoderLM (an EncoderDecoderLM for the audio family) with random
    weights drawn on `device` (None: the CUDA device) by a generator seeded
    with `seed`; on the meta device, parameters of the right shapes and
    dtypes that hold no memory (the dry run's)."""
    dev = resolve_device(device)
    cls = EncoderDecoderLM if cfg.is_encdec else DecoderLM
    if dev.type == "meta":  # shapes only: a CPU generator draws nothing there
        with torch.device("meta"):
            return cls(cfg, torch.Generator().manual_seed(seed))
    return cls(cfg, torch.Generator(device=dev).manual_seed(seed))


def cache_axes(cfg) -> list:
    """The logical axes of `init_caches`' states, in the same order: the
    JAX `cache_axes` without the stacked "layers" axis."""
    _check_family(cfg)
    axes = [transformer.block_cache_axes(kind) for kind in transformer.layer_kinds(cfg)]
    if cfg.is_encdec:
        a = ("kv_batch", "kv_seq", "kv_heads", None)
        axes += [attention.CrossKV(a, a) for _ in range(cfg.n_layers)]
    return axes


def init_caches(cfg, batch: int, max_len: int, device=None) -> list:
    """A zeroed state per decoder layer, in layer order; for the audio
    family then one `CrossKV` (batch, encoder_seq, K, hd) in the model's
    dtype per decoder layer."""
    _check_family(cfg)
    dev = resolve_device(device)
    caches = transformer.decoder_caches(cfg, batch, max_len, dev)
    if cfg.is_encdec:
        shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        dtype = getattr(torch, cfg.dtype)
        caches += [attention.CrossKV(torch.zeros(shape, dtype=dtype, device=dev),
                                     torch.zeros(shape, dtype=dtype, device=dev))
                   for _ in range(cfg.n_layers)]
    return caches
