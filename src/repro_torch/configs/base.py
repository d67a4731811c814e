"""Model / run configuration schema for all assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden
    n_shared: int = 0              # shared experts (qwen2-moe: 4)
    router_mode: str = "topk"      # 'topk' | 'boltzmann' (PASS-inspired sampling)
    router_temp: float = 1.0
    capacity_factor: float = 1.25
    group_size: int = 256          # tokens per dispatch group
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"            # swiglu | geglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False         # qwen-style
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d_model)
    # Layer pattern: None => all-global-attention decoder. Otherwise a tuple
    # of block kinds forming the repeating unit, e.g. ("rglru","rglru","attn_local").
    block_pattern: Optional[tuple[str, ...]] = None
    window: int = 2048             # sliding-window size for attn_local
    moe: Optional[MoEConfig] = None
    # hybrid / ssm
    lru_width: Optional[int] = None
    conv_width: int = 4
    mlstm_chunk: int = 64
    # encoder-decoder (audio)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500        # nominal frame count (stub frontend)
    # vlm
    n_patches: int = 0             # prepended image-patch positions
    # serving / numeric
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    remat: str = "dots"            # 'none' | 'dots' | 'full'
    logit_softcap: float = 0.0
    # sharding strategy for train/prefill: "tp_sp" = tensor parallel on the
    # model axis + sequence-parallel residual stream; "fsdp_pure" = ZeRO-3
    # over (data x model) with no tensor parallelism (optimal when
    # global_batch >= chips; see EXPERIMENTS.md SPerf iteration 3)
    strategy: str = "tp_sp"
    # long-sequence (blockwise) attention layout when heads don't divide the
    # tensor axis: True = context-parallel q (wins for phi3-class prefill),
    # False = padded-head TP (wins for the 64-layer 32B; SPerf iteration 6)
    blockwise_context_parallel: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if decode cost is O(window + state), not O(context)."""
        if self.block_pattern is None:
            return False
        return all(k != "attn_global" for k in self.block_pattern)

    def pattern_for_layers(self) -> list[str]:
        """Expand block_pattern over n_layers (remainder truncates the unit)."""
        if self.block_pattern is None:
            return ["attn_global"] * self.n_layers
        unit = list(self.block_pattern)
        out = []
        while len(out) < self.n_layers:
            out.extend(unit)
        return out[: self.n_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
