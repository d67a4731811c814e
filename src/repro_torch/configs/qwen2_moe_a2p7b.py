"""qwen2-moe-a2p7b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen2-moe-a2p7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=151936,
    qkv_bias=True, act="swiglu",
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, n_shared=4),
)

REDUCED = ModelConfig(
    name="qwen2-moe-a2p7b", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=512,
    qkv_bias=True, act="swiglu", dtype="float32", kv_cache_dtype="float32",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=2, group_size=64, capacity_factor=4.0),
)
