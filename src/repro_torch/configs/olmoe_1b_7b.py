"""olmoe-1b-7b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304, act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024), strategy="fsdp_pure",
)

REDUCED = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=512, act="swiglu",
    dtype="float32", kv_cache_dtype="float32",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, group_size=64, capacity_factor=4.0),
)
