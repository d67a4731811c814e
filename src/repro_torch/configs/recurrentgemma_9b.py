"""recurrentgemma-9b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab_size=256000,
    head_dim=256, act="geglu", embed_scale=True, tie_embeddings=True,
    block_pattern=("rglru", "rglru", "attn_local"), window=2048,
    lru_width=4096,
)

REDUCED = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=512,
    head_dim=16, act="geglu", embed_scale=True, tie_embeddings=True,
    block_pattern=("rglru", "rglru", "attn_local"), window=32,
    lru_width=64, dtype="float32", kv_cache_dtype="float32",
)
