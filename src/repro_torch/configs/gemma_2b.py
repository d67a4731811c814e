"""gemma-2b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab_size=256000,
    head_dim=256, act="geglu", embed_scale=True, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma-2b", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=512,
    head_dim=16, act="geglu", embed_scale=True, tie_embeddings=True,
    dtype="float32", kv_cache_dtype="float32",
)
