"""phi3-medium-14b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab_size=100352, act="swiglu",
)

REDUCED = ModelConfig(
    name="phi3-medium-14b", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=512, act="swiglu",
    dtype="float32", kv_cache_dtype="float32",
)
