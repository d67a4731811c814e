"""phi4-mini-3p8b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3p8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=200064, act="swiglu",
    strategy="fsdp_pure",
)

REDUCED = ModelConfig(
    name="phi4-mini-3p8b", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512, act="swiglu",
    dtype="float32", kv_cache_dtype="float32",
)
