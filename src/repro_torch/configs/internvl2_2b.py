"""internvl2-2b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92553, act="swiglu",
    n_patches=256,
)

REDUCED = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512, act="swiglu",
    n_patches=8, dtype="float32", kv_cache_dtype="float32",
)
