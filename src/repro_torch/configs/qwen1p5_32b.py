"""qwen1p5-32b — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen1p5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152064,
    qkv_bias=True, act="swiglu", remat="full", strategy="fsdp_pure",
    blockwise_context_parallel=False,
)

REDUCED = ModelConfig(
    name="qwen1p5-32b", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    qkv_bias=True, act="swiglu", dtype="float32", kv_cache_dtype="float32",
)
