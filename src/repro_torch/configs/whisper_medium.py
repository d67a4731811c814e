"""whisper-medium — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51865,
    act="gelu", norm="layernorm", n_encoder_layers=24, encoder_seq=1500,
)

REDUCED = ModelConfig(
    name="whisper-medium", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    act="gelu", norm="layernorm", n_encoder_layers=2, encoder_seq=32,
    dtype="float32", kv_cache_dtype="float32",
)
