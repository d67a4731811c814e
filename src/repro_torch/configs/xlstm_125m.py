"""xlstm-125m — exact assigned configuration + reduced smoke variant."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    norm="layernorm", block_pattern=("mlstm", "slstm"),
)

REDUCED = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=512,
    norm="layernorm", block_pattern=("mlstm", "slstm"), dtype="float32", kv_cache_dtype="float32",
)
