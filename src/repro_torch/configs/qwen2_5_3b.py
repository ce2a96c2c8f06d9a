"""qwen2.5-3b — dense GQA decoder with QKV bias.
[hf:Qwen/Qwen2.5-3B family; hf]  36L d_model=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    sub_quadratic=False,
)
