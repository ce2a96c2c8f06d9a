"""qwen1.5-110b — dense GQA decoder with QKV bias.
[hf:Qwen/Qwen1.5-110B family; hf]  80L d_model=8192 64H (GQA kv=8)
d_ff=49152 vocab=152064."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    sub_quadratic=False,
)
