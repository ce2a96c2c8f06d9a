"""zamba2-2.7b — hybrid: Mamba2 backbone + one shared attention block.
[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64.  The shared transformer block (weights reused)
is applied every 6 SSD layers on concat([hidden, embeddings]) — 9
applications.  Sub-quadratic-dominated: runs long_500k."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_conv=4,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    attn_every=6,
    sub_quadratic=True,
)
