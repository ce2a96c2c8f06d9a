"""mamba2-780m — attention-free SSM (SSD).
[arXiv:2405.21060; unverified]  48L d_model=1536 d_ff=0 vocab=50280,
ssm_state=128, headdim=64 (d_inner=3072 -> 48 ssd heads), conv=4.
Sub-quadratic: runs long_500k."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    tie_embeddings=True,
    sub_quadratic=True,
)
