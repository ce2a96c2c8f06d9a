"""deepseek-v2-236b — MoE with Multi-head Latent Attention.
[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff(expert)=1536
vocab=102400; MLA kv_lora=512 q_lora=1536, qk_nope=128 qk_rope=64 v=128;
2 shared + 160 routed experts, top-6; first layer dense (d_ff 12288)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,            # dense-layer ff (layer 0)
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    dense_d_ff=12288,
    sub_quadratic=False,
)
