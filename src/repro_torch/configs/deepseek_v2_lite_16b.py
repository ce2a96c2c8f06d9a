"""deepseek-v2-lite-16b — MoE with MLA (no q-lora).
[arXiv:2405.04434; hf]  27L d_model=2048 16H d_ff(expert)=1408
vocab=102400; MLA kv_lora=512; 2 shared + 64 routed experts, top-6;
first layer dense (d_ff 10944)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    dense_d_ff=10944,
    sub_quadratic=False,
)
