"""llama-3.2-vision-11b — VLM: text backbone with gated cross-attention
image layers.  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; 8 cross-attn
layers interleaved (here: 8 groups of 4 self + 1 gated cross).  The vision
tower is a stub per the assignment — input_specs() provides precomputed
patch embeddings [B, 1601, d]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_groups=8,
    self_per_group=4,
    vision_seq=1601,
    rope_theta=500000.0,
    sub_quadratic=False,
)
