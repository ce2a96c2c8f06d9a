"""seamless-m4t-large-v2 — enc-dec multimodal (audio) backbone.
[arXiv:2308.11596; hf]  24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206.  Implemented as 24 encoder + 24 decoder layers (the released
model's speech encoder and text decoder are 24L each); the audio frontend is
a stub per the assignment — input_specs() provides precomputed frame
embeddings at seq/4."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    encoder_downsample=4,
    sub_quadratic=False,
)
