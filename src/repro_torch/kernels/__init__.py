"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``flash_attention`` (K1, K10, K11), ``decode_attention`` (K2,
K3, K7, K8), ``mamba_ssd`` (K12, K13) and ``moe_gmm`` (K14, K15)."""
