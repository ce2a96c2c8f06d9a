"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``flash_attention`` = K1, ``decode_attention`` = K2)."""
