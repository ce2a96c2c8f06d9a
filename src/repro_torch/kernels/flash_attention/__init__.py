"""K1 (flash-attention forward), K10 (the same over a quantized KV cache)
and K11 (flash-attention backward): see ``ops``."""
