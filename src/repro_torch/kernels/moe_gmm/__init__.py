"""K14 (grouped expert matmul) and K15 (the same over int8/fp8 weights):
see ``ops``."""
