"""K12 (Mamba2 SSD chunked scan) and K13 (the same over int8/fp8 x): see
``ops``."""
