"""K1: flash-attention forward (see ``ops``)."""
