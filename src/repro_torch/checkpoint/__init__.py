from repro_torch.checkpoint import bridge
