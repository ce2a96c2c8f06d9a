from repro_torch.data import pipeline

__all__ = ["pipeline"]
