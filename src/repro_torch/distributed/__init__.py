from repro_torch.distributed import sharding

__all__ = ["sharding"]
