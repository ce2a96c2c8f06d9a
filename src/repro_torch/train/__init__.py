from repro_torch.train import optimizer, train_step, trainer

__all__ = ["optimizer", "train_step", "trainer"]
