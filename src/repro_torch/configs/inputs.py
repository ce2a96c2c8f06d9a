"""make_dummy_batch(): small real model inputs from a seed.

The modality frontends are stubs, as in the reference: the audio and
vision entries are precomputed frame and patch embeddings.  The draws are
the reference's (``numpy.random.RandomState(seed)``, in its order), so
both packages get the same arrays from one seed.  ``input_specs`` (the
reference's shape stand-ins for its dry run) waits for ``launch/dryrun.py``
(ROADMAP: Distributed and launch).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def make_dummy_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     *, device="cuda") -> dict[str, torch.Tensor]:
    """{"tokens": [batch, seq] int32} on ``device``, with ``"frames"``
    [batch, max(1, seq // encoder_downsample), d] (encoder-decoder family)
    or ``"patches"`` [batch, vision_seq, d] (vision family) in
    ``cfg.dtype``: 0.1 times a standard normal."""
    rng = np.random.RandomState(seed)
    out = {"tokens": torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (batch, seq)), dtype=torch.int32,
        device=device)}
    rows = {"encdec": ("frames", max(1, seq // cfg.encoder_downsample)),
            "vlm": ("patches", cfg.vision_seq)}.get(cfg.family)
    if rows is not None:
        key, n = rows
        out[key] = torch.as_tensor(0.1 * rng.randn(batch, n, cfg.d_model),
                                   device=device).to(cfg.dtype)
    return out
