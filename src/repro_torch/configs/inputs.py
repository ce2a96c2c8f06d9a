"""input_specs(): meta-tensor stand-ins for every model input;
make_dummy_batch(): small real model inputs from a seed.

The dry run (``launch/dryrun.py``) counts a step on the stand-ins, which
hold no data.  The modality frontends are stubs, as in the reference: the
audio and vision entries are precomputed frame and patch embeddings.  The
draws are the reference's (``numpy.random.RandomState(seed)``, in its
order), so both packages get the same arrays from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """{name: meta tensor} for one (arch, shape) cell, the reference's
    shapes and dtypes: ``"tokens"`` int32 [B, S] at train and prefill, [B,
    1] at decode (the KV cache is the decode step's own argument, made by
    ``Model.init_cache``); the encoder-decoder family's ``"frames"`` [B, S
    // encoder_downsample, d] and the vision family's ``"patches"`` [B,
    vision_seq, d], bf16, except at decode."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda *dims, dtype: torch.empty(dims, dtype=dtype, device="meta")
    specs = {"tokens": meta(b, 1 if shape.kind == "decode" else s,
                            dtype=torch.int32)}
    if shape.kind != "decode":
        if cfg.family == "encdec":
            specs["frames"] = meta(b, s // cfg.encoder_downsample,
                                   cfg.d_model, dtype=torch.bfloat16)
        if cfg.family == "vlm":
            specs["patches"] = meta(b, cfg.vision_seq, cfg.d_model,
                                    dtype=torch.bfloat16)
    return specs


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
