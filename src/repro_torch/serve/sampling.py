"""Temperature sampling: the draws of the reference engine, in torch on
the logits' device.

The reference samples with ``jax.random``: a token is
``categorical(fold_in(fold_in(PRNGKey(seed), rid), step), logits / T)``
(``repro.serve.engine``, ``_sample_fn`` and ``_sample_row``), so every
sampled token is a pure function of (seed, request id, step).  This module
draws the reference's bits from JAX's threefry key stream
(:mod:`repro_torch.core.prng`: ``PRNGKey``, ``fold_in``, the partitionable
bits and ``_uniform``, re-exported here) and adds:

- :func:`gumbel` is ``_gumbel``'s ``"low"`` mode, ``-log(-log(u))`` with
  u uniform in [tiny, 1), and :func:`categorical` the Gumbel-max trick,
  ``argmax(gumbel + logits)`` over the last axis, the noise drawn in the
  logits' dtype.

The bits equal JAX's exactly.  The logarithms are the device's:
a gumbel may differ from JAX's by an ulp or two, which moves an argmax
only between near ties.  Everything runs on the logits' device and only
the [B] token ids leave it, the reference's transfer contract.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.prng import (Key, fold_in, prng_key, random_bits,
                                   threefry2x32, uniform)

__all__ = ["categorical", "fold_in", "gumbel", "prng_key",
           "random_bits", "sample", "threefry2x32", "uniform"]


def gumbel(key: Key, shape: Sequence[int],
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in ``dtype``:
    ``-log(-log(u))``, u uniform in [tiny, 1)."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits`` [..., V]
    with a key of the leading shape: ``argmax(gumbel + logits)``, the
    noise in the logits' dtype, the first index on a tie.  Returns int64
    ids of the leading shape."""
    noise = gumbel(key, logits.shape[-1:], logits.dtype)
    return torch.argmax(noise + logits, dim=-1)


def sample(logits: torch.Tensor, seed: int, rids, steps,
           temperature: float) -> torch.Tensor:
    """The engine's draw: row b of ``logits`` [B, V] samples
    ``categorical(fold_in(fold_in(PRNGKey(seed), rids[b]), steps[b]),
    logits[b] / temperature)`` on the logits' device; ``rids`` and
    ``steps`` are [B] int arrays (or scalars, broadcast).  Returns [B]
    int64 ids on that device."""
    dev = logits.device
    b = logits.shape[0]

    def words(x):
        return torch.broadcast_to(
            torch.as_tensor(x, dtype=torch.int64).to(dev), (b,))

    key = fold_in(fold_in(prng_key(seed, dev), words(rids)), words(steps))
    # the temperature in the logits' dtype, as JAX casts a Python scalar
    temp = torch.tensor(temperature, dtype=logits.dtype, device=dev)
    return categorical(key, logits / temp)
