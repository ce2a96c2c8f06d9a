"""Temperature sampling: the draws of the reference engine, in torch on
the logits' device.

The reference samples with ``jax.random``: a token is
``categorical(fold_in(fold_in(PRNGKey(seed), rid), step), logits / T)``
(``repro.serve.engine``, ``_sample_fn`` and ``_sample_row``), so every
sampled token is a pure function of (seed, request id, step).  This module
re-creates the parts of JAX's threefry PRNG that those calls reach, as
JAX 0.9 computes them with ``jax_threefry_partitionable`` on (its
default), so that the port draws the reference's bits:

- :func:`prng_key` is ``PRNGKey(seed)`` for a seed in 32-bit mode: the
  key words (0, seed mod 2**32);
- :func:`fold_in` hashes the data word under the key,
  ``threefry_2x32(key, [0, data])``;
- :func:`random_bits` gives element ``i`` of a draw the counter pair
  (0, i) (a 64-bit counter split in a high and a low word) and keeps
  ``bits1 ^ bits2`` of the hash, cut to 8 or 16 bits for narrow draws;
- :func:`uniform` is ``_uniform``'s mantissa trick: the top ``nmant``
  bits of the draw under the exponent of 1.0, minus 1, scaled into
  [minval, maxval).  A type with fewer than 8 mantissa bits (bf16) draws
  8 bits, as JAX does;
- :func:`gumbel` is ``_gumbel``'s ``"low"`` mode, ``-log(-log(u))`` with
  u uniform in [tiny, 1), and :func:`categorical` the Gumbel-max trick,
  ``argmax(gumbel + logits)`` over the last axis, the noise drawn in the
  logits' dtype.

Unsigned 32-bit words are held in int64 tensors and masked to 32 bits
after every add and rotate (torch's uint32 arithmetic is partial on
CUDA), so the bits equal JAX's exactly.  The logarithms are the device's:
a gumbel may differ from JAX's by an ulp or two, which moves an argmax
only between near ties.  Everything runs on the logits' device and only
the [B] token ids leave it, the reference's transfer contract.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# mantissa bits and the bit pattern of 1.0 of each float type a draw takes
_FLOATS = {torch.float32: (23, 0x3F800000, torch.int32),
           torch.bfloat16: (7, 0x3F80, torch.int16),
           torch.float16: (10, 0x3C00, torch.int16)}

Word = Union[int, torch.Tensor]
Key = Tuple[torch.Tensor, torch.Tensor]


def threefry2x32(key: Key, x1: Word, x2: Word) -> Key:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words; all int64 tensors (or ints) holding 32-bit
    values, broadcast together.  Returns the two output words."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = (((b << r) & MASK) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` as JAX builds it in 32-bit mode: the
    seed cast to 32 bits is the low key word, the high word is 0."""
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.tensor(int(seed) & MASK, dtype=torch.int64, device=device))


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in``: ``data`` (an int, or an int tensor of
    per-row words broadcast against the key) hashed under ``key``."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data), dtype=torch.int64,
                            device=key[0].device)
    return threefry2x32(key, 0, data.to(torch.int64) & MASK)


def random_bits(key: Key, width: int, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` (8, 16 or 32) bits: an int64
    tensor of the key's batch shape followed by ``shape``.  Element i
    hashes the counter (0, i); a narrow draw keeps the low bits of
    ``bits1 ^ bits2``."""
    if width not in (8, 16, 32):
        raise ValueError(f"random_bits draws 8, 16 or 32 bits, got {width}")
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 1 << 32:
        raise ValueError("random_bits counts elements in one 32-bit word")
    k1, k2 = key
    lead = (None,) * len(shape)
    counts = torch.arange(n, dtype=torch.int64, device=k1.device).reshape(
        tuple(shape))
    b1, b2 = threefry2x32((k1[(...,) + lead], k2[(...,) + lead]), 0, counts)
    return (b1 ^ b2) & ((1 << width) - 1)


def uniform(key: Key, shape: Sequence[int], dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in ``dtype`` (float32, bfloat16 or float16):
    the draw's top mantissa bits under the exponent of 1.0, minus 1,
    scaled into [minval, maxval) and clipped below at ``minval``, every
    step in ``dtype``."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform draws {list(_FLOATS)}, got {dtype}")
    nmant, one, as_int = _FLOATS[dtype]
    nbits = torch.finfo(dtype).bits
    width = 8 if nmant < 8 else nbits
    bits = random_bits(key, width, shape)
    floats = ((bits >> (width - nmant)) | one).to(as_int).view(dtype) - 1
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


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
