"""JAX's threefry key stream in torch: the parts of ``jax.random`` that
the port draws the reference's numbers from.

JAX 0.9 computes its draws with ``jax_threefry_partitionable`` on (its
default); so does this module:

- :func:`prng_key` is ``PRNGKey(seed)`` for a seed in 32-bit mode: the
  key words (0, seed mod 2**32);
- :func:`fold_in` hashes the data word under the key,
  ``threefry_2x32(key, [0, data])``;
- :func:`split` gives key ``i`` of ``num`` the hash of the counter pair
  (0, i), the partitionable ``_threefry_split_foldlike``;
- :func:`random_bits` gives element ``i`` of a draw the counter pair
  (0, i) (a 64-bit counter split in a high and a low word) and keeps
  ``bits1 ^ bits2`` of the hash, cut to 8 or 16 bits for narrow draws;
- :func:`uniform` is ``_uniform``'s mantissa trick: the top ``nmant``
  bits of the draw under the exponent of 1.0, minus 1, scaled into
  [minval, maxval).  A type with fewer than 8 mantissa bits (bf16) draws
  8 bits, as JAX does;
- :func:`normal` is ``_normal_real``: ``sqrt(2) * erfinv(u)`` with u
  uniform in (-1, 1), erfinv by the polynomial XLA evaluates.

A key is a pair of int64 tensors (the two 32-bit words) of any batch
shape: every function maps over it as ``jax.vmap`` over a key array
would.  Unsigned 32-bit words are held in int64 tensors and masked to 32
bits after every add and rotate (torch's uint32 arithmetic is partial on
CUDA), so the bits equal JAX's exactly.  The logarithm inside erfinv
is the device's, so a normal may differ from JAX's by an ulp or two.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
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


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)``: a key of the input's batch shape
    followed by ``[num]``; key ``i`` hashes the counter (0, i)."""
    k1, k2 = key
    counts = torch.arange(num, dtype=torch.int64, device=k1.device)
    return threefry2x32((k1[..., None], k2[..., None]), 0, counts)


def unstack(key: Key) -> list:
    """The keys along the last axis of a batched key, as JAX unpacks
    ``k1, k2 = split(key)``."""
    k1, k2 = key
    return [(a, b) for a, b in zip(k1.unbind(-1), k2.unbind(-1))]


# Giles' single-precision erfinv ("Approximating the erfinv function",
# 2010), the polynomial XLA lowers ``erf_inv`` to for float32: w =
# -log1p(-x^2); on w < 5 a degree-8 polynomial in w - 2.5, else in
# sqrt(w) - 3, times x.  Its Horner steps are fused multiply-adds, as XLA
# contracts them.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erfinv of float32 ``x`` in (-1, 1) by XLA's polynomial."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, a, b)
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = torch.addcmul(c, p, w)
    return p * x


def normal(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)``, u
    uniform in [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, torch.float32, minval=lo, maxval=1.0)
    return _erfinv_f32(u) * torch.tensor(math.sqrt(2.0), dtype=u.dtype,
                                         device=u.device)
