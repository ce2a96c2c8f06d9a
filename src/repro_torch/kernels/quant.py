"""Symmetric per-vector quantization for KV caches.

Port of ``repro.kernels.quant``.  Each vector along ``axis`` (a KV
token's head slice) gets one scale ``max|x| / qmax`` and its values round
to the storage dtype: int8 (qmax 127) or fp8 e4m3 (``float8_e4m3fn``,
qmax 448).  The scale is constant along the contraction axis of both
attention products, so the quantized kernels (K7, K8, K10) apply it to
the scores and to ``p`` instead of dequantizing the values.

``quantize`` gives the reference's bytes bit for bit, values and scales
alike: the scale is computed in f32, rounded to the stored scale dtype
and clamped at that dtype's smallest normal, and ``x / scale`` is a true
division in f32 (``torch.round`` rounds half to even, as ``jnp.round``
does).  PyTorch's f32 -> fp8 cast saturates where ml_dtypes' gives NaN
(past 464), but the f16-rounded scale keeps ``|x / scale|`` within
``448 * (1 + 2**-11)``, where the two casts agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "SCALE_DTYPE",
    "STORE_CODES",
    "as_bytes",
    "check_cache_inputs",
    "dequantize",
    "is_quant_dtype",
    "kv_byte_ratio",
    "max_abs_error",
    "quant_dtypes",
    "quantize",
    "supports_fp8",
]

# cache scales are stored half-width: an f32 scale per D-wide vector would
# claw back 4/D of the byte win; f16's 2**-11 rounding is far below the
# int8 step itself
SCALE_DTYPE = torch.float16

_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}

# storage dtype codes of the quantized kernels (csrc/common.cuh)
STORE_CODES = {torch.int8: 2}
if hasattr(torch, "float8_e4m3fn"):
    STORE_CODES[torch.float8_e4m3fn] = 3


def supports_fp8() -> bool:
    """Whether the installed torch has float8_e4m3fn."""
    return hasattr(torch, "float8_e4m3fn")


def quant_dtypes() -> Tuple[str, ...]:
    """Quantized storage dtype names available on this install, int8
    first."""
    return ("int8", "float8_e4m3fn") if supports_fp8() else ("int8",)


def _name(dtype) -> Optional[str]:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return None if dtype is None else str(dtype)


def is_quant_dtype(dtype) -> bool:
    """True for the dtypes (torch dtype or name) this module quantizes
    to."""
    return _name(dtype) in quant_dtypes()


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor's storage as a uint8 view (PyTorch lacks some
    indexing kernels for fp8, e.g. ``index_copy_`` on the CPU), any other
    tensor itself: copies through the view move the same bits."""
    return t.view(torch.uint8) if t.dtype == getattr(
        torch, "float8_e4m3fn", None) else t


def check_cache_inputs(q, k, v, k_scale, v_scale, *, what: str,
                       q_dtypes) -> None:
    """The dtype and layout checks a quantized kernel (K7, K8, K10) makes
    of its cache: values of one storage dtype in :data:`STORE_CODES`, f16
    scales ``k.shape[:-1] + (1,)`` beside them, contiguous, on q's
    device, and q of a dtype in ``q_dtypes``."""
    if q.dtype not in q_dtypes:
        raise ValueError(f"{what}: q dtype must be one of {list(q_dtypes)}, "
                         f"got {q.dtype}")
    if k.dtype not in STORE_CODES or k.dtype != v.dtype:
        raise ValueError(f"{what}: k, v must share a storage dtype in "
                         f"{list(STORE_CODES)}, got {k.dtype}, {v.dtype}")
    if k.data_ptr() % 4 or v.data_ptr() % 4:
        raise ValueError(f"{what}: k, v must start 4-byte aligned (the "
                         f"kernels read four values a word)")
    want = tuple(k.shape[:-1]) + (1,)
    for sc in (k_scale, v_scale):
        if sc.dtype != SCALE_DTYPE:
            raise ValueError(f"{what}: scales must be {SCALE_DTYPE}, got "
                             f"{sc.dtype}")
        if (sc.device != q.device or tuple(sc.shape) != want
                or not sc.is_contiguous()):
            raise ValueError(f"{what}: scales must be contiguous {want} on "
                             f"q's device, got {tuple(sc.shape)} on "
                             f"{sc.device}")


def quantize(x: torch.Tensor, *, dtype=torch.int8, axis: int = -1,
             scale_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector quantization along ``axis``.

    Returns ``(q, scale)`` with ``scale = max|x| / qmax`` kept as a size-1
    axis, so ``q * scale`` broadcasts back.  ``scale_dtype`` defaults to
    f32; pass :data:`SCALE_DTYPE` for cache storage: the scale is rounded
    before use, so quantize and dequantize agree with what a cache
    holds."""
    name = _name(dtype)
    if name not in _QMAX:
        raise ValueError(f"unsupported quantized dtype {name!r} "
                         f"(expected one of {sorted(_QMAX)})")
    if name not in quant_dtypes():
        raise ValueError(f"{name} requested but this torch has no fp8 "
                         f"dtypes")
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / _QMAX[name]
    if scale_dtype is not None:
        # a narrow stored scale underflows for vectors whose amax sits
        # below qmax * (smallest subnormal): clamp at the smallest normal
        # so dequantize stays finite (such values round to zero)
        scale = torch.clamp_min(scale.to(scale_dtype),
                                torch.finfo(scale_dtype).tiny)
    y = xf / scale.float()
    if name == "int8":
        q = torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    else:
        q = y.to(torch.float8_e4m3fn)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 reconstruction ``q * scale``: the oracle the kernels chase."""
    return q.float() * scale.float()


def max_abs_error(scale, amax, dtype="int8") -> torch.Tensor:
    """Elementwise error bound of one quantize/dequantize round trip.

    int8: rounding contributes ``scale / 2``; an f16-stored scale adds
    ``|q| * scale * 2**-11 <= amax * 2**-11``.  fp8 e4m3 has 3 mantissa
    bits: relative error ``2**-4`` of the magnitude plus one subnormal
    step.  A slack of 1.01 absorbs f32 rounding in the bound itself."""
    scale = torch.as_tensor(scale).float()
    amax = torch.as_tensor(amax).float()
    if _name(dtype) == "int8":
        return (0.5 * scale + amax * 2.0 ** -11) * 1.01
    return (amax * 2.0 ** -4 + scale * 2.0 ** -8 + amax * 2.0 ** -11) * 1.01


def kv_byte_ratio(head_dim: int, *, dtype="int8",
                  wide_bytes: int = 2) -> float:
    """Bytes per token of a ``wide_bytes``-wide KV cache over the
    quantized one (1-byte values plus one f16 scale per D-wide vector):
    the factor by which a fixed page budget's concurrency grows."""
    itemsize = getattr(torch, _name(dtype)).itemsize
    scale_bytes = SCALE_DTYPE.itemsize
    return (wide_bytes * head_dim) / (itemsize * head_dim + scale_bytes)
