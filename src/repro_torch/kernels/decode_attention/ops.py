"""K2 and K3: split-K flash-decode over a contiguous cache (K2) and over a
shared page pool (K3), and K7 and K8, the same over a quantized cache —
the CUDA kernels' wrappers and their plain PyTorch versions.

Port of ``repro.kernels.decode_attention`` (Pallas ``decode_attention_fwd``
and ``paged_decode_attention_fwd``, each with its partial-softmax
combine).  One query token per row, each row with its own valid length
``kv_len`` (clamped to the rows the cache holds: an idle serve slot's
length keeps growing past it).

K2 layout: q [B, Hq, Dk]; k [B, S, Hkv, Dk]; v [B, S, Hkv, Dv]; kv_len
[B] int; Hq = G * Hkv.  K3 layout: k_pool [Np, ps, Hkv, Dk], v_pool
[Np, ps, Hkv, Dv]; page_table [B, P] int, logical page j of row b is pool
page ``page_table[b, j]``, so row b sees the P * ps logical rows of
``k_pool[page_table[b]]``.  Both return [B, Hq, Dv] in q's dtype; a row
with kv_len = 0 gets zeros.  They take the (Dk, Dv) pairs of
``HEAD_DIM_PAIRS``: the square head dims of the dense decoder and MLA's
absorbed decode, where one latent KV head of kv_lora + qk_rope columns
(576 at full width, 40 reduced) serves as K and its first kv_lora
columns (512, 32) as V.  The
two kernels are one split kernel with two row addresses (see
``csrc/decode_attention.cu``), so K3 on a pool equals K2 on the gathered
cache bit for bit.

K7 and K8 (port of ``decode_attention_fwd_quantized`` and
``paged_decode_attention_fwd_quantized``) take the cache as int8 or fp8
e4m3 values plus f16 scales [.., Hkv, 1] laid out like them (pools of
scale pages for K8, named by the same page table): q, k_q, k_scale, v_q,
v_scale, [page_table,] kv_len.  They are the split kernel with the
quantized value format, so K8 on a pool equals K7 on the gathered cache
bit for bit.  They take square head dims only (``HEAD_DIMS``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)          # K7 and K8: Dk == Dv
# (Dk, Dv) pairs K2 and K3 are built for (``SplitDims`` in
# csrc/decode_attention.cu)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((576, 512), (40, 32))
MAX_GROUP = 16          # query heads per KV head the kernel is built for
MIN_SPLIT_ROWS = 64     # fewest cache rows one split may hold
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY_POINTS = {
    "decode_attention_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                             + [ctypes.c_void_p]),
    "paged_decode_attention_fwd": ([ctypes.c_void_p] * 9
                                   + [ctypes.c_int] * 10
                                   + [ctypes.c_void_p]),
    "decode_attention_fwd_quantized": ([ctypes.c_void_p] * 10
                                       + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p]),
    "paged_decode_attention_fwd_quantized": ([ctypes.c_void_p] * 11
                                             + [ctypes.c_int] * 10
                                             + [ctypes.c_void_p]),
}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """The plain version: one masked softmax over the cache in f32; v may
    be narrower than q and k (Dv != Dk), the scale is 1 / sqrt(Dk)."""
    b, hq, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) / math.sqrt(d)
    kl = torch.as_tensor(kv_len, device=q.device).to(torch.int64)
    mask = torch.arange(s, device=q.device)[None, :] < kl.clamp(0, s)[:, None]
    mask = mask[:, None, None, :]
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, hq, dv).to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_len: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: gather each row's pages back to a
    contiguous [B, P * ps, Hkv, D] cache and run the plain K2.  A table
    entry outside the pool raises (torch indexing)."""
    b, pages = page_table.shape
    ps = k_pool.shape[1]
    pt = page_table.to(torch.long)
    k = k_pool[pt].reshape(b, pages * ps, *k_pool.shape[2:])
    v = v_pool[pt].reshape(b, pages * ps, *v_pool.shape[2:])
    return decode_attention_plain(q, k, v, kv_len)


def decode_attention_quantized_plain(q, k_q, k_scale, v_q, v_scale,
                                    kv_len) -> torch.Tensor:
    """The plain version of K7: dequantize, then K2's plain version (the
    reference oracle ``decode_attention_quant_ref``)."""
    return decode_attention_plain(q, quant.dequantize(k_q, k_scale),
                                  quant.dequantize(v_q, v_scale), kv_len)


def paged_decode_attention_quantized_plain(q, k_pool, k_scale, v_pool,
                                           v_scale, page_table,
                                           kv_len) -> torch.Tensor:
    """The plain version of K8: gather values and scale pages through the
    page table, dequantize, run K2's plain version."""
    b, pages = page_table.shape
    pt = page_table.to(torch.long)

    def rows(pool):   # fp8 pools are gathered as bytes
        got = quant.as_bytes(pool)[pt].view(pool.dtype)
        return got.reshape(b, pages * pool.shape[1], *pool.shape[2:])

    return decode_attention_quantized_plain(
        q, rows(k_pool), rows(k_scale), rows(v_pool), rows(v_scale), kv_len)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(b: int, hkv: int, s: int, sm_count: int) -> int:
    """Splits per (row, KV head): enough blocks to cover every SM, but no
    split shorter than ``MIN_SPLIT_ROWS`` cache rows."""
    want = -(-sm_count // max(1, b * hkv))
    return max(1, min(want, s // MIN_SPLIT_ROWS))


def _check_cuda_inputs(q, k, v, kv_len, *, what="decode_attention",
                       pool=False, scales=None):
    """Checks shared by K2, K3, K7 and K8; ``k``/``v`` are [B, S, Hkv, Dk]
    / [B, S, Hkv, Dv] caches, or [Np, ps, Hkv, Dk] / [.., Dv] pools with no
    batch axis (``pool=True``), (Dk, Dv) in ``HEAD_DIM_PAIRS``; ``scales``
    is (k_scale, v_scale) for a quantized cache (Dk == Dv)."""
    pairs = HEAD_DIM_PAIRS if scales is None else tuple(
        (d, d) for d in HEAD_DIMS)
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError(f"{what}: q, k, v must be on one CUDA device")
    if scales is None:
        if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
            raise ValueError(f"{what}: q, k, v must share a dtype in "
                             f"{list(_DTYPE_CODES)}, got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
    else:
        quant.check_cache_inputs(q, k, v, *scales, what=what,
                                 q_dtypes=_DTYPE_CODES)
    if (q.dim() != 3 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3]):
        raise ValueError(f"{what}: q [B,Hq,Dk], k [..,Hkv,Dk] and v "
                         f"[..,Hkv,Dv] of one leading shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if (not pool and k.shape[0] != b) or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{what}: incompatible shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if (d, v.shape[3]) not in pairs:
        raise ValueError(f"{what}: head_dim pair (Dk, Dv) = "
                         f"{(d, v.shape[3])} not in {pairs}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"{what}: {hq // hkv} query heads per KV head "
                         f"exceeds {MAX_GROUP}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    fa_ops.check_aligned(what, q, *(() if scales else (k, v)))
    if (kv_len.dtype != torch.int32 or kv_len.device != q.device
            or kv_len.shape != (b,) or not kv_len.is_contiguous()):
        raise ValueError(f"{what}: kv_len must be a contiguous int32 [B] "
                         f"tensor on q's device")


def _check_page_table(page_table, q, what: str) -> None:
    if (page_table.dtype != torch.int32 or page_table.device != q.device
            or page_table.dim() != 2 or page_table.shape[0] != q.shape[0]
            or not page_table.is_contiguous()):
        raise ValueError(f"{what}: page_table must be a contiguous int32 "
                         f"[B, P] tensor on q's device")


def _split_scratch(q, hkv: int, s: int, dv: int):
    """K2's and K3's split plan over ``s`` logical rows and its f32
    scratch: (num_splits, split_size, o_part, m_part, l_part)."""
    b, hq, _ = q.shape
    ns = num_splits(b, hkv, s, _sm_count(q.device.index))
    split_size = -(-s // ns)
    ns = -(-s // split_size)
    f32 = dict(dtype=torch.float32, device=q.device)
    return (ns, split_size,
            torch.empty((b, hkv, ns, hq // hkv, dv), **f32),
            torch.empty((b, hkv, ns, hq // hkv), **f32),
            torch.empty((b, hkv, ns, hq // hkv), **f32))


def _launch(wrapper, q, k, v, kv_len, *, scales=None, page_table=None):
    """Check the CUDA inputs of K2 (``wrapper`` = decode_attention), K3
    (with ``page_table``), K7 (with ``scales`` = (k_scale, v_scale)) or K8
    (with both), launch the split and combine kernels on the current
    stream and count the launch on ``wrapper``; returns out."""
    what = wrapper.__name__
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    paged = page_table is not None
    _check_cuda_inputs(q, k, v, kv_len, what=what, pool=paged, scales=scales)
    b, hq, d = q.shape
    hkv = k.shape[2]
    if paged:
        _check_page_table(page_table, q, what)
        shape = (page_table.shape[1], k.shape[1])   # pages, page size
    else:
        shape = (k.shape[1],)                       # cache rows
    rows = math.prod(shape)
    dv = v.shape[3]
    out = q.new_empty((b, hq, dv))
    if out.numel() == 0 or rows == 0:
        return out.zero_()
    ns, split_size, o_part, m_part, l_part = _split_scratch(q, hkv, rows, dv)
    values = [k, v] if scales is None else [k, scales[0], v, scales[1]]
    tables = [page_table] if paged else []
    store = [] if scales is None else [quant.STORE_CODES[k.dtype]]
    dims = [d] if store else [d, dv]     # K7 and K8 are square
    entry = ("paged_" if paged else "") + "decode_attention_fwd" + (
        "_quantized" if store else "")
    lib = _build.load("decode_attention", _ENTRY_POINTS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in (q, *values, *tables, kv_len, o_part,
                                     m_part, l_part, out)),
            b, *shape, hq, hkv, *dims, ns, split_size, _DTYPE_CODES[q.dtype],
            *store, stream)
    _build.check(lib, rc, entry)
    wrapper.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """K2 (split kernel + combine kernel) on a CUDA tensor, the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    return _launch(decode_attention, q, k, v, kv_len)


decode_attention.launches = 0   # kernel launches since the last reset


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """K3 (K2's split kernel over the page table + K2's combine kernel) on
    a CUDA tensor, the plain version on a CPU tensor.  Splits are planned
    over the P * ps logical rows exactly as K2 plans them over S rows.
    Table entries must lie in [0, Np): the kernel reads them unchecked
    (checking would cost a device-to-host sync per call)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            kv_len)
    return _launch(paged_decode_attention, q, k_pool, v_pool, kv_len,
                   page_table=page_table)


paged_decode_attention.launches = 0   # kernel launches since the last reset


def decode_attention_quantized(q: torch.Tensor, k_q: torch.Tensor,
                               k_scale: torch.Tensor, v_q: torch.Tensor,
                               v_scale: torch.Tensor,
                               kv_len: torch.Tensor) -> torch.Tensor:
    """K7 (K2's split kernel over int8 / fp8 values and f16 scales + K2's
    combine kernel) on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_quantized_plain(q, k_q, k_scale, v_q,
                                                v_scale, kv_len)
    return _launch(decode_attention_quantized, q, k_q, v_q, kv_len,
                   scales=(k_scale, v_scale))


decode_attention_quantized.launches = 0   # launches since the last reset


def paged_decode_attention_quantized(q: torch.Tensor, k_pool: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     page_table: torch.Tensor,
                                     kv_len: torch.Tensor) -> torch.Tensor:
    """K8 (K3 over quantized value pages and f16 scale pages, named by the
    same page table) on a CUDA tensor, the plain version on a CPU tensor.
    Table entries must lie in [0, Np), unchecked as for K3."""
    if q.device.type == "cpu":
        return paged_decode_attention_quantized_plain(
            q, k_pool, k_scale, v_pool, v_scale, page_table, kv_len)
    return _launch(paged_decode_attention_quantized, q, k_pool, v_pool,
                   kv_len, scales=(k_scale, v_scale), page_table=page_table)


paged_decode_attention_quantized.launches = 0   # launches since last reset
