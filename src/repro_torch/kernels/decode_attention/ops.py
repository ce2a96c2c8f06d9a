"""K2: split-K flash-decode — the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.decode_attention`` (Pallas ``decode_attention_fwd``
plus its partial-softmax combine).  One query token per row against a
[B, S, Hkv, D] cache, each row with its own valid length ``kv_len``
(clamped to S: an idle serve slot's length keeps growing past the cache).

Layout: q [B, Hq, D]; k, v [B, S, Hkv, D]; kv_len [B] int; Hq = G * Hkv.
Returns [B, Hq, D] in q's dtype.  A row with kv_len = 0 gets zeros.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16          # query heads per KV head the kernel is built for
MIN_SPLIT_ROWS = 64     # fewest cache rows one split may hold
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY_POINTS = {
    "decode_attention_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p]),
}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """The plain version: one masked softmax over the cache in f32."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
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
    return o.reshape(b, hq, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(b: int, hkv: int, s: int, sm_count: int) -> int:
    """Splits per (row, KV head): enough blocks to cover every SM, but no
    split shorter than ``MIN_SPLIT_ROWS`` cache rows."""
    want = -(-sm_count // max(1, b * hkv))
    return max(1, min(want, s // MIN_SPLIT_ROWS))


def _check_cuda_inputs(q, k, v, kv_len):
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("decode_attention: q, k, v must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"decode_attention: q, k, v must share a dtype in "
                         f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q [B,Hq,D], k/v [B,S,Hkv,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"decode_attention: incompatible shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {hq // hkv} query heads per KV "
                         f"head exceeds {MAX_GROUP}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: q, k, v must be contiguous")
    if (kv_len.dtype != torch.int32 or kv_len.device != q.device
            or kv_len.shape != (b,) or not kv_len.is_contiguous()):
        raise ValueError("decode_attention: kv_len must be a contiguous "
                         "int32 [B] tensor on q's device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """K2 (split kernel + combine kernel) on a CUDA tensor, the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, kv_len)
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    out = torch.empty_like(q)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    ns = num_splits(b, hkv, s, _sm_count(q.device.index))
    split_size = -(-s // ns)
    ns = -(-s // split_size)
    f32 = dict(dtype=torch.float32, device=q.device)
    o_part = torch.empty((b, hkv, ns, g, d), **f32)
    m_part = torch.empty((b, hkv, ns, g), **f32)
    l_part = torch.empty((b, hkv, ns, g), **f32)
    lib = _build.load("decode_attention", _ENTRY_POINTS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            out.data_ptr(), b, s, hq, hkv, d, ns, split_size,
            _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, rc, "decode_attention_fwd")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0   # kernel launches since the last reset
