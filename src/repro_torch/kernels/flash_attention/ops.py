"""K1: flash-attention forward, and K10, the same over a quantized KV
cache — the CUDA kernels' wrappers and their plain PyTorch versions.

Port of ``repro.kernels.flash_attention`` (Pallas ``flash_attention_fwd``).
Unlike the Pallas op, both versions take the valid KV length ``kv_len``
(an int or a [B] int tensor) and the absolute position ``q_offset`` of
query 0; ``None``/``None`` mean every KV row is valid and the suffix
alignment ``Skv - Sq`` the Pallas kernel computes.  With those two
arguments one call is what the model's prefill needs: causal attention of
the new tokens against the whole ``max_len`` cache, of which only the
first ``kv_len`` rows are live.

Layout: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq = G * Hkv.  Returns
(out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] f32).  A query row that
sees no KV row at all gets out = 0 and lse ~ NEG_INF in both versions.

K10 (port of ``flash_attention_fwd_quantized``) takes k and v as int8 or
fp8 e4m3 values with f16 scales [B, Skv, Hkv, 1] beside them, and keeps
K1's ``kv_len`` and ``q_offset``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

KvLen = Union[None, int, torch.Tensor]


def _kv_len_rows(kv_len: KvLen, b: int, skv: int,
                 device: torch.device) -> torch.Tensor:
    if kv_len is None:
        return torch.full((b,), skv, dtype=torch.int64, device=device)
    kl = torch.as_tensor(kv_len, device=device).to(torch.int64)
    return torch.broadcast_to(kl, (b,)).clamp(0, skv)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, kv_len: KvLen = None,
                          q_offset: Optional[int] = None,
                          block_k: int = 128):
    """The plain version: online softmax over KV blocks of ``block_k``
    rows in f32 (the reference's ``chunked_attention`` with ``lse``).
    Masked scores contribute exactly zero."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    offset = skv - sq if q_offset is None else int(q_offset)
    qpos = torch.arange(sq, device=dev) + offset
    kl = _kv_len_rows(kv_len, b, skv, dev)
    qf = (q.float() / math.sqrt(d)).reshape(b, sq, hkv, g, d)
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        kpos = torch.arange(k0, k0 + kb.shape[1], device=dev)
        mask = (kpos[None, None, :] < kl[:, None, None]).expand(
            b, sq, kb.shape[1])
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
        mask = mask[:, :, None, None, :]                  # [B,Sq,1,1,bk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (o / l[..., None]).reshape(b, sq, hq, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, sq, hq).permute(0, 2, 1).contiguous()
    return out, lse


def flash_attention_quantized_plain(q, k_q, k_scale, v_q, v_scale, *,
                                    causal: bool = True,
                                    kv_len: KvLen = None,
                                    q_offset: Optional[int] = None,
                                    block_k: int = 128):
    """The plain version of K10: dequantize, then K1's plain version (the
    reference oracle ``flash_attention_quant_ref``, with K1's ``kv_len``
    and ``q_offset``)."""
    return flash_attention_plain(
        q, quant.dequantize(k_q, k_scale), quant.dequantize(v_q, v_scale),
        causal=causal, kv_len=kv_len, q_offset=q_offset, block_k=block_k)


_ENTRY_POINTS = {
    "flash_attention_fwd": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                            + [ctypes.c_void_p]),
    "flash_attention_fwd_quantized": ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 11
                                      + [ctypes.c_void_p]),
}


def _check_cuda_inputs(q, k, v, scales=None):
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if scales is not None:
        quant.check_cache_inputs(q, k, v, *scales,
                                 what="flash_attention_quantized",
                                 q_dtypes=_DTYPE_CODES)
    elif q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v must share a dtype in "
                         f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D]"
                         f", got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"flash_attention: incompatible shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def _launch(wrapper, q, k, v, *, scales=None, causal, kv_len, q_offset):
    """Check the CUDA inputs of K1 (``wrapper`` = flash_attention) or K10
    (with ``scales`` = (k_scale, v_scale)), launch the kernel on the
    current stream and count the launch on ``wrapper``; returns (out,
    lse)."""
    if not q.is_cuda:
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v, scales)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rows, all_len = None, skv
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
        if (kv_len.dtype != torch.int32 or kv_len.device != q.device
                or kv_len.shape != (b,) or not kv_len.is_contiguous()):
            raise ValueError("flash_attention: a per-row kv_len must be a "
                             "contiguous int32 [B] tensor on q's device")
        rows = kv_len
    elif kv_len is not None:
        all_len = int(kv_len)
    offset = skv - sq if q_offset is None else int(q_offset)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    values = [k, v] if scales is None else [k, scales[0], v, scales[1]]
    store = [] if scales is None else [quant.STORE_CODES[k.dtype]]
    entry = "flash_attention_fwd" + ("_quantized" if store else "")
    lib = _build.load("flash_attention", _ENTRY_POINTS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in (q, *values, out, lse)),
            rows.data_ptr() if rows is not None else None, all_len, b, sq,
            skv, hq, hkv, d, offset, int(causal), _DTYPE_CODES[q.dtype],
            *store, stream)
    _build.check(lib, rc, entry)
    wrapper.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: KvLen = None,
                    q_offset: Optional[int] = None):
    """K1 on a CUDA tensor, the plain version on a CPU tensor.  Returns
    (out [B, Sq, Hq, D], lse [B, Hq, Sq] f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     q_offset=q_offset)
    return _launch(flash_attention, q, k, v, causal=causal, kv_len=kv_len,
                   q_offset=q_offset)


flash_attention.launches = 0   # kernel launches since the last reset


def flash_attention_quantized(q: torch.Tensor, k_q: torch.Tensor,
                              k_scale: torch.Tensor, v_q: torch.Tensor,
                              v_scale: torch.Tensor, *, causal: bool = True,
                              kv_len: KvLen = None,
                              q_offset: Optional[int] = None):
    """K10 on a CUDA tensor, the plain version on a CPU tensor.  Returns
    (out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] f32)."""
    if q.device.type == "cpu":
        return flash_attention_quantized_plain(
            q, k_q, k_scale, v_q, v_scale, causal=causal, kv_len=kv_len,
            q_offset=q_offset)
    return _launch(flash_attention_quantized, q, k_q, v_q,
                   scales=(k_scale, v_scale), causal=causal, kv_len=kv_len,
                   q_offset=q_offset)


flash_attention_quantized.launches = 0   # launches since the last reset
