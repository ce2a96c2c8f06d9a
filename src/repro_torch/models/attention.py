"""Attention: the GQA block (projections, RoPE, KV cache) and the dispatch
to the port's kernels.

Every attention call goes through :func:`attention`, which picks the
kernel by call shape: the per-row single-token decode of continuous serve
goes to K2 (``kernels.decode_attention``), or to K3 when it carries a page
table (paged serve); prefill, the continuation prefill of a prefix hit,
the cache-less forward and the scalar-length decode of ``generate()`` go
to K1 (``kernels.flash_attention``).  A quantized cache (int8 / fp8
values with f16 scales) goes to their quantized twins: K7, K8 and K10.
A call that needs a gradient (training: grad mode on, q, k or v requiring
grad, no cache) goes through ``FlashAttentionFunction``: K1 forward, K11
backward.  Each kernel's wrapper launches the CUDA kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor.

Layout convention: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq = G * Hkv.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers

NEG_INF = -1e30


def naive_attention(q, k, v, *, causal=True, kv_len=None, q_offset=None):
    """O(S²)-memory oracle (tests & tiny shapes only)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(d)
    offset = q_offset if q_offset is not None else skv - sq
    qpos = torch.arange(sq, device=q.device) + offset
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])[None]
    if kv_len is not None:
        kl = torch.broadcast_to(torch.as_tensor(kv_len, device=q.device), (b,))
        mask = mask & (kpos[None, None, :] < kl[:, None, None])
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, block_k=None, kv_len=None,
                      q_offset=None):
    """Flash-style attention over KV blocks with running (m, l, o) — K1's
    plain version, the path :func:`attention` takes on the CPU."""
    return fa_ops.flash_attention_plain(
        q, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset,
        block_k=block_k or 128)[0]


def attention(q, k, v, *, causal=True, kv_len=None, q_offset=None,
              page_table=None, k_scale=None, v_scale=None):
    """Dispatch by call shape: a per-row ([B] ``kv_len``) single-query call
    is the decode tick and goes to K3 if it carries a ``page_table`` (then
    ``k``/``v`` are page pools), else to K2; everything else goes to K1.
    With ``k_scale``/``v_scale``, ``k``/``v`` are a quantized cache and the
    same calls go to K8, K7 and K10.  A call that needs a gradient goes
    through ``FlashAttentionFunction`` (K1 forward, K11 backward); only
    the cache-less call (no ``kv_len``, ``q_offset``, page table or
    scales) has a backward."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if (kv_len is not None or q_offset is not None
                or page_table is not None or k_scale is not None):
            raise NotImplementedError(
                "attention with a cache has no backward: only the "
                "cache-less call (training) is differentiable")
        return fa_ops.flash_attention_autograd(q, k, v, causal=causal)
    per_row_decode = (isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1
                      and q.shape[1] == 1 and not causal)
    quantized = k_scale is not None
    if page_table is not None:
        if not per_row_decode:
            raise ValueError("a page table needs the per-row single-query "
                             "decode call (causal=False, [B] kv_len)")
        if quantized:
            return decode_ops.paged_decode_attention_quantized(
                q[:, 0], k, k_scale, v, v_scale, page_table,
                kv_len)[:, None]
        return decode_ops.paged_decode_attention(q[:, 0], k, v, page_table,
                                                 kv_len)[:, None]
    if per_row_decode:
        if quantized:
            return decode_ops.decode_attention_quantized(
                q[:, 0], k, k_scale, v, v_scale, kv_len)[:, None]
        return decode_ops.decode_attention(q[:, 0], k, v, kv_len)[:, None]
    if quantized:
        return fa_ops.flash_attention_quantized(
            q, k, k_scale, v, v_scale, causal=causal, kv_len=kv_len,
            q_offset=q_offset)[0]
    return fa_ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                  q_offset=q_offset)[0]


# ---------------------------------------------------------------------------
# Standard GQA attention block (projections + rope + cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    use_rope: bool = True


def attn_init(gen, cfg: AttnConfig, *, lead=(), dtype=torch.float32):
    hd = cfg.head_dim
    return {
        "wq": layers.dense_init(gen, cfg.d_model, cfg.n_heads * hd, lead=lead,
                                bias=cfg.qkv_bias, dtype=dtype),
        "wk": layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                                lead=lead, bias=cfg.qkv_bias, dtype=dtype),
        "wv": layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                                lead=lead, bias=cfg.qkv_bias, dtype=dtype),
        "wo": layers.dense_init(
            gen, cfg.n_heads * hd, cfg.d_model, lead=lead,
            stddev=1.0 / math.sqrt(cfg.n_heads * hd), dtype=dtype),
    }


def attn_apply(p, cfg: AttnConfig, x: torch.Tensor, *,
               cache: Optional[dict] = None,
               positions: Optional[torch.Tensor] = None):
    """Returns (out [B,S,d], new_cache or None).

    ``cache`` is one layer's {"k", "v": [B, Smax, Hkv, D], "len"}: ``len``
    a scalar (prefill, ``generate()``) or a [B] vector (continuous serve,
    each slot at its own position).  The new tokens' K/V are written into
    ``cache["k"]``/``cache["v"]`` in place; the returned dict holds those
    same tensors and the advanced ``len``.  Every write index is clamped
    to ``Smax - s``, as the reference's ``dynamic_update_slice`` clamps
    it, so an idle serve slot whose length runs past the cache keeps
    rewriting its last row instead of indexing out of range.

    A paged cache (paged serve) is {"k", "v": pools [Np+1, ps, Hkv, D],
    "pt": [B, P] int32, "len": [B]}: the token is written in place into
    the row's current page and attention reads the pool through the page
    table (K3), with no contiguous view on the card.

    A quantized cache (int8 / fp8 ``k``/``v``) carries f16 scales "ks",
    "vs" [.., Hkv, 1] beside the values, in each of these forms: the new
    tokens are quantized once, values and scales written in place, and
    attention reads the quantized cache (K10, K7, K8), as the reference
    attends over its dequantized cache, the prompt's own tokens included.
    The per-row multi-token verify raises ``NotImplementedError``; the
    reference's sequence-sharded decode has no counterpart yet (ROADMAP:
    distributed and launch).
    """
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = layers.dense(p["wq"], x).reshape(b, s, hq, hd)
    k = layers.dense(p["wk"], x).reshape(b, s, hkv, hd)
    v = layers.dense(p["wv"], x).reshape(b, s, hkv, hd)

    if cache is None:
        if cfg.use_rope:
            pos = (positions if positions is not None
                   else torch.arange(s, device=x.device)[None, :])
            pos = torch.broadcast_to(pos, (b, s))
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            k = layers.apply_rope(k, pos, cfg.rope_theta)
        out = attention(q, k, v, causal=cfg.causal)
        return layers.dense(p["wo"], out.reshape(b, s, hq * hd)), None

    length = cache["len"]
    per_row = length.dim() == 1
    if "pt" in cache and not per_row:
        raise ValueError("paged KV cache requires per-row lengths "
                         "(run set_cache_lengths / the serve path)")
    if per_row and s != 1:
        raise NotImplementedError(
            "per-row multi-token verify: not ported yet (ROADMAP: "
            "speculation)")
    ck, cv = cache["k"], cache["v"]
    if "pt" in cache:
        return _paged_decode(p, cfg, q, k, v, cache)
    smax = ck.shape[1]
    if per_row:
        pos = length[:, None] + torch.arange(s, device=x.device)[None, :]
    else:
        start = int(length)
        pos = torch.broadcast_to(
            start + torch.arange(s, device=x.device)[None, :], (b, s))
    if cfg.use_rope:
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    if per_row:
        rows = torch.arange(b, device=x.device)
        idx = torch.clamp(length, max=smax - 1)
        _write_kv(cache, (rows, idx), k[:, 0], v[:, 0])
        # the causal mask (kpos <= row position) and the valid-length mask
        # (kpos < length + 1) coincide, so kv_len alone masks each row
        out = attention(q, ck, cv, causal=False, kv_len=length + 1,
                        q_offset=0, **_scales(cache))
    else:
        w = min(start, smax - s)
        _write_kv(cache, (slice(None), slice(w, w + s)), k, v)
        # query i sits at absolute position start + i
        out = attention(q, ck, cv, causal=cfg.causal, kv_len=start + s,
                        q_offset=start, **_scales(cache))
    new_cache = dict(cache, len=length + s)
    return layers.dense(p["wo"], out.reshape(b, s, hq * hd)), new_cache


def _write_kv(cache, index, k, v) -> None:
    """Write new tokens' K/V at ``index`` of the cache's ``k``/``v``, in
    place.  A quantized cache stores them quantized (one f16 scale per
    token and KV head, K and V in one ``quantize`` call) with their scales
    at the same index of ``ks``/``vs``; fp8 values go through a byte view
    (PyTorch lacks fp8 indexing kernels on some devices)."""
    if "ks" not in cache:
        cache["k"][index] = k.to(cache["k"].dtype)
        cache["v"][index] = v.to(cache["v"].dtype)
        return
    q, sc = quant.quantize(torch.stack((k, v)), dtype=cache["k"].dtype,
                           scale_dtype=cache["ks"].dtype)
    for i, name in enumerate(("k", "v")):
        quant.as_bytes(cache[name])[index] = quant.as_bytes(q[i])
        cache[name + "s"][index] = sc[i]


def _scales(cache) -> dict:
    """The scale arguments of :func:`attention` for a quantized cache."""
    if "ks" not in cache:
        return {}
    return {"k_scale": cache["ks"], "v_scale": cache["vs"]}


def _paged_decode(p, cfg: AttnConfig, q, k, v, cache):
    """The decode tick against a page pool: write each row's token into
    its current page in place, then attend through the page table.

    Idle slots (an all-zero table row) write into scratch page 0, so
    several rows may name the same (page, offset): the plain assignment
    keeps one of them, which is harmless, since scratch is never read
    unmasked (never ``accumulate=True``).  A live row never names page 0.
    """
    b, _, hq, hd = q.shape
    ck, cv, pt, length = cache["k"], cache["v"], cache["pt"], cache["len"]
    ps, pcount = ck.shape[1], pt.shape[1]
    if cfg.use_rope:
        pos = length[:, None]
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(b, device=q.device)
    page = torch.clamp(length // ps, max=pcount - 1)
    phys = pt[rows, page]
    off = length % ps
    _write_kv(cache, (phys, off), k[:, 0], v[:, 0])
    out = attention(q, ck, cv, causal=False, kv_len=length + 1,
                    page_table=pt, **_scales(cache))
    new_cache = dict(cache, len=length + 1)
    return layers.dense(p["wo"], out.reshape(b, 1, hq * hd)), new_cache


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, *, device="cuda"):
    """KV cache dict with a scalar ``len`` (see :func:`attn_apply`).  A
    quantized ``dtype`` (int8 / fp8) adds per-token scale leaves "ks"/"vs"
    [B, Smax, Hkv, 1] in ``quant.SCALE_DTYPE``: their token axis sits where
    k/v's does, so the generic cache walkers (paging, splice, prefix
    gather) handle them as they handle k/v."""
    quantized = quant.is_quant_dtype(dtype)
    if not quantized and dtype not in (torch.float32, torch.bfloat16,
                                       torch.float16):
        raise ValueError(f"unsupported KV cache dtype {dtype}")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    c = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }
    if quantized:
        for name in ("ks", "vs"):
            c[name] = torch.zeros(shape[:-1] + (1,), dtype=quant.SCALE_DTYPE,
                                  device=device)
    return c
