"""Attention: the GQA block (projections, RoPE, KV cache) and the dispatch
to the port's kernels.

Every attention call goes through :func:`attention`, which picks the
kernel by call shape: the per-row single-token decode of continuous serve
goes to K2 (``kernels.decode_attention``), or to K3 when it carries a page
table (paged serve), one call per position of a speculative verify too;
prefill, the continuation prefill of a prefix hit,
the cache-less forward and the scalar-length decode of ``generate()`` go
to K1 (``kernels.flash_attention``).  A quantized cache (int8 / fp8
values with f16 scales) goes to their quantized twins: K7, K8 and K10.
A call that needs a gradient (training: grad mode on, q, k or v requiring
grad, no cache) goes through ``FlashAttentionFunction``: K1 forward, K11
backward.  Each kernel's wrapper launches the CUDA kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor.  On CUDA the
ops take their ring depth (and K2's and K7's split count) from the
tuning db (``core/autotune_search``): a depth above 1 runs the pipelined
kernels K4, K5, K6 and K9 in place of K1, K2, K3 and K8, with the same
results bit for bit.  Under ``ShardingPolicy(decode_seq_shard=True)`` the
one-token decode over a contiguous cache goes to
:func:`distributed_decode_attention` instead: K2's split kernel on this
rank's block of cache positions, the ranks' partials combined by K2's
combine kernel.

Layout convention: q [B, Sq, Hq, Dk]; k [B, Skv, Hkv, Dk]; v [B, Skv,
Hkv, Dv]; Hq = G * Hkv.  Dv == Dk for GQA; MLA (``models/mla.py``) passes
its wider query/key heads through the same dispatch (K1 at prefill, K2
at its absorbed decode).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
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


def distributed_decode_attention(q, k, v, kv_len, *, mesh, axis="model"):
    """Flash-decode over a KV cache split along ``axis`` of ``mesh`` by
    positions — the split-K ParallelFor dual at cluster scale (the
    reference's ``distributed_decode_attention``).

    q [B, Hq, Dk] is this rank's rows; k [B, S_loc, Hkv, Dk] and v [B,
    S_loc, Hkv, Dv] its block of cache positions, which starts at
    ``coordinate(mesh)[axis] * S_loc``; ``kv_len`` the rows' global
    lengths, a scalar or [B].  Returns [B, Hq, Dv] in q's dtype.  The rows
    are local already (each rank holds its own), so there is no
    ``batch_axes`` argument.

    Each rank runs K2's split kernel over its block with its local
    lengths, ``clamp(kv_len - offset, 0, S_loc)`` (a block past a row's
    length gives empty splits: m = NEG_INF, l = 0, o = 0); the ranks'
    partials are gathered over the axis (one all-gather, o, m and l
    packed) and laid side by side on the split axis in rank order, and
    K2's combine kernel sums them.  Where
    the reference meets the partial softmaxes with a pmax and two psums,
    this gathers R x ns partials: the combine stays K2's, at one rank the
    call is the tick's own split and combine (so a serve under the policy
    equals a plain one bit for bit), and at R ranks whose ``ns`` splits
    divide S_loc the result equals one K2 call at R x ns splits of the
    same size, bit for bit."""
    sharding.require_group("distributed_decode_attention")
    b = q.shape[0]
    s_loc = k.shape[1]
    ranks = sharding.axis_sizes(mesh)[axis]
    offset = sharding.coordinate(mesh)[axis] * s_loc
    kvl = torch.broadcast_to(torch.as_tensor(kv_len, device=q.device), (b,))
    local = (kvl - offset).clamp(0, s_loc).to(torch.int32).contiguous()
    parts = decode_ops.decode_attention_partials(q, k, v, local)
    if ranks > 1:
        # one gather of o, m and l packed side by side (all f32):
        # [R, B, Hkv, ns, G, Dv + 2] -> [B, Hkv, R * ns, G, Dv + 2]
        packed = torch.cat(parts, dim=-1).contiguous()
        out = packed.new_empty((ranks * packed.numel(),))
        dist.all_gather_into_tensor(out, packed.view(-1),
                                    group=sharding.group_of(mesh, (axis,)))
        bb, hkv, ns, g, w = packed.shape
        out = out.view(ranks, bb, hkv, ns, g, w).permute(1, 2, 0, 3, 4, 5)
        out = out.reshape(bb, hkv, ranks * ns, g, w)
        parts = [t.contiguous() for t in out.split([w - 2, 1, 1], dim=-1)]
    return decode_ops.decode_combine(*parts, q.dtype)


def seq_sharded_decode(leaf, s: int, what: str, *, kernel: bool = True):
    """How a call with ``s`` new tokens reads its cache, of which ``leaf``
    is the leaf cut by positions (``k`` or ``ckv``; None without a cache):
    (mesh, axis, offset, blocks) for :func:`distributed_decode_attention`
    over this rank's positions ``offset`` on, of ``blocks`` equal blocks;
    or None for the path the call takes without a policy.

    Whether the cache is this rank's block of positions, and which, the
    leaf carries itself (``sharding.block_of``, marked where the cache was
    cut: ``params.shard_cache``).  A one-token call under a policy with
    ``decode_seq_shard`` and a "model" axis goes to
    :func:`distributed_decode_attention`, as in the reference, on such a
    block and on a whole cache where the axis has size 1; ``kernel``
    False (a paged pool or a quantized cache, which K2's partials do not
    read) keeps a whole cache's decode on its own path.  A cache kept
    whole at a model axis above 1 (its length not a multiple of it) takes
    the plain path, as the reference does.  Any call on a block that is
    not that decode raises, naming ``what``: the prefill into the cache,
    the speculative verify, paged pools, quantized caches and a decode
    without the policy are not ported there."""
    if leaf is None:
        return None
    cut = sharding.block_of(leaf)
    pol = sharding.active_policy()
    seq = (s == 1 and kernel and pol is not None and pol.decode_seq_shard
           and "model" in sharding.axis_sizes(pol.mesh))
    if cut is not None:
        if not seq:
            raise NotImplementedError(
                f"{what} on a block of a sequence-sharded cache: only the "
                f"one-token decode under ShardingPolicy(decode_seq_shard="
                f"True) is ported (ROADMAP: distributed and launch)")
        mesh, axis = cut
        return (mesh, axis, sharding.coordinate(mesh)[axis] * leaf.shape[1],
                sharding.axis_sizes(mesh)[axis])
    if seq and sharding.axis_sizes(pol.mesh)["model"] == 1:
        return pol.mesh, "model", 0, 1
    return None


def write_block(cache_leaf, index, value, offset: int) -> None:
    """Write one new token a row at the global positions ``index`` [B]
    into a rank's block of positions starting at ``offset``, in place:
    rows whose position lies in another rank's block keep their values
    (a clamped index rewrites what it reads, so the write needs no
    host sync)."""
    s_loc = cache_leaf.shape[1]
    rows = torch.arange(cache_leaf.shape[0], device=cache_leaf.device)
    local = index - offset
    inside = (local >= 0) & (local < s_loc)
    local = local.clamp(0, s_loc - 1)
    keep = cache_leaf[rows, local]
    mask = inside.reshape(-1, *([1] * (keep.dim() - 1)))
    cache_leaf[rows, local] = torch.where(mask, value.to(keep.dtype), keep)


def seq_positions(s: int, device, split=None) -> torch.Tensor:
    """[1, s] positions of a cache-less call's tokens: 0.. s - 1, or, on
    this rank's block of the sequence (``sharding.seq_split``), the
    block's global positions ``offset + arange(s)``."""
    pos = torch.arange(s, device=device)[None, :]
    return pos if split is None else pos + split.offset


def gather_prefix(split, *blocks: torch.Tensor) -> list:
    """Every rank's ``blocks`` [B, S_loc, ...] along the sequence over the
    split's axis, cut to the prefix [0, offset + S_loc) this rank's
    queries attend to (causal: the suffix alignment Skv - Sq is then the
    block's offset).  The tensors travel as one, concatenated along their
    last dim; under autograd the gather's backward reduce-scatters their
    gradients, so each rank gets its block's sum over the ranks' uses.
    One block is the whole sequence: ``blocks`` themselves."""
    if split.blocks == 1:
        return list(blocks)
    s = blocks[0].shape[1]
    widths = [t.shape[-1] for t in blocks]
    whole = sharding.gather_rows(torch.cat(blocks, dim=-1), split.mesh,
                                 (split.axis,), dim=1)
    return list(whole[:, :split.offset + s].split(widths, dim=-1))


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

    Several tokens against per-row lengths are the speculative verify
    (:func:`_verify`).  Without a cache, on this rank's block of the
    sequence (``sharding.seq_split``, sequence-parallel training), the
    queries and keys are roped at their global positions and attend over
    K and V gathered from every block up to this block's end
    (:func:`gather_prefix`).  Under ``ShardingPolicy(decode_seq_shard=True)``
    a one-token decode on a contiguous cache goes to
    :func:`distributed_decode_attention` (:func:`seq_sharded_decode`);
    where the cache is this rank's block of positions, the new token is
    written by the rank whose block holds its (clamped) position.
    """
    b, s, _ = x.shape
    where = seq_sharded_decode(
        None if cache is None else cache["k"], s, "attention",
        kernel=cache is not None and not ("pt" in cache or "ks" in cache))
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if verifying(cache, x):
        return _verify(p, cfg, x, cache)
    q = layers.dense(p["wq"], x).reshape(b, s, hq, hd)
    k = layers.dense(p["wk"], x).reshape(b, s, hkv, hd)
    v = layers.dense(p["wv"], x).reshape(b, s, hkv, hd)

    if cache is None:
        split = sharding.seq_split()
        if cfg.use_rope:
            pos = (positions if positions is not None
                   else seq_positions(s, x.device, split))
            pos = torch.broadcast_to(pos, (b, s))
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            k = layers.apply_rope(k, pos, cfg.rope_theta)
        if split is not None:
            k, v = gather_prefix(split, k, v)
        out = attention(q, k, v, causal=cfg.causal)
        return layers.dense(p["wo"], out.reshape(b, s, hq * hd)), None

    length = cache["len"]
    per_row = length.dim() == 1
    if "pt" in cache and not per_row:
        raise ValueError("paged KV cache requires per-row lengths "
                         "(run set_cache_lengths / the serve path)")
    ck, cv = cache["k"], cache["v"]
    if "pt" in cache:
        return _paged_decode(p, cfg, q, k, v, cache)
    rows_here = ck.shape[1]
    offset, blocks = (0, 1) if where is None else where[2:]
    smax = rows_here * blocks
    if per_row:
        pos = length[:, None] + torch.arange(s, device=x.device)[None, :]
    else:
        start = layers.host_int(length)
        pos = torch.broadcast_to(
            start + torch.arange(s, device=x.device)[None, :], (b, s))
    if cfg.use_rope:
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    if per_row:
        idx = torch.clamp(length, max=smax - 1)
        if blocks > 1:
            write_block(ck, idx, k[:, 0], offset)
            write_block(cv, idx, v[:, 0], offset)
        else:
            rows = torch.arange(b, device=x.device)
            _write_kv(cache, (rows, idx), k[:, 0], v[:, 0])
    else:
        w = min(start, smax - s) - offset
        if blocks == 1 or 0 <= w <= rows_here - s:  # this block holds it
            _write_kv(cache, (slice(None), slice(w, w + s)), k, v)
    if where is not None:
        out = distributed_decode_attention(
            q[:, 0], ck, cv, length + s, mesh=where[0],
            axis=where[1])[:, None]
    elif per_row:
        # the causal mask (kpos <= row position) and the valid-length mask
        # (kpos < length + 1) coincide, so kv_len alone masks each row
        out = attention(q, ck, cv, causal=False, kv_len=length + 1,
                        q_offset=0, **_scales(cache))
    else:
        # query i sits at absolute position start + i
        out = attention(q, ck, cv, causal=cfg.causal, kv_len=start + s,
                        q_offset=start, **_scales(cache))
    new_cache = dict(cache, len=length + s)
    return layers.dense(p["wo"], out.reshape(b, s, hq * hd)), new_cache


def verifying(cache: Optional[dict], x: torch.Tensor) -> bool:
    """Several tokens against per-row cache lengths: the speculative
    verify (``Model.verify_step``), whose row-wise work runs one position
    at a time (``layers.per_position``)."""
    return cache is not None and cache["len"].dim() == 1 and x.shape[1] > 1


def _verify(p, cfg: AttnConfig, x, cache):
    """The speculative verify: ``s`` tokens per row against a per-row
    cache, contiguous or paged, quantized or not.

    Each position's projections and RoPE run at the decode tick's shape
    (position ``j`` of row ``b`` at ``len[b] + j``).  Each row then writes
    its ``s`` tokens in place at ``len .. len + s - 1``: on a contiguous
    cache from a start clamped to ``Smax - s`` (the reference's vmapped
    ``dynamic_update_slice``), on a paged one through page ``min(pos //
    ps, P - 1)`` of the row's table, so a position past the row's pages
    lands in scratch page 0.  A quantized cache quantizes each token as a
    single write would (one scale per token and KV head).  Attention then
    runs once per position with ``kv_len = len + j + 1``: the tick's K2 /
    K3 (K7 / K8) call on the same ``B`` rows, so position ``j``'s output
    equals the tick's that consumes the same tokens, bit for bit."""
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    length = cache["len"]
    pos = length[:, None] + torch.arange(s, device=x.device)[None, :]
    qs, ks, vs = [], [], []
    for j in range(s):
        xj = x[:, j:j + 1].contiguous()
        q = layers.dense(p["wq"], xj).reshape(b, 1, hq, hd)
        k = layers.dense(p["wk"], xj).reshape(b, 1, hkv, hd)
        v = layers.dense(p["wv"], xj).reshape(b, 1, hkv, hd)
        if cfg.use_rope:
            q = layers.apply_rope(q, pos[:, j:j + 1], cfg.rope_theta)
            k = layers.apply_rope(k, pos[:, j:j + 1], cfg.rope_theta)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    k, v = torch.cat(ks, 1), torch.cat(vs, 1)
    ck, cv = cache["k"], cache["v"]
    table = {}
    if "pt" in cache:
        pt = table["page_table"] = cache["pt"]
        ps = ck.shape[1]
        page = torch.clamp(pos // ps, max=pt.shape[1] - 1)
        _write_kv(cache, (torch.gather(pt, 1, page), pos % ps), k, v)
    else:
        start = torch.clamp(length, max=ck.shape[1] - s)
        rows = torch.arange(b, device=x.device)[:, None]
        steps = torch.arange(s, device=x.device)[None, :]
        _write_kv(cache, (rows, start[:, None] + steps), k, v)
        table["q_offset"] = 0
    outs = []
    for j in range(s):
        out = attention(qs[j], ck, cv, causal=False, kv_len=length + (j + 1),
                        **table, **_scales(cache))
        outs.append(layers.dense(p["wo"], out.reshape(b, 1, hq * hd)))
    return torch.cat(outs, 1), dict(cache, len=length + s)


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
