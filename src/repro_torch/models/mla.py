"""DeepSeek-V2 Multi-head Latent Attention (arXiv:2405.04434).

Port of ``repro.models.mla``.  Prefill runs the standard formulation: per
head K = [k_nope, k_rope] of qk_nope + qk_rope columns against V of
v_head_dim columns, through K1 (192 / 128 at full width).  Decode runs
the absorbed formulation over the compressed latent cache: ``w_kn`` is
folded into q, and attention runs over one latent KV head of kv_lora +
qk_rope columns (K) whose first kv_lora columns are V, through K2 with
the group of all query heads (576 / 512; G = 16 for deepseek-v2-lite and
128 for deepseek-v2-236b, whose group K2 splits over blocks of 16).  The
cache stores ``ckv`` [B, Smax, kv_lora] and ``kr`` [B, Smax, qk_rope]
per layer instead of per-head K/V.

The cache is UPDATED IN PLACE, as the port's KV cache is.  The reference
derives K and V of a call from that call's own tokens only, yet passes
``kv_len = len + s``: a multi-token call on a non-empty cache attends to
the new tokens alone (R7 in ROADMAP.md).  Its engine never makes such a
call for this family, and the port raises on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = direct q projection (deepseek-v2-lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(gen: torch.Generator, cfg: MLAConfig, *, lead=(),
             dtype=torch.float32) -> dict:
    """Params of one MLA block (``lead`` stacking axes in front), with the
    reference's tree: ``wq`` (no q-lora) or ``wq_a``/``q_norm``/``wq_b``."""
    lead = tuple(lead)
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    dev = gen.device
    p = {
        "wkv_a": layers.dense_init(gen, cfg.d_model, cfg.kv_lora_rank + dr,
                                   lead=lead, dtype=dtype),
        "kv_norm": layers.rmsnorm_init(cfg.kv_lora_rank, lead=lead,
                                       dtype=dtype, device=dev),
        "wkv_b": layers.dense_init(gen, cfg.kv_lora_rank, h * (dn + dv),
                                   lead=lead, dtype=dtype),
        "wo": layers.dense_init(gen, h * dv, cfg.d_model, lead=lead,
                                stddev=1.0 / math.sqrt(h * dv), dtype=dtype),
    }
    if cfg.q_lora_rank:
        p["wq_a"] = layers.dense_init(gen, cfg.d_model, cfg.q_lora_rank,
                                      lead=lead, dtype=dtype)
        p["q_norm"] = layers.rmsnorm_init(cfg.q_lora_rank, lead=lead,
                                          dtype=dtype, device=dev)
        p["wq_b"] = layers.dense_init(gen, cfg.q_lora_rank, h * cfg.qk_dim,
                                      lead=lead, dtype=dtype)
    else:
        p["wq"] = layers.dense_init(gen, cfg.d_model, h * cfg.qk_dim,
                                    lead=lead, dtype=dtype)
    return p


def _project_q(p, cfg: MLAConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    if cfg.q_lora_rank:
        q = layers.dense(p["wq_b"], layers.rmsnorm(
            p["q_norm"], layers.dense(p["wq_a"], x)))
    else:
        q = layers.dense(p["wq"], x)
    return q.reshape(b, s, cfg.n_heads, cfg.qk_dim)


def mla_apply(p, cfg: MLAConfig, x: torch.Tensor, *,
              cache: Optional[dict] = None):
    """Returns (out [B, S, d], new_cache or None).

    ``cache`` is one layer's {"ckv": [B, Smax, kv_lora], "kr": [B, Smax,
    qk_rope], "len"}: ``len`` a scalar (prefill, ``generate()``) or a [B]
    vector (continuous serve).  The new tokens' latents are written in
    place, each write clamped to the cache's last row as the reference's
    ``dynamic_update_slice`` clamps it (an idle serve slot keeps rewriting
    its last row).  A one-token call with a cache is the absorbed decode
    (K2); any other call is the standard formulation (K1).  A multi-token
    call on a non-empty cache raises (R7).  Under
    ``ShardingPolicy(decode_seq_shard=True)`` the absorbed decode goes to
    ``attention.distributed_decode_attention`` at (576, 512)
    (``attention.seq_sharded_decode``): on a rank's block of positions the
    new latents are written by the rank whose block holds their
    position.  Without a cache on a rank's block of the sequence
    (``sharding.seq_split``, sequence-parallel training) the ropes take
    the global positions and the latent ``ckv`` and the roped ``kr`` of
    every block up to this one's end are gathered over the split's axis
    (``attention.gather_prefix``) before K and V are derived."""
    b, s, _ = x.shape
    where = attn_mod.seq_sharded_decode(
        None if cache is None else cache["ckv"], s, "the MLA attention")
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    lora = cfg.kv_lora_rank
    length = cache["len"] if cache is not None else None
    per_row = length is not None and length.dim() == 1
    if per_row and s != 1:
        raise ValueError(
            "per-row cache lengths support single-token decode (s == 1); "
            f"got a [{s}]-token step")
    start = 0 if length is None or per_row else layers.host_int(length)
    if cache is not None and s > 1 and start > 0:
        raise NotImplementedError(
            "a multi-token MLA call on a non-empty cache: the reference "
            "attends to the new tokens alone there (ROADMAP: R7), and no "
            "engine path makes this call")

    split = sharding.seq_split() if cache is None else None
    q = _project_q(p, cfg, x)
    qn, qr = q.split([dn, dr], dim=-1)
    if per_row:
        qpos = length[:, None] + torch.arange(s, device=x.device)[None, :]
    elif split is not None:
        qpos = torch.broadcast_to(
            attn_mod.seq_positions(s, x.device, split), (b, s))
    else:
        qpos = torch.broadcast_to(
            start + torch.arange(s, device=x.device)[None, :], (b, s))
    qr = layers.apply_rope(qr, qpos, cfg.rope_theta)

    ckv, kr = layers.dense(p["wkv_a"], x).split([lora, dr], dim=-1)
    ckv = layers.rmsnorm(p["kv_norm"], ckv)                  # [B, S, lora]
    kr = layers.apply_rope(kr[:, :, None, :], qpos,
                           cfg.rope_theta)[:, :, 0, :]        # [B, S, dr]

    new_cache = None
    if cache is not None:
        cc, ck = cache["ckv"], cache["kr"]
        offset, blocks = (0, 1) if where is None else where[2:]
        smax = cc.shape[1] * blocks
        if per_row:
            idx = torch.clamp(length, max=smax - 1)
            if blocks > 1:
                attn_mod.write_block(cc, idx, ckv[:, 0], offset)
                attn_mod.write_block(ck, idx, kr[:, 0], offset)
            else:
                rows = torch.arange(b, device=x.device)
                cc[rows, idx] = ckv[:, 0].to(cc.dtype)
                ck[rows, idx] = kr[:, 0].to(ck.dtype)
        else:
            w = min(start, smax - s) - offset
            if blocks == 1 or 0 <= w <= cc.shape[1] - s:  # block holds it
                cc[:, w:w + s] = ckv.to(cc.dtype)
                ck[:, w:w + s] = kr.to(ck.dtype)
        new_cache = dict(cache, len=length + s)

    if cache is not None and s == 1:
        # ----- absorbed decode over the latent cache (K2) -----
        wkv_b = p["wkv_b"]["w"].reshape(lora, h, dn + dv)
        w_kn, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
        q_lat = torch.einsum("bshd,lhd->bshl", qn.float(), w_kn.float())
        # MLA's scale is 1/sqrt(qk_dim); the kernel divides by the sqrt of
        # its key width, lora + dr: pre-scale q to compensate
        fix = math.sqrt(lora + dr) / math.sqrt(cfg.qk_dim)
        qq = torch.cat([q_lat, qr.float()], dim=-1) * fix
        kk = torch.cat([cc, ck], dim=-1)[:, :, None, :]     # [B,Smax,1,576]
        vv = cc[:, :, None, :]                               # [B,Smax,1,512]
        # s == 1: kv_len subsumes the causal mask at each row's position,
        # so a scalar length decodes through the per-row call too
        kv_len = (length + 1).to(torch.int32).expand(b).contiguous()
        if where is not None:
            o_lat = attn_mod.distributed_decode_attention(
                qq[:, 0].to(x.dtype), kk.to(x.dtype), vv.to(x.dtype), kv_len,
                mesh=where[0], axis=where[1])[:, None]
        else:
            o_lat = attn_mod.attention(
                qq.to(x.dtype), kk.to(x.dtype), vv.to(x.dtype),
                causal=False, kv_len=kv_len, q_offset=0)     # [B,1,H,lora]
        out = torch.einsum("bshl,lhv->bshv", o_lat.float(),
                           w_v.float()).to(x.dtype)
    else:
        # ----- standard formulation (prefill, K1) -----
        skv = s
        if split is not None:
            # this rank's block of the sequence: the latents of every
            # block up to its end (kv_lora + qk_rope values a position,
            # not the heads' K/V), K and V derived from them here
            ckv, kr = attn_mod.gather_prefix(split, ckv, kr)
            ckv, skv = ckv.contiguous(), ckv.shape[1]
        kv = layers.dense(p["wkv_b"], ckv).reshape(b, skv, h, dn + dv)
        kn, v = kv.split([dn, dv], dim=-1)
        k = torch.cat([kn, kr[:, :, None, :].expand(b, skv, h, dr)], dim=-1)
        qq = torch.cat([qn, qr], dim=-1)
        if cache is None:
            out = attn_mod.attention(qq, k, v.contiguous(), causal=True)
        else:
            out = attn_mod.attention(qq, k, v.contiguous(), causal=True,
                                     kv_len=start + s, q_offset=start)
    out = layers.dense(p["wo"], out.reshape(b, s, h * dv))
    return out, new_cache


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, *, device="cuda") -> dict:
    """Latent cache dict with a scalar ``len`` (see :func:`mla_apply`)."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }
