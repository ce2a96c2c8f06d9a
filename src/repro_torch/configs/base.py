"""Config schema: one flat dataclass covers all 10 assigned families, plus
the input-shape registry (train_4k / prefill_32k / decode_32k / long_500k).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def torch_dtype(name) -> torch.dtype:
    """A dtype name as the reference configs spell it ("float32",
    "bfloat16", ...) -> the torch dtype; a torch dtype passes through."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_groups: int = 0   # 0 = global FAA-style claiming
    moe_impl: str = "einsum"       # "einsum" (GSPMD) | "sharded" (shard_map
                                   # all_to_all, hierarchical claiming)
    remat_policy: str = "full"     # "full" | "dots" | "none"
    attn_block_k: int = 0          # 0 = autotuned flash chunk length
    # --- MLA ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    # --- hybrid (zamba2): shared attn block every N ssm layers ---
    attn_every: int = 0
    # --- vlm: groups of (self_per_group) self layers + 1 gated cross ---
    cross_attn_groups: int = 0
    self_per_group: int = 0
    vision_seq: int = 1601
    # --- encdec ---
    n_encoder_layers: int = 0
    encoder_downsample: int = 4    # audio frames = seq/downsample
    # --- skip rules ---
    sub_quadratic: bool = False    # can run long_500k
    # dtypes
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def with_dtype(self, dtype: str) -> "ModelConfig":
        return dataclasses.replace(self, param_dtype=dtype)

    # ----- parameter counting (for roofline MODEL_FLOPS) -----

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            if self.use_mla:
                qk = self.qk_nope_dim + self.qk_rope_dim
                q = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk
                     if self.q_lora_rank else d * self.n_heads * qk)
                kva = d * (self.kv_lora_rank + self.qk_rope_dim)
                kvb = self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                wo = self.n_heads * self.v_head_dim * d
                return q + kva + kvb + wo
            return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d)

        def mlp_params(f):
            return 3 * d * f  # gated

        def ssm_params():
            d_in = self.ssm_expand * d
            heads = d_in // self.ssm_headdim
            convc = d_in + 2 * self.ssm_ngroups * self.ssm_state
            return (d * (2 * d_in + 2 * self.ssm_ngroups * self.ssm_state
                         + heads) + self.ssm_conv * convc + d_in * d)

        if self.family == "ssm":
            return emb + self.n_layers * ssm_params()
        if self.family == "hybrid":
            n_groups = self.n_layers // self.attn_every
            shared = attn_params() + mlp_params(self.d_ff)
            return emb + self.n_layers * ssm_params() + shared
        if self.family == "moe":
            moe_ff = self.moe_d_ff
            routed = 3 * d * moe_ff * self.n_experts
            shared = mlp_params(self.n_shared_experts * moe_ff)
            router = d * self.n_experts
            n_moe = self.n_layers - self.first_dense_layers
            return (emb + self.n_layers * attn_params()
                    + self.first_dense_layers * mlp_params(self.dense_d_ff)
                    + n_moe * (routed + shared + router))
        if self.family == "encdec":
            enc = self.n_encoder_layers * (attn_params() + mlp_params(ff))
            dec = self.n_layers * (2 * attn_params() + mlp_params(ff))
            return emb + enc + dec
        if self.family == "vlm":
            n_cross = self.cross_attn_groups
            n_self = self.n_layers - n_cross
            return (emb + n_self * (attn_params() + mlp_params(ff))
                    + n_cross * (attn_params() + mlp_params(ff)))
        return emb + self.n_layers * (attn_params() + mlp_params(ff))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        moe_ff = self.moe_d_ff
        routed_all = 3 * d * moe_ff * self.n_experts
        routed_active = 3 * d * moe_ff * self.top_k
        n_moe = self.n_layers - self.first_dense_layers
        return self.param_count() - n_moe * (routed_all - routed_active)

    # ----- reduced config for CPU smoke tests -----

    def reduced(self) -> "ModelConfig":
        r = {
            "n_layers": min(self.n_layers, 4),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            "d_ff": 128,
            "vocab_size": 256,
            "head_dim": 16,
        }
        if self.family == "moe":
            r.update(n_experts=4, top_k=2, moe_d_ff=32,
                     first_dense_layers=min(1, self.first_dense_layers),
                     dense_d_ff=128,
                     kv_lora_rank=32, q_lora_rank=16 if self.q_lora_rank else 0,
                     qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.family in ("ssm", "hybrid"):
            r.update(ssm_state=16, ssm_headdim=16)
        if self.family == "hybrid":
            r.update(n_layers=4, attn_every=2)
        if self.family == "vlm":
            r.update(cross_attn_groups=2, self_per_group=1, n_layers=4,
                     vision_seq=16)
        if self.family == "encdec":
            r.update(n_encoder_layers=2, n_layers=2)
        return dataclasses.replace(self, **r)
