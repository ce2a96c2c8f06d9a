"""The dense decoder block and the loop over its stacked layers.

Parameters are layer-stacked (a leading [n_layers] axis on every leaf), as
in the reference; where the reference runs ``jax.lax.scan`` over that axis,
the port runs a Python loop and hands each block views of its layer.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers


def attn_cfg(cfg: ModelConfig, *, causal=True, use_rope=True,
             n_heads=None, n_kv=None) -> attn_mod.AttnConfig:
    return attn_mod.AttnConfig(
        d_model=cfg.d_model,
        n_heads=n_heads or cfg.n_heads,
        n_kv_heads=n_kv or cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        causal=causal,
        use_rope=use_rope,
    )


def dense_block_init(gen, cfg: ModelConfig, n_layers: int, *, d_ff=None,
                     dtype=torch.float32):
    """Params of ``n_layers`` stacked dense blocks."""
    lead = (n_layers,)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "attn": attn_mod.attn_init(gen, attn_cfg(cfg), lead=lead,
                                   dtype=dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "mlp": layers.mlp_init(gen, cfg.d_model, d_ff or cfg.d_ff, lead=lead,
                               act=cfg.act, dtype=dtype),
    }


def dense_block_apply(p, cfg: ModelConfig, x, *, cache=None):
    """One layer; returns (x, new_cache or None)."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, new_cache = attn_mod.attn_apply(p["attn"], attn_cfg(cfg), h,
                                       cache=cache)
    x = x + a
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + layers.mlp(p["mlp"], h, act=cfg.act)
    return x, new_cache


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def scan_layers(block_apply: Callable, stacked_params, x: torch.Tensor,
                caches: Optional[dict] = None):
    """Run ``block_apply(params_i, x, cache_i) -> (x, new_cache_i)`` over
    the layer axis; returns (x, new_caches).

    ``caches`` is a layer-stacked KV cache ({"k", "v": [L, B, S, Hkv, D],
    "len": [L] or [L, B]}).  Each block writes its K/V rows in place
    through the views it is given, so the stacked ``k``/``v`` tensors are
    returned as they are and only the advanced ``len`` entries are
    restacked."""
    n = next(iter(_leaves(stacked_params))).shape[0]
    lens = []
    for i in range(n):
        x, new_c = block_apply(layer(stacked_params, i), x,
                               None if caches is None else layer(caches, i))
        if new_c is not None:
            lens.append(new_c["len"])
    if caches is None:
        return x, None
    return x, {**caches, "len": torch.stack(lens)}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
