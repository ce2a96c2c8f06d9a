"""The dense decoder block, the Mamba2 block, and the loop over stacked
layers.

Parameters are layer-stacked (a leading [n_layers] axis on every leaf), as
in the reference; where the reference runs ``jax.lax.scan`` over that axis,
the port runs a Python loop and hands each block views of its layer.
Training rematerialises each layer (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm


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


def ssm_cfg(cfg: ModelConfig) -> ssm.SSMConfig:
    return ssm.SSMConfig(
        d_model=cfg.d_model, d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
        n_groups=cfg.ssm_ngroups,
    )


def ssm_block_init(gen, cfg: ModelConfig, n_layers: int, *,
                   dtype=torch.float32):
    """Params of ``n_layers`` stacked Mamba2 blocks."""
    lead = (n_layers,)
    return {
        "ln": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                  device=gen.device),
        "ssm": ssm.ssm_init(gen, ssm_cfg(cfg), lead=lead, dtype=dtype),
    }


def ssm_block_apply(p, cfg: ModelConfig, x, *, cache=None):
    """One layer; returns (x, cache or None), the cache advanced in
    place."""
    h = layers.rmsnorm(p["ln"], x, cfg.norm_eps)
    y, new_cache = ssm.ssm_apply(p["ssm"], ssm_cfg(cfg), h, cache=cache)
    return x + y, new_cache


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a layer-stacked tree as a list of trees of
    views, one ``unbind`` per leaf: under autograd each leaf's gradient is
    then stacked once from its layers' gradients (indexing each layer out
    would add a full-size gradient per layer)."""
    per_leaf = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def scan_layers(block_apply: Callable, stacked_params, x: torch.Tensor,
                caches: Optional[dict] = None, *, remat: bool = False,
                remat_policy: str = "full"):
    """Run ``block_apply(params_i, x, cache_i) -> (x, new_cache_i)`` over
    the layer axis; returns (x, new_caches).

    ``caches`` is a layer-stacked KV cache ({"k", "v": [L, B, S, Hkv, D],
    "len": [L] or [L, B]}) or SSM cache ({"conv", "state"}).  Each block
    writes its K/V rows (or its conv window and state) in place through
    the views it is given, so the stacked tensors are returned as they are
    and only the advanced ``len`` entries, where there are any, are
    restacked.

    ``remat`` (training, no caches) with ``remat_policy="full"`` keeps
    only each layer's input and recomputes the layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``nothing_saveable`` policy does: attention's K1 then runs twice per
    layer.  ``"none"`` saves every activation; ``"dots"`` (keep the matmul
    outputs) is not ported (ROADMAP: selective remat)."""
    n = next(iter(_leaves(stacked_params))).shape[0]
    layers_p = unstack(stacked_params, n)
    if remat and remat_policy != "none":
        if remat_policy == "dots":
            raise NotImplementedError(
                'remat_policy="dots": selective remat is not ported yet '
                "(ROADMAP: selective remat)")
        if remat_policy != "full":
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if caches is not None:
            raise ValueError("remat is for training: no KV caches")
        for p in layers_p:
            x = checkpoint(lambda xc, pc: block_apply(pc, xc, None)[0], x, p,
                           use_reentrant=False, preserve_rng_state=False)
        return x, None
    lens = []
    for i, p in enumerate(layers_p):
        x, new_c = block_apply(p, x,
                               None if caches is None else layer(caches, i))
        if new_c is not None and "len" in new_c:
            lens.append(new_c["len"])
    if caches is None or not lens:
        return x, caches
    return x, {**caches, "len": torch.stack(lens)}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
