"""The dense decoder block (GQA or MLA attention), the MoE block, the
Mamba2 block, the cross-attention block, and the loop over stacked
layers.

Parameters are layer-stacked (a leading [n_layers] axis on every leaf), as
in the reference; where the reference runs ``jax.lax.scan`` over that axis,
the port runs a Python loop and hands each block views of its layer.
Training rematerialises each layer (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does: all of it (``remat_policy="full"``),
or all but the outputs of its products without batch dimensions
(``"dots"``, a selective checkpoint).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mla, moe, ssm


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


def mla_cfg(cfg: ModelConfig) -> mla.MLAConfig:
    return mla.MLAConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
    )


def moe_cfg(cfg: ModelConfig) -> moe.MoEConfig:
    return moe.MoEConfig(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff=cfg.moe_d_ff, n_shared_experts=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor,
        dispatch_groups=cfg.moe_dispatch_groups,
    )


def _attn_init(gen, cfg: ModelConfig, lead, dtype):
    if cfg.use_mla:
        return mla.mla_init(gen, mla_cfg(cfg), lead=lead, dtype=dtype)
    return attn_mod.attn_init(gen, attn_cfg(cfg), lead=lead, dtype=dtype)


def _attn_apply(p, cfg: ModelConfig, h, cache):
    if cfg.use_mla:
        return mla.mla_apply(p, mla_cfg(cfg), h, cache=cache)
    return attn_mod.attn_apply(p, attn_cfg(cfg), h, cache=cache)


def _lead(n_layers) -> tuple:
    """Stacking axes: ``n_layers`` layers, or a tuple of axes (``()`` for
    one unstacked block, ``(groups, per_group)`` for the hybrid's
    doubly stacked SSD blocks)."""
    return tuple(n_layers) if isinstance(n_layers, tuple) else (n_layers,)


def dense_block_init(gen, cfg: ModelConfig, n_layers, *, d_ff=None,
                     dtype=torch.float32):
    """Params of ``n_layers`` stacked dense blocks (MLA attention when
    ``cfg.use_mla``); ``n_layers`` may be a tuple of stacking axes."""
    lead = _lead(n_layers)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "attn": _attn_init(gen, cfg, lead, dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "mlp": layers.mlp_init(gen, cfg.d_model, d_ff or cfg.d_ff, lead=lead,
                               act=cfg.act, dtype=dtype),
    }


def dense_block_apply(p, cfg: ModelConfig, x, *, cache=None):
    """One layer; returns (x, new_cache or None).  A speculative verify
    (several tokens, per-row lengths) runs the norms and the MLP one
    position at a time, at a decode tick's shape."""
    split = attn_mod.verifying(cache, x)
    h = layers.per_position(
        lambda t: layers.rmsnorm(p["ln1"], t, cfg.norm_eps), x, split)
    a, new_cache = _attn_apply(p["attn"], cfg, h, cache)
    x = x + a

    def ffn(t):
        h = layers.rmsnorm(p["ln2"], t, cfg.norm_eps)
        return layers.mlp(p["mlp"], h, act=cfg.act)

    return x + layers.per_position(ffn, x, split), new_cache


def moe_block_init(gen, cfg: ModelConfig, n_layers: int, *,
                   dtype=torch.float32):
    """Params of ``n_layers`` stacked MoE blocks: attention (MLA when
    ``cfg.use_mla``) and the routed + shared expert FFN."""
    lead = (n_layers,)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "attn": _attn_init(gen, cfg, lead, dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "moe": moe.moe_init(gen, moe_cfg(cfg), lead=lead, dtype=dtype),
    }


def moe_block_apply(p, cfg: ModelConfig, x, *, cache=None):
    """One layer; returns (x, new_cache or None, aux_loss f32 scalar).
    ``moe_impl="sharded"`` (expert parallelism across devices) raises."""
    if cfg.moe_impl == "sharded":
        raise NotImplementedError(
            'moe_impl="sharded": expert-parallel dispatch is not ported yet '
            "(ROADMAP: distributed and launch)")
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, new_cache = _attn_apply(p["attn"], cfg, h, cache)
    x = x + a
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    y, metrics = moe.moe_apply(p["moe"], moe_cfg(cfg), h)
    return x + y, new_cache, metrics["aux_loss"]


def ssm_cfg(cfg: ModelConfig) -> ssm.SSMConfig:
    return ssm.SSMConfig(
        d_model=cfg.d_model, d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
        n_groups=cfg.ssm_ngroups,
    )


def ssm_block_init(gen, cfg: ModelConfig, n_layers, *,
                   dtype=torch.float32):
    """Params of ``n_layers`` stacked Mamba2 blocks; ``n_layers`` may be a
    tuple of stacking axes."""
    lead = _lead(n_layers)
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


def cross_block_init(gen, cfg: ModelConfig, n_layers, *, gated=False,
                     dtype=torch.float32):
    """Params of ``n_layers`` stacked cross-attention blocks (the vision
    family's; ``n_layers`` may be a tuple of stacking axes): attention
    without RoPE from x to an encoder or vision output, then the MLP.
    ``gated`` adds the scalar gates ``gate_attn`` and ``gate_mlp`` (one a
    layer), 0 at init as in the reference, so tanh(0) lets a fresh block
    add nothing."""
    lead = _lead(n_layers)
    p = {
        "ln1": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "xattn": attn_mod.attn_init(gen, attn_cfg(cfg, causal=False,
                                                  use_rope=False),
                                    lead=lead, dtype=dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                   device=gen.device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, lead=lead,
                               act=cfg.act, dtype=dtype),
    }
    if gated:
        for name in ("gate_attn", "gate_mlp"):
            p[name] = torch.zeros(lead, dtype=dtype, device=gen.device)
    return p


def cross_attention(p, cfg: ModelConfig, h, enc, cache=None):
    """Cross-attention of h [B, S, d] over an encoder or vision output;
    returns (out [B, S, d] before any gate, ck, cv).

    ``enc`` [B, S_enc, d] is projected to K/V (a prefill); with a
    ``cache`` ({"ck", "cv": [B, S_enc, Hkv, D]}) they are written into it
    in place, cast to its dtype, and attention reads the cast values, as
    the reference attends over its cast K/V.  ``enc`` None (a decode
    tick, or a vision prefill without patches) reads the cache as it
    stands.  The call is non-causal with no ``kv_len``: on CUDA it is K1
    (K4 under a tuned db), on the CPU K1's plain version."""
    ac = attn_cfg(cfg, causal=False, use_rope=False)
    b, s, _ = h.shape
    hd, hq, hkv = ac.head_dim, ac.n_heads, ac.n_kv_heads
    if enc is None:
        if cache is None:
            raise ValueError("cross-attention needs the encoder output or "
                             "a cache that holds its K/V")
        ck, cv = cache["ck"], cache["cv"]
    else:
        ck = layers.dense(p["wk"], enc).reshape(b, enc.shape[1], hkv, hd)
        cv = layers.dense(p["wv"], enc).reshape(b, enc.shape[1], hkv, hd)
        if cache is not None:
            if ck.shape != cache["ck"].shape:
                raise ValueError(f"cross K/V {tuple(ck.shape)} do not fit "
                                 f"the cache's {tuple(cache['ck'].shape)}")
            cache["ck"].copy_(ck)
            cache["cv"].copy_(cv)
            ck, cv = cache["ck"], cache["cv"]
    q = layers.dense(p["wq"], h).reshape(b, s, hq, hd)
    o = attn_mod.attention(q, ck, cv, causal=False)
    return layers.dense(p["wo"], o.reshape(b, s, hq * hd)), ck, cv


def cross_block_apply(p, cfg: ModelConfig, x, enc, *, cache=None):
    """One cross block; returns (x, {"ck", "cv"} or None).  ``enc`` as in
    :func:`cross_attention`.  A gated block scales the attention and the
    MLP outputs by tanh of its gates."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, ck, cv = cross_attention(p["xattn"], cfg, h, enc, cache)
    if "gate_attn" in p:
        a = torch.tanh(p["gate_attn"].to(a.dtype)) * a
    x = x + a
    m = layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps),
                   act=cfg.act)
    if "gate_mlp" in p:
        m = torch.tanh(p["gate_mlp"].to(m.dtype)) * m
    return x + m, (None if cache is None else {"ck": ck, "cv": cv})


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


# The reference's ``dots_with_no_batch_dims_saveable``: under
# remat_policy="dots" the outputs of products without batch dimensions are
# saved and every other op is recomputed.  ``x @ w`` on a [B, S, d]
# activation folds to one ``mm`` (``layers.dense``); the attention's
# batched products (``bmm``) and the kernels are recomputed, so K1 runs
# twice per layer as under "full".  No op may write into a saved product
# in place: matmul hands the ``mm`` out through ``_unsafe_view``, past the
# checkpoint's version check, so the backward would read the written
# values (tests/test_torch_train.py checks a step writes none).
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def scan_layers(block_apply: Callable, stacked_params, x: torch.Tensor,
                caches: Optional[dict] = None, *, remat: bool = False,
                remat_policy: str = "full"):
    """Run ``block_apply(params_i, x, cache_i) -> (x, new_cache_i)`` over
    the layer axis; returns (x, new_caches).

    ``caches`` is a layer-stacked KV cache ({"k", "v": [L, B, S, Hkv, D],
    "len": [L] or [L, B]}), SSM cache ({"conv", "state"}) or a tree of
    them (the hybrid's groups).  Each block writes its K/V rows (or its
    conv window and state) in place through the views it is given, so the
    stacked tensors are returned as they are and only the advanced
    ``len`` entries, where there are any, are restacked.

    ``remat`` (training, no caches) with ``remat_policy="full"`` keeps
    only each layer's input and recomputes the layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``nothing_saveable`` policy does: attention's K1 then runs twice per
    layer.  ``"dots"`` also keeps the outputs of the layer's products
    without batch dimensions (:data:`_DOTS_SAVED`, a selective checkpoint)
    and recomputes the rest, K1 included.  ``"none"`` saves every
    activation."""
    n = next(iter(_leaves(stacked_params))).shape[0]
    layers_p = unstack(stacked_params, n)
    if remat and remat_policy != "none":
        if remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if caches is not None:
            raise ValueError("remat is for training: no KV caches")
        selective = {} if remat_policy == "full" else {
            "context_fn": partial(create_selective_checkpoint_contexts,
                                  _DOTS_SAVED)}
        for p in layers_p:
            x = checkpoint(lambda xc, pc: block_apply(pc, xc, None)[0], x, p,
                           use_reentrant=False, preserve_rng_state=False,
                           **selective)
        return x, None
    new_cs = []
    for i, p in enumerate(layers_p):
        x, new_c = block_apply(p, x,
                               None if caches is None else layer(caches, i))
        new_cs.append(new_c)
    if caches is None:
        return x, None
    return x, _restack_lens(caches, new_cs)


def _restack_lens(caches: dict, new_cs: list) -> dict:
    """``caches`` with every ``len`` entry replaced by the stack of the
    layers' advanced ones (the other leaves were written in place)."""
    out = dict(caches)
    for key, leaf in caches.items():
        if isinstance(leaf, dict):
            out[key] = _restack_lens(leaf, [c[key] for c in new_cs])
        elif key == "len":
            out[key] = torch.stack([c[key] for c in new_cs])
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
