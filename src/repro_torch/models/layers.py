"""Primitive layers: plain functions on tensors.

Params are nested dicts of tensors in the reference's layout: a dense
weight is [d_in, d_out] and applied as ``x @ w`` (not ``nn.Linear``'s
[d_out, d_in]), so a JAX parameter tree maps onto the port leaf for leaf.
Initialisers take a ``lead`` shape, the layer-stacking axes the reference
builds with ``vmap`` over per-layer keys, and draw from an explicit
``torch.Generator`` on its device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_TRUNC_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)
_TRUNC_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))    # Phi(2)


def truncated_normal(gen: torch.Generator, shape: Sequence[int],
                     stddev: float, dtype: torch.dtype) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in
    f32 by inverting the CDF (as ``jax.random.truncated_normal``) and then
    cast to ``dtype``."""
    u = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    u.uniform_(_TRUNC_LO, _TRUNC_HI, generator=gen)
    u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return u.mul_(stddev).to(dtype)


class MetaGenerator(torch.Generator):
    """A generator that stands for one on the meta device: initialisers
    handed it make meta tensors of the shapes and dtypes they would draw,
    and draw nothing (the dry run's parameters, ``Model.init`` on
    ``"meta"``).  Meta tensors take a CPU generator's draws as no-ops."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def host_int(t: torch.Tensor) -> int:
    """A 0-dim tensor's value as a Python int.  A meta tensor has no value:
    a fresh cache's length made by ``Model.init_cache`` on meta carries
    its value (``known_value``, on the tensor it and its views are of)."""
    if not t.is_meta:
        return int(t)
    value = getattr(t if t._base is None else t._base, "known_value", None)
    if value is None:
        raise ValueError("a meta tensor has no value to read on the host "
                         "(only a fresh cache's length carries one)")
    return value


def dense_init(gen, d_in, d_out, *, lead=(), bias=False, stddev=None,
               dtype=torch.float32):
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal(gen, (*lead, d_in, d_out), stddev, dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def per_position(fn, x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """``fn`` over x [B, S, ...], or with ``split`` over each position's
    contiguous [B, 1, ...] slice in turn, concatenated along S.

    The speculative verify runs its row-wise work this way: a library
    kernel picked by shape (cuBLAS's split-K, a reduction's block split)
    then sees a decode tick's shape and rounds each position as the tick
    does."""
    if not split or x.shape[1] == 1:
        return fn(x)
    return torch.cat([fn(x[:, j:j + 1].contiguous())
                      for j in range(x.shape[1])], dim=1)


def embedding_init(gen, vocab, d, dtype=torch.float32):
    return {"table": truncated_normal(gen, (vocab, d), 0.02, dtype)}


def embed(p, ids):
    return p["table"][ids]


def unembed(p, x):
    """Tied read-out: logits via the embedding table."""
    return x @ p["table"].to(x.dtype).T


def rmsnorm_init(d, *, lead=(), dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def gated_rmsnorm(p, x, gate, eps=1e-5):
    """Mamba2-style norm: RMSNorm(x * silu(gate))."""
    return rmsnorm(p, x * F.silu(gate.to(x.dtype)), eps)


def mlp_init(gen, d, d_ff, *, lead=(), act="silu", dtype=torch.float32):
    p = {
        "up": dense_init(gen, d, d_ff, lead=lead, dtype=dtype),
        "down": dense_init(gen, d_ff, d, lead=lead,
                           stddev=1.0 / math.sqrt(d_ff), dtype=dtype),
    }
    if act == "silu":  # gated (SwiGLU) — all assigned LM archs use this
        p["gate"] = dense_init(gen, d, d_ff, lead=lead, dtype=dtype)
    return p


def mlp(p, x, *, act="silu"):
    if act == "silu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    return dense(p["down"], h)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D] (D even); positions: broadcastable to [..., S].
    Split-half rotation with f32 angles, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # [D/2]
    angles = positions[..., None].float() * freqs                # [..., S, D/2]
    sin = torch.sin(angles)[..., None, :]                        # [..., S, 1, D/2]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x: [B, S, C], w: [K, C]; ``cache``
    [B, K-1, C] holds the K-1 inputs before x (zeros when None).

    Returns (y [B, S, C] in x's dtype, new_cache [B, K-1, C]: the last K-1
    inputs, for the next decode step)."""
    k = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # [B, S+K-1, C]
    # depthwise, summed in the reference's order: w[0] x[t-K+1] + ...
    y = sum(w[i].to(x.dtype) * xp[:, i:i + x.shape[1], :] for i in range(k))
    if b is not None:
        y = y + b.to(x.dtype)
    new_cache = xp[:, xp.shape[1] - (k - 1):, :] if k > 1 else pad
    return y, new_cache
