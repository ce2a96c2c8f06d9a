"""Mamba2 — state-space duality (SSD), chunked algorithm (arXiv:2405.21060).

Port of ``repro.models.ssm``.  The chunk length is a ParallelFor block
size in the paper's exact sense: each chunk does quadratic-in-chunk local
work (the "task"), and the sequential inter-chunk state scan plays the
synchronisation role.  On CUDA every multi-token scan runs K12
(``kernels/mamba_ssd``, at ``autotune.SSD_CHUNK`` whatever the tuning
db holds: another chunk would move the served bits), which takes any sequence length (the last chunk is
ragged) and an initial state, and its gradient K16 (training); a
one-token step with a cache runs :func:`ssd_decode_step` in plain torch,
as the reference computes it outside any Pallas kernel.

The cache ({"conv": [B, K-1, C], "state": [B, H, P, N]}, both f32) is
UPDATED IN PLACE by :func:`ssm_apply`, as the port's KV cache is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_ssd import ops as ssd_ops
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_init(gen: torch.Generator, cfg: SSMConfig, *, lead=(),
             dtype=torch.float32) -> dict:
    """Params of one Mamba2 mixer (``lead`` stacking axes in front), drawn
    with the reference's distributions on ``gen``'s device.  ``A_log``,
    ``D`` and ``dt_bias`` stay f32 whatever ``dtype`` is, as in the
    reference."""
    dev = gen.device
    lead = tuple(lead)
    h = cfg.n_heads
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + h
    conv_w = torch.empty(lead + (cfg.d_conv, cfg.conv_channels),
                         dtype=torch.float32, device=dev)
    conv_w.normal_(generator=gen)
    # dt bias: softplus^-1 of dt log-uniform in [1e-3, 1e-1] (mamba2)
    u = torch.empty(lead + (h,), dtype=torch.float32, device=dev)
    u.uniform_(generator=gen)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": layers.dense_init(gen, cfg.d_model, d_in_proj, lead=lead,
                                     dtype=dtype),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros(lead + (cfg.conv_channels,), dtype=dtype,
                              device=dev),
        "A_log": a_log.expand(lead + (h,)).contiguous(),
        "D": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm": layers.rmsnorm_init(cfg.d_inner, lead=lead, dtype=dtype,
                                    device=dev),
        "out_proj": layers.dense_init(gen, cfg.d_inner, cfg.d_model,
                                      lead=lead,
                                      stddev=1.0 / math.sqrt(cfg.d_inner),
                                      dtype=dtype),
    }


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, *,
                chunk: Optional[int] = None,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan through ``kernels.mamba_ssd.ssd`` (K12 on CUDA, its
    plain version on the CPU).  x [B,S,H,P], dt [B,S,H] (after softplus),
    a [H] (negative), b_in/c_in [B,S,G,N], initial_state [B,H,P,N] or
    None.  Returns (y [B,S,H,P] in x's dtype, final_state [B,H,P,N] f32).
    Any S: the last chunk may be ragged.  A call that needs a gradient
    (grad mode on, an input requiring grad) goes through
    ``ssd_ops.ssd_autograd``: K12 forward and K16 backward on CUDA,
    their plain versions on the CPU."""
    init = (None if initial_state is None
            else initial_state.float().contiguous())
    args = (x.contiguous(), dt.float().contiguous(), a.float().contiguous(),
            b_in.contiguous(), c_in.contiguous())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args + (init,)):
        return ssd_ops.ssd_autograd(*args, chunk=chunk, initial_state=init)
    return ssd_ops.ssd(*args, chunk=chunk, initial_state=init)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_in: torch.Tensor, c_in: torch.Tensor,
                    state: torch.Tensor):
    """One token of the recurrence: x [B,1,H,P], dt [B,1,H], b_in/c_in
    [B,1,G,N], state [B,H,P,N].  Returns (y [B,1,H,P], new_state f32)."""
    h = x.shape[2]
    rep = h // b_in.shape[2]
    xf = x[:, 0].float()
    dtf = dt[:, 0].float()
    bh = b_in[:, 0].float().repeat_interleave(rep, dim=1)     # [B,H,N]
    ch = c_in[:, 0].float().repeat_interleave(rep, dim=1)
    da = torch.exp(dtf * a.float()[None, :])                 # [B,H]
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtf, xf, bh)
    new_state = state.float() * da[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", ch, new_state)
    return y[:, None].to(x.dtype), new_state


def ssm_apply(p, cfg: SSMConfig, x: torch.Tensor, *,
              cache: Optional[dict] = None):
    """Full Mamba2 mixer.  x: [B, S, d_model].  Returns (out, cache): with
    a cache ({"conv", "state"}), its tensors are advanced in place and the
    same dict is returned; without one, (out, None).  A one-token step with
    a cache takes the decode step; every other call scans the sequence
    from the cached state (or zeros)."""
    bsz, s, _ = x.shape
    h, pdim, n, g = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups
    zxbcdt = layers.dense(p["in_proj"], x)
    z, xbc, dt_raw = torch.split(
        zxbcdt, [cfg.d_inner, cfg.conv_channels, h], dim=-1)
    conv_cache = cache["conv"] if cache is not None else None
    xbc, new_conv = layers.causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                         cache=conv_cache)
    xbc = F.silu(xbc)
    xs, b_in, c_in = torch.split(xbc, [cfg.d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, s, h, pdim)
    b_in = b_in.reshape(bsz, s, g, n)
    c_in = c_in.reshape(bsz, s, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float()[None, None, :])
    a = -torch.exp(p["A_log"].float())

    if cache is not None and s == 1:
        y, new_state = ssd_decode_step(xs, dt, a, b_in, c_in, cache["state"])
    else:
        init = cache["state"] if cache is not None else None
        y, new_state = ssd_chunked(xs, dt, a, b_in, c_in,
                                   initial_state=init)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(bsz, s, cfg.d_inner)
    y = layers.gated_rmsnorm(p["norm"], y, z)
    out = layers.dense(p["out_proj"], y)
    if cache is None:
        return out, None
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(new_state)
    return out, cache


def init_ssm_cache(cfg: SSMConfig, batch: int, *, device="cuda") -> dict:
    """Zero conv window [B, K-1, C] and state [B, H, P, N], both f32."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_channels),
                            **f32),
        "state": torch.zeros((batch, cfg.n_heads, cfg.headdim, cfg.d_state),
                             **f32),
    }
