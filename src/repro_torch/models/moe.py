"""Mixture-of-Experts with prefix-sum slot claiming — the paper's FAA.

Port of ``repro.models.moe``.  Every (token, choice) claims a slot in its
expert's capacity buffer exactly once; one FAA counter per expert, served
in token order, would hand out the slot numbers that a prefix sum over
the token axis of the expert one-hot gives all at once
(:func:`prefix_sum_slots`).  The capacity is the paper's block size: too
small drops choices, too large wastes buffer rows.  ``dispatch_groups``
splits the claims into token groups, each with its own counters and
capacity share.  Under the sharded train step each rank holds its block
of the batch's rows (``distributed.sharding.row_axes``), and under
``seq_parallel`` its block of their sequences (``sharding.seq_split``):
its claim groups are its share of the batch's, which must split evenly
across those ranks (a group, a run of tokens in row-major [B, S] order,
must then lie inside one row's block), and the balance fractions and
z-loss are averaged over them (``sharding.token_axes``), so that the
step computes the unsharded function.

The buffers are laid out [E, G, C, d] (the reference's [G, E, C, d] with
the expert axis first), so the group axis folds into the rows of one
grouped matmul per product: the three expert products run as K14
(``kernels.moe_gmm.grouped_matmul``) on [E, G * C, d], the weights being
the same for every group; under a gradient each runs through
``GroupedMatmulFunction``, whose backward is K17.  ``silu(gate) * up``
stays in torch in the buffer's dtype, as the reference computes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    aux_loss_weight: float = 1e-2
    # 0 = one global prefix sum over all tokens (one FAA counter per
    # expert); > 0 = that many token groups, each with its own counters
    dispatch_groups: int = 0

    @property
    def shared_d_ff(self) -> int:
        return self.n_shared_experts * self.d_ff


def _normal(gen: torch.Generator, shape, stddev: float,
            dtype: torch.dtype) -> torch.Tensor:
    """``stddev`` times a standard normal drawn in f32 and rounded to
    ``dtype`` (the reference's expert init, not truncated).  Drawn one
    trailing [d, f] slab at a time straight into the result, so the f32
    draw never holds more than one slab (a full-width stack is 9.6 GB in
    bf16, twice that in f32).  On meta there is nothing to draw."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    slabs = out.view(-1, *out.shape[-2:])
    for i in range(slabs.shape[0]):
        slabs[i] = torch.randn(tuple(out.shape[-2:]), generator=gen,
                               device=gen.device).mul_(stddev)
    return out


def moe_init(gen: torch.Generator, cfg: MoEConfig, *, lead=(),
             dtype=torch.float32) -> dict:
    """Params of one MoE FFN (``lead`` stacking axes in front): the router
    f32 whatever ``dtype`` is, the expert weights ``N(0, 1/d)`` (gate, up)
    and ``N(0, 1/f)`` (down), and the shared experts' gated MLP."""
    lead = tuple(lead)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": layers.dense_init(gen, d, e, lead=lead, stddev=0.02,
                                    dtype=torch.float32),
        "gate": _normal(gen, (*lead, e, d, f), 1.0 / math.sqrt(d), dtype),
        "up": _normal(gen, (*lead, e, d, f), 1.0 / math.sqrt(d), dtype),
        "down": _normal(gen, (*lead, e, f, d), 1.0 / math.sqrt(f), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(gen, d, cfg.shared_d_ff, lead=lead,
                                      dtype=dtype)
    return p


def prefix_sum_slots(expert_idx: torch.Tensor, n_experts: int,
                     capacity: int):
    """FAA-equivalent slot assignment by a prefix sum.

    ``expert_idx``: [..., T, K] chosen expert per (token, choice); leading
    axes are independent groups.  Returns (slot [..., T, K] int32, keep
    [..., T, K] bool).  Slots are claimed in k-major order — every first
    choice before any second choice, each in token order — the order in
    which one FAA counter per expert would serve a deterministic queue."""
    *lead, t, k = expert_idx.shape
    flat = expert_idx.transpose(-1, -2).reshape(*lead, k * t).long()
    # the one-hot expert-major, [..., E, K*T], so that the prefix sum runs
    # along the innermost axis (a scan along an outer axis is ~30x slower
    # on the card at a 488-token prefill)
    experts = torch.arange(n_experts, device=flat.device)
    onehot = (flat[..., None, :] == experts[:, None]).to(torch.int32)
    ranks = torch.cumsum(onehot, dim=-1) - onehot           # claims before
    slot = ranks.gather(-2, flat[..., None, :])[..., 0, :]
    keep = slot < capacity
    return (slot.reshape(*lead, k, t).transpose(-1, -2).to(torch.int32),
            keep.reshape(*lead, k, t).transpose(-1, -2))


def capacity_of(cfg: MoEConfig, tokens_per_group: int,
                capacity: Optional[int] = None) -> int:
    """Rows per expert buffer: ``capacity`` or ceil(T_g * K / E * cf),
    rounded up to a multiple of 8, at least 8 (the reference's sublane
    alignment, kept so that the capacities and hence the drops agree)."""
    cap = capacity or math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def _expert_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One expert product: K14, through ``GroupedMatmulFunction`` (K17 its
    backward) when a gradient is needed."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return gmm_ops.grouped_matmul_autograd(x, w)
    return gmm_ops.grouped_matmul(x, w)


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor, *,
              capacity: Optional[int] = None):
    """x [B, S, d] -> (out [B, S, d], {"aux_loss", "dropped"} f32
    scalars), as the reference computes them."""
    b, s, d = x.shape
    t = b * s
    tokens = x.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    # under the sharded train step this rank holds its block of the
    # batch's rows (and, sequence-parallel, its block of their
    # sequences): the claim groups and the batch means (the balance
    # fractions and the z-loss) span every rank's tokens, as unsharded
    held = sharding.token_axes()
    shards = 1 if held is None else math.prod(
        sharding.axis_sizes(held[0])[a] for a in held[1])
    g = cfg.dispatch_groups or 1
    while (t * shards) % g:
        g //= 2
    tg = t * shards // g
    split = sharding.seq_split()
    if split is not None and split.blocks > 1 and s % tg:
        # a group is a run of tg tokens in row-major [B, S] order: it must
        # lie inside one row's block of S / m positions
        raise ValueError(
            f"moe_apply: a claim group of {tg} tokens ({g} dispatch_groups "
            f"over {t * shards} tokens) straddles the sequence blocks of "
            f"{s} positions: tg must divide S / m")
    if t % tg:
        raise ValueError(
            f"moe_apply: {g} claim groups (dispatch_groups) do not split "
            f"evenly across the {shards} ranks that hold the batch's rows")
    g = t // tg

    logits = tokens.float() @ p["router"]["w"].float()      # [T, E] f32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)             # [T, K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = capacity_of(cfg, tg, capacity)
    slot, keep = prefix_sum_slots(top_i.reshape(g, tg, k), e, cap)
    slot = slot.reshape(t, k)
    keep = keep.reshape(t, k)
    weight = torch.where(keep, top_p, 0.0)                  # [T, K]

    # ---- dispatch: scatter tokens into expert buffers [E, G, C, d] ----
    # a kept slot holds exactly one token, so a plain scatter places them;
    # dropped choices land in one extra row past the buffers, which is
    # never read (the reference adds them as zeros at slot cap - 1: the
    # same buffers)
    e_flat = top_i.reshape(g, tg * k)
    g_flat = torch.arange(g, device=x.device)[:, None].expand(g, tg * k)
    s_flat = torch.where(keep, slot, cap - 1).reshape(g, tg * k).long()
    rows = torch.where(keep.reshape(g, tg * k),
                       (e_flat * g + g_flat) * cap + s_flat, e * g * cap)
    vals = tokens.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(-1, d)
    flat = tokens.new_zeros((e * g * cap + 1, d))
    flat[rows.reshape(-1)] = vals
    buf = flat[:-1].view(e, g, cap, d)

    # ---- expert FFN (gated), K14 with the groups folded into the rows ----
    xb = buf.view(e, g * cap, d)
    h = F.silu(_expert_product(xb, p["gate"].to(buf.dtype)))
    h = h * _expert_product(xb, p["up"].to(buf.dtype))
    out_buf = _expert_product(h, p["down"].to(buf.dtype))

    # ---- combine: gather back and weight ----
    gathered = out_buf.view(e, g, cap, d)[e_flat, g_flat, s_flat]
    gathered = gathered.reshape(t, k, d)
    out = (gathered * weight[..., None].to(gathered.dtype)).sum(1)

    if cfg.n_shared_experts:
        out = out + layers.mlp(p["shared"], tokens)

    # ---- aux losses (Switch/GShard style) ----
    def batch_mean(v):
        v = v.mean(0)
        return v if held is None else sharding.mean_over(v, *held)

    assign_frac = batch_mean(F.one_hot(top_i[:, 0], e).float())
    prob_frac = batch_mean(probs)
    aux = e * (assign_frac * prob_frac).sum() * cfg.aux_loss_weight
    zloss = cfg.router_zloss * batch_mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - batch_mean(keep.float().reshape(-1))
    return out.reshape(b, s, d), {"aux_loss": aux + zloss, "dropped": dropped}
