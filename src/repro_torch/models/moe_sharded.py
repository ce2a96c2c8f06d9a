"""Expert-parallel MoE dispatch: hierarchical FAA claiming and one
all_to_all each way.

Port of ``repro.models.moe_sharded``.  The einsum formulation
(``moe.py``) is the faithful single-counter baseline.  This is the
paper's core-group insight applied to dispatch across devices:

* each (data, model) shard claims slots for ITS tokens with LOCAL
  counters (a prefix sum per shard = per-core-group FAA, no cross-group
  coherence);
* per-(source shard, expert) capacity buckets are exchanged with ONE
  all_to_all over the model axis (the only traffic between groups,
  analogous to the paper's cross-L3 line transfer, but batched and free
  of contention);
* the expert FFN runs on the locally owned experts; a second all_to_all
  returns the outputs; the combine is local.

Capacity semantics differ from the global counter only in being per
source shard (tokens never compete with another shard's tokens), the
same relaxation the paper applies between core groups.

The reference writes the body ``shard_map`` runs on each shard; the port
runs it on each rank.  A rank holds its block of the batch's rows, split
over the axes ``sharding.row_axes`` names (none outside the sharded train
step: every rank then holds every row); it takes its shard of those
tokens along the remaining token axes, and after the combine gathers the
shards' outputs back into its rows.  The parameters arrive whole (the
sharded step gathers each one before the loss, which is where the
reference's all_gather of the FSDP'd expert weights over "data" went), so
a rank slices out the experts it owns.  The two all_to_alls run under
autograd (``torch.distributed.nn.functional.all_to_all_single``), as do
the token-axis means of the balance fractions and z-loss
(``sharding.mean_over``).  The expert products are K14 (K17 under a
gradient), as in ``moe_apply``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.nn.functional import all_to_all_single

from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.moe import (MoEConfig, _expert_product, moe_apply,
                                    prefix_sum_slots)


def moe_apply_sharded(p, cfg: MoEConfig, x: torch.Tensor, *,
                      capacity: Optional[int] = None):
    """Drop-in for ``moe_apply``; needs an active ShardingPolicy whose
    mesh has a "model" axis dividing n_experts, and a token count that
    divides into the shards: else it is ``moe_apply``, as in the
    reference.  The capacity rounds up to a multiple of 4 (``moe_apply``
    rounds to 8).  A ``seq_parallel`` policy raises: its "model" axis
    carries the sequence."""
    pol = sharding.active_policy()
    if pol is not None and pol.seq_parallel:
        raise NotImplementedError(
            "moe_impl='sharded' under ShardingPolicy(seq_parallel=True): its "
            "experts split over the 'model' axis, which carries the "
            "sequence there (ROADMAP: distributed and launch)")
    sizes = {} if pol is None else sharding.axis_sizes(pol.mesh)
    if pol is None or "model" not in sizes \
            or cfg.n_experts % sizes["model"]:
        return moe_apply(p, cfg, x, capacity=capacity)

    mesh = pol.mesh
    m = sizes["model"]
    token_axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
    n_shards = math.prod(sizes[a] for a in token_axes)
    rows = sharding.row_axes()
    if rows is not None and rows[0] is not mesh:
        raise ValueError("moe_apply_sharded: the sharded step's mesh is not "
                         "the active policy's")
    held = () if rows is None else rows[1]
    b, s, d = x.shape
    t = b * s * math.prod(sizes[a] for a in held)   # the batch's tokens
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // m
    if t % n_shards:
        return moe_apply(p, cfg, x, capacity=capacity)
    if held != token_axes[:len(held)]:
        raise ValueError(f"moe_apply_sharded: rows split over {held}, not "
                         f"a prefix of the token axes {token_axes}")
    # the axes left to split this rank's rows over (one of size 1 splits
    # nothing)
    rest = tuple(a for a in token_axes[len(held):] if sizes[a] > 1)
    t_loc = t // n_shards
    cap = capacity or int(math.ceil(t_loc * k / e * cfg.capacity_factor))
    cap = max(4, -(-cap // 4) * 4)

    coord = sharding.coordinate(mesh)
    tokens = x.reshape(b * s, d)
    i, _ = sharding.chunk_index(sizes, coord, rest)
    # a rank that holds its shard whole takes no slice: a slice would sum
    # the routing and dispatch gradients before adding the shared experts',
    # in another order than moe_apply's (another rounding in bf16)
    tok = tokens[i * t_loc:(i + 1) * t_loc] if rest else tokens
    own = slice(coord["model"] * e_loc, (coord["model"] + 1) * e_loc)
    gate, up, down = (p[n][own] for n in ("gate", "up", "down"))

    # ---- routing, shard-local ----
    logits = tok.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    tp, ti = torch.topk(probs, k, dim=-1)
    tp = tp / tp.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- local (core-group) FAA claiming ----
    slot, keep = prefix_sum_slots(ti, e, cap)
    w = torch.where(keep, tp, 0.0)
    ef = ti.reshape(-1)
    sf = torch.where(keep, slot, cap - 1).reshape(-1).long()
    # a kept slot holds one choice; dropped ones land in an extra row
    dest = torch.where(keep.reshape(-1), ef * cap + sf, e * cap)
    flat = tok.new_zeros((e * cap + 1, d))
    flat[dest] = tok[:, None, :].expand(t_loc, k, d).reshape(-1, d)
    buf = flat[:-1].view(m, e_loc, cap, d)

    # one all_to_all to the expert owners (destination = e // e_loc)
    group = sharding.group_of(mesh, ("model",))
    recv = all_to_all_single(torch.empty_like(buf), buf, group=group)
    moe_apply_sharded.all_to_all_calls += 1
    xb = recv.transpose(0, 1).reshape(e_loc, m * cap, d)
    h = F.silu(_expert_product(xb, gate.to(xb.dtype)))
    h = h * _expert_product(xb, up.to(xb.dtype))
    outb = _expert_product(h, down.to(xb.dtype))
    back = outb.view(e_loc, m, cap, d).transpose(0, 1).contiguous()
    ret = all_to_all_single(torch.empty_like(back), back, group=group)
    moe_apply_sharded.all_to_all_calls += 1
    gathered = ret.view(e, cap, d)[ef, sf].reshape(t_loc, k, d)
    out = (gathered * w[..., None].to(gathered.dtype)).sum(1)
    if rest:
        out = sharding.gather_rows(out, mesh, rest)

    if cfg.n_shared_experts:
        out = out + layers.mlp(p["shared"], tokens)

    # ---- aux losses: shard-local sums, global means over the token axes
    # (no [T, E] tensor leaves the shard) ----
    def token_mean(v):
        return sharding.mean_over(v.mean(0), mesh, token_axes)

    assign_frac = token_mean(F.one_hot(ti[:, 0], e).float())
    prob_frac = token_mean(probs)
    aux = e * (assign_frac * prob_frac).sum() * cfg.aux_loss_weight
    zloss = cfg.router_zloss * token_mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    kept = token_mean(keep.float().reshape(-1))
    return out.reshape(b, s, d), {"aux_loss": aux + zloss,
                                  "dropped": 1.0 - kept}


moe_apply_sharded.all_to_all_calls = 0   # forward exchanges since a reset
