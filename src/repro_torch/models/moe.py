"""Mixture-of-Experts with prefix-sum slot claiming — the paper's FAA.

Port of ``repro.models.moe``.  Every (token, choice) claims a slot in its
expert's capacity buffer exactly once; one FAA counter per expert, served
in token order, would hand out the slot numbers that a prefix sum over
the token axis of the expert one-hot gives all at once
(:func:`prefix_sum_slots`).  The capacity is the paper's block size: too
small drops choices, too large wastes buffer rows.  ``dispatch_groups``
splits the claims into token groups (runs of the batch's tokens in
row-major [B, S] order), each with its own counters and capacity share.

The buffers are laid out [E, G, C, d] (the reference's [G, E, C, d] with
the expert axis first), so the group axis folds into the rows of one
grouped matmul per product: the three expert products run as K14
(``kernels.moe_gmm.grouped_matmul``) on [E, G * C, d], the weights being
the same for every group; under a gradient each runs through
``GroupedMatmulFunction``, whose backward is K17.  ``silu(gate) * up``
stays in torch in the buffer's dtype, as the reference computes it.

Claim groups across ranks: the FAA ticket.  Under the sharded train step
each rank holds its block of the batch's rows (``sharding.row_axes``)
and, under ``seq_parallel``, its block of their sequences
(``sharding.seq_split``), so a group's tokens may lie on several ranks
(the token axes, ``sharding.token_axes``).  Each rank cuts its tokens
into pieces (:func:`claim_pieces`: runs that are contiguous in the
group's order and lie in one group; under ``seq_parallel`` each local
row's block is a run of its own, since the ranks' blocks interleave),
counts its claims a piece by (choice, expert) (:func:`piece_claims`) and
all-gathers those counts over the token axes: E x K integers a piece.
Every rank then holds every piece's counts and reckons its own claims'
slots as the one prefix sum over the group would (:func:`piece_bases`):
the group's claims of earlier choices (the order is k-major), then the
earlier pieces' claims of the same choice, then the claim's rank in its
piece.  That is a fetch-and-add ticket that every rank computes without
a contended counter.  The group's E x C buffer rows, in (expert, slot)
order, are split evenly over the ranks that hold its tokens: each owns
E / R whole experts, or, past E ranks, a block of C E / R rows of one
expert; the kept claims go to their owners and the outputs come back in
one ``all_to_all_single`` each way under autograd, whose split sizes
every rank reads from the gathered counts (one device-to-host copy a
layer).  The owners run K14 (K17 under a gradient) on their rows.  On
meta tensors, where counts have no values, the exchange is counted at an
even split of every claim.  Where every group lies on one rank (several
groups, each held whole by one rank) the slots are that rank's own
prefix sums and the exchange the identity, so the rank runs its groups
as the unsharded step does, with no host copy and no exchange; the one
group of ``dispatch_groups`` 0 takes the ticket at any number of ranks,
one included (where it is the identity), so that the reference's default
runs one route on one card and on many.  The balance fractions and
z-loss are means over the token axes (``sharding.mean_over``), and
``dropped`` is reckoned from exact counts summed over them, so that the
step computes the unsharded function.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.nn.functional import all_to_all_single

from repro_torch.distributed import sharding
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import layers


# the ticket's collectives since a reset: its count exchanges (one a MoE
# layer's forward) and row exchanges (two), recomputes included
EXCHANGE_CALLS = {"all_gather": 0, "all_to_all": 0}


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
    # contiguous [..., T, K]: the router's gradient then sums over K in one
    # order whichever path (one group or several, this rank's groups or
    # the ticket's) made the keep bits
    return (slot.reshape(*lead, k, t).transpose(-1, -2).to(torch.int32)
            .contiguous(),
            keep.reshape(*lead, k, t).transpose(-1, -2).contiguous())


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
    scalars), as the reference computes them (under a sharded step: this
    rank's rows of them, through the FAA ticket where a group's tokens
    lie on several ranks or the batch is one group)."""
    b, s, d = x.shape
    t = b * s
    tokens = x.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    held = sharding.token_axes()

    logits = tokens.float() @ p["router"]["w"].float()      # [T, E] f32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)             # [T, K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    if held is None:
        lay = None
        g = cfg.dispatch_groups or 1
        while t % g:
            g //= 2
        tg, cap = t // g, capacity_of(cfg, t // g, capacity)
    else:
        lay = _layout_here(cfg, b, s, capacity)
        tg, cap = lay.tokens // lay.groups, lay.cap
    if lay is None or (lay.groups > 1 and lay.n_holders.max() == 1):
        # every claim group on this rank: its groups' prefix sums and
        # buffers here, the batch's kept claims summed over the token axes
        g = t // tg
        slot, keep = prefix_sum_slots(top_i.reshape(g, tg, k), e, cap)
        slot = slot.reshape(t, k)
        keep = keep.reshape(t, k)
        weight = torch.where(keep, top_p, 0.0)              # [T, K]
        out = _local_experts(p, tokens, top_i, slot, keep, weight, g, cap)
        kept = keep.sum()
        if lay is not None and len(lay.pieces) > 1:
            torch.distributed.all_reduce(kept, group=sharding.group_of(*held))
        kept = kept.float()
    else:
        tk = claim_ticket(top_i, lay, e)
        weight = torch.where(tk.keep, top_p, 0.0)
        out = _exchanged_experts(p, tokens, top_i, weight, tk)
        # the batch's kept claims, from every rank's gathered counts
        kept = (torch.empty((), device=x.device) if tk.kept is None else
                torch.full((), tk.kept, dtype=torch.float32, device=x.device))
    # one f32 quotient of exact counts, whichever ranks held the claims
    dropped = 1.0 - kept / ((t if lay is None else lay.tokens) * k)

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
    return out.reshape(b, s, d), {"aux_loss": aux + zloss, "dropped": dropped}


def _local_experts(p, tokens, top_i, slot, keep, weight, g: int, cap: int):
    """Every claim group's buffers on this rank: dispatch, the three
    expert products and the combine (out [T, d])."""
    t, d = tokens.shape
    e, k = p["gate"].shape[0], top_i.shape[1]
    tg = t // g
    # ---- dispatch: scatter tokens into expert buffers [E, G, C, d] ----
    # a kept slot holds exactly one token, so a plain scatter places them;
    # dropped choices land in one extra row past the buffers, which is
    # never read (the reference adds them as zeros at slot cap - 1: the
    # same buffers)
    e_flat = top_i.reshape(g, tg * k)
    g_flat = torch.arange(g, device=tokens.device)[:, None].expand(g, tg * k)
    s_flat = torch.where(keep, slot, cap - 1).reshape(g, tg * k).long()
    rows = torch.where(keep.reshape(g, tg * k),
                       (e_flat * g + g_flat) * cap + s_flat, e * g * cap)
    vals = tokens.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(-1, d)
    flat = tokens.new_zeros((e * g * cap + 1, d))
    flat[rows.reshape(-1)] = vals
    buf = flat[:-1].view(e, g, cap, d)

    # ---- expert FFN (gated), K14 with the groups folded into the rows ----
    out_buf = _expert_ffn(p, buf.view(e, g * cap, d), slice(0, e))

    # ---- combine: gather back and weight ----
    gathered = out_buf.view(e, g, cap, d)[e_flat, g_flat, s_flat]
    gathered = gathered.reshape(t, k, d)
    return (gathered * weight[..., None].to(gathered.dtype)).sum(1)


def _expert_ffn(p, xb: torch.Tensor, experts: slice) -> torch.Tensor:
    """The gated expert FFN of the experts ``experts`` on their rows xb
    [E', C, d]: three K14 products.  Where the block spans every expert the
    weights go in whole, since a slice's backward would copy each gradient
    into a zero tensor of the whole weight's size; an owner of part of the
    experts takes their slice."""
    def w(name):
        full = p[name]
        if experts != slice(0, full.shape[0]):
            full = full[experts]
        return full.to(xb.dtype)

    h = F.silu(_expert_product(xb, w("gate")))
    h = h * _expert_product(xb, w("up"))
    return _expert_product(h, w("down"))


# --------------------------------------- claim groups across ranks: the ticket

def claim_pieces(b: int, s: int, m: int, tg: int, blocks) -> list:
    """The pieces of each rank's tokens: for each (row block i, sequence
    block c) of ``blocks`` (a rank holding rows [i b, (i + 1) b) and
    positions [c s, (c + 1) s) of sequences of m s), an int64 array [P, 4]
    of (local start, length, group, global start), the local tokens in
    row-major [b, s] order and the global ones in [B, S] order, a group
    being ``tg`` consecutive global tokens.  A piece is a run of the
    rank's tokens contiguous in the global order and inside one group:
    each local row's block is a run of its own where m > 1 (the ranks'
    blocks of a row interleave), the whole block where m = 1; a group
    boundary inside a run cuts it in two."""
    seq = s * m
    out = []
    for i, c in blocks:
        if m == 1:
            runs = [(0, i * b * s, b * s)]
        else:
            runs = [(r * s, (i * b + r) * seq + c * s, s) for r in range(b)]
        pieces = []
        for u0, g0, n in runs:
            cuts = np.arange((-g0) % tg or tg, n, tg)
            offs = np.concatenate([[0], cuts])
            lens = np.diff(np.append(offs, n))
            pieces.append(np.stack([u0 + offs, lens, (g0 + offs) // tg,
                                    g0 + offs], 1))
        out.append(np.concatenate(pieces).astype(np.int64))
    return out


def piece_claims(top_i: torch.Tensor, pieces: np.ndarray, n_experts: int):
    """This rank's claims by piece: (counts [P, K, E] int32, each piece's
    claims of each (choice, expert); ranks [T, K], the claims of the same
    (choice, expert) before each in its piece).  ``pieces`` from
    :func:`claim_pieces`."""
    t, k = top_i.shape
    dev = top_i.device
    flat = top_i.t().long()                                   # [K, T]
    experts = torch.arange(n_experts, device=dev)
    onehot = (flat[None] == experts[:, None, None]).to(torch.int32)
    cum = F.pad(torch.cumsum(onehot, dim=-1, dtype=torch.int32), (1, 0))
    starts = torch.as_tensor(pieces[:, 0], device=dev)
    ends = starts + torch.as_tensor(pieces[:, 1], device=dev)
    before = cum[:, :, starts]                                # [E, K, P]
    counts = (cum[:, :, ends] - before).permute(2, 1, 0)
    piece = torch.as_tensor(np.repeat(np.arange(len(pieces)), pieces[:, 1]),
                            device=dev)                       # [T]
    excl = cum[:, :, :-1].gather(0, flat[None])[0].t()        # [T, K]
    ranks = excl - before.permute(2, 1, 0)[piece[:, None],
                                           torch.arange(k, device=dev),
                                           top_i.long()]
    return counts.contiguous(), ranks


def piece_bases(counts: np.ndarray, pieces: list) -> np.ndarray:
    """Each piece's first slot of each (choice, expert) in its group's one
    prefix sum (k-major: every first choice before any second): the
    group's claims of earlier choices plus the claims of the same choice
    in the group's earlier pieces.  ``counts`` [R, Pmax, K, E] every
    rank's :func:`piece_claims` counts (rows past a rank's pieces
    ignored), ``pieces`` every rank's :func:`claim_pieces`; returns
    [R, Pmax, K, E] int64."""
    r, pmax, k, e = counts.shape
    which = [(ri, pi) for ri, pc in enumerate(pieces) for pi in range(len(pc))]
    rs, ps = np.array(which).T
    gstart = np.concatenate([pc[:, 3] for pc in pieces])
    group = np.concatenate([pc[:, 2] for pc in pieces])
    order = np.argsort(gstart, kind="stable")
    rs, ps, group = rs[order], ps[order], group[order]
    n = counts[rs, ps].astype(np.int64)                        # [Q, K, E]
    excl = np.cumsum(n, 0) - n                                 # pieces before
    first = np.flatnonzero(np.r_[True, group[1:] != group[:-1]])
    run = np.repeat(np.arange(len(first)), np.diff(np.r_[first, len(group)]))
    within = excl - excl[first][run]
    total = np.add.reduceat(n, first, axis=0)                  # [groups, K, E]
    earlier = np.cumsum(total, 1) - total                      # choices before
    out = np.zeros((r, pmax, k, e), np.int64)
    out[rs, ps] = within + earlier[run]
    return out


class TicketLayout(NamedTuple):
    """What every rank's tokens are and who owns which buffer rows, from
    the shapes alone (:func:`ticket_layout`)."""
    tokens: int              # the batch's tokens, over every rank
    groups: int
    cap: int
    me: int                  # this rank's index in the token axes' group
    pieces: list             # every rank's claim_pieces
    holders: list            # each group's ranks, ascending
    n_holders: np.ndarray    # [groups]
    table: np.ndarray        # [groups, most holders] padded with the last
    # this rank's buffers, one K14 call each: (first expert, experts, rows
    # an expert, groups, the first expert's first slot)
    blocks: list


@functools.lru_cache(maxsize=64)
def ticket_layout(b: int, s: int, m: int, tg: int, blocks: tuple, me: int,
                  n_experts: int, cap: int) -> TicketLayout:
    """The layout of the ticket over the ranks ``blocks`` (each rank's (row
    block, sequence block), in the token axes' group order; ``me`` this
    rank's index): pieces, each group's holders and this rank's buffer
    blocks.  A group held by R ranks splits its E x C rows, in (expert,
    slot) order, into R runs of E C / R rows (rounded down at each cut),
    the q-th holder owning the q-th: E / R whole experts where R divides
    E, C E / R rows of one expert where E divides R and R / E divides C,
    else runs that end inside an expert.  A rank's runs of the groups it
    holds that start and end at the same rows form one block, laid out
    [experts, groups x rows, d] as the unsharded buffers are (rows past a
    run's ends stay zero)."""
    e = n_experts
    pieces = claim_pieces(b, s, m, tg, blocks)
    tokens = b * s * len(blocks)
    groups = tokens // tg
    holders = [[] for _ in range(groups)]
    for r, pc in enumerate(pieces):
        for grp in np.unique(pc[:, 2]):
            holders[grp].append(r)
    n = np.array([len(h) for h in holders])
    runs = {}
    for grp, h in enumerate(holders):
        if me in h:
            q = h.index(me)
            r0, r1 = q * e * cap // len(h), (q + 1) * e * cap // len(h)
            if r1 > r0:
                runs.setdefault((r0, r1), []).append(grp)
    mine = []
    for (r0, r1), grps in runs.items():
        e0, e1 = r0 // cap, (r1 - 1) // cap
        lo = r0 - e0 * cap
        rows = max(min(cap, r1 - x * cap) - (lo if x == e0 else 0)
                   for x in range(e0, e1 + 1))
        mine.append((e0, e1 - e0 + 1, rows, tuple(grps), lo))
    width = int(n.max())
    table = np.array([h + h[-1:] * (width - len(h)) for h in holders])
    return TicketLayout(tokens, groups, cap, me, pieces, holders, n, table,
                        mine)


class Ticket(NamedTuple):
    """This rank's claims and its part of the exchange
    (:func:`claim_ticket`)."""
    layout: TicketLayout
    slot: torch.Tensor        # [T, K] int64, the group's prefix-sum slot
    keep: torch.Tensor        # [T, K] bool
    kept: Optional[int]       # the batch's kept claims (None on meta)
    order: torch.Tensor       # [n_send] claims (t * K + j) sent, in order
    send: list                # rows sent to each rank of the group
    recv: list                # rows received from each
    rows: torch.Tensor        # [n_recv] each received row's local row
    group: object             # the token axes' group (_token_group)


def _layout_here(cfg: MoEConfig, b: int, s: int,
                 capacity: Optional[int] = None) -> TicketLayout:
    """The :func:`ticket_layout` of this rank's [b, s] tokens under the
    running sharded step: every rank of the token axes with its (row
    block, sequence block), the groups and the capacity counted over all
    of them."""
    mesh, axes = sharding.token_axes()
    sizes = sharding.axis_sizes(mesh)
    rows_of = sharding.row_axes()
    seq = sharding.seq_split()
    row_axes = () if rows_of is None else rows_of[1]
    m = 1 if seq is None else seq.blocks
    blocks = []
    for pos in itertools.product(*(range(sizes[a]) for a in axes)):
        coord = dict(zip(axes, pos))
        blocks.append((sharding.chunk_index(sizes, coord, row_axes)[0],
                       0 if seq is None else coord[seq.axis]))
    me, n_ranks = sharding.chunk_index(sizes, sharding.coordinate(mesh),
                                       axes)
    t_all = b * s * n_ranks
    g = cfg.dispatch_groups or 1
    while t_all % g:
        g //= 2
    tg = t_all // g
    return ticket_layout(b, s, m, tg, tuple(blocks), me, cfg.n_experts,
                         capacity_of(cfg, tg, capacity))


def claim_ticket(top_i: torch.Tensor, lay: TicketLayout,
                 e: int) -> Ticket:
    """The FAA ticket of this rank's claims ``top_i`` [b s, K] of ``e``
    experts under the running sharded step, laid out as ``lay``
    (:func:`_layout_here`; module docstring): the pieces' counts
    all-gathered over the token axes, the slots of the one prefix sum
    over each group, and the plan of the exchange with the buffer rows'
    owners."""
    k = top_i.shape[1]
    n_ranks, cap = len(lay.pieces), lay.cap
    mine = lay.pieces[lay.me]
    group = _token_group(*sharding.token_axes())

    counts, ranks = piece_claims(top_i, mine, e)
    pmax = max(len(pc) for pc in lay.pieces)
    padded = counts.new_zeros((pmax, k, e))
    padded[:len(mine)] = counts
    gathered = padded[None]
    if group is not None:
        gathered = padded.new_empty((n_ranks, pmax, k, e))
        torch.distributed.all_gather_into_tensor(
            gathered.view(-1), padded.view(-1), group=group)
        EXCHANGE_CALLS["all_gather"] += 1
    dev = top_i.device
    host = None if gathered.is_meta else gathered.cpu().numpy()
    plan = _exchange_plan(lay, host, k, e)

    piece = torch.as_tensor(np.repeat(np.arange(len(mine)), mine[:, 1]),
                            device=dev)
    base = (torch.empty((len(mine), k, e), dtype=torch.int64, device=dev)
            if host is None else torch.as_tensor(plan["base"], device=dev))
    kk = torch.arange(k, device=dev)
    slot = (base[piece[:, None], kk, top_i.long()] + ranks).contiguous()
    keep = slot < cap                                          # [T, K]
    # the owner of each claim's row and its place in the send order:
    # (owner, group, expert, slot), the order each owner reads its rows in
    grp = torch.as_tensor(mine[:, 2], device=dev)[piece][:, None]
    held = torch.as_tensor(lay.n_holders, device=dev)[grp]
    q = ((top_i.long() * cap + slot + 1) * held - 1) // (e * cap)
    table = torch.as_tensor(lay.table, device=dev)
    own = table[grp, q.clamp_max(table.shape[1] - 1)]
    span = lay.groups * e * cap
    key = torch.where(keep, own * span + (grp * e + top_i.long()) * cap + slot,
                      n_ranks * span)
    order = torch.sort(key.reshape(-1)).indices[:sum(plan["send"])]
    rows = (torch.empty(sum(plan["recv"]), dtype=torch.int64, device=dev)
            if host is None else torch.as_tensor(plan["rows"], device=dev))
    return Ticket(lay, slot, keep, plan["kept"], order, plan["send"],
                  plan["recv"], rows, group)


def _token_group(mesh, axes):
    """The process group of the token axes; where no axis splits the
    tokens, the world if it is this rank alone (a one-card step still runs
    the collectives), else None (no other rank holds a claim of this
    rank's groups: the exchange is the identity)."""
    if axes:
        return sharding.group_of(mesh, axes)
    if torch.distributed.get_world_size() == 1:
        return torch.distributed.group.WORLD
    return None


def _exchange_plan(lay: TicketLayout, counts: Optional[np.ndarray], k: int,
                   e: int) -> dict:
    """From every rank's gathered counts [R, Pmax, K, E]: this rank's
    pieces' bases, the rows it sends each rank and receives from each,
    the local row of each received row (in each sender's order), and the
    batch's kept claims.  ``counts`` None (meta): every claim counted as
    kept, each piece's claims split evenly over its group's owners."""
    n_ranks, cap, me = len(lay.pieces), lay.cap, lay.me
    if counts is None:
        send, recv = [0] * n_ranks, [0] * n_ranks
        for r, pc in enumerate(lay.pieces):
            for _, length, grp, _ in pc:
                h = lay.holders[grp]
                share, rest = divmod(int(length) * k, len(h))
                for q, o in enumerate(h):
                    n = share + (q < rest)
                    if r == me:
                        send[o] += n
                    if o == me:
                        recv[r] += n
        return {"send": send, "recv": recv, "kept": None}
    bases = piece_bases(counts, lay.pieces)
    # every (rank, piece, choice, expert)'s kept slots [lo, hi), cut into
    # the owners' row blocks
    lo_all, hi_all, grp_all = [], [], []
    for r, pc in enumerate(lay.pieces):
        lo = bases[r, :len(pc)]
        lo_all.append(lo)
        hi_all.append(np.minimum(lo + counts[r, :len(pc)], cap))
        grp_all.append(np.broadcast_to(pc[:, 2, None, None], lo.shape))
    sender = np.concatenate([np.full(len(pc), r) for r, pc in
                             enumerate(lay.pieces)])
    lo, hi, grp = (np.concatenate(a) for a in (lo_all, hi_all, grp_all))
    sender = np.broadcast_to(sender[:, None, None], lo.shape)
    expert = np.broadcast_to(np.arange(e), lo.shape)
    kept = int(np.maximum(hi - lo, 0).sum())
    # the ranges as rows of the group's E x C in (expert, slot) order, and
    # the holders' places of the owners of their first and last rows
    big, held = e * cap, lay.n_holders[grp]
    fa, fz = expert * cap + lo, expert * cap + hi
    valid = hi > lo
    qa = ((fa + 1) * held - 1) // big
    qz = (fz * held - 1) // big
    # this rank's blocks by group: (offset, first expert, rows an expert,
    # groups in the block, the group's place, the first expert's first slot)
    place = np.zeros((6, lay.groups), np.int64)
    offset = 0
    for e0, ne, rows, grps, first in lay.blocks:
        for j, gg in enumerate(grps):
            place[:, gg] = (offset, e0, rows, len(grps), j, first)
        offset += ne * rows * len(grps)
    send, recv = np.zeros(n_ranks, np.int64), np.zeros(n_ranks, np.int64)
    starts, lens, keys = [], [], []
    steps = int((qz - qa)[valid].max()) + 1 if valid.any() else 0
    for step in range(steps):
        q = qa + step
        a = np.maximum(fa, q * big // held)
        z = np.minimum(fz, (q + 1) * big // held)
        ok = valid & (q <= qz) & (z > a)
        owner = lay.table[grp, np.minimum(q, lay.table.shape[1] - 1)]
        out = ok & (sender == me)
        np.add.at(send, owner[out], (z - a)[out])
        mine = ok & (owner == me)
        np.add.at(recv, sender[mine], (z - a)[mine])
        gg, ee = grp[mine], expert[mine]
        sa = a[mine] - ee * cap
        off, e0, rows, n_g, j, first = place[:, gg]
        starts.append(off + (ee - e0) * rows * n_g + j * rows + sa
                      - np.where(ee == e0, first, 0))
        lens.append((z - a)[mine])
        keys.append((sender[mine] * lay.groups + gg) * big + ee * cap + sa)
    starts, lens, keys = (np.concatenate(x) if x else np.zeros(0, np.int64)
                          for x in (starts, lens, keys))
    o = np.argsort(keys, kind="stable")
    st, ln = starts[o], lens[o]
    rows = np.repeat(st - np.cumsum(ln) + ln, ln) + np.arange(int(ln.sum()))
    return {"base": bases[me, :len(lay.pieces[me])], "send": send.tolist(),
            "recv": recv.tolist(), "rows": rows, "kept": kept}


def _exchanged_experts(p, tokens, top_i, weight, tk: Ticket):
    """The kept claims' rows sent to their owners, the owners' expert
    products, the outputs sent back and combined (out [T, d])."""
    t, d = tokens.shape
    k = top_i.shape[1]
    vals = tokens[:, None, :].expand(t, k, d).reshape(t * k, d)
    sent = vals[tk.order]
    got = _exchange(sent, tk.recv, tk.send, tk.group)
    size = sum(ne * rows * len(gs) for _, ne, rows, gs, _ in tk.layout.blocks)
    local = got.new_zeros((size, d)).index_put((tk.rows,), got)
    outs, offset = [], 0
    for e0, ne, rows, gs, _ in tk.layout.blocks:
        n = ne * rows * len(gs)
        xb = local[offset:offset + n].view(ne, rows * len(gs), d)
        outs.append(_expert_ffn(p, xb, slice(e0, e0 + ne)).reshape(n, d))
        offset += n
    out_local = outs[0] if len(outs) == 1 else torch.cat(outs)
    back = _exchange(out_local[tk.rows], tk.send, tk.recv, tk.group)
    gathered = tokens.new_zeros((t * k, d)).index_put((tk.order,), back)
    gathered = gathered.view(t, k, d)
    return (gathered * weight[..., None].to(gathered.dtype)).sum(1)


def _exchange(rows: torch.Tensor, recv: list, send: list, group):
    """``rows`` sent ``send[r]`` to rank r of ``group``, ``recv[r]``
    received from each, in one ``all_to_all_single`` under autograd (its
    backward sends the gradients back the same way); ``rows`` itself
    without a group."""
    if group is None:
        return rows
    EXCHANGE_CALLS["all_to_all"] += 1
    return all_to_all_single(rows.new_empty((sum(recv), rows.shape[1])),
                             rows, recv, send, group=group)

