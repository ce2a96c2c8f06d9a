"""Sharding policy: every PartitionSpec of the port in one place.

Port of ``repro.distributed.sharding``.  A :class:`ShardingPolicy` names
a ``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the reference's axes:

  pod    — data-parallel replica groups across pods (slow links; the
           paper's "core group" boundary)
  data   — data parallel within a pod; FSDP parameter sharding
  model  — tensor parallel: attention heads / FFN hidden / experts / KV
           heads; the expert-parallel axis of ``models/moe_sharded``

The reference's model code calls ``constrain(x, name)`` so that GSPMD
lays each activation out under the active policy.  The port computes on
each rank's local tensors: the sharded train step hands every rank its
rows of the batch and the full parameters, so there is nothing to
constrain, and ``constrain`` / ``named_sharding`` are not ported.  The
spec table :func:`_specs` is the reference's, verbatim; the activation
entries document the layout the reference would pick.  Under
``seq_parallel`` the sharded step also cuts each row's sequence into
equal blocks over "model" (the reference's ``act_btd`` then is ``P(b,
"model", None)``): a rank holds its rows' block of positions, and
attention gathers K and V over "model" (:func:`gather_rows` along the
sequence dim) and attends over the prefix of the sequence up to its
block's end.

Beside the policy, the rank-local computation needs to know which mesh
axes its rows are split over (:func:`row_axes`, set by the sharded step
through :func:`rows_split_over`) and, under ``seq_parallel``, which block
of the sequence it holds (:func:`seq_split`, set through
:func:`seq_split_over`): a mean over the batch (the MoE balance fractions
and z-loss) is then averaged over those axes with :func:`mean_over`
(:func:`token_axes`), so that the sharded step computes the unsharded
one's function; the MoE's FAA ticket (``models/moe.py``) gathers its
claim counts and exchanges its expert rows over the same axes' group.
A tensor cut into this rank's block along a mesh axis can carry the cut
(:func:`mark_block`, :func:`block_of`): the KV cache
leaves that ``params.shard_cache`` cuts by positions do, so that a layer
knows from the cache it is handed whether it holds a block, and which
(a one-token decode under ``decode_seq_shard`` then combines the ranks'
partial softmaxes).  :func:`group_of` makes the process group of a set
of mesh axes on first use; no group is made until a policy or a sharded step
asks for one, and a sharded call with no initialized default group
raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist


class P(tuple):
    """A PartitionSpec: one entry per tensor dim, each a mesh axis name,
    a tuple of names (the dim split over them, the first outermost) or
    None (not split).  Entries are canonical as JAX's are: a list is a
    tuple, one name in a tuple is the name, an empty tuple is None."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_entry(a) for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _entry(a):
    if isinstance(a, (tuple, list)):
        return None if not a else a[0] if len(a) == 1 else tuple(a)
    return a


# batch axes: data parallel spans (pod, data)
BATCH = ("pod", "data")
# the axis ``seq_parallel`` cuts the sequence over
SEQ_AXIS = "model"


def _specs(multi_pod: bool, seq_parallel: bool = False,
           fsdp_pure: bool = False) -> dict[str, P]:
    b = BATCH if multi_pod else ("data",)
    if fsdp_pure:
        # ZeRO-3: batch over (data x model), no tensor parallelism anywhere.
        # With seq_parallel, the model axis shards the SEQUENCE instead
        # (Ulysses-style): right when global_batch < chips — compute stays
        # fully parallel and attention pays only a KV all-gather.
        bf = (*b, "model")
        act = (P(b, "model", None) if seq_parallel
               else P(bf, None, None))
        return {
            "act_btd": act,
            "act_btd_tp": act,
            "act_bthd": (P(b, "model", None, None) if seq_parallel
                         else P(bf, None, None, None)),
            "logits": (P(b, "model", None) if seq_parallel
                       else P(bf, None, None)),
            "tokens": P(bf, None),
            "moe_tokens": P(bf, None),
            "moe_buffers": P(),
            "moe_logits": P(bf, None),
            "kv_cache": (P(b, "model", None, None) if seq_parallel
                         else P(bf, None, None, None)),
            "mla_cache": (P(b, "model", None) if seq_parallel
                          else P(bf, None, None)),
            "ssm_state": P(bf, None, None, None),
            "conv_cache": P(bf, None, None),
            # stacked KV blocks inside the chunked-attention scan
            # [nk, B, bk, Hkv, D]: keep batch sharding through the
            # reshape/transpose (GSPMD otherwise all-gathers the cache)
            "kv_blocks": P(None, bf, None, None, None),
        }
    return {
        # activations; seq_parallel = sequence-parallel TP (Korthikanti et
        # al.): residual-stream tensors sharded over S on the model axis,
        # turning per-layer all-reduces into reduce-scatter + all-gather
        "act_btd": (P(b, "model", None)
                    if seq_parallel else P(b, None, None)),
        "act_btd_tp": P(b, None, "model"),      # [B, S, d] d sharded (rare)
        "act_bthd": P(b, None, "model", None),  # [B, S, H, dh] heads TP
        "logits": P(b, None, "model"),          # [B, S, V] vocab TP
        "tokens": P(b, None),                   # [B, S]
        # MoE
        "moe_tokens": P((*b, "model"), None),   # [T, d] token-sharded dispatch
        # buffers [G, E, C, d]: claim groups over the batch axes (shard-local
        # counters), experts over model (EP); G=1 falls back to pure EP
        "moe_buffers": P(b, "model", None, None),
        "moe_logits": P((*b, "model"), None),   # [T, E]
        # KV / SSM caches
        "kv_cache": P(b, None, "model", None),  # [B, S, Hkv, dh]
        "mla_cache": P(b, None, None),          # [B, S, lora] replicated feat
        "ssm_state": P(b, "model", None, None), # [B, H, P, N] heads TP
        "conv_cache": P(b, None, "model"),      # [B, K-1, C] channels TP
        # stacked KV blocks in the chunked-attention scan [nk, B, bk, Hkv, D]
        "kv_blocks": P(None, b, None, "model", None),
        # params (FSDP over data; TP over model)
        "p_embed": P("model", None),                 # [V, d] vocab sharded
        "p_col": P("data", "model"),                 # [d, ff] col-parallel
        "p_row": P("model", "data"),                 # [ff, d] row-parallel
        "p_replicated": P(),
        "p_expert_col": P("model", None, "data"),    # [E, d, f]
        "p_expert_row": P("model", "data", None),    # [E, f, d]
        "p_vec": P(None,),
    }


def batch_axes(mesh, fsdp: bool) -> tuple:
    """The mesh axes a batch splits over: ("pod", "data"), and "model" too
    under the fsdp layout, those ``mesh`` has (``params.batch_shardings``,
    the sharded step's rows)."""
    axes = (*BATCH, "model") if fsdp else BATCH
    return tuple(a for a in axes if a in axis_sizes(mesh))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The reference's policy, less ``multi_pod`` (a mesh with a "pod"
    axis is multi-pod).  Under ``seq_parallel`` the sharded step splits
    the rows over ("pod", "data") under both layouts and each row's
    sequence into equal blocks over "model" (``SEQ_AXIS``)."""

    mesh: Any                    # a DeviceMesh with mesh_dim_names
    seq_parallel: bool = False
    fsdp_pure: bool = False
    # decode: KV cache sequence-sharded over model + a flash-decode with a
    # partial-softmax combine (attention.distributed_decode_attention)
    decode_seq_shard: bool = False

    def __post_init__(self):
        if self.seq_parallel and SEQ_AXIS not in axis_sizes(self.mesh):
            raise ValueError(
                f"ShardingPolicy(seq_parallel=True) splits the sequence over "
                f"{SEQ_AXIS!r}: the mesh's axes are "
                f"{tuple(axis_sizes(self.mesh))}")

    def spec(self, name: str) -> Optional[P]:
        return _specs("pod" in axis_sizes(self.mesh), self.seq_parallel,
                      self.fsdp_pure).get(name)

    def batch_axes(self) -> tuple:
        """The mesh axes the sharded step splits a batch's rows over: the
        layout's, but ("pod", "data") alone under ``seq_parallel``, whose
        "model" axis carries the sequence."""
        return batch_axes(self.mesh,
                          self.fsdp_pure and not self.seq_parallel)


# The active policy and (mesh, axes), the mesh axes the rows of the running
# computation are split over (set by the sharded train step).  Process-wide
# settings, not context variables (the reference's policy is one): the
# autograd engine runs a CUDA backward, and with it the recompute of a
# checkpointed layer, on threads of its own, which must see them.
_ACTIVE: dict = {"policy": None, "rows": None, "seq": None}


@contextlib.contextmanager
def _setting(key: str, value):
    before = _ACTIVE[key]
    _ACTIVE[key] = value
    try:
        yield value
    finally:
        _ACTIVE[key] = before


def policy(p: ShardingPolicy):
    """Install ``p`` as the active policy (its mesh's default group must
    be initialized)."""
    require_group("ShardingPolicy")
    return _setting("policy", p)


def active_policy() -> Optional[ShardingPolicy]:
    return _ACTIVE["policy"]


def policy_seq_blocks() -> int:
    """The number of blocks the active policy cuts a sequence into: the
    size of its ``SEQ_AXIS`` under ``seq_parallel``, else 1."""
    pol = _ACTIVE["policy"]
    if pol is None or not pol.seq_parallel:
        return 1
    return axis_sizes(pol.mesh)[SEQ_AXIS]


def rows_split_over(mesh, axes: tuple):
    """Within the block, this rank holds its block of the batch's rows,
    split over the mesh ``axes`` (row-major, the first outermost)."""
    return _setting("rows", (mesh, tuple(axes)))


def row_axes() -> Optional[tuple]:
    """(mesh, axes) of the running sharded computation, or None where
    every rank holds whole rows (no sharded step runs)."""
    return _ACTIVE["rows"]


class SeqSplit(NamedTuple):
    """This rank's block of each row's sequence: positions [offset,
    offset + S_loc) of ``blocks`` equal blocks cut along ``axis`` of
    ``mesh`` in coordinate order."""
    mesh: Any
    axis: str
    offset: int
    blocks: int


def seq_split_over(mesh, axis: str, offset: int, blocks: int):
    """Within the block, this rank holds the block of each of its rows'
    sequences that starts at position ``offset``, of ``blocks`` equal
    blocks along ``axis`` of ``mesh`` (the sharded step under
    ``ShardingPolicy(seq_parallel=True)``)."""
    return _setting("seq", SeqSplit(mesh, axis, offset, blocks))


def seq_split() -> Optional[SeqSplit]:
    """The running computation's block of the sequence, or None where
    every rank holds whole sequences."""
    return _ACTIVE["seq"]


def token_axes() -> Optional[tuple]:
    """(mesh, axes): the mesh axes the running computation's tokens are
    split over, its rows' (:func:`row_axes`) and then its sequence's
    (:func:`seq_split`), or None where every rank holds every token."""
    rows, seq = row_axes(), seq_split()
    if seq is None:
        return rows
    axes = (() if rows is None else rows[1]) + (seq.axis,)
    names = tuple(axis_sizes(seq.mesh))
    return seq.mesh, tuple(sorted(axes, key=names.index))


def mark_block(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mark ``t`` (a tensor of its own, not a view) as this rank's block
    of a tensor cut along ``axis`` of ``mesh`` into equal blocks in
    coordinate order; returns ``t``.  The mark stays with the tensor and
    its views (one layer of a layer-stacked cache), and not with a copy,
    which holds the same values as a tensor of its own."""
    if t._base is not None:
        raise ValueError("mark_block: a view; mark the tensor it is of")
    t.cut_along = (mesh, axis)
    return t


def block_of(t: torch.Tensor) -> Optional[tuple]:
    """(mesh, axis) of the cut whose block ``t``, or the tensor ``t`` is a
    view of, is (:func:`mark_block`); None for a whole tensor."""
    return getattr(t if t._base is None else t._base, "cut_along", None)


# ------------------------------------------------------------ mesh helpers

def require_group(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what}: no torch.distributed process group is initialized "
            f"(call torch.distributed.init_process_group first)")


def axis_sizes(mesh) -> dict:
    """{axis: size} of a DeviceMesh, or the dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def coordinate(mesh) -> dict:
    """{axis: index} of this rank on ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def chunk_index(sizes: dict, coord: dict, axes) -> tuple:
    """(index, count): the row-major index over ``axes`` (first
    outermost) of the rank at ``coord``, and the number of chunks."""
    index, count = 0, 1
    for a in axes:
        index = index * sizes[a] + coord[a]
        count *= sizes[a]
    return index, count


def ranks(mesh) -> list:
    """The global ranks of ``mesh`` in row-major order of its axes."""
    return mesh.mesh.reshape(-1).tolist()


_GROUPS: dict = {}


def group_of(mesh, axes) -> Any:
    """The process group of this rank's line of ``mesh`` along ``axes``
    (the ranks that differ only in those coordinates), made on first use.
    Every rank must ask for the same axes in the same order (a group's
    creation is collective): the port asks only inside the sharded step
    and ``moe_apply_sharded``, which every rank runs alike."""
    require_group("group_of")
    axes = tuple(axes)
    key = (id(mesh), axes)      # the entry keeps the mesh, and its id, alive
    if key in _GROUPS:
        return _GROUPS[key][1]
    names = tuple(mesh.mesh_dim_names)
    if not axes:
        raise ValueError("group_of: no axes")
    if sorted(axes, key=names.index) != list(axes):
        raise ValueError(f"group_of: axes {axes} out of the mesh's order "
                         f"{names}")
    if ranks(mesh) != sorted(ranks(mesh)):
        raise ValueError("group_of: the mesh's ranks must rise in "
                         "row-major order (a group orders its ranks so)")
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    elif sorted(axes) == sorted(names) and len(ranks(mesh)) == \
            dist.get_world_size():
        group = dist.group.WORLD
    else:
        grid = mesh.mesh.permute(
            *[names.index(a) for a in names if a not in axes],
            *[names.index(a) for a in axes])
        lines = grid.reshape(-1, math.prod(grid.shape[len(names)
                                                      - len(axes):]))
        group = dist.new_subgroups_by_enumeration(lines.tolist())[0]
    _GROUPS[key] = (mesh, group)
    return group


# ----------------------------------------------- collectives under autograd

class _MeanOver(torch.autograd.Function):
    """All-reduce mean over ``group``; its backward all-reduces the
    gradient's mean too, so that each rank's share of the mean is
    weighted as in the full mean (the ranks' losses being averaged)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out / ctx.n, None, None


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``x`` over the ranks along ``axes`` of ``mesh``, under
    autograd (every rank gets the mean and, in the backward, the mean of
    the ranks' gradients); ``x`` itself over no axes or one rank."""
    n = math.prod(axis_sizes(mesh)[a] for a in axes)
    if n == 1:
        return x
    return _MeanOver.apply(x, group_of(mesh, axes), n)


class _Gather(torch.autograd.Function):
    """Concatenate every rank's ``x`` along dim 0, in group rank order;
    the backward sums each rank's slice of the gradient over the group
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // ctx.n, *grad.shape[1:]))
        dist.reduce_scatter_tensor(out.view(-1), grad.view(-1),
                                   group=ctx.group)
        return out, None, None


def gather_rows(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along ``axes`` of ``mesh``, concatenated
    along ``dim`` in row-major order of the axes (the inverse of taking
    this rank's :func:`chunk_index` chunk), under autograd: the backward
    hands each rank the sum over the ranks of its block's gradient.  Over
    one rank, ``x`` itself."""
    n = math.prod(axis_sizes(mesh)[a] for a in axes)
    if n == 1:
        return x
    return _Gather.apply(x.movedim(dim, 0), group_of(mesh, axes),
                         n).movedim(0, dim)
