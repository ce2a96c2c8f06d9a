"""Parameter / cache / optimizer-state / batch layouts.

Port of ``repro.distributed.params``: path pattern -> PartitionSpec, with
the reference's two safety transforms applied per leaf (:func:`_fit_spec`):

  * left-pad the spec with None for stacked-layer leading axes ([L, ...]
    from layer stacking, [G, n, ...] from group stacking);
  * prune mesh axes that do not divide the dimension (e.g. kv_heads=8 on
    a 16-way model axis, or batch=1) — pruned dims fall back to
    replication.

The rule tables, :func:`_match` and :func:`_fit_spec` are the
reference's, over a mesh given as {axis: size} (``sharding.axis_sizes``
of a DeviceMesh).  Where the reference returns a ``NamedSharding`` per
leaf, the port returns a :class:`Layout`: the mesh, the fitted spec and
the full shape.  A layout cuts a full tensor into a rank's block
(:meth:`Layout.block`, :meth:`Layout.shard`) and puts the ranks' blocks
back together (:meth:`Layout.gather`).  A dim split over several axes
keeps JAX's row-major order over the axes as listed: ``P(("model",
"data"), None)`` on the fsdp embedding puts "model" outermost, which
DTensor's ``[Shard(0), Shard(0)]`` on a ("data", "model") mesh would not,
so the blocks are cut here by hand.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core.tree import flatten, unflatten
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P

# ordered [(regex over "/"-joined path, spec for the *trailing* dims)]
PARAM_RULES: list[tuple[str, P]] = [
    (r"embed/table$", P("model", "data")),
    (r"head/w$", P("data", "model")),
    (r"router/w$", P()),                 # tiny; shard_map path wants it whole
    (r"(wq|wk|wv|gate|up|in_proj|wq_a|wkv_a|shared_proj)/w$",
     P("data", "model")),
    (r"(wo|down|out_proj)/w$", P("model", "data")),
    (r"(wq_b|wkv_b)/w$", P(None, "model")),
    (r"moe/gate$", P("model", "data", None)),
    (r"moe/up$", P("model", "data", None)),
    (r"moe/down$", P("model", None, "data")),
    (r"conv_w$", P(None, "model")),
    (r"conv_b$", P("model",)),
    (r"(A_log|D|dt_bias)$", P("model",)),
    (r"/b$", P("model",)),              # projection biases (output dim)
    (r"(scale|gate_attn|gate_mlp)$", P()),
]

# pure-FSDP (ZeRO-3) layout: no tensor parallelism — every matmul weight is
# fully sharded over BOTH mesh axes on its input dim and gathered per layer;
# activations are batch-sharded over (data x model).  Removes all per-layer
# activation all-reduces at the cost of weight all-gathers.
PARAM_RULES_FSDP: list[tuple[str, P]] = [
    (r"embed/table$", P(("model", "data"), None)),
    (r"router/w$", P()),
    (r"(head|wq|wk|wv|gate|up|in_proj|wq_a|wkv_a|shared_proj|wq_b|wkv_b)/w$",
     P(("data", "model"), None)),
    (r"(wo|down|out_proj)/w$", P(("data", "model"), None)),
    # experts stay expert-parallel (the shard_map dispatch owns them)
    (r"moe/gate$", P("model", "data", None)),
    (r"moe/up$", P("model", "data", None)),
    (r"moe/down$", P("model", None, "data")),
    (r"conv_w$", P(None, ("data", "model"))),
    (r"conv_b$", P(("data", "model"),)),
    (r"(A_log|D|dt_bias)$", P()),
    (r"/b$", P(("data", "model"),)),
    (r"(scale|gate_attn|gate_mlp)$", P()),
]

RULESETS = {"tp": PARAM_RULES, "fsdp": PARAM_RULES_FSDP}

CACHE_RULES: list[tuple[str, P]] = [
    (r"(^|/)(k|v|ck|cv)$", P(("pod", "data"), None, "model", None)),
    (r"(^|/)(ckv|kr)$", P(("pod", "data"), None, None)),
    (r"(^|/)state$", P(("pod", "data"), "model", None, None)),
    (r"(^|/)conv$", P(("pod", "data"), None, "model")),
    (r"(^|/)len$", P()),
]

_FSDP_B = ("pod", "data", "model")
CACHE_RULES_FSDP: list[tuple[str, P]] = [
    (r"(^|/)(k|v|ck|cv)$", P(_FSDP_B, None, None, None)),
    (r"(^|/)(ckv|kr)$", P(_FSDP_B, None, None)),
    (r"(^|/)state$", P(_FSDP_B, None, None, None)),
    (r"(^|/)conv$", P(_FSDP_B, None, None)),
    (r"(^|/)len$", P()),
]

# sequence-sharded KV for distributed flash-decode (decode_seq_shard)
CACHE_RULES_SEQ: list[tuple[str, P]] = [
    (r"(^|/)(k|v)$", P(("pod", "data"), "model", None, None)),
    (r"(^|/)(ck|cv)$", P(("pod", "data"), None, "model", None)),
    (r"(^|/)(ckv|kr)$", P(("pod", "data"), "model", None)),
    (r"(^|/)state$", P(("pod", "data"), "model", None, None)),
    (r"(^|/)conv$", P(("pod", "data"), None, "model")),
    (r"(^|/)len$", P()),
]


def _match(rules, path: str) -> Optional[P]:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return None


def _fit_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Right-align spec to shape (pad leading Nones), prune non-dividing or
    absent mesh axes."""
    mesh = sharding.axis_sizes(mesh)
    axes = list(spec)
    if len(axes) > len(shape):
        axes = axes[-len(shape):] if len(shape) else []
    axes = [None] * (len(shape) - len(axes)) + axes

    def ok(names, dim):
        total = 1
        for n in names:
            if n not in mesh:
                return False
            total *= mesh[n]
        return dim % total == 0 and total > 1

    fixed = []
    for dim, a in zip(shape, axes):
        if a is None:
            fixed.append(None)
            continue
        names = a if isinstance(a, tuple) else (a,)
        names = tuple(n for n in names if n in mesh)
        # longest dividing prefix (batch 256 on (pod,data,model)=512 ->
        # (pod,data)=32), then single-axis fallback
        while names and not ok(names, dim):
            names = names[:-1]
        if not names:
            orig = a if isinstance(a, tuple) else (a,)
            names = tuple(n for n in orig if ok((n,), dim))[:1]
        if not names:
            fixed.append(None)
        else:
            fixed.append(names if len(names) > 1 else names[0])
    return P(*fixed)


def _names(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


@dataclasses.dataclass(frozen=True)
class Layout:
    """A leaf's layout: the mesh (a DeviceMesh, or {axis: size} where the
    layout is only computed), the fitted spec and the full shape.  The
    rank at mesh coordinate c holds, along each dim split over axes (a1,
    a2, ...), chunk ``(c[a1] * n[a2] + c[a2]) * ...`` of ``n[a1] * n[a2] *
    ...`` equal chunks: the row-major order of JAX's named sharding."""

    mesh: Any
    spec: P
    shape: tuple

    @property
    def sizes(self) -> dict:
        return sharding.axis_sizes(self.mesh)

    @property
    def sharded(self) -> bool:
        """Whether any dim is split (else every rank holds the whole)."""
        return any(e is not None for e in self.spec)

    @property
    def block_shape(self) -> tuple:
        return tuple(dim // math.prod(self.sizes[a] for a in _names(e))
                     for dim, e in zip(self.shape, self.spec))

    @property
    def replicas(self) -> int:
        """How many ranks hold each block."""
        used = {a for e in self.spec for a in _names(e)}
        return math.prod(n for a, n in self.sizes.items() if a not in used)

    def index(self, coord: dict) -> tuple:
        """The slices of the full tensor the rank at ``coord`` holds."""
        out = []
        for dim, e in zip(self.shape, self.spec):
            i, n = sharding.chunk_index(self.sizes, coord, _names(e))
            out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
        return tuple(out)

    def block(self, full: torch.Tensor, coord: dict) -> torch.Tensor:
        """The block of ``full`` the rank at ``coord`` holds (a view)."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"Layout: tensor {tuple(full.shape)} is not "
                             f"the layout's {tuple(self.shape)}")
        return full[self.index(coord)]

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, as a tensor of its own."""
        sharding.require_group("Layout.shard")
        return self.block(full, sharding.coordinate(self.mesh)).clone()

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (this rank's is
        ``block``): one all-gather over the ranks that hold the other
        blocks (:meth:`line`).  An unsplit layout's block is the full
        tensor already, and comes back as is."""
        sharding.require_group("Layout.gather")
        if tuple(block.shape) != self.block_shape:
            raise ValueError(f"Layout.gather: block {tuple(block.shape)}, "
                             f"the layout's {self.block_shape}")
        if not self.sharded:
            return block
        axes, coords = self.line()
        blocks = block.new_empty((len(coords) * block.numel(),))
        dist.all_gather_into_tensor(blocks, block.contiguous().view(-1),
                                    group=sharding.group_of(self.mesh, axes))
        blocks = blocks.view(len(coords), *self.block_shape)
        full = block.new_empty(self.shape)
        for i, coord in enumerate(coords):
            full[self.index(coord)] = blocks[i]
        return full

    def reduce(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sum, over the mesh's ranks, of each
        rank's ``full`` (collective): a reduce-scatter of the blocks over
        the ranks that hold the other blocks (:meth:`line`), then an
        all-reduce (in place) over the ranks that hold the same block."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"Layout.reduce: tensor {tuple(full.shape)}, "
                             f"the layout's {tuple(self.shape)}")
        sharding.require_group("Layout.reduce")
        axes, out = (), full
        if self.sharded:
            axes, coords = self.line()
            stacked = full.new_empty((len(coords), *self.block_shape))
            for i, coord in enumerate(coords):
                stacked[i] = full[self.index(coord)]
            out = full.new_empty(self.block_shape)
            dist.reduce_scatter_tensor(
                out.view(-1), stacked.view(-1),
                group=sharding.group_of(self.mesh, axes))
        rest = tuple(a for a in self.mesh.mesh_dim_names if a not in axes)
        if rest:
            dist.all_reduce(out, group=sharding.group_of(self.mesh, rest))
        return out

    def line(self) -> tuple:
        """(the mesh axes the spec splits over, in the mesh's order; the
        {axis: index} of each block along them, in the rank order of
        ``sharding.group_of`` over those axes: row-major)."""
        used = {a for e in self.spec for a in _names(e)}
        axes = tuple(a for a in self.mesh.mesh_dim_names if a in used)
        return axes, [dict(zip(axes, idx)) for idx in itertools.product(
            *(range(self.sizes[a]) for a in axes))]


def tree_shardings(tree: Any, mesh, rules, *, default: P = P()) -> Any:
    """Map a tree (of tensors, or of anything with a ``shape``) to
    :class:`Layout` leaves via the rule table."""
    return unflatten({
        path: Layout(mesh, _fit_spec(_match(rules, path) or default,
                                     tuple(leaf.shape), mesh),
                     tuple(leaf.shape))
        for path, leaf in flatten(tree).items()})


def param_shardings(abstract_params, mesh, layout: str = "tp"):
    return tree_shardings(abstract_params, mesh, RULESETS[layout])


def cache_shardings(abstract_cache, mesh, layout: str = "tp"):
    rules = {"tp": CACHE_RULES, "fsdp": CACHE_RULES_FSDP,
             "seq": CACHE_RULES_SEQ}[layout]
    return tree_shardings(abstract_cache, mesh, rules)


# dims of one layer's cache leaf, batch first (the rest of a leaf's dims
# are the layer-stack dims in front)
_CACHE_LEAF_DIMS = {"k": 4, "v": 4, "ks": 4, "vs": 4, "ck": 4, "cv": 4,
                    "ckv": 3, "kr": 3, "conv": 3, "state": 4}


def shard_cache(cache: dict, mesh) -> tuple:
    """Cut a whole cache (every rank holds the same) for a
    sequence-sharded decode on ``mesh``: (this rank's blocks, their
    layouts).  The layouts are :func:`cache_shardings`' under
    ``CACHE_RULES_SEQ`` (the K/V positions over "model" where its size
    divides the cache's length, the reference's condition; else every
    rank keeps them whole), except that a per-row ``len`` leaf (one dim
    more than its layer stack, which a sibling leaf shows) is cut along
    its rows as the cache's rows are, so that the rank-local layers read
    their own rows' lengths (the reference's ``len`` is a global array,
    replicated).  Each block cut along "model" carries its cut
    (``sharding.mark_block``), so the layers read from the cache itself
    whether it is a block and at which offset.  :func:`gather_tree` the
    blocks back with the layouts."""
    lays = flatten(cache_shardings(cache, mesh, "seq"))
    leaves = flatten(cache)
    rows = P(("pod", "data"))
    for path, leaf in leaves.items():
        head, _, name = path.rpartition("/")
        if name != "len":
            continue
        stack = {leaves[f"{head}/{k}" if head else k].dim() - n
                 for k, n in _CACHE_LEAF_DIMS.items()
                 if (f"{head}/{k}" if head else k) in leaves}
        if stack and leaf.dim() == min(stack) + 1:
            shape = tuple(leaf.shape)
            lays[path] = Layout(mesh, _fit_spec(rows, shape, mesh), shape)
    blocks = {}
    for path, leaf in leaves.items():
        blocks[path] = lays[path].shard(leaf)
        if any("model" in _names(e) for e in lays[path].spec):
            sharding.mark_block(blocks[path], mesh, "model")
    return unflatten(blocks), unflatten(lays)


def batch_shardings(abstract_batch, mesh, layout: str = "tp"):
    spec = P(sharding.batch_axes(mesh, layout == "fsdp"))
    return unflatten({
        path: Layout(mesh, _fit_spec(spec, tuple(leaf.shape), mesh),
                     tuple(leaf.shape))
        for path, leaf in flatten(abstract_batch).items()})


def shard_tree(tree: dict, layouts: dict) -> dict:
    """This rank's block of every leaf of ``tree`` under ``layouts`` (a
    tree of the same keys)."""
    lay = flatten(layouts)
    return unflatten({k: lay[k].shard(v) for k, v in flatten(tree).items()})


def gather_tree(tree: dict, layouts: dict) -> dict:
    """The full leaves of a tree of blocks under ``layouts`` (collective:
    every rank calls it with its blocks, in the same order)."""
    lay = flatten(layouts)
    return unflatten({k: lay[k].gather(v) for k, v in flatten(tree).items()})
