"""The train step: gradients of ``Model.loss``, microbatch accumulation,
optional bf16 gradient compression, then AdamW; and the prefill and
decode steps (the dry run's serve cells).

Port of ``repro.train.train_step``.  Gradient accumulation microbatching:
the microbatch count is the paper's block-size knob applied to the batch
dimension.  The reference scans over microbatches inside one jitted step;
the port runs a Python loop, accumulating each microbatch's gradients
into f32 tensors shaped like the params.  ``grad_compression="bf16"``
rounds the accumulated gradients to bf16 and back before the optimizer,
as the reference does to halve a data-parallel all-reduce.

The sharded step (``grad_shardings``: a tree of
``distributed.params.Layout``, one per parameter) holds each parameter,
gradient and moment as this rank's block of its layout.  Each rank
gathers every parameter whole once a step, computes the loss of its rows
of each microbatch (split along B over the active policy's batch axes,
``ShardingPolicy.batch_axes``; the tp layout's without a policy), and
reduces each gradient into its block as the sum of every rank's gradient
over the number of ranks.  That averages the ranks that held different
rows; ranks that held the same rows (the model axis under "tp") hold
equal gradients, except inside the expert-parallel layer, where each
holds the part of its own token shard and experts, and the parts add up
to the whole.  Where a model path reduces over the batch (the MoE
balance fractions and z-loss) it does so over the ranks' rows
(``sharding.row_axes``), and a MoE claim group whose tokens lie on
several ranks claims its slots through the FAA ticket
(``models/moe.py``), each rank's expert rows going to their owners and
back.  The clipping norm adds every block once.  Gathering whole
parameters is this design's; a gather per layer is later work.

Under ``ShardingPolicy(seq_parallel=True)`` the rows split over the
policy's batch axes ("pod", "data") and each row's sequence into equal
blocks over "model" (``sharding.seq_split``): a rank holds S/m positions
of its rows.  The targets and the loss mask are made from the whole rows
before the cut (a block's last position predicts the next block's first
token; only a row's last position is masked) and cut with the tokens.
The loss then takes each block's cross-entropy sum over the live count
of its rows' whole sequences, so that the step's average over the ranks
is the unsharded loss and its gradients (``Model.loss``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.distributed import params as params_mod
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.models.model import Model, next_token_targets
from repro_torch.train import optimizer as opt_mod


def make_train_step(
    model: Model,
    opt_cfg: opt_mod.AdamWConfig,
    *,
    microbatches: int = 1,
    grad_compression: Optional[str] = None,   # None | "bf16"
    grad_shardings=None,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``; params and state are updated in place
    (``optimizer.apply_updates``).  ``batch["tokens"]`` is [B, S] with B
    divisible by ``microbatches``; microbatch i is rows [i B/n, (i+1) B/n),
    as the reference's reshape cuts them."""
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    sharded = None if grad_shardings is None else _Sharded(grad_shardings)

    def grads_of(params, batch):
        """The loss, metrics and gradients of ``batch`` (under a sharded
        step: of this rank's rows of it) at the whole ``params``."""
        ctx = contextlib.ExitStack()
        if sharded is not None:
            batch, axes, seq = sharded.rows(batch)
            ctx.enter_context(sharding.rows_split_over(sharded.mesh, axes))
            if seq is not None:
                ctx.enter_context(sharding.seq_split_over(*seq))
        # aliases that require grad: the caller's tensors stay plain
        req = opt_mod.tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad(), ctx:
            loss, metrics = model.loss(req, batch)
            grads = torch.autograd.grad(loss, opt_mod.tree_leaves(req))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def as_tree(params, grads):
        it = iter(grads)          # grads are in tree_leaves(params) order
        return opt_mod.tree_map(lambda _: next(it), params)

    def train_step(params, opt_state, batch):
        full = params if sharded is None else sharded.gather(params)
        if microbatches == 1:
            loss, metrics, grads = grads_of(full, batch)
        else:
            n = microbatches
            b = len(batch["tokens"])
            if b % n:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{n} microbatches")
            rows = b // n
            acc, loss = None, 0.0
            for i in range(n):
                mb = {k: x[i * rows:(i + 1) * rows] for k, x in batch.items()}
                mloss, _, grads = grads_of(full, mb)
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=torch.float32,
                                       device=g.device) for g in grads]
                for a, g in zip(acc, grads):
                    a.add_(g, alpha=1.0 / n)
                del grads
                loss = loss + mloss / n
            grads, metrics = acc, {}
        del full
        layouts = None
        if sharded is not None:
            grads, loss, metrics = sharded.reduce(grads, loss, metrics)
            layouts = sharded.layouts
        if grad_compression == "bf16":
            grads = [g.to(torch.bfloat16).float() for g in grads]
        new_params, new_state, om = opt_mod.apply_updates(
            params, as_tree(params, grads), opt_state, opt_cfg,
            layouts=layouts)
        return new_params, new_state, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """``prefill_step(params, batch) -> (logits, cache)``:
    ``Model.prefill`` into a fresh cache of ``max_len`` positions."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """``decode_step(params, tokens, cache) -> (logits, cache)``:
    ``Model.decode_step``."""
    def decode_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)
    return decode_step


# the [B, S] leaves a sequence-parallel step cuts along S
SEQ_KEYS = ("tokens", "targets", "mask")


class _Sharded:
    """The sharded step's collectives over the mesh of ``layouts``."""

    def __init__(self, layouts):
        sharding.require_group("make_train_step(grad_shardings=...)")
        self.layouts = layouts
        self.leaves = opt_mod.tree_leaves(layouts)
        self.mesh = self.leaves[0].mesh
        if any(lay.mesh is not self.mesh for lay in self.leaves):
            raise ValueError("grad_shardings: every layout must be on one "
                             "mesh")
        self.world = len(sharding.ranks(self.mesh))
        if self.world != torch.distributed.get_world_size():
            raise ValueError("grad_shardings: the mesh must span the world")

    def axes(self) -> tuple:
        """The mesh axes a batch's rows split over: the active policy's
        (it must be on this mesh), else the tp layout's."""
        pol = sharding.active_policy()
        if pol is None:
            return sharding.batch_axes(self.mesh, fsdp=False)
        if pol.mesh is not self.mesh:
            raise ValueError("the active policy's mesh is not the "
                             "grad_shardings' mesh")
        return pol.batch_axes()

    def rows(self, mb: dict) -> tuple:
        """(this rank's part of the microbatch ``mb``, the mesh axes its
        rows split over, its ``sharding.SeqSplit`` or None): every
        leaf [B, ...] cut along B over the active policy's batch axes,
        fitted as ``params._fit_spec`` fits them.
        (``params.batch_shardings`` right-aligns its one-entry spec, as the
        reference's does, and so lays the batch axes on a leaf's last dim:
        a layout GSPMD may compute under, but not a split of the rows.)
        Under ``seq_parallel`` the targets and the loss mask of the whole
        rows join the tokens, and the three [B, S] leaves are also cut
        along S into this rank's block over "model"."""
        coord = sharding.coordinate(self.mesh)
        pol = sharding.active_policy()
        seq = None
        if pol is not None and pol.seq_parallel:
            targets, mask = next_token_targets(mb["tokens"])
            mb = dict(mb, targets=targets, mask=mask)
            s, m = mb["tokens"].shape[1], sharding.policy_seq_blocks()
            if s % m:
                raise ValueError(
                    f"sequence-parallel step: a sequence of {s} positions "
                    f"does not split into the {m} blocks of the "
                    f"{sharding.SEQ_AXIS!r} axis")
            seq = sharding.SeqSplit(self.mesh, sharding.SEQ_AXIS,
                                    coord[sharding.SEQ_AXIS] * (s // m), m)
        out, axes = {}, set()
        for key, x in mb.items():
            spec = params_mod._fit_spec(
                P(self.axes(), *[None] * (x.dim() - 1)), tuple(x.shape),
                self.mesh)
            out[key] = params_mod.Layout(self.mesh, spec,
                                         tuple(x.shape)).block(x, coord)
            if seq is not None and key in SEQ_KEYS:
                out[key] = out[key][:, seq.offset:seq.offset + s // m]
            axes.add(params_mod._names(spec[0]))
        if len(axes) != 1:
            raise ValueError(f"the batch's leaves split over different "
                             f"axes {sorted(axes)}")
        return out, axes.pop(), seq

    def gather(self, params):
        return params_mod.gather_tree(params, self.layouts)

    def reduce(self, grads, loss, metrics):
        """Each gradient's block (sum over the ranks / their number), the
        loss and metrics averaged over the ranks."""
        out = []
        for i, lay in enumerate(self.leaves):
            out.append(lay.reduce(grads[i]).div_(self.world))
            grads[i] = None       # the full gradient goes now
        stats = torch.stack([torch.as_tensor(loss, dtype=torch.float32,
                                             device=out[0].device)]
                            + [v.float() for v in metrics.values()])
        torch.distributed.all_reduce(stats)
        stats = stats / self.world
        return out, stats[0], dict(zip(metrics, stats[1:]))
