"""The train step: gradients of ``Model.loss``, microbatch accumulation,
optional bf16 gradient compression, then AdamW.

Port of ``repro.train.train_step``.  Gradient accumulation microbatching:
the microbatch count is the paper's block-size knob applied to the batch
dimension.  The reference scans over microbatches inside one jitted step;
the port runs a Python loop, accumulating each microbatch's gradients
into f32 tensors shaped like the params.  ``grad_compression="bf16"``
rounds the accumulated gradients to bf16 and back before the optimizer,
as the reference does to halve a data-parallel all-reduce.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.model import Model
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
    if grad_shardings is not None:
        raise NotImplementedError(
            "make_train_step(grad_shardings=...): no sharded gradients in "
            "the port yet (ROADMAP: distributed and launch)")
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    def grads_of(params, batch):
        # aliases that require grad: the caller's tensors stay plain
        req = opt_mod.tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = model.loss(req, batch)
            grads = torch.autograd.grad(loss, opt_mod.tree_leaves(req))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def as_tree(params, grads):
        it = iter(grads)          # grads are in tree_leaves(params) order
        return opt_mod.tree_map(lambda _: next(it), params)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
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
                mloss, _, grads = grads_of(params, mb)
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=torch.float32,
                                       device=g.device) for g in grads]
                for a, g in zip(acc, grads):
                    a.add_(g, alpha=1.0 / n)
                del grads
                loss = loss + mloss / n
            grads, metrics = acc, {}
        if grad_compression == "bf16":
            grads = [g.to(torch.bfloat16).float() for g in grads]
        new_params, new_state, om = opt_mod.apply_updates(
            params, as_tree(params, grads), opt_state, opt_cfg)
        return new_params, new_state, {"loss": loss, **metrics, **om}

    return train_step
