"""AdamW + cosine schedule + global-norm clipping, from scratch.

Port of ``repro.train.optimizer``.  Moments are f32 whatever the params'
dtype, with an optional f32 master copy.  The state is a plain dict of
tensors ({"step", "m", "v"[, "master"]}) so the checkpoint layer saves it
beside the params in the reference's format.

Unlike the reference's pure functions, :func:`apply_updates` works IN
PLACE: it scales the gradients, updates ``m``, ``v`` (and ``master``) and
writes the new params into the tensors it was given, and returns those
same tensors.  At full width a functional update would hold a second copy
of params, moments and gradients (tens of GB on one card).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_copy: bool = False   # f32 master params (else update in-dtype)


def tree_map(fn, *trees) -> dict:
    """``fn`` over the leaves of nested dicts of one structure, keys in
    sorted order (as ``jax.tree.map`` walks them)."""
    first = trees[0]
    return {k: tree_map(fn, *(t[k] for t in trees))
            if isinstance(first[k], dict) else fn(*(t[k] for t in trees))
            for k in sorted(first)}


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in :func:`tree_map`'s order."""
    return [x for k in sorted(tree) for x in
            (tree_leaves(tree[k]) if isinstance(tree[k], dict)
             else [tree[k]])]


def init_state(params, cfg: AdamWConfig) -> dict:
    device = tree_leaves(params)[0].device
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
    }
    if cfg.master_copy:
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def schedule(step: int, cfg: AdamWConfig) -> float:
    """The learning rate at ``step`` (1-based): linear warmup, then a
    cosine decay to ``min_lr_frac * lr``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient leaf in place so that their global L2 norm is
    at most ``max_norm``; returns (grads, the norm before scaling as an
    f32 scalar tensor)."""
    leaves = tree_leaves(grads)
    gnorm = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in leaves]).square().sum().sqrt()
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place (see the module docstring): ``grads`` are
    clipped, ``state`` and ``params`` updated.  Weight decay skips leaves
    with ``ndim < 2`` (norms, biases).  Returns (params, state, {"lr",
    "grad_norm"})."""
    _, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"].add_(1)
    step = int(state["step"])
    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    base = state.get("master", params)
    for p, b, g, m, v in zip(*map(tree_leaves, (params, base, grads,
                                                state["m"], state["v"]))):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        p32 = b if b.dtype == torch.float32 else b.float()
        if p.ndim >= 2:
            delta.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(delta, alpha=lr)     # in place when ``b`` is f32 already
        if p32 is not p:
            p.copy_(p32)
    return params, state, {"lr": lr, "grad_norm": gnorm}
