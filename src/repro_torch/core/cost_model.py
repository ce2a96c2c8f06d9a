"""The paper's cost model: prediction in numpy, training in torch.

Analytic model (paper, Problem statement)::

    Cost(T, N, L) = N/B * L + O(N)/T

Learned model (paper, Cost model and improvements)::

    B = (alpha*G + delta0) / (beta0*T + beta1*R + beta2*W + beta3*C + delta1)

with the published trained weights (on normalized inputs)::

    B = (1558.31 - 61.84*G) / (693.13 - 10.48*T - 33.71*R - 34.50*W - 26.84*C)

Normalization (paper): G is multiplied by 100; unit read/write are replaced by
``n`` such that ``2^n = unit``; unit computation by ``p`` such that
``unit = 2^(10p)`` (i.e. log base 1024).

Prediction runs in float32, as the reference does.  The speculation
half (``expected_accept_span``, ``speculative_token_cost``,
``best_draft_span``: the draft span read as the block size) is here too.

Training (``train_cost_model``) is the reference's full-batch Adam, step
for step in the reference's order of operations, with gradients from
``torch.autograd``; the random restarts are a leading [R] axis of every
parameter (the reference's ``vmap``), drawn from JAX's key stream
(:mod:`repro_torch.core.prng`) so that they start where the reference's
start.  The fit runs on the card unless the caller asks for the CPU.  A
fit is held to the reference by its loss and its predictions, never by
its raw parameters: numerator and denominator of the rational form can
scale together.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core import prng


# --------------------------------------------------------------------------
# Features & normalization
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadFeatures:
    """Raw (un-normalized) inputs of the cost model."""

    core_groups: int
    threads: int
    unit_read: int
    unit_write: int
    unit_comp: int

    def normalized(self) -> np.ndarray:
        """Paper's normalization -> [G*100, T, log2 R, log2 W, log1024 C]."""
        return np.array(
            [
                100.0 * self.core_groups,
                float(self.threads),
                np.log2(max(2.0, float(self.unit_read))),
                np.log2(max(2.0, float(self.unit_write))),
                np.log2(max(2.0, float(self.unit_comp))) / 10.0,
            ],
            dtype=np.float32,
        )

    def normalized_ext(self, faa_latency: float,
                       bw_bytes_per_clock: float) -> np.ndarray:
        """The paper's future-work features appended: cross-group FAA
        latency (log2 clocks) and platform DRAM bandwidth (log2 B/clk)."""
        return np.concatenate([
            self.normalized(),
            np.array([np.log2(max(2.0, faa_latency)),
                      np.log2(max(2.0, bw_bytes_per_clock))], np.float32),
        ])


def normalize_batch(feats: Iterable[WorkloadFeatures]) -> np.ndarray:
    return np.stack([f.normalized() for f in feats])


# --------------------------------------------------------------------------
# Rational model  B = (a*G + d0) / (b . [T,R,W,C] + d1)
# --------------------------------------------------------------------------

_LEAVES = ("alpha", "delta0", "beta", "delta1")


def init_params(key: Optional[prng.Key] = None,
                n_cost_features: int = 4) -> dict:
    """Matches the paper's two nn.Linear layers: power: 1->1, cost: n->1.

    The reference's draws from ``key`` (a :mod:`repro_torch.core.prng`
    key, of any batch shape: each leaf then leads with it), its key reuse
    included (``k2`` both splits and draws ``beta``).  Returns float32
    tensors on the key's device.  n_cost_features > 4 enables the paper's
    stated FUTURE WORK: "CPU frequency and cache latency parameters" as
    extra denominator features (see WorkloadFeatures.normalized_ext)."""
    key = key if key is not None else prng.prng_key(0)
    k1, k2 = prng.unstack(prng.split(key))
    k3, k4 = prng.unstack(prng.split(k2))
    return {
        "alpha": 0.5 * prng.normal(k1, (1,)),
        "delta0": 10.0 + 20.0 * prng.normal(k3, (1,)),
        "beta": 0.5 * prng.normal(k2, (n_cost_features,)),
        "delta1": 10.0 + 20.0 * prng.normal(k4, (1,)),
    }


# Published trained weights (paper, end of "Cost model and improvements").
PAPER_WEIGHTS = {
    "alpha": np.array([-61.84], np.float32),
    "delta0": np.array([1558.31], np.float32),
    "beta": np.array([-10.48, -33.71, -34.50, -26.84], np.float32),
    "delta1": np.array([693.13], np.float32),
}


def predict(params: dict, x: np.ndarray) -> np.ndarray:
    """x: [batch, 5] normalized features -> predicted block size [batch]."""
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    x = np.asarray(x, np.float32)
    power = p["alpha"][0] * x[:, 0] + p["delta0"][0]
    cost = x[:, 1:] @ p["beta"] + p["delta1"][0]
    return power / cost


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Paper's loss: sum of squared error over the dataset, in torch.
    ``params`` leaves may lead with a restart axis [R]; the loss then has
    shape [R]."""
    power = params["alpha"] * x[:, 0] + params["delta0"]
    cost = params["beta"] @ x[:, 1:].T + params["delta1"]
    return torch.sum((power / cost - y) ** 2, dim=-1)


def _train(params: dict, x: torch.Tensor, y: torch.Tensor, steps: int,
           lr: float) -> tuple[dict, torch.Tensor]:
    """Full-batch Adam, the reference's inline step (b1 0.9, b2 0.999, eps
    1e-8; ``t = i + 1`` in float32; ``mh = m / (1 - b1**t)``, ``vh = v /
    (1 - b2**t)``, ``p - lr * mh / (sqrt(vh) + eps)``) on float32 tensors
    on x's device.  Leaves may lead with a restart axis [R], each restart
    its own fit.  Returns (params, losses [steps], or [R, steps]: the loss
    before each step).

    The leaves live as views of one packed tensor, so that a step is one
    Adam update, not one per leaf: the update is elementwise, so the
    packing changes no value.  The bias corrections are float32 tensors on
    the device (a division by a host scalar is a multiplication by its
    reciprocal on the card, which rounds differently)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    dev = x.device
    leaves = [torch.as_tensor(params[k], dtype=torch.float32, device=dev)
              for k in _LEAVES]
    widths = [t.shape[-1] for t in leaves]
    p = torch.cat(leaves, dim=-1)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    t = np.arange(1, steps + 1, dtype=np.float32)
    c1 = torch.from_numpy(1 - np.float32(b1) ** t).to(dev)
    c2 = torch.from_numpy(1 - np.float32(b2) ** t).to(dev)
    losses = torch.empty((steps,) + p.shape[:-1], dtype=torch.float32,
                         device=dev)
    ones = torch.ones(p.shape[:-1], dtype=torch.float32, device=dev)
    for i in range(steps):
        views = [w.requires_grad_() for w in p.split(widths, dim=-1)]
        loss = loss_fn(dict(zip(_LEAVES, views)), x, y)
        g = torch.cat(torch.autograd.grad(loss, views, grad_outputs=ones),
                      dim=-1)
        losses[i] = loss.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / c1[i]
        vh = v / c2[i]
        p = p - lr * mh / (torch.sqrt(vh) + eps)
    return (dict(zip(_LEAVES, p.split(widths, dim=-1))),
            losses.movedim(0, -1))


def lstsq_init(x: np.ndarray, y: np.ndarray) -> dict:
    """Closed-form initializer.

    The model is linear in its parameters up to scale:
    ``alpha*G + delta0 - B*(beta.x + delta1) = 0`` for a perfect fit, a
    homogeneous system M theta = 0 with
    ``theta = [alpha, delta0, beta0..3, delta1]``.  The smallest right
    singular vector of M is the best fit in that algebraic sense; Adam then
    polishes the true MSE.  (The paper burned 30 h of M4000 time instead.)
    Returns float32 numpy arrays.
    """
    g, rest = x[:, :1], x[:, 1:]
    b = y[:, None]
    m = np.concatenate([g, np.ones_like(g), -b * rest, -b], axis=1)
    # normalize rows to balance scales
    m = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-9)
    _, _, vt = np.linalg.svd(m, full_matrices=False)
    theta = vt[-1]
    # fix scale/sign so predictions are positive on the data
    pred_num = theta[0] * x[:, 0] + theta[1]
    pred_den = x[:, 1:] @ theta[2:6] + theta[6]
    pred = pred_num / np.where(np.abs(pred_den) < 1e-9, 1e-9, pred_den)
    if np.mean(pred) < 0:
        theta = -theta
    return {
        "alpha": np.asarray(theta[0:1], np.float32),
        "delta0": np.asarray(theta[1:2], np.float32),
        "beta": np.asarray(theta[2:6], np.float32),
        "delta1": np.asarray(theta[6:7], np.float32),
    }


def _fit_device(device) -> torch.device:
    # the fit runs on the card unless the caller asks for the CPU
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train_cost_model runs on the card by default and this machine "
            "has no CUDA device: pass device='cpu' to fit on the CPU")
    return dev


def _numpy(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def train_cost_model(
    x: np.ndarray,
    y: np.ndarray,
    *,
    steps: int = 30_000,
    lr: float = 0.01,
    seed: int = 0,
    init: str = "multistart",
    restarts: int = 16,
    device=None,
) -> tuple[dict, np.ndarray]:
    """Fit the rational model; returns (params as float32 numpy arrays,
    loss curve as a numpy array).

    The rational form is non-convex (the denominator may cross zero), so the
    default strategy trains `restarts` random inits in parallel (a leading
    restart axis) and keeps the best — converges in seconds where the paper
    spent 30 h on a Quadro M4000.  ``init="lstsq"`` starts one fit from
    :func:`lstsq_init`, rescaled so that |delta1| = 100; any other value one
    fit from ``init_params(PRNGKey(seed))``.  Runs on ``device``, the card
    by default.
    """
    dev = _fit_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    if init == "lstsq":
        params = lstsq_init(np.asarray(x), np.asarray(y))
        scale = 100.0 / max(float(np.abs(params["delta1"])[0]), 1e-6)
        params = {k: v * np.float32(scale) for k, v in params.items()}
        params, losses = _train(params, xt, yt, steps, lr)
        return _numpy(params), losses.cpu().numpy()
    if init == "multistart":
        nfeat = int(x.shape[1]) - 1
        keys = prng.split(prng.prng_key(seed), restarts)
        all_params, all_losses = _train(init_params(keys, nfeat), xt, yt,
                                        steps, lr)
        final = all_losses[:, -1]
        final = torch.where(torch.isfinite(final), final, torch.inf)
        best = int(torch.argmin(final))
        return ({k: v[best].detach().cpu().numpy()
                 for k, v in all_params.items()},
                all_losses[best].cpu().numpy())
    params, losses = _train(init_params(prng.prng_key(seed)), xt, yt, steps,
                            lr)
    return _numpy(params), losses.cpu().numpy()


# --------------------------------------------------------------------------
# Paper's published example training rows (normalized) — fixture for tests
# and benchmarks.  Columns: G, T, R, W, C, B.
# --------------------------------------------------------------------------

PAPER_TRAINING_ROWS = np.array(
    [
        [100, 2, 10, 10, 1, 128],
        [100, 2, 10, 10, 2, 64],
        [100, 2, 10, 10, 3, 32],
        [100, 2, 10, 10, 4, 16],
        [100, 2, 10, 10, 5, 8],
        [100, 2, 10, 10, 6, 4],
    ],
    dtype=np.float32,
)

# The paper's inference-examples table (G,T,R,W,C,B_true,B_inferred).
PAPER_INFERENCE_ROWS = np.array(
    [
        [100, 2, 10, 10, 1, 128, 125],
        [100, 2, 10, 10, 3, 64, 51],
        [100, 2, 10, 10, 4, 32, 39],
        [100, 2, 10, 10, 6, 16, 27],
        [100, 8, 10, 10, 2, 32, 36],
        [100, 8, 10, 10, 3, 32, 30],
        [100, 8, 10, 10, 5, 16, 22],
        [100, 4, 6, 10, 6, 64, 80],
        [100, 4, 8, 10, 6, 32, 37],
        [100, 4, 12, 10, 6, 16, 17],
        [100, 4, 16, 10, 6, 16, 11],
        [100, 8, 8, 10, 6, 16, 27],
        [100, 8, 10, 10, 6, 16, 19],
        [100, 8, 16, 10, 6, 4, 10],
        [200, 8, 10, 10, 1, 128, 108],
        [200, 8, 10, 10, 2, 64, 85],
        [200, 8, 10, 6, 6, 64, 112],
        [200, 8, 10, 8, 6, 64, 65],
        [200, 8, 10, 10, 6, 64, 46],
        [200, 8, 10, 14, 6, 32, 29],
        [200, 8, 10, 16, 6, 16, 24],
        [400, 16, 6, 10, 6, 128, 126],
        [400, 16, 8, 10, 6, 128, 92],
        [800, 32, 6, 10, 6, 128, 136],
        [800, 32, 10, 10, 6, 64, 98],
        [800, 32, 16, 10, 6, 64, 69],
    ],
    dtype=np.float32,
)


def paper_normalized_features(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a (G,T,R,W,C,B[,*]) table into (x [n,5], y [n])."""
    return rows[:, :5].astype(np.float32), rows[:, 5].astype(np.float32)


# --------------------------------------------------------------------------
# Analytic model & block-size suggestion API
# --------------------------------------------------------------------------

def analytic_cost(
    n: int, block_size: float, faa_cost: float, per_item_cost: float,
    threads: int, quota: float = 0.0, *, groups: int = 1,
    faa_remote_cost: float = 0.0,
) -> float:
    """Paper's Cost(T,N,L) = N/B * L + O(N)/T, plus the imbalance term the
    paper observes empirically (quota-jitter tail ~ one block per thread).

    ``groups``/``faa_remote_cost`` extend L with the cross-core-group line
    transfer (Schweizer et al.): with T threads spread over G groups, a
    claim on the flat shared counter finds the line in a foreign group with
    probability (G-1)/G and pays ``faa_remote_cost`` extra clocks on top of
    the local ``faa_cost``.  Defaults (G=1, remote=0) reproduce the paper's
    published single-term model exactly."""
    b = max(1.0, float(block_size))
    p_remote = (groups - 1.0) / groups if groups > 1 else 0.0
    sync = (n / b) * (faa_cost + p_remote * faa_remote_cost)
    work = n * per_item_cost / threads
    imbalance = quota * b * per_item_cost  # tail: last block finishes late
    return sync + work + imbalance


def analytic_hierarchical_cost(
    n: int, block_size: float, faa_cost: float, per_item_cost: float,
    threads: int, quota: float = 0.0, *, groups: int = 1,
    faa_remote_cost: float = 0.0, fanout: int = 8,
) -> float:
    """Cost of the two-level ``hierarchical`` policy under the same model.

    Every claim still pays a (group-local) ``faa_cost``, but only one in
    ``fanout`` touches the shared counter and risks the cross-group
    transfer; the price is a coarser shared granularity, so the jitter tail
    scales with the super-block (``fanout * B``) instead of B.  Comparing
    this against :func:`analytic_cost` at equal B is how the model ranks
    ``hierarchical`` vs flat ``faa`` (see :func:`rank_schedules`)."""
    b = max(1.0, float(block_size))
    p_remote = (groups - 1.0) / groups if groups > 1 else 0.0
    local = (n / b) * faa_cost
    shared = (n / (b * fanout)) * p_remote * faa_remote_cost
    work = n * per_item_cost / threads
    imbalance = quota * b * fanout * per_item_cost
    return local + shared + work + imbalance


def rank_schedules(
    n: int, block_size: float, faa_cost: float, per_item_cost: float,
    threads: int, *, groups: int = 1, faa_remote_cost: float = 0.0,
    quota: float = 0.35, fanout: int = 8,
) -> list:
    """[(policy, predicted_clocks)] sorted cheapest-first for the flat-FAA
    family the analytic model covers: ``faa``, ``hierarchical``, ``static``.

    ``static`` pays no sync but eats the full quota-jitter tail of its
    N/T-sized ranges; ``faa`` pays a (possibly remote) FAA per block;
    ``hierarchical`` trades shared-line traffic for a coarser tail.  On
    multi-group topologies with expensive remote transfers the ranking
    flips toward ``hierarchical`` — the paper's motivating regime."""
    costs = {
        "faa": analytic_cost(
            n, block_size, faa_cost, per_item_cost, threads, quota,
            groups=groups, faa_remote_cost=faa_remote_cost),
        "hierarchical": analytic_hierarchical_cost(
            n, block_size, faa_cost, per_item_cost, threads, quota,
            groups=groups, faa_remote_cost=faa_remote_cost, fanout=fanout),
        "static": analytic_cost(
            n, max(1.0, n / max(1, threads)), 0.0, per_item_cost, threads,
            quota),
    }
    return sorted(costs.items(), key=lambda kv: kv[1])


def analytic_best_block(
    n: int, faa_cost: float, per_item_cost: float, threads: int,
    quota: float = 0.35,
) -> int:
    """argmin_B of analytic_cost — closed form sqrt(N*L/(quota*c))."""
    b = np.sqrt(n * faa_cost / max(quota * per_item_cost, 1e-12))
    return int(np.clip(b, 1, max(1, n // max(1, threads))))


# --------------------------------------------------------------- speculation
# Speculative decoding is the serving-side instance of the paper's grain
# trade: one verification amortizes the per-token claim/admission
# bookkeeping (the FAA term) over a whole accepted span, and the draft
# span k is the block size B.  With per-draft-token acceptance
# probability a and longest-matching-prefix greedy acceptance, the span
# emitted per verify is 1 + (number of leading matches), so
# E[tokens/verify] = sum_{j=0..k} a^j.


def expected_accept_span(k: int, acceptance: float) -> float:
    """E[tokens emitted per verify] at draft span ``k``: geometric
    longest-prefix acceptance, sum_{j=0..k} a^j = (1-a^(k+1))/(1-a)."""
    if k < 0:
        raise ValueError(f"draft span must be >= 0, got {k}")
    a = min(max(float(acceptance), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def speculative_token_cost(
    k: int, acceptance: float, *, draft_cost: float, verify_cost: float,
    sync_cost: float = 0.0,
) -> float:
    """Expected cost per *emitted* token at draft span ``k``: ``k``
    drafter steps, one verify and the per-tick host bookkeeping
    (``sync_cost``: acceptance scan, length rollback — the FAA analogue)
    over ``expected_accept_span(k, a)`` tokens.  ``k = 0`` is the
    non-speculative baseline."""
    e = expected_accept_span(k, acceptance)
    return (k * draft_cost + verify_cost + sync_cost) / e


def best_draft_span(
    acceptance: float, *, draft_cost: float, verify_cost: float,
    sync_cost: float = 0.0, max_k: int = 8,
) -> int:
    """argmin_k of :func:`speculative_token_cost` over 0..max_k — the
    grain-size choice, mirroring :func:`analytic_best_block`."""
    costs = [speculative_token_cost(k, acceptance, draft_cost=draft_cost,
                                    verify_cost=verify_cost,
                                    sync_cost=sync_cost)
             for k in range(max_k + 1)]
    return int(np.argmin(costs))


_DEFAULT_PARAMS: Optional[dict] = None


def default_params() -> dict:
    """Paper's published weights (the faithful default; retrained weights can
    be installed via set_default_params)."""
    global _DEFAULT_PARAMS
    return _DEFAULT_PARAMS if _DEFAULT_PARAMS is not None else PAPER_WEIGHTS


def set_default_params(params: dict) -> None:
    global _DEFAULT_PARAMS
    _DEFAULT_PARAMS = params


def suggest_block_size(
    feats: WorkloadFeatures, *, n: Optional[int] = None,
    params: Optional[dict] = None,
) -> int:
    """Predict the block size for a workload; clamps to [1, n]."""
    p = params or default_params()
    b = float(predict(p, feats.normalized()[None, :])[0])
    if not np.isfinite(b) or b < 1:
        b = 1
    if n is not None:
        b = min(b, n)
        # the paper's own empirical bound: B* sits below N/T — never let the
        # regressor starve parallelism
        b = min(b, max(1.0, n / (2 * max(feats.threads, 1))))
    return max(1, int(round(b)))
