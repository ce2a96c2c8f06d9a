"""The port's training path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks;
params cross over through the bridge.  Tolerances (f32 throughout):

* K11's plain version against the Pallas ``flash_attention_bwd`` in
  interpret mode: atol = rtol = 2e-5 (both recompute the probabilities
  from the same lse; they differ in summation order only);
* ``attention()`` under autograd against autograd of ``naive_attention``:
  atol = rtol = 2e-5 (the same, through the softmax's own backward);
* ``Model.loss`` and every gradient leaf against
  ``jax.value_and_grad(Model.loss)`` (whose attention is autodiff of
  ``chunked_attention``, ROADMAP R1): atol = 1e-5, rtol = 1e-4;
* the optimizer and the train step over 3 steps: atol = 1e-5 on params
  and moments (the summation orders of norms and sums differ).

Data batches, schedule stats and checkpoint bytes must be equal.  Inside
the port, a resumed trainer must equal an uninterrupted one bit for bit.
"""

import dataclasses
import json
import shutil
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_config as jax_config
from repro.core import autotune as jax_autotune
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels.flash_attention.kernel import (flash_attention_bwd as
                                                  pallas_bwd)
from repro.kernels.flash_attention.kernel import (flash_attention_fwd as
                                                  pallas_fwd)
from repro.models import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import autotune
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models.attention import attention, naive_attention
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

KTOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ["qwen2.5-3b", "granite-3-2b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


def _assert_trees_close(port, ref, **tol):
    p, r = _flat(port), _flat(_np(ref))
    assert sorted(p) == sorted(r)
    for key in r:
        np.testing.assert_allclose(p[key].float().numpy(), r[key], **tol,
                                   err_msg=key)


# ---------------------------------------------------------------- (a) K11

@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,bq,bk", [
    (2, 32, 32, 4, 4, 16, True, 8, 16),      # G = 1
    (2, 32, 32, 4, 2, 16, False, 16, 8),     # G = 2, not causal
    (1, 16, 48, 8, 2, 32, True, 8, 16),      # G = 4, Sq < Skv (suffix)
    (2, 24, 40, 8, 2, 16, False, 8, 8),      # G = 4, Sq != Skv, not causal
    (1, 40, 40, 4, 1, 16, True, 8, 8),       # G = 4, MQA
])
def test_bwd_plain_matches_pallas(b, sq, skv, hq, hkv, d, causal, bq, bk):
    rng = np.random.RandomState(sq + skv + hq)
    q = rng.randn(b, sq, hq, d).astype(np.float32)
    k = rng.randn(b, skv, hkv, d).astype(np.float32)
    v = rng.randn(b, skv, hkv, d).astype(np.float32)
    do = rng.randn(b, sq, hq, d).astype(np.float32)
    out, lse = pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, block_q=bq, block_k=bk,
                          interpret=True)
    want = pallas_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                      lse, jnp.asarray(do), causal=causal, block_q=bq,
                      block_k=bk, interpret=True)
    ins = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, do)]
    got = fa.flash_attention_bwd_plain(*ins, causal=causal, block_k=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KTOL)
    # the wrapper takes the plain version for a CPU tensor
    via = fa.flash_attention_bwd(*ins, causal=causal)
    for g, w in zip(via, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KTOL)


def test_bwd_plain_row_that_sees_nothing_contributes_zero():
    """Causal with Sq > Skv: the first queries see no KV row (lse ~
    NEG_INF); their gradients are 0, not NaN."""
    rng = np.random.RandomState(0)
    q, do = (torch.from_numpy(rng.randn(1, 12, 2, 16).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 8, 1, 16).astype(np.float32))
            for _ in range(2))
    out, lse = fa.flash_attention_plain(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    assert torch.all(dq[:, :4] == 0)


# ----------------------------------------------------- (b) attention grads

@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 16, 16, 4, 2, 16, True),
    (1, 8, 24, 4, 1, 16, True),
    (2, 20, 20, 8, 2, 32, False),
    (1, 12, 30, 4, 4, 16, False),
])
def test_attention_grad_matches_naive_autograd(b, sq, skv, hq, hkv, d,
                                               causal):
    rng = np.random.RandomState(b + sq + skv)
    arrays = [rng.randn(*s).astype(np.float32) for s in
              ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    do = torch.from_numpy(rng.randn(b, sq, hq, d).astype(np.float32))
    grads = []
    for fn in (attention, naive_attention):
        ins = [torch.tensor(a, requires_grad=True) for a in arrays]
        fn(*ins, causal=causal).backward(do)
        grads.append([t.grad for t in ins])
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **KTOL)


def test_attention_with_a_cache_has_no_backward():
    q = torch.zeros(1, 2, 2, 16, requires_grad=True)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError, match="backward"):
        attention(q, k, k, kv_len=3, q_offset=1)
    with torch.no_grad():               # inference keeps every branch
        attention(q, k, k, kv_len=3, q_offset=1)


# ------------------------------------------------- (c) loss and gradients

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, port model, port params) for one arch."""
    name = request.param
    jm = JaxModel(jax_config(name).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(name).reduced(), device="cpu")
    return jm, jp, tm, params_from_numpy(_np(jp), device="cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def test_loss_and_gradients_match_jax(pair):
    jm, jp, tm, tp = pair
    batch = {"tokens": _tokens(jm.cfg.vocab_size, (2, 24))}
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    tree = opt.tree_map(lambda t: t.detach().requires_grad_(), tp)
    leaves = _flat(tree)
    loss, met = tm.loss(tree, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]), rtol=1e-5)
    assert met["aux"].item() == 0.0
    want = _flat(_np(jgrads))
    assert sorted(want) == sorted(leaves)
    for key, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[key], **GTOL,
                                   err_msg=key)


def test_loss_chunks_and_remat_policies_agree(pair, monkeypatch):
    """A sequence longer than LOSS_CHUNK (several chunks) gives the same
    loss and gradients with and without remat, full or selective."""
    _, _, tm, tp = pair
    from repro_torch.models import model as model_mod
    monkeypatch.setattr(model_mod, "LOSS_CHUNK", 8)
    batch = {"tokens": _tokens(tm.cfg.vocab_size, (2, 20), seed=3)}
    results = []
    for policy in ("full", "none", "dots"):
        m = Model(dataclasses.replace(tm.cfg, remat_policy=policy),
                  device="cpu")
        tree = opt.tree_map(lambda t: t.detach().requires_grad_(), tp)
        leaves = opt.tree_leaves(tree)
        loss, _ = m.loss(tree, batch)
        results.append((loss, torch.autograd.grad(loss, leaves)))
    for other in results[1:]:
        assert torch.equal(results[0][0], other[0])
        for a, b in zip(results[0][1], other[1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_dots_remat_matches_jax(pair):
    """remat_policy="dots" (the reference's
    ``dots_with_no_batch_dims_saveable``) against ``jax.value_and_grad``
    of the reference model under the same policy."""
    jm, jp, tm, tp = pair
    jdots = JaxModel(dataclasses.replace(jm.cfg, remat_policy="dots"))
    tdots = Model(dataclasses.replace(tm.cfg, remat_policy="dots"),
                  device="cpu")
    batch = {"tokens": _tokens(jm.cfg.vocab_size, (2, 24), seed=1)}
    (jloss, _), jgrads = jax.value_and_grad(jdots.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    tree = opt.tree_map(lambda t: t.detach().requires_grad_(), tp)
    leaves = _flat(tree)
    loss, _ = tdots.loss(tree, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _flat(_np(jgrads))
    assert sorted(want) == sorted(leaves)
    for key, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[key], **GTOL,
                                   err_msg=key)


class _CountProducts(TorchDispatchMode):
    """Counts ``mm`` / ``bmm`` / ``addmm`` calls; with ``keep``, also keeps
    each ``mm`` / ``addmm`` output of a forward pass (grad mode on: not the
    backward's, nor the optimizer's) beside a copy of it."""

    def __init__(self, keep=False):
        super().__init__()
        self.calls = {"mm": 0, "bmm": 0, "addmm": 0}
        self.kept = [] if keep else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.calls:
            self.calls[name] += 1
            if (self.kept is not None and name in ("mm", "addmm")
                    and torch.is_grad_enabled()):
                self.kept.append((out, out.clone()))
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_projection_is_one_mm(dtype):
    """``x @ w`` on a [B, S, d] activation (``layers.dense``) reaches one
    ``aten.mm``, the op "dots" saves, never ``bmm``, which it would
    recompute: forward and backward."""
    from repro_torch.models import layers
    x = torch.randn(2, 5, 16, dtype=dtype, requires_grad=True)
    w = torch.randn(16, 24, dtype=dtype, requires_grad=True)
    with _CountProducts() as fwd:
        y = layers.dense({"w": w}, x)
    with _CountProducts() as bwd:
        y.sum().backward()
    assert fwd.calls == {"mm": 1, "bmm": 0, "addmm": 0}
    assert bwd.calls["bmm"] == 0 and bwd.calls["mm"] == 2


def test_dots_remat_runs_products_once_and_attention_twice(qwen_pair,
                                                           monkeypatch):
    """Per train step (2 microbatches): under "dots" the layers' products
    (``mm``) run as often as under "none" (saved, not recomputed) and
    fewer times than under "full"; the attention forward (K1's plain
    version) runs twice per layer and microbatch, as under "full", and
    its batched products (``bmm``) as often as under "full".  No product
    of the step is written in place afterwards: the saved outputs stay
    what the forward computed."""
    _, _, tm = qwen_pair
    calls = {"fwd": 0}
    real_fwd = fa.flash_attention

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", fwd)
    params0 = tm.init(0)
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, (4, 16)))
    counted = {}
    for policy in ("none", "full", "dots"):
        m = Model(dataclasses.replace(tm.cfg, remat_policy=policy),
                  device="cpu")
        step = make_train_step(m, opt.AdamWConfig(warmup_steps=1),
                               microbatches=2)
        params = opt.tree_map(lambda t: t.detach().clone(), params0)
        calls["fwd"] = 0
        with _CountProducts(keep=policy == "dots") as products:
            step(params, opt.init_state(params, opt.AdamWConfig()),
                 {"tokens": toks})
        counted[policy] = (dict(products.calls), calls["fwd"])
        if products.kept is not None:
            assert products.kept
            for out, copy in products.kept:
                assert torch.equal(out, copy)
    n = tm.cfg.n_layers
    assert counted["none"][1] == n * 2
    assert counted["full"][1] == counted["dots"][1] == 2 * n * 2
    assert counted["dots"][0]["mm"] == counted["none"][0]["mm"]
    assert counted["dots"][0]["mm"] < counted["full"][0]["mm"]
    assert counted["dots"][0]["bmm"] == counted["full"][0]["bmm"]


def test_full_remat_runs_each_layer_forward_twice(pair, monkeypatch):
    """Under full remat the attention forward runs once in the forward
    pass and once in the recompute, per layer; the backward once."""
    _, _, tm, tp = pair
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_attention, fa.flash_attention_bwd

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    step = make_train_step(tm, opt.AdamWConfig(warmup_steps=1),
                           microbatches=2)
    params = opt.tree_map(lambda t: t.detach().clone(), tp)
    step(params, opt.init_state(params, opt.AdamWConfig()),
         {"tokens": torch.from_numpy(_tokens(tm.cfg.vocab_size, (4, 16)))})
    n = tm.cfg.n_layers
    assert calls == {"fwd": 2 * n * 2, "bwd": n * 2}


# ------------------------------------------------------ (d) the optimizer

@pytest.mark.parametrize("master_copy", [False, True])
def test_apply_updates_matches_reference_over_three_steps(master_copy):
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "blk": {"b": rng.randn(5).astype(np.float32),
                      "k": rng.randn(2, 3, 4).astype(np.float32)}}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5,
               master_copy=master_copy)
    jcfg, tcfg = jax_opt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_opt.init_state(jp, jcfg)
    tp = params_from_numpy(params, device="cpu")
    ts = opt.init_state(tp, tcfg)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32) * (step + 1),
            params)
        jp, js, jm = jax_opt.apply_updates(
            jp, jax.tree.map(jnp.asarray, grads), js, jcfg)
        tp, ts, tm = opt.apply_updates(
            tp, params_from_numpy(grads, device="cpu"), ts, tcfg)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        _assert_trees_close(tp, jp, atol=1e-5, rtol=1e-5)
        _assert_trees_close({k: v for k, v in ts.items() if k != "step"},
                            {k: v for k, v in js.items() if k != "step"},
                            atol=1e-5, rtol=1e-5)
        assert int(ts["step"]) == int(js["step"]) == step + 1


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for step in (0, 1, 4, 5, 6, 20, 40, 50):
        np.testing.assert_allclose(
            opt.schedule(step, opt.AdamWConfig(**cfg)),
            float(jax_opt.schedule(jnp.asarray(step, jnp.int32),
                                   jax_opt.AdamWConfig(**cfg))), rtol=1e-6)


# ----------------------------------------------------- (e) the train step

@pytest.fixture(scope="module")
def qwen_pair():
    jm = JaxModel(jax_config("qwen2.5-3b").reduced())
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, jp, Model(get_config("qwen2.5-3b").reduced(), device="cpu")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_over_three_steps(qwen_pair,
                                                       microbatches):
    jm, jp, tm = qwen_pair
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, jax_opt.AdamWConfig(**ocfg),
                                        microbatches=microbatches))
    tstep = make_train_step(tm, opt.AdamWConfig(**ocfg),
                            microbatches=microbatches)
    js = jax_opt.init_state(jp, jax_opt.AdamWConfig(**ocfg))
    tp = params_from_numpy(_np(jp), device="cpu")
    ts = opt.init_state(tp, opt.AdamWConfig(**ocfg))
    for i in range(3):
        toks = _tokens(jm.cfg.vocab_size, (4, 16), seed=10 + i)
        jp, js, jmet = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tmet = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        _assert_trees_close(tp, jp, atol=1e-5, rtol=1e-4)


def test_bf16_grad_compression_matches_reference_direction(qwen_pair):
    """bf16 compression changes the update little (cos > 0.98 against the
    uncompressed step, as the reference's own test holds), and the port's
    compressed step lands where the reference's does."""
    jm, jp0, tm = qwen_pair
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    toks = _tokens(jm.cfg.vocab_size, (4, 16), seed=7)
    jp, _, _ = jax_make_train_step(jm, jax_opt.AdamWConfig(**ocfg),
                                   grad_compression="bf16")(
        jp0, jax_opt.init_state(jp0, jax_opt.AdamWConfig(**ocfg)),
        {"tokens": jnp.asarray(toks)})
    deltas = []
    for comp in (None, "bf16"):
        tp = params_from_numpy(_np(jp0), device="cpu")
        step = make_train_step(tm, opt.AdamWConfig(**ocfg),
                               grad_compression=comp)
        tp, _, _ = step(tp, opt.init_state(tp, opt.AdamWConfig(**ocfg)),
                        {"tokens": torch.from_numpy(toks)})
        if comp:
            _assert_trees_close(tp, jp, atol=1e-5, rtol=1e-4)
        ref = _flat(_np(jp0))
        deltas.append(torch.cat([(v - torch.tensor(ref[k])).flatten()
                                 for k, v in _flat(tp).items()]))
    cos = torch.dot(*deltas) / (deltas[0].norm() * deltas[1].norm())
    assert cos.item() > 0.98


def test_unported_train_options_raise(qwen_pair, tmp_path):
    _, _, tm = qwen_pair
    with pytest.raises(NotImplementedError, match="distributed"):
        make_train_step(tm, opt.AdamWConfig(), grad_shardings={})
    data = DataConfig(vocab_size=256, seq_len=8, global_batch=2)
    with pytest.raises(NotImplementedError, match="autotuner"):
        Trainer(tm, opt.AdamWConfig(), data,
                TrainerConfig(microbatches=None), log_fn=lambda s: None)
    with pytest.raises(NotImplementedError, match="distributed"):
        Trainer(tm, opt.AdamWConfig(), data, TrainerConfig(),
                shardings=({}, {}), log_fn=lambda s: None)
    base = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="autotuner"):
        launch_train.main(base)
    ckpt.save({"w": torch.ones(2)}, tmp_path, 1)
    with pytest.raises(NotImplementedError, match="distributed"):
        ckpt.restore(tmp_path, like={"w": torch.ones(2)}, shardings={})
    with pytest.raises(ValueError, match="remat is for training"):
        tfm.scan_layers(lambda p, x, c: (x, c), {"w": torch.ones(2, 1)},
                        torch.ones(1), {"len": torch.zeros(2)}, remat=True)


# --------------------------------------------------------- (f) the data

@pytest.mark.parametrize("schedule", ["static", "faa", "cost_model"])
def test_synthetic_batches_equal_reference(schedule):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=12, host_threads=3,
              schedule=schedule)
    ours, ref = SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(
        JaxDataConfig(**kw))
    for step in (0, 5):
        a, b = ours.batch(step)["tokens"], ref.batch(step)["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got, want = ours.last_schedule_stats, ref.last_schedule_stats
    assert got.schedule == want.schedule == schedule
    assert int(got.items_per_thread.sum()) == 12
    if schedule == "static":
        for f in want.__dataclass_fields__:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))


def test_data_grain_size_matches_reference():
    for n, t, nbytes in ((1024, 8, 4 * 4096), (16, 2, 128), (4, 4, 4096)):
        assert autotune.data_grain_size(
            n, host_threads=t, bytes_per_example=nbytes) == \
            jax_autotune.data_grain_size(n, host_threads=t,
                                         bytes_per_example=nbytes)


def test_prefetch_iterator_orders_and_bounds_steps():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2,
                     host_threads=2, prefetch=2)
    it = PrefetchIterator(SyntheticLM(cfg), start_step=3)
    steps = [next(it)[0] for _ in range(4)]
    it.close()
    assert steps == [3, 4, 5, 6]
    it = PrefetchIterator(SyntheticLM(cfg), start_step=3, num_steps=4)
    assert [s for s, _ in it] == [3, 4, 5, 6]
    with pytest.raises(StopIteration):
        next(it)
    it.close()


def test_prefetch_iterator_retries_skipped_stragglers():
    """A straggler batch is skipped (the next index is served first), then
    retried and delivered exactly once."""

    class OneSlowStep(SyntheticLM):
        def batch(self, step):
            out = super().batch(step)
            if step == 1 and 1 not in getattr(self, "_slowed", set()):
                self._slowed = {1}
                time.sleep(0.5)
            return out

    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2,
                     host_threads=2, prefetch=4, straggler_timeout_s=0.25)
    it = PrefetchIterator(OneSlowStep(cfg), start_step=0, num_steps=4)
    got = [s for s, _ in it]
    it.close()
    assert it.stragglers == [1]
    assert sorted(got) == [0, 1, 2, 3]
    assert got.index(1) > got.index(2)


# --------------------------------------------------- (g) the checkpoints

def _ckpt_tree(dtype):
    rng = np.random.RandomState(4)
    w = rng.randn(3, 4).astype(np.float32)
    return {"params": {"w": w, "blocks": {"scale": np.ones(5, np.float32)}},
            "opt": {"step": np.asarray(7, np.int32),
                    "m": {"w": rng.randn(3, 4).astype(np.float32)}}}, dtype


def _jax_tree(tree, dtype):
    return jax.tree.map(
        lambda a: jnp.asarray(a, dtype) if a.dtype == np.float32
        else jnp.asarray(a), tree)


def _torch_tree(tree, dtype):
    return jax.tree.map(
        lambda a: torch.from_numpy(a).to(dtype) if a.dtype == np.float32
        else torch.from_numpy(a), tree)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_port_save_is_byte_equal_to_reference_save(tmp_path, name):
    tree, _ = _ckpt_tree(name)
    ref = jax_ckpt.save(_jax_tree(tree, getattr(jnp, name)), tmp_path / "j",
                        3)
    ours = ckpt.save(_torch_tree(tree, getattr(torch, name)), tmp_path / "t",
                     3)
    files = sorted(p.name for p in ref.iterdir())
    assert files == sorted(p.name for p in ours.iterdir())
    assert "MANIFEST.json" in files and "COMMIT" in files
    for f in files:
        assert (ref / f).read_bytes() == (ours / f).read_bytes(), f
    keys = json.loads((ours / "MANIFEST.json").read_text())["keys"]
    assert keys["params/w"]["dtype"] == name
    assert list(keys) == sorted(keys)      # opt/... before params/...


def test_port_restores_reference_bf16_and_fp8_saves(tmp_path):
    rng = np.random.RandomState(6)
    w = rng.randn(4, 6).astype(np.float32)
    jax_ckpt.save({"w": jnp.asarray(w, jnp.bfloat16),
                   "q": jnp.asarray(w, jnp.float8_e4m3fn),
                   "s": jnp.asarray(3, jnp.int32)}, tmp_path, 2)
    like = {"w": torch.zeros(4, 6, dtype=torch.bfloat16),
            "q": torch.zeros(4, 6, dtype=torch.float8_e4m3fn),
            "s": torch.zeros((), dtype=torch.int32)}
    got, step = ckpt.restore(tmp_path, like=like)
    assert step == 2 and got["w"].dtype == torch.bfloat16
    want_w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got["w"].float().numpy(), want_w)
    want_q = np.asarray(jnp.asarray(w, jnp.float8_e4m3fn).astype(
        jnp.float32))
    np.testing.assert_array_equal(got["q"].float().numpy(), want_q)
    assert int(got["s"]) == 3
    # and into another dtype: the bf16 leaf cast to f32
    got32, _ = ckpt.restore(tmp_path, like={"w": torch.zeros(4, 6)})
    np.testing.assert_array_equal(got32["w"].numpy(), want_w)


def test_checkpoint_roundtrip_latest_prune_and_torn(tmp_path):
    tree = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    for s in (1, 2, 3, 4):
        ckpt.save(tree, tmp_path, s)
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "MANIFEST.json").write_text("{}")
    assert ckpt.latest_step(tmp_path) == 4 == jax_ckpt.latest_step(tmp_path)
    ckpt.prune_old(tmp_path, keep=2)
    assert not (tmp_path / "step_00000001").exists()
    assert (tmp_path / "step_00000003").exists()
    like = {"params": {"w": torch.zeros(3, 4)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, step = ckpt.restore(tmp_path, like=like)
    assert step == 4 and torch.equal(got["params"]["w"], tree["params"]["w"])
    assert int(got["opt"]["step"]) == 7


def test_async_saver_snapshots_before_returning(tmp_path):
    w = torch.arange(4.0)
    saver = ckpt.AsyncSaver()
    saver.save({"w": w}, tmp_path, 5)
    w.add_(100.0)                 # the trainer updates in place at once
    saver.wait()
    assert ckpt.latest_step(tmp_path) == 5
    got, _ = ckpt.restore(tmp_path, like={"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4.0))


def test_restore_dtype_cast_and_missing_leaf(tmp_path):
    ckpt.save({"w": torch.arange(8.0)}, tmp_path, 1)
    got, _ = ckpt.restore(tmp_path,
                          like={"w": torch.zeros(8, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path, like={"b": torch.ones(8)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, like={"w": torch.ones(3)})


# -------------------------------------------------------- (h) the trainer

@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("qwen2.5-3b").reduced()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=4, host_threads=2)
    return Model(cfg, device="cpu"), data


def _trainer(tiny, ckpt_dir, total, **kw):
    model, data = tiny
    return Trainer(model, opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=20), data,
                   TrainerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                                 log_every=1, **kw), log_fn=lambda s: None)


def test_trainer_resumed_equals_uninterrupted(tiny, tmp_path):
    full = _trainer(tiny, tmp_path / "a", 6, ckpt_every=3,
                    microbatches=2).run()
    assert full["final_step"] == 6
    assert full["history"][-1][1] < full["history"][0][1]
    first = _trainer(tiny, tmp_path / "b", 3, ckpt_every=3,
                     microbatches=2).run()
    resumed = _trainer(tiny, tmp_path / "b", 6, ckpt_every=3,
                       microbatches=2).run()
    assert resumed["final_step"] == 6
    assert first["history"] + resumed["history"] == full["history"]
    for key, leaf in _flat(full["params"]).items():
        assert torch.equal(leaf, _flat(resumed["params"])[key]), key
    assert torch.equal(full["opt_state"]["v"]["embed"]["table"],
                       resumed["opt_state"]["v"]["embed"]["table"])


def test_trainer_skips_sync_save_when_final_step_committed(
        tiny, tmp_path, monkeypatch):
    saved = []
    real = ckpt.save

    def counting(tree, directory, step):
        saved.append(step)
        return real(tree, directory, step)

    monkeypatch.setattr(ckpt, "save", counting)
    out = _trainer(tiny, tmp_path, 4, ckpt_every=2, keep_ckpts=2).run()
    assert out["final_step"] == 4 and saved == [2, 4]
    assert ckpt.latest_step(tmp_path) == 4


def test_preemption_saves_state(tiny, tmp_path):
    tr = _trainer(tiny, tmp_path, 50, ckpt_every=100)
    tr._preempted = True           # SIGTERM before the loop
    out = tr.run()
    assert out["preempted"] and out["final_step"] == 0
    assert ckpt.latest_step(tmp_path) == 0


def test_trainer_restores_signal_handlers(tiny, tmp_path):
    """SIGTERM/SIGINT preempt the trainer only while it runs: once ``run``
    returns, the handlers it replaced are back."""
    before = {sig: signal.getsignal(sig)
              for sig in (signal.SIGTERM, signal.SIGINT)}
    tr = _trainer(tiny, tmp_path, 50, ckpt_every=100)
    tr._preempted = True
    tr.run()
    assert {sig: signal.getsignal(sig) for sig in before} == before


def test_trainer_in_order_view_reorders_straggler_retries():
    stream = [(0, "b0"), (2, "b2"), (1, "b1"), (3, "b3")]
    assert list(Trainer._in_order(iter(stream), 0)) == [
        (0, "b0"), (1, "b1"), (2, "b2"), (3, "b3")]
    assert list(Trainer._in_order(iter([(6, "x"), (5, "y")]), 5)) == [
        (5, "y"), (6, "x")]


def test_launch_train_cli_resumes_on_cpu(tmp_path):
    """The launcher run again from a copy of its step-2 checkpoint gives
    the uninterrupted run's losses for steps 3 and 4, bit for bit."""
    args = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16", "--microbatches",
            "1", "--ckpt-every", "2", "--log-every", "1"]
    full = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert full["final_step"] == 4 and len(full["history"]) == 4
    assert ckpt.latest_step(tmp_path / "a") == 4
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_00000004")
    rest = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert rest["history"] == full["history"][2:]
