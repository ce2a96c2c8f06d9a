"""Training the MoE/MLA family (deepseek-v2-lite-16b) in the port, against
the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks;
params cross over through ``params_from_numpy``.  Tolerances, f32
throughout:

* ``grouped_matmul_bwd_plain`` (K17's plain version) against ``jax.vjp``
  of the reference's expert einsum ``gecd,edf->gecf`` with the group axis
  folded into the capacity rows, as the port lays its buffers out: 1e-5;
* ``GroupedMatmulFunction`` on CPU tensors is autograd of
  ``grouped_matmul_plain``, bit for bit;
* ``flash_attention_bwd_plain`` (K11's plain version) at MLA's Dk != Dv
  pairs against ``jax.vjp`` of the reference's ``chunked_attention`` (the
  ``ref.py`` oracle is square-only): 2e-5;
* ``Model.loss`` (rtol 1e-5), its ``aux`` and every gradient leaf
  (``GTOL``: atol 1e-5, rtol 1e-4) against
  ``jax.value_and_grad(Model.loss)``, under both remat policies, with one
  dispatch group and with two, at the default capacity and at one small
  enough to drop choices (the dropped rows' zero gradients held too);
* three ``make_train_step`` steps: loss rtol 1e-5, grad norm rtol 1e-4,
  params ``STEP_TOL`` (atol 1e-4, a tenth of the lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models.attention import chunked_attention as jax_chunked
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.moe_gmm import ops as mg
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models import moe
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
GTOL = dict(atol=1e-5, rtol=1e-4)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
KTOL = dict(atol=2e-5, rtol=2e-5)
# (dispatch groups, capacity factor): one global claim counter per expert
# at the default factor, and two token groups at a factor that drops
DISPATCH = {"global": (0, 1.25), "groups_drop": (2, 0.5)}


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


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ------------------------------------------------------------ K17

@pytest.mark.parametrize("g,e,c,d,f", [
    (1, 4, 8, 16, 24),      # the reduced widths' ratio, one group
    (2, 3, 8, 12, 20),      # two dispatch groups folded into the rows
    (3, 2, 5, 7, 9),        # ragged everything
])
def test_grouped_matmul_bwd_plain_matches_jax_vjp(g, e, c, d, f):
    rng = np.random.RandomState(g + e + c)
    buf, w = _rand(rng, g, e, c, d), _rand(rng, e, d, f)
    dout = _rand(rng, g, e, c, f)
    _, vjp = jax.vjp(lambda b, ww: jnp.einsum("gecd,edf->gecf", b, ww),
                     jnp.asarray(buf), jnp.asarray(w))
    want_dbuf, want_dw = vjp(jnp.asarray(dout))
    fold = lambda t: torch.from_numpy(
        np.ascontiguousarray(t.transpose(1, 0, 2, 3)).reshape(
            e, g * c, t.shape[-1]))
    dx, dw = mg.grouped_matmul_bwd_plain(fold(buf), torch.from_numpy(w),
                                         fold(dout))
    got_dbuf = dx.numpy().reshape(e, g, c, d).transpose(1, 0, 2, 3)
    np.testing.assert_allclose(got_dbuf, np.asarray(want_dbuf), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=1e-5,
                               rtol=1e-5)


def test_grouped_matmul_function_on_cpu_is_autograd_of_plain():
    """On CPU tensors the Function runs K14's and K17's plain versions:
    its output and gradients equal autograd of ``grouped_matmul_plain``,
    and ``grouped_matmul_bwd`` (K17's wrapper) gives the same."""
    rng = np.random.RandomState(5)
    x, w = torch.from_numpy(_rand(rng, 3, 10, 12)), torch.from_numpy(
        _rand(rng, 3, 12, 7))
    dy = torch.from_numpy(_rand(rng, 3, 10, 7))
    runs = []
    for fn in (mg.grouped_matmul_autograd, mg.grouped_matmul_plain):
        lx, lw = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(lx, lw)
        runs.append([out] + list(torch.autograd.grad(out, (lx, lw), dy)))
    for u, v in zip(*runs):
        assert torch.equal(u, v)
    for u, v in zip(mg.grouped_matmul_bwd(x, w, dy), runs[0][1:]):
        assert torch.equal(u, v)


def test_grouped_matmul_bwd_raises_on_what_it_cannot_take():
    """K17's launch raises on a device it does not take before it reaches
    the library (the wrapper hands it every device but the CPU and meta,
    where it returns (dx, dw) of the right shapes and runs nothing), and
    its shape rule names one path a dtype."""
    x, w = torch.zeros(2, 4, 8), torch.zeros(2, 8, 6)
    meta = (x.to("meta"), w.to("meta"), torch.zeros(2, 4, 6, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        mg._launch_bwd(*meta)
    dx, dw = mg.grouped_matmul_bwd(*meta)
    assert dx.is_meta and dx.shape == x.shape and dw.shape == w.shape
    assert mg.bwd_path(x, w) == "cuda_cores"
    assert mg.bwd_path(x.bfloat16(), w.bfloat16()) == "mma"   # f = 6


@pytest.mark.parametrize("dtype,e,c,d,f,offset,want", [
    (torch.bfloat16, 64, 240, 2048, 1408, 0, "wgmma"),   # gate / up
    (torch.bfloat16, 64, 240, 1408, 2048, 0, "wgmma"),   # down
    (torch.bfloat16, 4, 24, 128, 96, 0, "wgmma"),        # C <= 32
    (torch.bfloat16, 4, 16, 64, 32, 0, "wgmma"),         # the reduced widths
    (torch.bfloat16, 3, 37, 72, 44, 0, "mma"),           # f not 16-byte rows
    (torch.bfloat16, 2, 50, 36, 40, 0, "mma"),           # d not 16-byte rows
    (torch.bfloat16, 2, 40, 64, 32, 1, "mma"),           # x one element off
    (torch.float32, 64, 240, 2048, 1408, 0, "cuda_cores"),
    (torch.float32, 3, 37, 72, 44, 0, "cuda_cores"),
])
def test_k17_shape_rule_names_the_kernels(dtype, e, c, d, f, offset, want):
    """K17's rule (``bwd_path(x, w[, dy])``): bf16 runs the wgmma kernel
    when TMA can address every operand (d and f multiples of 8, 16-byte
    aligned bases), else the mma.sync tile kernel; f32 the CUDA cores.  A
    misaligned dy alone also sends the call to ``"mma"``."""
    flat = torch.empty(e * c * d + 8, dtype=dtype)   # no value is read
    x = flat[offset:][:e * c * d].view(e, c, d)
    w = torch.empty(e, d, f, dtype=dtype)
    assert mg.bwd_path(x, w) == want
    assert mg.PATHS[want] == {"cuda_cores": 0, "mma": 1, "wgmma": 3}[want]
    dy_flat = torch.empty(e * c * f + 1, dtype=dtype)
    aligned_dy = dy_flat[:-1].view(e, c, f)
    assert mg.bwd_path(x, w, aligned_dy) == want
    if want == "wgmma":
        assert mg.bwd_path(x, w, dy_flat[1:].view(e, c, f)) == "mma"


def test_expert_products_route_grad_calls_to_the_function(monkeypatch):
    """``moe_apply`` runs its three expert products through
    ``grouped_matmul_autograd`` (K14 forward, K17 backward) when a
    gradient is needed, and through the forward-only ``grouped_matmul``
    otherwise (serve launches no extra kernel).  The Function's forward
    is ``grouped_matmul`` itself."""
    calls = []
    for name in ("grouped_matmul", "grouped_matmul_autograd"):
        real = getattr(mg, name)
        monkeypatch.setattr(mg, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    cfg = moe.MoEConfig(d_model=16, n_experts=4, top_k=2, d_ff=8)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_rand(np.random.RandomState(0), 1, 6, 16))
    moe.moe_apply(p, cfg, x)
    moe.moe_apply(p, cfg, x.requires_grad_())
    with torch.no_grad():
        moe.moe_apply(p, cfg, x)
    assert calls == (["grouped_matmul"] * 3
                     + ["grouped_matmul_autograd", "grouped_matmul"] * 3
                     + ["grouped_matmul"] * 3)


# ---------------------------------------------- K11 at Dk != Dv

@pytest.mark.parametrize("b,sq,skv,hq,hkv,dk,dv,causal", [
    (2, 20, 20, 4, 4, 24, 16, True),       # the reduced MLA prefill
    (1, 17, 17, 4, 2, 24, 16, True),       # GQA, ragged
    (1, 12, 12, 2, 2, 192, 128, True),     # the full MLA pair
    (1, 9, 21, 4, 2, 192, 128, False),     # GQA, Sq < Skv, non-causal
])
def test_bwd_plain_at_dk_ne_dv_matches_jax_vjp(b, sq, skv, hq, hkv, dk, dv,
                                               causal):
    rng = np.random.RandomState(sq + skv + dk)
    q, k = _rand(rng, b, sq, hq, dk), _rand(rng, b, skv, hkv, dk)
    v, do = _rand(rng, b, skv, hkv, dv), _rand(rng, b, sq, hq, dv)
    _, vjp = jax.vjp(lambda *t: jax_chunked(*t, causal=causal, block_k=8),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal)
    assert out.shape == (b, sq, hq, dv)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse,
                                       torch.from_numpy(do), causal=causal,
                                       block_k=8)
    for gt, w, t in zip(got, want, (q, k, v)):
        assert gt.shape == t.shape
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **KTOL)


# ------------------------------------------------- loss and gradients

def _pair(policy="full", dispatch="global"):
    """(JAX model, JAX params, port model, port params) of the reduced
    config under ``policy`` and a ``DISPATCH`` setting."""
    groups, factor = DISPATCH[dispatch]
    knobs = dict(remat_policy=policy, moe_dispatch_groups=groups,
                 capacity_factor=factor)
    jm = JaxModel(dataclasses.replace(jax_config(ARCH).reduced(), **knobs))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(get_config(ARCH).reduced(), **knobs),
               device="cpu")
    return jm, jp, tm, params_from_numpy(_np(jp), device="cpu")


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(1, 256, shape).astype(
        np.int32)


@pytest.mark.parametrize("dispatch", list(DISPATCH))
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_loss_and_gradients_match_jax(policy, dispatch):
    jm, jp, tm, tp = _pair(policy, dispatch)
    toks = _tokens((2, 24))
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    tree = opt.tree_map(lambda t: t.detach().requires_grad_(), tp)
    leaves = _flat(tree)
    loss, met = tm.loss(tree, {"tokens": torch.from_numpy(toks)})
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    want = _flat(_np(jgrads))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               rtol=1e-5)
    assert met["aux"].item() > 0.0
    assert sorted(grads) == sorted(want)
    for key, gt in grads.items():
        np.testing.assert_allclose(gt.numpy(), want[key], **GTOL,
                                   err_msg=key)


def test_small_capacity_drops_choices_in_both_packages():
    """The ``groups_drop`` setting does drop choices (so the gradient test
    above holds the dropped rows' zero gradients), and the port drops the
    ones the reference drops."""
    from repro.models import moe as jax_moe
    from repro_torch.models import transformer as tfm
    jm, jp, tm, tp = _pair(dispatch="groups_drop")
    x = _rand(np.random.RandomState(1), 2, 24, jm.cfg.d_model)
    jp_moe = jax.tree.map(lambda t: t[0], jp["blocks"]["moe"])
    tp_moe = opt.tree_map(lambda t: t[0], tp["blocks"]["moe"])
    jcfg = jax_moe.MoEConfig(
        d_model=jm.cfg.d_model, n_experts=jm.cfg.n_experts,
        top_k=jm.cfg.top_k, d_ff=jm.cfg.moe_d_ff,
        n_shared_experts=jm.cfg.n_shared_experts,
        capacity_factor=jm.cfg.capacity_factor,
        dispatch_groups=jm.cfg.moe_dispatch_groups)
    jout, jmet = jax_moe.moe_apply(jp_moe, jcfg, jnp.asarray(x))
    out, met = moe.moe_apply(tp_moe, tfm.moe_cfg(tm.cfg), torch.from_numpy(x))
    assert met["dropped"].item() > 0.1
    np.testing.assert_allclose(met["dropped"].item(), float(jmet["dropped"]),
                               rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------ the train step

def test_train_step_matches_reference_over_three_steps():
    jm, jp, tm, tp = _pair()
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, jax_opt.AdamWConfig(**ocfg),
                                        microbatches=2))
    tstep = make_train_step(tm, opt.AdamWConfig(**ocfg), microbatches=2)
    js = jax_opt.init_state(jp, jax_opt.AdamWConfig(**ocfg))
    ts = opt.init_state(tp, opt.AdamWConfig(**ocfg))
    for i in range(3):
        toks = _tokens((4, 16), seed=10 + i)
        jp, js, jmet = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tmet = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        want = _flat(_np(jp))
        for key, leaf in _flat(tp).items():
            np.testing.assert_allclose(leaf.numpy(), want[key], **STEP_TOL,
                                       err_msg=key)


def test_launch_train_trains_deepseek_on_cpu(tmp_path):
    out = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--microbatches",
        "1", "--steps", "2", "--batch", "2", "--seq", "16", "--log-every",
        "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(loss) for _, loss in out["history"])
