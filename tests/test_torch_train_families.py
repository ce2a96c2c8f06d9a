"""Training the SSM (mamba2-780m), hybrid (zamba2-2.7b), encoder-decoder
(seamless-m4t-large-v2) and vision (llama-3.2-vision-11b) families in the
port, against the JAX package, on the CPU.

Inputs are made with numpy from a seed (or by both packages'
``make_dummy_batch``) and handed to both frameworks; params cross over
through ``params_from_numpy``.  The vision family's cross gates are set
to 0.5 in the params both packages get (at their initial 0 a cross block
adds nothing and its weights get no gradient; one test keeps them at 0).
Tolerances, f32 throughout:

* ``ssd_plain``'s gradients against ``jax.vjp`` of the reference's
  ``ssd_chunked`` (at lengths it accepts, S % chunk == 0, ROADMAP R4):
  atol = rtol = 1e-5 of the largest value (summation order only);
* ``flash_attention_bwd_plain`` (K11's plain version) at head dim 80 and
  at the cross shapes against the Pallas ``flash_attention_bwd`` in
  interpret mode (whole blocks), or ``jax.vjp`` of the ``ref.py`` oracle
  (a KV tail of one row, which no Pallas block tiles): 2e-5;
* ``Model.loss`` (rtol 1e-5) and every gradient leaf (``GTOL``: atol
  1e-5, rtol 1e-4) against ``jax.value_and_grad(Model.loss)``, under
  both remat policies;
* ``make_train_step`` steps: loss rtol 1e-5, grad norm rtol 1e-4, and
  the params after AdamW within ``STEP_TOL`` (atol 1e-4, a tenth of the
  lr): Adam divides each gradient entry by its running RMS, so an entry
  whose gradient is near 0 moves by a share of the lr that the last bits
  of that gradient decide (``GTOL`` still holds every gradient above).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.inputs import make_dummy_batch as jax_dummy_batch
from repro.kernels.flash_attention.kernel import (flash_attention_bwd as
                                                  pallas_bwd)
from repro.kernels.flash_attention.kernel import (flash_attention_fwd as
                                                  pallas_fwd)
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import Model as JaxModel
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.inputs import make_dummy_batch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_ssd import ops as ss
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

GTOL = dict(atol=1e-5, rtol=1e-4)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
KTOL = dict(atol=2e-5, rtol=2e-5)
ARCHS = ["mamba2-780m", "zamba2-2.7b", "seamless-m4t-large-v2",
         "llama-3.2-vision-11b"]
GATE = 0.5


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


def _gated(jp, value):
    """The JAX params with the vision family's cross gates at ``value``."""
    if "groups" not in jp or "cross" not in jp["groups"]:
        return jp
    cross = dict(jp["groups"]["cross"])
    for name in ("gate_attn", "gate_mlp"):
        cross[name] = jnp.full_like(cross[name], value)
    return dict(jp, groups=dict(jp["groups"], cross=cross))


# ------------------------------------------------------ the SSD backward

@pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_init", [
    (2, 48, 4, 16, 1, 16, 16, True),        # G = 1, three chunks
    (1, 64, 4, 16, 2, 32, 16, True),        # G = 2
    (2, 32, 6, 8, 2, 16, 32, False),        # G = 2, one chunk, no state
])
def test_ssd_plain_gradients_match_jax_vjp(b, s, h, p, g, n, chunk,
                                           with_init):
    """The gradients of x, dt, a, B, C and the initial state under a y and
    a final-state cotangent."""
    rng = np.random.RandomState(s + h + g)
    x = _rand(rng, b, s, h, p)
    dt = np.log1p(np.exp(_rand(rng, b, s, h)))
    a = -np.exp(_rand(rng, h))
    b_in, c_in = _rand(rng, b, s, g, n), _rand(rng, b, s, g, n)
    init = _rand(rng, b, h, p, n) if with_init else None
    dy, dfin = _rand(rng, b, s, h, p), _rand(rng, b, h, p, n)
    args = [x, dt, a, b_in, c_in] + ([init] if with_init else [])

    def ref(*t):
        return jax_ssd_chunked(*t[:5], chunk=chunk,
                               initial_state=t[5] if with_init else None)

    _, vjp = jax.vjp(ref, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin)))
    got = ss.ssd_bwd_plain(*map(torch.from_numpy, args[:5]),
                           torch.from_numpy(dy),
                           initial_state=(torch.from_numpy(init)
                                          if with_init else None),
                           d_final=torch.from_numpy(dfin), chunk=chunk)
    assert (got[5] is None) == (not with_init)
    for name, gt, w in zip(("x", "dt", "a", "B", "C", "init"), got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(gt.numpy(), w, atol=1e-5 * scale,
                                   rtol=1e-5, err_msg=name)


def test_ssd_autograd_on_cpu_is_autograd_of_plain():
    """On CPU tensors the differentiable scan is ``ssd_plain`` itself
    (ragged length, G = 2, an initial state), and ``ssd_bwd_plain`` (K16's
    plain version) gives the same gradients."""
    rng = np.random.RandomState(1)
    b, s, h, p, g, n = 2, 37, 4, 16, 2, 16
    ins = [torch.from_numpy(a) for a in (
        _rand(rng, b, s, h, p), np.log1p(np.exp(_rand(rng, b, s, h))),
        -np.exp(_rand(rng, h)), _rand(rng, b, s, g, n),
        _rand(rng, b, s, g, n), _rand(rng, b, h, p, n))]
    dy = torch.from_numpy(_rand(rng, b, s, h, p))
    dfin = torch.from_numpy(_rand(rng, b, h, p, n))
    grads = []
    for fn in (ss.ssd_autograd, ss.ssd_plain):
        leaves = [t.clone().requires_grad_() for t in ins]
        y, st = fn(*leaves[:5], initial_state=leaves[5])
        grads.append(torch.autograd.grad((y * dy).sum() + (st * dfin).sum(),
                                         leaves))
    for u, v in zip(*grads):
        assert torch.equal(u, v)
    via = ss.ssd_bwd_plain(*ins[:5], dy, initial_state=ins[5],
                           d_final=dfin)
    for u, v in zip(via, grads[0]):
        torch.testing.assert_close(u, v, atol=1e-6, rtol=1e-6)


def test_ssd_bwd_raises_on_cpu():
    """K16's wrapper takes CUDA tensors only: a CPU call raises and points
    at the plain version."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_rand(rng, 1, 8, 2, 16))
    dt = torch.from_numpy(np.log1p(np.exp(_rand(rng, 1, 8, 2))))
    bc = torch.from_numpy(_rand(rng, 1, 8, 1, 16))
    with pytest.raises(ValueError, match="ssd_bwd_plain"):
        ss.ssd_bwd(x, dt, torch.tensor([-1.0, -0.5]), bc, bc, x)


def _ssd_bwd_by_chunks(x, dt, a, b_in, c_in, dy, init, d_final, chunk,
                       slices):
    """The decomposition K16's tensor-core kernel computes, in f64 numpy.
    Pass one recomputes the state entering each chunk; pass two walks the
    chunks from the last to the first with dh (the gradient of the state
    leaving the chunk) carried back.  The sums that feed ddt and da come
    as ``slices`` partials, the columns dealt round robin as the kernel's
    warps take 16-column slabs by parity, and are added after in a fixed
    order: x . du and W over P, e^{cum_i} dy_i . (h_in C_i) and <dh, h_in>
    over N, T = M o G by row over the chunk's columns and by column over
    its rows."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2:]
    rep, nc = h // g, -(-s // chunk)
    pad = lambda t: np.concatenate(
        [t, np.zeros((t.shape[0], nc * chunk - s) + t.shape[2:])], 1)
    xs, dts, bs, cs, dys = (pad(t.astype(np.float64))
                            for t in (x, dt, b_in, c_in, dy))
    dx, ddt = np.zeros(xs.shape), np.zeros(dts.shape)
    da = np.zeros((bsz, h))       # per batch row, summed after
    db, dc = np.zeros(bs.shape[:2] + (h, n)), np.zeros(bs.shape[:2] + (h, n))
    d_init = np.zeros((bsz, h, p, n))
    lower = np.tril(np.ones((chunk, chunk), dtype=bool))
    part = lambda r: slice(r, None, slices)     # slice r's columns
    parts = lambda f: sum(f(part(r)) for r in range(slices))
    for b in range(bsz):
        for hh in range(h):
            gg, ah = hh // rep, float(a[hh])
            rows = [slice(c * chunk, (c + 1) * chunk) for c in range(nc)]

            def tiles(c):
                q = rows[c]
                d = dts[b, q, hh]
                cum = np.cumsum(d * ah)
                return (xs[b, q, hh], dys[b, q, hh], bs[b, q, gg],
                        cs[b, q, gg], d, cum)

            st = (init[b, hh].astype(np.float64) if init is not None
                  else np.zeros((p, n)))
            h_in = []
            for c in range(nc):          # pass one
                h_in.append(st)
                xc, _, bc, _, d, cum = tiles(c)
                w = np.exp(cum[-1] - cum) * d
                st = st * np.exp(cum[-1]) + (xc * w[:, None]).T @ bc
            dh = (d_final[b, hh].astype(np.float64) if d_final is not None
                  else np.zeros((p, n)))
            for c in reversed(range(nc)):   # pass two
                xc, dyc, bc, cc, d, cum = tiles(c)
                hc = h_in[c]
                ecum, edec = np.exp(cum), np.exp(cum[-1] - cum)
                diff = np.where(lower, cum[:, None] - cum[None, :], -np.inf)
                lmat = np.exp(diff)
                m = (cc @ bc.T) * lmat
                gm = np.where(lower, (dyc @ xc.T) * d[None, :], 0.0)
                t, gl = m * gm, gm * lmat
                v2 = bc @ dh.T
                u = m.T @ dyc + edec[:, None] * v2
                dx[b, rows[c], hh] = d[:, None] * u
                d2 = dyc @ hc
                dc[b, rows[c], hh] = gl @ bc + ecum[:, None] * d2
                db[b, rows[c], hh] = (gl.T @ cc
                                      + (edec * d)[:, None] * (xc @ dh))
                xdu = parts(lambda k: (xc[:, k] * u[:, k]).sum(1))
                w = parts(lambda k: edec * d * (xc[:, k] * v2[:, k]).sum(1))
                inter = parts(lambda k: ecum * (cc[:, k] * d2[:, k]).sum(1))
                dot = parts(lambda k: (dh[:, k] * hc[:, k]).sum())
                dcum = (inter - w + parts(lambda k: t[:, k].sum(1))
                        - parts(lambda k: t[k].sum(0)))
                dcum[-1] += ecum[-1] * dot + w.sum()
                dda = np.cumsum(dcum[::-1])[::-1]
                ddt[b, rows[c], hh] = xdu + ah * dda
                da[b, hh] += (d * dda).sum()
                dh = ecum[-1] * dh + (dyc * ecum[:, None]).T @ cc
            d_init[b, hh] = dh
    group = lambda t: t[:, :s].reshape(bsz, s, g, rep, n).sum(3)
    return (dx[:, :s], ddt[:, :s], da.sum(0), group(db), group(dc),
            d_init if init is not None else None)


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_init,vs_jax", [
    (2, 48, 4, 16, 1, 16, 16, True, True),   # test_ssd_plain_gradients_..
    (1, 64, 4, 16, 2, 32, 16, True, True),
    (2, 32, 6, 8, 2, 16, 32, False, True),
    (2, 100, 4, 16, 2, 32, 32, True, False),   # ragged: the plain only (R4)
])
def test_ssd_bwd_decomposition_matches_plain_and_jax(b, s, h, p, g, n, chunk,
                                                     with_init, vs_jax,
                                                     slices):
    """K16's decomposition (:func:`_ssd_bwd_by_chunks`) against
    ``ssd_bwd_plain`` run in f64 (1e-10 of each gradient's largest |value|:
    the same algebra in another order) and, where the reference takes the
    length, ``jax.vjp`` of its ``ssd_chunked`` (f32: 1e-5, as
    ``test_ssd_plain_gradients_match_jax_vjp``), with a y and a
    final-state cotangent."""
    rng = np.random.RandomState(s + h + g + n)
    x = _rand(rng, b, s, h, p)
    dt = np.log1p(np.exp(_rand(rng, b, s, h)))
    a = -np.exp(_rand(rng, h))
    b_in, c_in = _rand(rng, b, s, g, n), _rand(rng, b, s, g, n)
    init = _rand(rng, b, h, p, n) if with_init else None
    dy, dfin = _rand(rng, b, s, h, p), _rand(rng, b, h, p, n)
    got = _ssd_bwd_by_chunks(x, dt, a, b_in, c_in, dy, init, dfin, chunk,
                             slices)
    f64 = lambda t: None if t is None else torch.from_numpy(t).double()
    plain = ss.ssd_bwd_plain(*map(f64, (x, dt, a, b_in, c_in, dy)),
                             initial_state=f64(init), d_final=f64(dfin),
                             chunk=chunk)
    names = ("x", "dt", "a", "B", "C", "init")
    assert (got[5] is None) == (not with_init)
    for name, gt, w in zip(names, got, plain):
        if gt is None:
            continue
        w = w.numpy()
        assert np.abs(gt - w).max() <= 1e-10 * np.abs(w).max(), name
    if not vs_jax:
        return
    args = [x, dt, a, b_in, c_in] + ([init] if with_init else [])
    _, vjp = jax.vjp(lambda *t: jax_ssd_chunked(
        *t[:5], chunk=chunk, initial_state=t[5] if with_init else None),
        *map(jnp.asarray, args))
    for name, gt, w in zip(names, got, vjp((jnp.asarray(dy),
                                            jnp.asarray(dfin)))):
        w = np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(gt, w, atol=1e-5 * scale, rtol=1e-5,
                                   err_msg=name)


def test_ssd_chunked_routes_grad_calls_to_autograd(monkeypatch):
    """``models.ssm.ssd_chunked`` takes ``ssd_autograd`` when a gradient is
    needed, and the forward-only ``ssd`` otherwise."""
    from repro_torch.models import ssm
    calls = []
    for name in ("ssd", "ssd_autograd"):
        real = getattr(ss, name)
        monkeypatch.setattr(ss, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    rng = np.random.RandomState(2)
    x = torch.from_numpy(_rand(rng, 1, 8, 2, 16))
    dt = torch.from_numpy(np.log1p(np.exp(_rand(rng, 1, 8, 2))))
    a = torch.tensor([-1.0, -0.5])
    bc = torch.from_numpy(_rand(rng, 1, 8, 1, 16))
    ssm.ssd_chunked(x, dt, a, bc, bc)
    ssm.ssd_chunked(x.requires_grad_(), dt, a, bc, bc)
    with torch.no_grad():
        ssm.ssd_chunked(x, dt, a, bc, bc)
    assert calls == ["ssd", "ssd_autograd", "ssd"]


# ---------------------------------------------- K11 at D = 80 and cross

@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,bq,bk", [
    (1, 32, 32, 4, 4, 80, True, 16, 16),     # zamba2's shared block
    (2, 16, 16, 2, 2, 80, False, 8, 8),
    (1, 32, 16, 4, 4, 64, False, 16, 16),    # seamless's cross, Sq > Skv
    (1, 16, 32, 8, 2, 128, False, 8, 16),    # llama-vision's cross, G = 4
])
def test_bwd_plain_at_d80_and_cross_matches_pallas(b, sq, skv, hq, hkv, d,
                                                   causal, bq, bk):
    rng = np.random.RandomState(sq + skv + d)
    q, do = _rand(rng, b, sq, hq, d), _rand(rng, b, sq, hq, d)
    k, v = _rand(rng, b, skv, hkv, d), _rand(rng, b, skv, hkv, d)
    out, lse = pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, block_q=bq, block_k=bk,
                          interpret=True)
    want = pallas_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                      lse, jnp.asarray(do), causal=causal, block_q=bq,
                      block_k=bk, interpret=True)
    ins = [torch.from_numpy(np.array(t)) for t in (q, k, v, out, lse, do)]
    got = fa.flash_attention_bwd_plain(*ins, causal=causal, block_k=16)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **KTOL)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [
    (1, 12, 17, 8, 2, 128),    # the vision cross's KV tail of 1 row
    (2, 9, 33, 4, 4, 80),
])
def test_bwd_plain_with_a_kv_tail_matches_ref_vjp(b, sq, skv, hq, hkv, d):
    """Non-causal cross shapes whose KV length leaves one row past the
    blocks (1,601 = 25 x 64 + 1 at full width): against ``jax.vjp`` of the
    reference's dense oracle."""
    rng = np.random.RandomState(skv + d)
    q, do = _rand(rng, b, sq, hq, d), _rand(rng, b, sq, hq, d)
    k, v = _rand(rng, b, skv, hkv, d), _rand(rng, b, skv, hkv, d)
    _, vjp = jax.vjp(lambda *t: flash_attention_ref(*t, causal=False),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=False)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse,
                                       torch.from_numpy(do), causal=False)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **KTOL)


# ------------------------------------------------- loss and gradients

def _pair(arch, gate=GATE, policy="full"):
    """(JAX model, JAX params, port model, port params) of the reduced
    config under ``policy``, the vision gates at ``gate``."""
    jm = JaxModel(dataclasses.replace(jax_config(arch).reduced(),
                                      remat_policy=policy))
    jp = _gated(jm.init(jax.random.PRNGKey(0)), gate)
    tm = Model(dataclasses.replace(get_config(arch).reduced(),
                                   remat_policy=policy), device="cpu")
    return jm, jp, tm, params_from_numpy(_np(jp), device="cpu")


def _batches(arch, batch=2, seq=24, seed=0):
    """The same batch for both packages (JAX arrays, port tensors): tokens
    and, for the vision and encoder-decoder families, the patches or
    frames."""
    return (jax_dummy_batch(jax_config(arch).reduced(), batch, seq, seed),
            make_dummy_batch(get_config(arch).reduced(), batch, seq, seed,
                             device="cpu"))


def _value_and_grads(arch, gate, policy, seed=0):
    jm, jp, tm, tp = _pair(arch, gate, policy)
    jb, tb = _batches(arch, seed=seed)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    tree = opt.tree_map(lambda t: t.detach().requires_grad_(), tp)
    leaves = _flat(tree)
    loss, met = tm.loss(tree, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    return loss, met, float(jloss), grads, _flat(_np(jgrads))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, policy):
    loss, met, jloss, grads, want = _value_and_grads(arch, GATE, policy)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert met["aux"].item() == 0.0
    assert sorted(grads) == sorted(want)
    for key, gt in grads.items():
        np.testing.assert_allclose(gt.numpy(), want[key], **GTOL,
                                   err_msg=key)


def test_vision_gates_at_zero_pass_no_gradient_to_the_cross_weights():
    """At the initial gates (tanh(0) = 0) a cross block adds nothing: its
    attention and MLP weights get exactly zero gradient, in both packages,
    while the gates themselves get one."""
    arch = "llama-3.2-vision-11b"
    loss, _, jloss, grads, want = _value_and_grads(arch, 0.0, "full")
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for key, gt in grads.items():
        np.testing.assert_allclose(gt.numpy(), want[key], **GTOL,
                                   err_msg=key)
        if key.startswith("groups/cross/") and "gate" not in key:
            assert not gt.any() and not want[key].any(), key
    assert grads["groups/cross/gate_attn"].abs().min() > 0


# ------------------------------------------------------ the train step

def test_train_step_matches_reference_over_three_steps():
    arch = "mamba2-780m"
    jm, jp, tm, tp = _pair(arch)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, jax_opt.AdamWConfig(**ocfg),
                                        microbatches=2))
    tstep = make_train_step(tm, opt.AdamWConfig(**ocfg), microbatches=2)
    js = jax_opt.init_state(jp, jax_opt.AdamWConfig(**ocfg))
    ts = opt.init_state(tp, opt.AdamWConfig(**ocfg))
    for i in range(3):
        toks = np.random.RandomState(10 + i).randint(
            0, jm.cfg.vocab_size, (4, 16)).astype(np.int32)
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


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_microbatches_carry_the_modal_input(arch):
    """Each microbatch gets its own rows of the frames or patches with its
    tokens: one step of 2 microbatches equals the reference's, and the
    loss saw [2, ...] slices of each key."""
    jm, jp, tm, tp = _pair(arch)
    jb, tb = _batches(arch, batch=4, seq=12, seed=3)
    key = "patches" if tm.cfg.family == "vlm" else "frames"
    seen = []
    real = tm.loss
    object.__setattr__(tm, "loss", lambda p, b: (
        seen.append({k: tuple(v.shape) for k, v in b.items()}),
        real(p, b))[1])
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jp, _, jmet = jax.jit(jax_make_train_step(
        jm, jax_opt.AdamWConfig(**ocfg), microbatches=2))(
            jp, jax_opt.init_state(jp, jax_opt.AdamWConfig(**ocfg)), jb)
    tp, _, tmet = make_train_step(tm, opt.AdamWConfig(**ocfg),
                                  microbatches=2)(
        tp, opt.init_state(tp, opt.AdamWConfig(**ocfg)), tb)
    assert [s[key][0] for s in seen] == [2, 2]
    assert [s["tokens"] for s in seen] == [(2, 12), (2, 12)]
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tmet["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=1e-4)
    want = _flat(_np(jp))
    for k, leaf in _flat(tp).items():
        np.testing.assert_allclose(leaf.numpy(), want[k], **STEP_TOL,
                                   err_msg=k)


def test_launch_train_trains_mamba2_on_cpu(tmp_path):
    out = launch_train.main([
        "--arch", "mamba2-780m", "--reduced", "--device", "cpu",
        "--microbatches", "1", "--steps", "2", "--batch", "2", "--seq",
        "16", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(loss) for _, loss in out["history"])


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_modal_families_refuse_tokens_alone(arch, tmp_path):
    """``Model.loss`` and the launcher (SyntheticLM makes tokens only)
    raise a ``ValueError`` naming the missing input."""
    _, _, tm, tp = _pair(arch)
    key = "patches" if tm.cfg.family == "vlm" else "frames"
    _, tb = _batches(arch)
    with pytest.raises(ValueError, match=key):
        tm.loss(tp, {"tokens": tb["tokens"]})
    with pytest.raises(ValueError, match=key):
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--microbatches", "1", "--steps", "1",
                           "--ckpt-dir", str(tmp_path / "ck")])
