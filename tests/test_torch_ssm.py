"""The port's Mamba2 (SSM) slice against the JAX package, on the CPU.

Kernel level: the plain versions of K12 (``ssd_plain``) and K13
(``ssd_quantized_plain``) against the Pallas kernels in interpret mode and
against the reference oracles (``ssd_ref``, a literal sequential
recurrence that never chunks, and ``ssd_quant_ref``), at the reference's
kernel-test tolerances (atol 2e-4, rtol 1e-3).  In bf16 both sides round
an f32 result to bf16 once, so y may differ by one bf16 ulp (at most 2^-7
of the value: rtol 2^-7); the f32 final state keeps the reference's
tolerance.  K13 in bf16 is held to the oracle alone (see the test).
Ragged lengths and an initial state, which the reference's chunked forms
do not take, are held against ``ssd_ref``.

Model level: the reduced mamba2-780m (f32, params bridged from the JAX
tree) — prefill logits, state and conv window, and decode-step logits at
1e-4 (summation order only); greedy serve tokens equal to the JAX
engine's under every admission policy at prompt lengths the reference's
exact-length prefill accepts (at most 64, or a multiple of its chunk);
and, at lengths it does not accept, the port's own invariant: a prefill
equals feeding the same tokens through ``decode_step`` one at a time
within 1e-5.  Paged serve equals contiguous serve bit for bit with zero
pages allocated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_config as jax_config
from repro.kernels import quant as jq
from repro.kernels.mamba_ssd.kernel import ssd_fwd, ssd_fwd_quantized
from repro.kernels.mamba_ssd.ref import ssd_quant_ref, ssd_ref
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import (load_reference_checkpoint,
                                           params_from_numpy)
from repro_torch.configs import get_config
from repro_torch.core.schedulers import available_schedulers
from repro_torch.kernels import quant
from repro_torch.kernels.mamba_ssd import ops
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.serve import Engine, ServeConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

REF_TOL = dict(atol=2e-4, rtol=1e-3)       # the reference's kernel tests
BF16_Y_TOL = dict(atol=2e-4, rtol=2.0 ** -7)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
POLICIES = list(available_schedulers())
MAX_LEN = 160
F32_LEAVES = ("A_log", "D", "dt_bias")


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); a = -exp(N(0, 1)) (the
    reference's kernel-test draws), as f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    a = (-np.exp(rng.randn(h))).astype(np.float32)
    b_in = rng.randn(b, s, g, n).astype(np.float32)
    c_in = rng.randn(b, s, g, n).astype(np.float32)
    return x, dt, a, b_in, c_in


def _t(a) -> torch.Tensor:
    """A numpy or jax array as a torch tensor of the same values; bf16 and
    fp8 cross as their bytes (numpy's come from ml_dtypes)."""
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        dtype = getattr(torch, a.dtype.name)
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _cast(arrs, dtype):
    """(x, dt, a, b_in, c_in) with x, b_in, c_in in ``dtype`` (jnp)."""
    x, dt, a, b_in, c_in = arrs
    return (jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(b_in, dtype), jnp.asarray(c_in, dtype))


# ------------------------------------------------------------ K12 plain

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 16, 1, 16, 16),     # chunk < S
    (1, 32, 4, 8, 2, 8, 8),        # G = 2, chunk < S
    (1, 64, 8, 32, 1, 64, 64),     # chunk = S
    (2, 48, 4, 16, 2, 16, 48),     # G = 2, chunk = S
])
def test_ssd_plain_matches_pallas_and_reference(dtype, b, s, h, p, g, n,
                                                chunk):
    ins = _cast(_ssd_inputs(b, s, h, p, g, n), dtype)
    y, st = ops.ssd_plain(*map(_t, ins), chunk=chunk)
    assert y.dtype == _t(ins[0]).dtype and st.dtype == torch.float32
    y_tol = REF_TOL if dtype == jnp.float32 else BF16_Y_TOL
    for want_y, want_st in (ssd_fwd(*ins, chunk=chunk, interpret=True),
                            ssd_ref(*ins)):
        np.testing.assert_allclose(_np(y), np.asarray(want_y, np.float32),
                                   **y_tol)
        np.testing.assert_allclose(_np(st), np.asarray(want_st), **REF_TOL)


@pytest.mark.parametrize("s,chunk,with_state", [
    (100, 64, False),      # the R4 length: ragged last chunk of 36 rows
    (100, 64, True),
    (37, 16, True),
    (5, None, False),      # shorter than one default chunk
])
def test_ssd_plain_ragged_and_initial_state_match_reference(s, chunk,
                                                            with_state):
    b, h, p, g, n = 2, 4, 16, 2, 16
    ins = _ssd_inputs(b, s, h, p, g, n, seed=s)
    init = (np.random.RandomState(1).randn(b, h, p, n).astype(np.float32)
            if with_state else None)
    y, st = ops.ssd_plain(*map(_t, ins), chunk=chunk,
                          initial_state=None if init is None else _t(init))
    want_y, want_st = ssd_ref(*map(jnp.asarray, ins), initial_state=init)
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **REF_TOL)
    np.testing.assert_allclose(_np(st), np.asarray(want_st), **REF_TOL)
    # and the chunk length moves nothing beyond rounding
    y8, st8 = ops.ssd_plain(*map(_t, ins), chunk=8,
                            initial_state=None if init is None else _t(init))
    np.testing.assert_allclose(_np(y8), _np(y), **REF_TOL)
    np.testing.assert_allclose(_np(st8), _np(st), **REF_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("p,n", [(p, n) for p in ops.HEAD_DIMS
                                 for n in ops.STATE_DIMS])
def test_ssd_plain_matches_reference_at_every_built_shape(p, n, dtype):
    """The plain version the card tests hold K12 to, against the
    reference at every (P, N) the kernels are built for, at the kernel's
    chunk, with a ragged last chunk, two groups and an initial state."""
    b, s, h, g = 1, 70, 4, 2
    ins = _cast(_ssd_inputs(b, s, h, p, g, n, seed=p + n), dtype)
    init = np.random.RandomState(n).randn(b, h, p, n).astype(np.float32)
    y, st = ops.ssd_plain(*map(_t, ins), initial_state=_t(init))
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    want_y, want_st = ssd_ref(*ins, initial_state=init)
    y_tol = REF_TOL if dtype == jnp.float32 else BF16_Y_TOL
    np.testing.assert_allclose(_np(y), np.asarray(want_y, np.float32),
                               **y_tol)
    np.testing.assert_allclose(_np(st), np.asarray(want_st), **REF_TOL)


def test_ssd_wrapper_on_cpu_runs_the_plain_version():
    ins = [_t(a) for a in _ssd_inputs(1, 70, 4, 16, 1, 16)]
    before = ops.ssd.launches
    y, st = ops.ssd(*ins)
    want_y, want_st = ops.ssd_plain(*ins)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert ops.ssd.launches == before      # the count is of kernel launches


@pytest.mark.parametrize("x_dtype,bc_dtype,want", [
    (torch.bfloat16, torch.bfloat16, "mma"),        # K12 in bf16
    (torch.int8, torch.bfloat16, "mma"),            # K13 in bf16
    (torch.float8_e4m3fn, torch.bfloat16, "mma"),
    (torch.float32, torch.float32, "cuda_cores"),   # the parity dtype
    (torch.int8, torch.float32, "cuda_cores"),
])
def test_ssd_path_rule_follows_b_dtype(x_dtype, bc_dtype, want):
    """B's dtype picks the library's kernel: bf16 on the tensor cores
    (K12 and K13 alike, whatever x's storage), f32 on the CUDA cores."""
    x = torch.zeros((1, 8, 4, 16)).to(x_dtype)
    b_in = torch.zeros((1, 8, 1, 16), dtype=bc_dtype)
    assert ops.path(x, b_in) == want


def test_ssd_wrapper_on_cpu_counts_no_path():
    """bf16 CPU tensors run the plain version: no launch, by path or
    not."""
    x, dt, a, b_in, c_in = (_t(v) for v in _ssd_inputs(1, 20, 4, 16, 1,
                                                         16))
    x, b_in, c_in = (t.bfloat16() for t in (x, b_in, c_in))
    before = (ops.ssd.launches, dict(ops.ssd.path_launches))
    y, _ = ops.ssd(x, dt, a, b_in, c_in)
    assert y.dtype == torch.bfloat16
    assert (ops.ssd.launches, dict(ops.ssd.path_launches)) == before


# ------------------------------------------------------------ K13 plain

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("store", quant.quant_dtypes())
def test_ssd_quantized_plain_matches_pallas_and_oracle(store, dtype):
    x, dt, a, b_in, c_in = _cast(_ssd_inputs(1, 64, 4, 16, 1, 16, seed=7),
                                 dtype)
    x_q, x_s = jq.quantize(x.astype(jnp.float32), dtype=store,
                           scale_dtype=jq.SCALE_DTYPE)
    y, st = ops.ssd_quantized_plain(*map(_t, (x_q, x_s, dt, a, b_in, c_in)),
                                    chunk=16)
    assert y.dtype == _t(b_in).dtype
    y_tol = REF_TOL if dtype == jnp.float32 else BF16_Y_TOL
    wants = [ssd_quant_ref(x_q, x_s, dt, a, b_in, c_in)]
    if dtype == jnp.float32:
        # the Pallas kernel keeps the dequantized x in f32 where the oracle
        # (and the port) rounds it to b_in's dtype: equal only in f32
        wants.append(ssd_fwd_quantized(x_q, x_s, dt, a, b_in, c_in,
                                       chunk=16, interpret=True))
    for want_y, want_st in wants:
        np.testing.assert_allclose(_np(y), np.asarray(want_y, np.float32),
                                   **y_tol)
        np.testing.assert_allclose(_np(st), np.asarray(want_st), **REF_TOL)
    before = ops.ssd_quantized.launches
    y2, st2 = ops.ssd_quantized(*map(_t, (x_q, x_s, dt, a, b_in, c_in)),
                                chunk=16)
    assert torch.equal(y2, y) and torch.equal(st2, st)
    assert ops.ssd_quantized.launches == before


# --------------------------------------------------------------- layers

@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_reference(with_cache):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    cache = rng.randn(2, 3, 12).astype(np.float32) if with_cache else None
    want_y, want_c = jax_layers.causal_conv1d(
        *map(jnp.asarray, (x, w, b)),
        cache=None if cache is None else jnp.asarray(cache))
    y, c = layers.causal_conv1d(*map(_t, (x, w, b)),
                                cache=None if cache is None else _t(cache))
    np.testing.assert_allclose(_np(y), np.asarray(want_y), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(_np(c), np.asarray(want_c))


def test_gated_rmsnorm_matches_reference():
    rng = np.random.RandomState(4)
    x, z = rng.randn(2, 5, 32).astype(np.float32), rng.randn(2, 5, 32)
    scale = rng.rand(32).astype(np.float32) + 0.5
    want = jax_layers.gated_rmsnorm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x), jnp.asarray(z, jnp.float32))
    got = layers.gated_rmsnorm({"scale": _t(scale)}, _t(x),
                               _t(z.astype(np.float32)))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params): reduced
    mamba2-780m, f32."""
    jm = JaxModel(jax_config("mamba2-780m").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("mamba2-780m").reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, shape).astype(
        np.int32)


def test_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, (2, 48))
    jl, jc = jm.prefill(jp, {"tokens": toks}, MAX_LEN, jnp.float32)
    tl, tc = tm.prefill(tp, {"tokens": toks}, MAX_LEN, torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    assert set(tc) == set(jc) == {"conv", "state"}
    for key in tc:
        assert tc[key].dtype == torch.float32
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                   **LOGIT_TOL)
    for step in range(4):
        nxt = _tokens(jm.cfg.vocab_size, (2, 1), seed=step + 1)
        jl, jc = jm.decode_step(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, nxt, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(_np(tc["state"]), np.asarray(jc["state"]),
                               **LOGIT_TOL)


@pytest.mark.parametrize("length", [100, 131])
def test_exact_length_prefill_equals_stepwise_decode(pair, length):
    """Lengths the reference's chunked scan refuses (R4): the port's
    prefill (one ragged scan per layer) equals the same tokens fed through
    ``decode_step`` one at a time."""
    _, _, tm, tp = pair
    toks = _tokens(tm.cfg.vocab_size, (1, length), seed=length)
    logits, cache = tm.prefill(tp, {"tokens": toks}, MAX_LEN, torch.float32)
    step_cache = tm.init_cache(1, MAX_LEN, torch.float32)
    for i in range(length):
        step_logits, step_cache = tm.decode_step(tp, toks[:, i:i + 1],
                                                 step_cache)
    torch.testing.assert_close(logits, step_logits, **STEP_TOL)
    for key in cache:
        torch.testing.assert_close(cache[key], step_cache[key], **STEP_TOL)


def test_prefill_scans_through_the_kernel_wrapper(pair, monkeypatch):
    """Every multi-token SSM prefill goes through ``kernels.mamba_ssd.ssd``
    once per layer (K12 on CUDA); a one-token prompt and a decode step
    take the plain recurrence instead."""
    _, _, tm, tp = pair
    calls = []
    real = ops.ssd

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "ssd", counted)
    _, cache = tm.prefill(tp, {"tokens": _tokens(256, (1, 9))}, MAX_LEN)
    assert len(calls) == tm.cfg.n_layers
    tm.decode_step(tp, _tokens(256, (1, 1)), cache)
    tm.prefill(tp, {"tokens": _tokens(256, (1, 1))}, MAX_LEN)
    assert len(calls) == tm.cfg.n_layers


@pytest.fixture(scope="module")
def engines(pair):
    jm, jp, tm, tp = pair
    return (JaxEngine(jm, jp, JaxServeConfig(max_len=MAX_LEN, slots=2)),
            Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2)))


@pytest.fixture(scope="module")
def prompts():
    """Lengths the reference accepts: up to 64 tokens, one of them a
    one-token prompt (the decode-step branch)."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).astype(np.int32)
            for n in [8, 1, 30, 64, 5, 17, 40]]


@pytest.mark.parametrize("policy", POLICIES)
def test_serve_tokens_equal_jax_under_every_policy(engines, prompts, policy):
    jax_engine, engine = engines
    jax_engine.cfg.refill_schedule = policy
    engine.cfg.refill_schedule = policy
    want = jax_engine.serve(prompts, 6)
    got = engine.serve(prompts, 6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert engine.last_report.prefill_tokens == sum(len(p) for p in prompts)


def test_paged_serve_equals_contiguous_with_zero_pages(pair, prompts):
    """The ssm family demands no pages: the paged backend degenerates to
    per-slot state, token for token equal to the contiguous backend, at
    lengths the reference refuses too."""
    _, _, tm, tp = pair
    rng = np.random.RandomState(5)
    reqs = prompts + [rng.randint(1, 256, n).astype(np.int32)
                      for n in (100, 77)]
    contiguous = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=3))
    paged = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=3,
                                       cache="paged", page_size=16))
    want = contiguous.serve(reqs, 8)
    got = paged.serve(reqs, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    rep = paged.last_report
    assert rep.pages_allocated == rep.peak_pages_live == 0
    assert paged._backend.has_pages is False
    assert set(paged._backend.cache) == {"conv", "state"}


# ------------------------------------------------ init, bridge, refusals

def test_init_follows_reference_tree_and_dtypes():
    """Model.init draws the reference's tree: the same leaves and shapes;
    in a bf16 model A_log, D and dt_bias stay f32 as in the reference;
    softplus(dt_bias) lies in [1e-3, 1e-1]."""
    cfg = get_config("mamba2-780m").reduced().with_dtype("bfloat16")
    jp = JaxModel(jax_config("mamba2-780m").reduced().with_dtype(
        "bfloat16")).init(jax.random.PRNGKey(0))
    params = Model(cfg, device="cpu").init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in flat:
        node = params
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name, path
    mixer = params["blocks"]["ssm"]
    assert all(mixer[k].dtype == torch.float32 for k in F32_LEAVES)
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    h = cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim
    assert torch.equal(mixer["A_log"][0], torch.log(torch.arange(1.0, h + 1)))


def test_bridge_casts_only_the_reference_dtype_leaves(pair, tmp_path):
    """``dtype="bfloat16"`` casts the leaves the reference's init makes in
    the model dtype and keeps A_log, D and dt_bias f32, leaf for leaf as
    the reference's own bf16 init; a checkpoint load does the same."""
    jm, jp, _, _ = pair
    jp16 = JaxModel(jax_config("mamba2-780m").reduced().with_dtype(
        "bfloat16")).init(jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path): leaf.dtype.name for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp16)[0]}
    jax_ckpt.save(jp, tmp_path, step=1)
    for cast in (params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu", dtype="bfloat16"),
                 load_reference_checkpoint(tmp_path, device="cpu",
                                           dtype="bfloat16")):
        got = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            node = cast
            for p in path:
                node = node[p.key]
            got[jax.tree_util.keystr(path)] = str(node.dtype).split(".")[-1]
        assert got == want
        np.testing.assert_array_equal(
            cast["blocks"]["ssm"]["dt_bias"].numpy(),
            np.asarray(jp["blocks"]["ssm"]["dt_bias"]))


def test_ssm_and_hybrid_train_moe_raises(pair):
    """The SSM family trains (the scan's gradient is K16 on the card, its
    plain version here), and so does the hybrid family, whose groups run
    the same scan: finite losses (tests/test_torch_train_families.py holds
    them and their gradients to the reference).  The moe family trains
    too (tests/test_torch_train_moe.py)."""
    _, _, tm, tp = pair
    loss, _ = tm.loss(tp, {"tokens": _tokens(256, (1, 8))})
    assert bool(torch.isfinite(loss))
    hm = Model(get_config("zamba2-2.7b").reduced(), device="cpu")
    loss, _ = hm.loss(hm.init(0), {"tokens": _tokens(256, (1, 8))})
    assert bool(torch.isfinite(loss))
    mm = Model(get_config("deepseek-v2-lite-16b").reduced(), device="cpu")
    loss, _ = mm.loss(mm.init(0), {"tokens": _tokens(256, (1, 8))})
    assert bool(torch.isfinite(loss))


def test_ssm_cache_ignores_the_kv_dtype(pair):
    """A quantized or bf16 kv_dtype leaves the SSM cache f32, as the
    reference's init_cache does; the engine serves with it."""
    _, _, tm, tp = pair
    cache = tm.init_cache(2, MAX_LEN, torch.int8)
    assert {k: v.dtype for k, v in cache.items()} == {
        "conv": torch.float32, "state": torch.float32}
    eng = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2,
                                     kv_dtype="int8"))
    plain = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2))
    reqs = [_tokens(256, (n,), seed=n) for n in (3, 12)]
    for a, b in zip(eng.serve(reqs, 4), plain.serve(reqs, 4)):
        np.testing.assert_array_equal(a, b)


def test_ssd_chunked_matches_reference_module(pair):
    """``models/ssm.ssd_chunked`` (the port's, through the kernel wrapper)
    against the reference's at a length it accepts, with a state."""
    from repro.models import ssm as jax_ssm
    x, dt, a, b_in, c_in = _ssd_inputs(1, 64, 4, 16, 2, 16, seed=9)
    init = np.random.RandomState(2).randn(1, 4, 16, 16).astype(np.float32)
    want_y, want_st = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, b_in, c_in)), chunk=32,
        initial_state=jnp.asarray(init))
    y, st = ssm_mod.ssd_chunked(*map(_t, (x, dt, a, b_in, c_in)), chunk=32,
                                initial_state=_t(init))
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **REF_TOL)
    np.testing.assert_allclose(_np(st), np.asarray(want_st), **REF_TOL)


# -------------------------------------------- the chunk as a tuned choice

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("chunk", ops.CHUNKS)
def test_ssd_plain_at_each_built_chunk_matches_pallas(chunk, dtype):
    """The plain version the card holds K12 to at each chunk the bf16
    kernel is built for, against the reference's Pallas ``ssd_fwd`` at
    that chunk (interpret mode) at a length the reference accepts (S a
    multiple of the chunk, R4) and a served (P, N) pair, and against the
    plain version at the classic 64 within the reference's tolerance
    (the chunk moves rounding only)."""
    b, s, h, p, g, n = 1, 256, 2, 32, 1, 64
    assert chunk in ops.chunks(p, n)
    ins = _cast(_ssd_inputs(b, s, h, p, g, n, seed=chunk), dtype)
    y, st = ops.ssd_plain(*map(_t, ins), chunk=chunk)
    want_y, want_st = ssd_fwd(*ins, chunk=chunk, interpret=True)
    y_tol = REF_TOL if dtype == jnp.float32 else BF16_Y_TOL
    np.testing.assert_allclose(_np(y), np.asarray(want_y, np.float32),
                               **y_tol)
    np.testing.assert_allclose(_np(st), np.asarray(want_st), **REF_TOL)
    y64, st64 = ops.ssd_plain(*map(_t, ins), chunk=64)
    np.testing.assert_allclose(_np(y), _np(y64), **y_tol)
    np.testing.assert_allclose(_np(st), _np(st64), **REF_TOL)


def test_ssd_chunks_built_follow_the_served_pairs():
    """bf16 K12 / K13 are built at chunks 32, 64 and 128 where a block
    takes 32 head-dim columns of a served state (mamba2-780m's P = 64, N =
    128; zamba2-2.7b's N = 64), at 64 elsewhere; f32 (the CUDA cores) at
    64 only.  The classic chunk is in every set."""
    for p in ops.HEAD_DIMS:
        for n in ops.STATE_DIMS:
            want = (32, 64, 128) if p >= 32 and n >= 64 else (64,)
            assert ops.chunks(p, n) == want
            assert ops.chunks(p, n, torch.float32) == (64,)
            assert ops.SSD_CHUNK in ops.chunks(p, n)


def test_resolve_chunk_reads_the_db_and_off_ignores_it(tmp_path,
                                                       monkeypatch):
    """``chunk=None`` runs the classic 64 whatever the tuning db holds for
    the ``mamba_ssd`` bucket (here the CPU's, a recorded winner of 128):
    another chunk moves the served bits, so the db's pick is timed but not
    served; a caller's ``chunk=`` reaches its instance, an unbuilt one
    raises, and ``REPRO_TUNING=off`` gives 64 too.  Training
    (``SSDFunction``) keeps 64 whatever the db."""
    from repro_torch.core import autotune_search

    monkeypatch.setenv("REPRO_TORCH_TUNING_DB", str(tmp_path / "db.json"))
    monkeypatch.setenv("REPRO_TUNING", "on")
    autotune_search.reset_db()
    x, dt, a, b_in, c_in = map(_t, _cast(_ssd_inputs(1, 488, 2, 64, 1, 128),
                                         jnp.bfloat16))
    try:
        assert ops.resolve_chunk(x, b_in) == ops.SSD_CHUNK
        spec = autotune_search.SPECS["mamba_ssd"]
        shape = dict(s=488, p=64, n=128, dtype="bfloat16")
        autotune_search.get_db().record(
            "mamba_ssd", "cpu", spec.bucket_key(spec.bucket(**shape)),
            {"chunk": 128})
        before = autotune_search.measurement_count()
        assert autotune_search.lookup_or_search(
            "mamba_ssd", device="cpu", **shape) == {"chunk": 128}
        assert ops.resolve_chunk(x, b_in) == ops.SSD_CHUNK
        assert ops.resolve_chunk(x, b_in, 128) == 128
        assert ops.resolve_chunk(x[:, :100].contiguous(),
                                 b_in[:, :100].contiguous(), 32) == 32
        with pytest.raises(ValueError, match="chunks of"):
            ops.resolve_chunk(x, b_in, 48)
        with pytest.raises(ValueError, match="chunks of"):
            ops.resolve_chunk(x.float(), b_in.float(), 128)
        assert autotune_search.measurement_count() == before
        monkeypatch.setenv("REPRO_TUNING", "off")
        assert ops.resolve_chunk(x, b_in) == ops.SSD_CHUNK
    finally:
        autotune_search.reset_db()
