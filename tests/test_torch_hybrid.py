"""The port's hybrid family (Zamba2: Mamba2 groups around one shared
attention block) against the JAX package, on the CPU.

Kernel level: the plain versions of K1, K2, K3, K7 and K10 at the full
model's head shape (head_dim 80, one query head per KV head) against the
Pallas kernels in interpret mode (f32: 1e-5, the summation order; the
1-byte caches 2e-5, as in tests/test_torch_quant.py).  The wrappers take
80 (K1-K10), and K11 does not (the hybrid family does not train).

Reduced zamba2-2.7b in f32, params bridged from the JAX tree: prefill
logits, the groups' SSM state and conv window, the shared block's KV
cache and 4 decode steps' logits within 1e-4 (summation order only).
Serve tokens equal the JAX engine's under every admission policy at
prompt lengths the reference's exact-length prefill accepts (at most 64,
R4), on the contiguous, the paged and the int8 cache, and in rounds mode
(same-length cohorts).  At other lengths the port's own invariant holds:
a prefill equals the same tokens fed through ``decode_step`` one at a
time within 1e-5.  Paged serve equals contiguous serve bit for bit with
pages allocated for the attention leaves only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_config as jax_config
from repro.kernels import quant as jq
from repro.kernels.decode_attention.kernel import (
    decode_attention_fwd, decode_attention_fwd_quantized,
    paged_decode_attention_fwd)
from repro.kernels.flash_attention.kernel import (
    flash_attention_fwd, flash_attention_fwd_quantized)
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import (load_reference_checkpoint,
                                           params_from_numpy)
from repro_torch.configs import get_config
from repro_torch.core.schedulers import available_schedulers
from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
POLICIES = list(available_schedulers())
MAX_LEN = 48
PS = 8
F32_LEAVES = ("A_log", "D", "dt_bias")


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params): reduced
    zamba2-2.7b (2 groups of 2 SSD layers), f32."""
    jm = JaxModel(jax_config(ARCH).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH).reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def prompts():
    """Lengths the reference accepts, one of them a one-token prompt."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).astype(np.int32)
            for n in [8, 1, 30, 12, 5, 17]]


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(1, 256, shape).astype(
        np.int32)


def _np(t) -> np.ndarray:
    return t.float().numpy()


def _leaves(tree, path=()):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (key,))
        else:
            yield path + (key,), v


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ------------------------------------------------------- kernels at D = 80

D80 = 80
TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tq(a) -> torch.Tensor:
    """A numpy or jax array as a torch tensor of the same bytes (fp8
    crosses as bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def test_head_dim_80_is_built_for_k1_to_k11():
    # K10 and K11 check their inputs against fa.HEAD_DIMS
    assert (D80, D80) in fa.HEAD_DIM_PAIRS and D80 in fa.HEAD_DIMS
    assert (D80, D80) in da.HEAD_DIM_PAIRS and D80 in da.HEAD_DIMS
    assert get_config(ARCH).resolved_head_dim == D80


@pytest.mark.parametrize("causal", [True, False])
def test_k1_plain_at_d80_matches_pallas(causal):
    q, k, v = (_rand(i, 2, 32, 4, D80) for i in range(3))
    out, lse = fa.flash_attention_plain(*map(_tq, (q, k, v)), causal=causal,
                                        block_k=16)
    want, want_lse = flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_k2_and_k3_plain_at_d80_match_pallas():
    """G = 1 (4 query heads on 4 KV heads), ragged lengths; K3 on a
    permuted pool equals K2 on the gathered rows bit for bit."""
    b, s, h, ps = 3, 64, 4, 8
    q, k, v = _rand(3, b, h, D80), _rand(4, b, s, h, D80), _rand(5, b, s, h,
                                                                 D80)
    kl = np.array([64, 1, 37], np.int32)
    got = da.decode_attention_plain(*map(_tq, (q, k, v, kl)))
    want = decode_attention_fwd(*map(jnp.asarray, (q, k, v, kl)),
                                num_splits=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pages = s // ps
    perm = np.random.RandomState(6).permutation(b * pages) + 1
    pt = perm.reshape(b, pages).astype(np.int32)
    pool = lambda x: np.concatenate(
        [np.zeros((1, ps, h, D80), np.float32),
         x.reshape(b * pages, ps, h, D80)[np.argsort(perm)]])
    kp, vp = pool(k), pool(v)
    paged = da.paged_decode_attention_plain(*map(_tq, (q, kp, vp, pt, kl)))
    want = paged_decode_attention_fwd(*map(jnp.asarray, (q, kp, vp, pt, kl)),
                                      interpret=True)
    np.testing.assert_allclose(paged.numpy(), np.asarray(want), **TOL)
    assert torch.equal(paged, got)


@pytest.mark.parametrize("store", quant.quant_dtypes())
def test_k7_and_k10_plain_at_d80_match_pallas(store):
    jdt = getattr(jnp, str(store).split(".")[-1])
    b, s, h = 2, 32, 4
    kq, ks = jq.quantize(jnp.asarray(_rand(7, b, s, h, D80)), dtype=jdt,
                         scale_dtype=jq.SCALE_DTYPE)
    vq, vs = jq.quantize(jnp.asarray(_rand(8, b, s, h, D80)), dtype=jdt,
                         scale_dtype=jq.SCALE_DTYPE)
    q = _rand(9, b, h, D80)
    kl = np.array([32, 11], np.int32)
    got = da.decode_attention_quantized_plain(
        *map(_tq, (q, kq, ks, vq, vs, kl)))
    want = decode_attention_fwd_quantized(
        jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(kl), num_splits=2,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **QUANT_TOL)
    qf = _rand(10, b, s, h, D80)
    out, lse = fa.flash_attention_quantized_plain(
        *map(_tq, (qf, kq, ks, vq, vs)), causal=True, block_k=16)
    want, want_lse = flash_attention_fwd_quantized(
        jnp.asarray(qf), kq, ks, vq, vs, causal=True, block_q=16,
        block_k=16, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **QUANT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               **QUANT_TOL)


# ------------------------------------------------------ init and bridge

def test_init_follows_reference_tree_and_dtypes():
    """Model.init draws the reference's tree: groups [G, attn_every, ...]
    of SSD blocks, shared_proj (2d -> d) and one unstacked dense block;
    in a bf16 model A_log, D and dt_bias stay f32."""
    cfg = get_config(ARCH).reduced().with_dtype("bfloat16")
    jp = JaxModel(jax_config(ARCH).reduced().with_dtype("bfloat16")).init(
        jax.random.PRNGKey(0))
    params = Model(cfg, device="cpu").init(seed=3)
    want = {path: leaf for path, leaf in _leaves(jax.tree.map(np.asarray,
                                                              jp))}
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == leaf.dtype.name, path
    g = cfg.n_layers // cfg.attn_every
    assert params["groups"]["ln"]["scale"].shape[:2] == (g, cfg.attn_every)
    assert params["shared_proj"]["w"].shape == (2 * cfg.d_model, cfg.d_model)


def test_bridge_carries_doubly_stacked_groups(pair, tmp_path):
    """The groups' [G, attn_every, ...] leaves cross over as they are,
    from the tree and from a reference checkpoint; a bf16 cast keeps
    A_log, D and dt_bias f32, leaf for leaf as the reference's own bf16
    init."""
    jm, jp, _, tp = pair
    jax_ckpt.save(jp, tmp_path, step=1)
    loaded = load_reference_checkpoint(tmp_path, device="cpu")
    for path, leaf in _leaves(jax.tree.map(np.asarray, jp)):
        np.testing.assert_array_equal(_at(tp, path).numpy(), leaf)
        np.testing.assert_array_equal(_at(loaded, path).numpy(), leaf)
    jp16 = JaxModel(jax_config(ARCH).reduced().with_dtype("bfloat16")).init(
        jax.random.PRNGKey(0))
    want = {path: leaf.dtype.name
            for path, leaf in _leaves(jax.tree.map(np.asarray, jp16))}
    for cast in (params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu", dtype="bfloat16"),
                 load_reference_checkpoint(tmp_path, device="cpu",
                                           dtype="bfloat16")):
        got = {path: str(t.dtype).split(".")[-1]
               for path, t in _leaves(cast)}
        assert got == want
        for name in F32_LEAVES:
            assert cast["groups"]["ssm"][name].dtype == torch.float32


def test_loss_trains_hybrid(pair):
    """The hybrid family trains (tests/test_torch_train_families.py holds
    its loss and gradients to the reference), and so does the moe family
    (tests/test_torch_train_moe.py)."""
    _, _, tm, tp = pair
    loss, met = tm.loss(tp, {"tokens": _tokens((1, 8))})
    assert bool(torch.isfinite(loss)) and met["aux"].item() == 0.0
    mm = Model(get_config("deepseek-v2-lite-16b").reduced(), device="cpu")
    loss, _ = mm.loss(mm.init(0), {"tokens": _tokens((1, 8))})
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------- model

def test_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens((2, 32))
    jl, jc = jm.prefill(jp, {"tokens": toks}, MAX_LEN, jnp.float32)
    tl, tc = tm.prefill(tp, {"tokens": toks}, MAX_LEN, torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for step in range(4):
        nxt = _tokens((2, 1), seed=step + 1)
        jl, jc = jm.decode_step(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, nxt, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    want = dict(_leaves(jax.tree.map(np.asarray, jc)))
    got = dict(_leaves(tc))
    assert set(got) == set(want) == {
        ("ssm", "conv"), ("ssm", "state"), ("attn", "k"), ("attn", "v"),
        ("attn", "len")}
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        np.testing.assert_allclose(_np(got[path]), leaf.astype(np.float32),
                                   err_msg=str(path), **LOGIT_TOL)
    assert got[("ssm", "state")].dtype == torch.float32


@pytest.mark.parametrize("length", [100, 131])
def test_exact_length_prefill_equals_stepwise_decode(pair, length):
    """Lengths the reference's chunked scan refuses (R4): the port's
    prefill equals the same tokens fed through ``decode_step`` one at a
    time, logits and every cache leaf."""
    _, _, tm, tp = pair
    toks = _tokens((1, length), seed=length)
    logits, cache = tm.prefill(tp, {"tokens": toks}, 160, torch.float32)
    step_cache = tm.init_cache(1, 160, torch.float32)
    for i in range(length):
        step_logits, step_cache = tm.decode_step(tp, toks[:, i:i + 1],
                                                 step_cache)
    torch.testing.assert_close(logits, step_logits, **STEP_TOL)
    for path, leaf in _leaves(cache):
        torch.testing.assert_close(leaf, _at(step_cache, path), **STEP_TOL)


# ---------------------------------------------------------------- serve

@pytest.fixture(scope="module")
def engines(pair):
    jm, jp, tm, tp = pair
    return (JaxEngine(jm, jp, JaxServeConfig(max_len=MAX_LEN, slots=2)),
            Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2)))


@pytest.mark.parametrize("policy", POLICIES)
def test_serve_tokens_equal_jax_under_every_policy(engines, prompts, policy):
    jax_engine, engine = engines
    jax_engine.cfg.refill_schedule = policy
    engine.cfg.refill_schedule = policy
    want = jax_engine.serve(prompts, 5)
    got = engine.serve(prompts, 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert engine.last_report.prefill_tokens == sum(len(p) for p in prompts)


def test_paged_serve_equals_contiguous_and_jax_twin(pair):
    """The reference's ``test_paged_bit_identical_hybrid``, in both
    frameworks: the shared block's KV leaves are paged and the groups'
    state stays per slot, and the paged tokens equal the contiguous ones
    and the JAX paged engine's."""
    jm, jp, tm, tp = pair
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 256, n).astype(np.int32) for n in (6, 9, 4, 7)]
    kw = dict(max_len=MAX_LEN, slots=2, refill_schedule="stealing")
    want = JaxEngine(jm, jp, JaxServeConfig(
        cache="paged", page_size=PS, **kw)).serve(prompts, 4)
    contiguous = Engine(tm, tp, ServeConfig(**kw)).serve(prompts, 4)
    paged = Engine(tm, tp, ServeConfig(cache="paged", page_size=PS, **kw))
    got = paged.serve(prompts, 4)
    for w, c, g in zip(want, contiguous, got):
        np.testing.assert_array_equal(g, c)
        np.testing.assert_array_equal(g, w)
    rep = paged.last_report
    assert rep.pages_allocated > 0
    backend = paged._backend
    assert backend.has_pages and backend.prefix is None
    cache = backend.cache
    assert set(cache["attn"]) == {"k", "v", "len", "pt"}
    g = tm.cfg.n_layers // tm.cfg.attn_every
    assert cache["attn"]["k"].shape[:3] == (g, backend.num_pages + 1, PS)
    assert cache["attn"]["pt"].shape == (g, 2, MAX_LEN // PS)
    assert cache["ssm"]["state"].shape[:3] == (g, tm.cfg.attn_every, 2)


def test_paged_serve_equals_contiguous_at_other_lengths(pair):
    """Lengths the reference refuses, more requests than slots, a tight
    pool (deferred admissions): paged tokens equal contiguous."""
    _, _, tm, tp = pair
    rng = np.random.RandomState(5)
    reqs = [rng.randint(1, 256, n).astype(np.int32)
            for n in (100, 77, 3, 41, 120)]
    kw = dict(max_len=160, slots=3)
    want = Engine(tm, tp, ServeConfig(**kw)).serve(reqs, 6)
    paged = Engine(tm, tp, ServeConfig(cache="paged", page_size=16,
                                       num_pages=12, **kw))
    for w, g in zip(want, paged.serve(reqs, 6)):
        np.testing.assert_array_equal(g, w)
    assert paged.last_report.deferred_admissions > 0


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_int8_serve_equals_jax_int8_engine(pair, prompts, cache):
    """An int8 KV cache quantizes the shared block's K/V (the SSM state
    stays f32): tokens equal the JAX int8 engine's."""
    jm, jp, tm, tp = pair
    kw = dict(max_len=MAX_LEN, slots=2, kv_dtype="int8", cache=cache,
              page_size=PS)
    want = JaxEngine(jm, jp, JaxServeConfig(**kw)).serve(prompts, 5)
    eng = Engine(tm, tp, ServeConfig(**kw))
    got = eng.serve(prompts, 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    c = eng._backend.cache
    assert c["attn"]["k"].dtype == torch.int8
    assert c["attn"]["ks"].dtype == torch.float16
    assert c["ssm"]["state"].dtype == torch.float32


def test_rounds_serve_equals_jax_in_same_length_cohorts(pair):
    """Rounds mode where padding is unsafe: each cohort holds prompts of
    one length, as the reference forms them; tokens and refill packings
    equal the JAX engine's, greedy and at temperature 0.8."""
    jm, jp, tm, tp = pair
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, n).astype(np.int32)
               for n in (8, 5, 8, 8, 5, 16)]
    for temp in (0.0, 0.8):
        kw = dict(max_len=MAX_LEN, slots=2, mode="rounds", temperature=temp)
        jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
        want = jeng.serve(prompts, 4, seed=1)
        eng = Engine(tm, tp, ServeConfig(**kw))
        got = eng.serve(prompts, 4, seed=1)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert [st.n for st in eng.refill_stats] == [
            st.n for st in jeng.refill_stats] == [2, 2, 1, 1]
