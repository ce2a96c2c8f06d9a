"""The port's quantized KV path against the JAX package, on the CPU:
``kernels/quant.py``, the plain versions of K7, K8 and K10, the model's
quantized caches and the quantized serve engine.

Tolerances, each with its reason:

* ``quantize`` is held byte for byte: values and f16 scales must be the
  reference's bytes, since a cache written by one framework must read the
  same in the other.
* The plain versions of K7, K8 and K10 are held to the reference oracles
  (dequantize, then the float oracle) and the Pallas kernels in interpret
  mode at atol = rtol = 2e-5, the reference's own tolerance for these
  kernels (``tests/test_quant.py``): f32 throughout, the scale placement
  is exact arithmetic, so only the summation order differs.
* Logits of the reduced qwen2.5-3b (f32 parameters bridged from the JAX
  tree) at atol = 2e-3 (about 0.5 % of the largest |logit|, 0.42).  On a
  float cache the two agree to 4e-7 (``tests/test_torch_model.py`` holds
  them to 1e-4), but quantization is discontinuous: that f32 summation-
  order difference puts an occasional K/V value, or an f16 scale, on the
  neighbouring level in the two frameworks, and the one-level step (up
  to amax/127 in int8, 2**-4 of the value in fp8) echoes through the
  later layers.  Over 12 seeds of this test's shapes the largest
  difference was 5.2e-4, with about 3 % of the K bytes on another level.
* Serve tokens are held equal, and inside the port paged equals
  contiguous bit for bit, as for the float caches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import quant as jq
from repro.kernels.decode_attention.kernel import (
    decode_attention_fwd_quantized, paged_decode_attention_fwd_quantized)
from repro.kernels.decode_attention.ref import (
    decode_attention_quant_ref, paged_decode_attention_quant_ref)
from repro.kernels.flash_attention.kernel import flash_attention_fwd_quantized
from repro.kernels.flash_attention.ref import flash_attention_quant_ref
from repro.models import Model as JaxModel
from repro.models.attention import naive_attention as jax_naive
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

QDTYPES = quant.quant_dtypes()
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=2e-3, rtol=0)
MAX_LEN = 48
PS = 8


def _t(a) -> torch.Tensor:
    """A numpy (or jax) array as a torch tensor of the same bytes; fp8
    crosses as bytes (numpy's fp8 comes from ml_dtypes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return quant.as_bytes(x).contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _quantized(x, dtype):
    """The reference's quantization of ``x`` (values and f16 scales)."""
    return jq.quantize(jnp.asarray(x), dtype=dtype,
                       scale_dtype=jq.SCALE_DTYPE)


# ------------------------------------------------------------ quantize

@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("mag", [1e-6, 1.0, 3e3])
def test_quantize_bytes_equal_reference(dtype, mag):
    x = (np.random.RandomState(int(mag * 7) % 97).randn(64, 4, 32)
         * mag).astype(np.float32)
    want_q, want_s = _quantized(x, dtype)
    got_q, got_s = quant.quantize(torch.from_numpy(x), dtype=dtype,
                                  scale_dtype=quant.SCALE_DTYPE)
    assert got_q.dtype == getattr(torch, dtype)
    assert got_s.dtype == torch.float16 and got_s.shape == (64, 4, 1)
    np.testing.assert_array_equal(_bytes(got_q), _bytes(want_q))
    np.testing.assert_array_equal(_bytes(got_s), _bytes(want_s))
    # the round trip stays inside the analytic bound
    amax = np.abs(x).max(-1, keepdims=True)
    err = np.abs(quant.dequantize(got_q, got_s).numpy() - x)
    bound = quant.max_abs_error(got_s, torch.from_numpy(amax), dtype)
    assert (err <= bound.numpy()).all()


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_below_f16_tiny_clamps_like_reference(dtype):
    """A vector whose scale underflows f16 gets the smallest normal f16
    scale (values round to zero), in both frameworks."""
    x = np.array([[1e-9, -3e-10, 0.0, 2e-9], [0.0] * 4], np.float32)
    want_q, want_s = _quantized(x, dtype)
    got_q, got_s = quant.quantize(torch.from_numpy(x), dtype=dtype,
                                  scale_dtype=quant.SCALE_DTYPE)
    np.testing.assert_array_equal(_bytes(got_q), _bytes(want_q))
    np.testing.assert_array_equal(_bytes(got_s), _bytes(want_s))
    assert (got_s == torch.finfo(torch.float16).tiny).all()
    assert torch.isfinite(quant.dequantize(got_q, got_s)).all()


def test_fp8_saturation_edge_pinned():
    """torch's f32 -> fp8 cast saturates where ml_dtypes' gives NaN, but
    quantize never leaves the range where they agree: the f16-rounded
    scale keeps |x / scale| <= 448 * (1 + 2**-11)."""
    assert torch.tensor(465.0).to(torch.float8_e4m3fn).float().item() == 448
    assert np.isnan(np.float32(465.0).astype(jnp.float8_e4m3fn).astype(
        np.float32))
    # amax values whose scale amax / 448 rounds DOWN in f16, so the
    # largest |x / scale| lands just above 448
    amax = np.linspace(400.0, 500.0, 4001, dtype=np.float32)
    scale16 = (amax / np.float32(448.0)).astype(np.float16)
    edge = amax[amax / scale16.astype(np.float32) > 448.0]
    assert edge.size > 100
    x = np.stack([edge, -edge / 3, edge / 7], -1).astype(np.float32)
    y_max = (np.abs(x).max(-1) / scale16[amax / scale16.astype(np.float32)
                                         > 448.0].astype(np.float32))
    assert (y_max <= 448.0 * (1 + 2.0 ** -11)).all()
    want_q, want_s = _quantized(x, "float8_e4m3fn")
    got_q, got_s = quant.quantize(torch.from_numpy(x),
                                  dtype="float8_e4m3fn",
                                  scale_dtype=quant.SCALE_DTYPE)
    np.testing.assert_array_equal(_bytes(got_q), _bytes(want_q))
    np.testing.assert_array_equal(_bytes(got_s), _bytes(want_s))
    assert not np.isnan(np.asarray(want_q).astype(np.float32)).any()
    assert (got_q.float().abs().amax(-1) == 448).all()


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("head_dim", [16, 32, 128])
def test_kv_byte_ratio_matches_reference(dtype, head_dim):
    assert quant.kv_byte_ratio(head_dim, dtype=dtype) == jq.kv_byte_ratio(
        head_dim, dtype=dtype)
    assert quant.is_quant_dtype(dtype) and quant.is_quant_dtype(
        getattr(torch, dtype))
    assert not quant.is_quant_dtype(torch.bfloat16)
    assert not quant.is_quant_dtype(None)


def test_quantize_rejects_unknown_dtype():
    with pytest.raises(ValueError, match="unsupported quantized dtype"):
        quant.quantize(torch.ones(4), dtype=torch.int16)


# ------------------------------------------------------- K7, K8, plain

def _decode_inputs(seed, b, s, hq, hkv, d, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, d).astype(np.float32)
    kq, ks = _quantized(rng.randn(b, s, hkv, d).astype(np.float32), dtype)
    vq, vs = _quantized(rng.randn(b, s, hkv, d).astype(np.float32), dtype)
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len,ns", [
    (2, 64, 2, 1, 16, [64, 37], 4),            # the reference's own case
    (4, 64, 4, 2, 16, [1, 64, 33, 17], 4),     # ragged, masked splits
    (3, 32, 4, 4, 32, [32, 1, 16], 2),          # MHA
])
def test_k7_plain_matches_reference_and_pallas(dtype, b, s, hq, hkv, d,
                                               kv_len, ns):
    q, kq, ks, vq, vs = _decode_inputs(s + hq, b, s, hq, hkv, d, dtype)
    kl = np.asarray(kv_len, np.int32)
    got = da.decode_attention_quantized_plain(*map(_t, (q, kq, ks, vq, vs,
                                                        kl)))
    ref = decode_attention_quant_ref(jnp.asarray(q), kq, ks, vq, vs,
                                     jnp.asarray(kl))
    pallas = decode_attention_fwd_quantized(
        jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(kl), num_splits=ns,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **KERNEL_TOL)


def _paged_inputs(seed, b, pages, ps, hq, hkv, d, kv_len, dtype, spare=3):
    """A quantized pool of b * pages + spare + 1 pages placed by a seeded
    permutation (page 0 is scratch and only row 0 names it)."""
    rng = np.random.RandomState(seed)
    n_pool = b * pages + spare + 1
    pt = (rng.permutation(n_pool - 1)[: b * pages] + 1).reshape(b, pages)
    pt[0] = 0
    q = rng.randn(b, hq, d).astype(np.float32)
    kq, ks = _quantized(rng.randn(n_pool, ps, hkv, d).astype(np.float32),
                        dtype)
    vq, vs = _quantized(rng.randn(n_pool, ps, hkv, d).astype(np.float32),
                        dtype)
    return q, kq, ks, vq, vs, pt.astype(np.int32), np.asarray(kv_len,
                                                              np.int32)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("b,pages,ps,hq,hkv,d,kv_len", [
    (4, 6, 8, 4, 2, 16, [0, 48, 17, 60]),       # scratch row; past P * ps
    (3, 4, 16, 8, 2, 32, [64, 1, 33]),
])
def test_k8_plain_matches_reference_pallas_and_k7(dtype, b, pages, ps, hq,
                                                  hkv, d, kv_len):
    """K8's plain version against the oracle and the Pallas kernel, and
    bit for bit against K7's plain version on the gathered rows."""
    args = _paged_inputs(b + pages, b, pages, ps, hq, hkv, d, kv_len, dtype)
    q, kq, ks, vq, vs, pt, kl = args
    got = da.paged_decode_attention_quantized_plain(*map(_t, args))
    ref = np.asarray(paged_decode_attention_quant_ref(
        jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(pt), jnp.asarray(kl)))
    pallas = np.asarray(paged_decode_attention_fwd_quantized(
        jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(pt), jnp.asarray(kl),
        interpret=True))
    # a kv_len = 0 row: the oracle's softmax over all-masked scores is
    # uniform, while the kernels' masked-split guard (and the port) give 0
    live = kl > 0
    np.testing.assert_allclose(got.numpy()[live], ref[live], **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **KERNEL_TOL)
    assert not got.numpy()[~live].any()

    def rows(pool):
        return _t(np.asarray(pool)[pt].reshape(b, pages * ps,
                                               *pool.shape[2:]))

    k7 = da.decode_attention_quantized_plain(
        _t(q), rows(kq), rows(ks), rows(vq), rows(vs), _t(kl))
    assert torch.equal(got, k7)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_k8_plain_is_placement_invariant(dtype):
    """The same logical rows and scales on other pool pages give the same
    output bit for bit (mirrors the reference's
    test_paged_quant_bit_identical_across_page_placements)."""
    q, kq, ks, vq, vs, pt, kl = _paged_inputs(1, 3, 4, 8, 4, 2, 16,
                                              [30, 9, 32], dtype)
    perm = np.random.RandomState(2).permutation(np.asarray(kq).shape[0]
                                                - 1) + 1
    perm = np.concatenate([[0], perm])          # scratch stays page 0
    inv = np.argsort(perm)
    moved = [np.asarray(x)[perm] for x in (kq, ks, vq, vs)]
    a = da.paged_decode_attention_quantized_plain(
        *map(_t, (q, kq, ks, vq, vs, pt, kl)))
    b = da.paged_decode_attention_quantized_plain(
        _t(q), *map(_t, moved), _t(inv[pt].astype(np.int32)), _t(kl))
    assert torch.equal(a, b)


# ------------------------------------------------------------- K10, plain

@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,bq,bk", [
    (1, 64, 2, 1, 16, True, 16, 16),      # the reference's own case
    (2, 32, 4, 2, 32, True, 8, 16),       # GQA
    (2, 32, 8, 8, 16, False, 16, 32),     # MHA, non-causal
])
def test_k10_plain_matches_reference_and_pallas(dtype, b, s, hq, hkv, d,
                                                causal, bq, bk):
    """Sq = Skv: the Pallas K10 aligns queries at Skv - Sq = 0."""
    rng = np.random.RandomState(s + hq)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    kq, ks = _quantized(rng.randn(b, s, hkv, d).astype(np.float32), dtype)
    vq, vs = _quantized(rng.randn(b, s, hkv, d).astype(np.float32), dtype)
    out, lse = fa.flash_attention_quantized_plain(
        *map(_t, (q, kq, ks, vq, vs)), causal=causal, block_k=bk)
    ref = flash_attention_quant_ref(jnp.asarray(q), kq, ks, vq, vs,
                                    causal=causal)
    pallas, pallas_lse = flash_attention_fwd_quantized(
        jnp.asarray(q), kq, ks, vq, vs, causal=causal, block_q=bq,
        block_k=bk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(pallas_lse),
                               **KERNEL_TOL)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("kv_len,q_offset", [
    (13, 5),                  # prefill continuing a 5-token cache
    (8, 0),                   # bucketed prefill: width 8, empty cache
    ([40, 9], 0),             # per-row valid lengths
    ([7, 30], 6),
])
def test_k10_plain_kv_len_q_offset_matches_dequantized_naive(dtype, kv_len,
                                                             q_offset):
    """K10's kv_len / q_offset (which the Pallas K10 lacks) against a
    dequantize-then-naive_attention oracle."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 8, 4, 16).astype(np.float32)
    kq, ks = _quantized(rng.randn(2, 40, 2, 16).astype(np.float32), dtype)
    vq, vs = _quantized(rng.randn(2, 40, 2, 16).astype(np.float32), dtype)
    kl = np.asarray(kv_len)
    out, _ = fa.flash_attention_quantized_plain(
        *map(_t, (q, kq, ks, vq, vs)), kv_len=torch.tensor(kl),
        q_offset=q_offset, block_k=16)
    ref = jax_naive(jnp.asarray(q), jq.dequantize(kq, ks),
                    jq.dequantize(vq, vs), kv_len=jnp.asarray(kl),
                    q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)


def test_quantized_wrappers_on_cpu_run_the_plain_versions():
    q, kq, ks, vq, vs, pt, kl = map(_t, _paged_inputs(
        3, 2, 4, 8, 4, 2, 16, [20, 7], "int8"))
    counters = (da.decode_attention_quantized,
                da.paged_decode_attention_quantized,
                fa.flash_attention_quantized)
    before = [c.launches for c in counters]
    assert torch.equal(
        da.paged_decode_attention_quantized(q, kq, ks, vq, vs, pt, kl),
        da.paged_decode_attention_quantized_plain(q, kq, ks, vq, vs, pt,
                                                  kl))
    rows = [x[:4].reshape(2, 16, 2, -1) for x in (kq, ks, vq, vs)]
    assert torch.equal(da.decode_attention_quantized(q, *rows, kl),
                       da.decode_attention_quantized_plain(q, *rows, kl))
    q4 = q[:, None].expand(2, 3, 4, 16).contiguous()
    assert torch.equal(
        fa.flash_attention_quantized(q4, *rows, kv_len=9, q_offset=6)[0],
        fa.flash_attention_quantized_plain(q4, *rows, kv_len=9,
                                           q_offset=6)[0])
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma"),
                                        (torch.float32, "cuda_cores")])
def test_k10_path_rule_follows_the_query_dtype(dtype, want):
    """The query's dtype picks K10's kernel, as K1's: bf16 on the tensor
    cores (the 1-byte tiles converted to bf16 in the block), f32 on the
    CUDA cores; the same rule names K1's, K4's and K11's."""
    q = torch.zeros((1, 4, 2, 16), dtype=dtype)
    assert fa.path(q) == want


def test_quantized_flash_on_cpu_counts_no_path():
    """A bf16 CPU call of K10 runs the plain version: no launch, by path
    or not."""
    q, kq, ks, vq, vs, pt, kl = map(_t, _paged_inputs(
        3, 2, 4, 8, 4, 2, 16, [20, 7], "int8"))
    rows = [x[:4].reshape(2, 16, 2, -1) for x in (kq, ks, vq, vs)]
    q4 = q[:, None].expand(2, 3, 4, 16).contiguous().bfloat16()
    fn = fa.flash_attention_quantized
    before = (fn.launches, dict(fn.path_launches))
    out, _ = fn(q4, *rows, kv_len=9, q_offset=6)
    assert out.dtype == torch.bfloat16
    assert (fn.launches, dict(fn.path_launches)) == before


# ------------------------------------------------------- model and serve

@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_config("qwen2.5-3b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("qwen2.5-3b").reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).astype(np.int32) for n in (8, 5, 11, 3)]


@pytest.mark.parametrize("dtype", QDTYPES)
def test_prefill_and_decode_logits_match_jax(models, dtype):
    """Scalar-length prefill (K10's path), a per-row padded prefill and
    per-row decode (K7's path) on a quantized cache."""
    jm, jp, tm, tp = models
    rng = np.random.RandomState(1)
    toks = rng.randint(1, 256, (2, 12)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32,
                        jnp.dtype(dtype))
    lt, ct = tm.prefill(tp, {"tokens": toks}, 32, getattr(torch, dtype))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    assert set(ct) == set(cj) == {"k", "v", "ks", "vs", "len"}
    nxt = rng.randint(1, 256, (2, 1)).astype(np.int32)
    dj, _ = jm.decode_step(jp, jnp.asarray(nxt), cj)
    dt, _ = tm.decode_step(tp, nxt, ct)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGIT_TOL)

    batch = {"tokens": toks, "lengths": np.array([12, 7], np.int32)}
    lj, cj = jm.prefill_padded(jp, jax.tree.map(jnp.asarray, batch), 32,
                               jnp.dtype(dtype))
    lt, ct = tm.prefill_padded(tp, batch, 32, getattr(torch, dtype))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    dj, _ = jm.decode_step(jp, jnp.asarray(nxt), cj)
    dt, _ = tm.decode_step(tp, nxt, ct)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGIT_TOL)


def _serve_pair(models, prompts, max_new, **kw):
    jm, jp, tm, tp = models
    want = JaxEngine(jm, jp, JaxServeConfig(**kw)).serve(prompts, max_new)
    engine = Engine(tm, tp, ServeConfig(**kw))
    got = engine.serve(prompts, max_new)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    return engine, got


def test_int8_contiguous_serve_tokens_equal_jax(models, prompts):
    engine, _ = _serve_pair(models, prompts, 4, max_len=MAX_LEN, slots=2,
                            kv_dtype="int8", refill_schedule="faa")
    assert engine.kv_dtype == torch.int8
    assert engine._backend.cache["k"].dtype == torch.int8
    assert engine._backend.cache["ks"].dtype == quant.SCALE_DTYPE


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_int8_paged_serve_tokens_equal_jax_and_contiguous(models, prompts,
                                                          prefix_cache):
    """The JAX setup of tests/test_quant.py (4 slots, pages of 8), with
    the prefix cache off and on (a shared 16-token prefix); the port's
    paged int8 tokens also equal its contiguous int8 tokens."""
    _, _, tm, tp = models
    if prefix_cache:
        rng = np.random.RandomState(4)
        shared = rng.randint(1, 256, 2 * PS).astype(np.int32)
        prompts = [np.concatenate([shared, p]) for p in prompts]
    engine, got = _serve_pair(
        models, prompts, 4, max_len=MAX_LEN, slots=4, cache="paged",
        page_size=PS, kv_dtype="int8", prefix_cache=prefix_cache,
        refill_schedule="faa")
    rep = engine.last_report
    assert (rep.prefix_hits > 0) == prefix_cache
    contiguous = Engine(tm, tp, ServeConfig(
        max_len=MAX_LEN, slots=2, kv_dtype="int8",
        refill_schedule="faa")).serve(prompts, 4)
    for c, g in zip(contiguous, got):
        np.testing.assert_array_equal(g, c)


def test_fp8_paged_serve_equals_contiguous(models, prompts):
    _, _, tm, tp = models
    kw = dict(max_len=MAX_LEN, kv_dtype="float8_e4m3fn",
              refill_schedule="faa")
    want = Engine(tm, tp, ServeConfig(slots=2, **kw)).serve(prompts, 4)
    got = Engine(tm, tp, ServeConfig(slots=4, cache="paged", page_size=PS,
                                     prefix_cache=False, **kw)).serve(
        prompts, 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_quantized_cache_bytes_per_token_equal_kv_byte_ratio(models):
    """At head_dim 32, the bf16 cache's bytes over the int8 cache's
    (scales included, lengths excluded) is kv_byte_ratio(32)."""
    _, _, tm, _ = models
    model = Model(dataclasses.replace(tm.cfg, head_dim=32), device="cpu")

    def kv_bytes(dtype):
        cache = model.init_cache(2, 32, dtype, device="meta")
        return sum(t.numel() * t.element_size() for name, t in cache.items()
                   if name != "len")

    ratio = kv_bytes(torch.bfloat16) / kv_bytes(torch.int8)
    assert ratio == pytest.approx(quant.kv_byte_ratio(32))
    assert ratio >= 1.8


@pytest.mark.parametrize("dtype", QDTYPES)
def test_scale_leaves_page_splice_and_gather_like_kv(models, dtype):
    """The scale leaves sit in the page spec and the batch axes where k/v
    do, the paged cache's leaves have the reference's shapes, and pages
    written from a prefill cache gather back to its bytes."""
    jm, _, tm, tp = models
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    spec = tm.cache_page_spec(dtype=tdt)
    assert spec == jax.tree.map(int, jm.cache_page_spec(dtype=jdt))
    assert spec["ks"] == spec["vs"] == spec["k"] >= 0
    axes = tm.cache_batch_axes(dtype=tdt)
    assert axes["ks"] == axes["vs"] == axes["k"]
    pool = tm.init_paged_cache(2, MAX_LEN, 9, PS, tdt)
    want = jax.eval_shape(lambda: jm.init_paged_cache(2, MAX_LEN, 9, PS,
                                                      jdt))
    assert set(pool) == set(want)
    for key in want:
        assert tuple(pool[key].shape) == want[key].shape, key
        assert str(pool[key].dtype).split(".")[-1] == str(want[key].dtype)
    toks = np.random.RandomState(5).randint(1, 256, (1, 24)).astype(np.int32)
    _, pre = tm.prefill_padded(tp, {"tokens": toks, "lengths": [21]},
                               MAX_LEN, tdt)
    pages = [7, 2, 5]
    tm.write_page(pool, pre, pages, [0, 1, 2], spec=spec, page_size=PS)
    pt_row = np.zeros(MAX_LEN // PS, np.int32)
    pt_row[:3] = pages
    view = tm.gather_prefix_cache(pool, pt_row, 21, spec=spec, page_size=PS)
    for key in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(_bytes(view[key][:, :, :24]),
                                      _bytes(pre[key][:, :, :24]))
    serve = tm.set_cache_lengths(tm.init_cache(3, MAX_LEN, tdt),
                                 np.zeros(3, np.int32))
    tm.splice_cache(serve, pre, 2, axes=axes)
    for key in ("k", "ks"):
        np.testing.assert_array_equal(_bytes(serve[key][:, 2]),
                                      _bytes(pre[key][:, 0]))
