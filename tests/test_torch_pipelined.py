"""The pipelined attention kernels (K4, K5, K6, K9) against the JAX
package, and the ops' routing to them.

A pipelined kernel computes its classic kernel's function (only when the
bytes arrive differs), so its plain version is the classic one's:
``flash_attention_plain``, ``decode_attention_plain``,
``paged_decode_attention_plain`` and
``paged_decode_attention_quantized_plain``.  Those are held here against
the reference's Pallas ``*_pipelined`` kernels in interpret mode at ring
depths 2 and 4, on the same inputs made with numpy from a seed (ragged
``kv_len``, causal offsets, GQA, f32 and bf16; K9 on int8 and fp8 pools).
Tolerances: f32 atol = rtol = 1e-5 (summation order only); bf16 outputs
atol 2e-2 (both versions compute in f32 from the same bf16 inputs and
round once to bf16: one bf16 ulp of values below 4), their f32 lse 1e-5.
The CUDA kernels are held to their classic kernels bit for bit on the
card by ``tests/test_torch_gpu.py``.

The routing: with a warm tuning db whose buckets hold depth 2, each op's
CUDA branch resolves to its pipelined kernel (checked through
:func:`route` on CPU tensors, without launching), and depth 1 otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro.kernels.decode_attention.kernel import (
    decode_attention_fwd_pipelined, paged_decode_attention_fwd_pipelined,
    paged_decode_attention_fwd_quantized_pipelined)
from repro.kernels.flash_attention.kernel import flash_attention_fwd_pipelined

from repro_torch.core import autotune_search
from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=0)}
LSE_TOL = dict(atol=1e-5, rtol=1e-5)
DEPTHS = [2, 4]
DTYPES = ["float32", "bfloat16"]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (f32 -> bf16 rounds to nearest even in both)."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _t(a) -> torch.Tensor:
    """A numpy / jax array as a torch tensor of the same bytes (fp8
    crosses as bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


# -------------------------------------------------------------- K4 plain

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,bq,bk", [
    (1, 32, 32, 2, 2, 16, True, 8, 8),        # four KV blocks: a full ring
    (2, 16, 64, 4, 2, 16, True, 8, 16),       # GQA, causal offset Skv - Sq
    (1, 32, 48, 4, 1, 32, False, 16, 8),      # MQA, not causal
])
def test_flash_plain_matches_pallas_pipelined(dtype, depth, b, sq, skv, hq,
                                              hkv, d, causal, bq, bk):
    rng = np.random.RandomState(sq + skv + depth)
    (jq_, tq), (jk, tk), (jv, tv) = (
        _pair(rng.randn(*shape).astype(np.float32), dtype)
        for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    out, lse = fa.flash_attention_pipelined(tq, tk, tv, causal=causal,
                                            num_buffers=depth)
    want, want_lse = flash_attention_fwd_pipelined(
        jq_, jk, jv, causal=causal, block_q=bq, block_k=bk,
        num_buffers=depth, interpret=True)
    assert out.dtype == tq.dtype
    _close(out, want, dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **LSE_TOL)


# -------------------------------------------------------------- K5 plain

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("b,s,hq,hkv,d,ns,kv_len", [
    (2, 64, 8, 2, 32, 4, [64, 23]),          # ragged kv_len
    (3, 96, 4, 1, 16, 6, [1, 96, 50]),       # MQA, a one-row cache
])
def test_decode_plain_matches_pallas_pipelined(dtype, depth, b, s, hq, hkv,
                                               d, ns, kv_len):
    rng = np.random.RandomState(s + ns + depth)
    (jq_, tq), (jk, tk), (jv, tv) = (
        _pair(rng.randn(*shape).astype(np.float32), dtype)
        for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    kl = np.asarray(kv_len, np.int32)
    out = da.decode_attention_pipelined(tq, tk, tv, torch.from_numpy(kl),
                                        num_splits=ns, num_buffers=depth)
    want = decode_attention_fwd_pipelined(
        jq_, jk, jv, jnp.asarray(kl), num_splits=ns, num_buffers=depth,
        interpret=True)
    _close(out, want, dtype)


# -------------------------------------------------------- K6 / K9 plain

def _pool(rng, b, pages, ps, hq, hkv, d, spare=3):
    """A pool of b * pages + spare + 1 pages placed by a seeded
    permutation (page 0 is the scratch page, and row 0's table names it
    only)."""
    n_pool = b * pages + spare + 1
    pt = (rng.permutation(n_pool - 1)[: b * pages] + 1).reshape(b, pages)
    pt[0] = 0
    return (rng.randn(b, hq, d).astype(np.float32),
            rng.randn(n_pool, ps, hkv, d).astype(np.float32),
            rng.randn(n_pool, ps, hkv, d).astype(np.float32),
            pt.astype(np.int32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_paged_plain_matches_pallas_pipelined(dtype, depth):
    b, pages, ps, hq, hkv, d = 4, 6, 8, 8, 2, 16
    rng = np.random.RandomState(21 + depth)
    q, kp, vp, pt = _pool(rng, b, pages, ps, hq, hkv, d)
    kl = np.asarray([0, 48, 17, 60], np.int32)    # scratch row; past P * ps
    (jq_, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
    out = da.paged_decode_attention_pipelined(
        tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(kl),
        num_buffers=depth)
    want = paged_decode_attention_fwd_pipelined(
        jq_, jk, jv, jnp.asarray(pt), jnp.asarray(kl), num_buffers=depth,
        interpret=True)
    _close(out, want, dtype)
    assert not out[0].float().any()       # kv_len 0 gives zeros in both


@pytest.mark.parametrize("store", quant.quant_dtypes())
@pytest.mark.parametrize("depth", DEPTHS)
def test_quantized_paged_plain_matches_pallas_pipelined(store, depth):
    b, pages, ps, hq, hkv, d = 3, 4, 16, 8, 2, 32
    rng = np.random.RandomState(35 + depth)
    q, kp, vp, pt = _pool(rng, b, pages, ps, hq, hkv, d)
    kl = np.asarray([64, 1, 33], np.int32)
    kq, ks = jq.quantize(jnp.asarray(kp), dtype=store,
                         scale_dtype=jq.SCALE_DTYPE)
    vq, vs = jq.quantize(jnp.asarray(vp), dtype=store,
                         scale_dtype=jq.SCALE_DTYPE)
    out = da.paged_decode_attention_quantized_pipelined(
        torch.from_numpy(q), *map(_t, (kq, ks, vq, vs, pt, kl)),
        num_buffers=depth)
    want = paged_decode_attention_fwd_quantized_pipelined(
        jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(pt), jnp.asarray(kl),
        num_buffers=depth, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------- routing

@pytest.fixture
def warm_db(monkeypatch):
    """Tuning mode on with an in-memory db (restored after)."""
    monkeypatch.setenv("REPRO_TUNING", "on")
    db = autotune_search.TuningDB()
    autotune_search.set_db(db)
    yield db
    autotune_search.reset_db()


def _record(db, kernel, config, **shape):
    spec = autotune_search.SPECS[kernel]
    db.record(kernel, autotune_search.backend_name("cpu"),
              spec.bucket_key(spec.bucket(**shape)), config)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_warm_db_routes_each_op_to_its_pipelined_kernel(warm_db, dtype):
    """Depth 2 in the db routes K1 -> K4 (bf16: the f32 forward has no
    ring), K2 -> K5, K3 -> K6 and K8 -> K9 (K7 and K10 have no ring); the
    same calls route to the classic kernels under REPRO_TUNING=off and
    with the db cold."""
    name = autotune_search.dtype_name(dtype)
    q = torch.zeros(1, 512, 16, 128, dtype=dtype)
    k = torch.zeros(1, 1024, 2, 128, dtype=dtype)
    qd = torch.zeros(8, 16, 128, dtype=dtype)
    kd = torch.zeros(8, 1024, 2, 128, dtype=dtype)
    pool = torch.zeros(513, 16, 2, 128, dtype=dtype)
    pool8 = torch.zeros(513, 16, 2, 128, dtype=torch.int8)
    pt = torch.zeros(8, 64, dtype=torch.int32)

    def routes():
        return (fa.route(q, k, k),
                da.route(qd, kd, kd),
                da.route(qd, pool, pool, page_table=pt),
                da.route(qd, pool8, pool8, page_table=pt, quantized=True),
                da.route(qd, kd.to(torch.int8), kd.to(torch.int8),
                         quantized=True))

    classic = routes()
    assert classic[0][:2] == (fa.flash_attention, 1)
    assert [r.wrapper for r in classic[1:]] == [
        da.decode_attention, da.paged_decode_attention,
        da.paged_decode_attention_quantized, da.decode_attention_quantized]
    assert all(r.num_buffers == 1 for r in classic[1:])

    _record(warm_db, "flash_attention", {"num_buffers": 2}, sq=512, skv=1024,
            d=128, dtype=name, causal=True)
    _record(warm_db, "decode_attention", {"num_splits": 8, "num_buffers": 2},
            s=1024, d=128, dtype=name, rows=16)
    _record(warm_db, "decode_attention", {"num_splits": 4, "num_buffers": 1},
            s=1024, d=128, dtype="int8", rows=16)
    for store in (name, "int8"):
        _record(warm_db, "paged_decode_attention", {"num_buffers": 2},
                s=1024, page_size=16, d=128, dtype=store, rows=16)
    before = autotune_search.measurement_count()
    k4, k5, k6, k9, k7 = routes()
    assert autotune_search.measurement_count() == before
    # f32 has no ring: its K1 stays at depth 1 whatever the db holds
    assert k4[:2] == ((fa.flash_attention_pipelined, 2)
                      if dtype == torch.bfloat16 else (fa.flash_attention, 1))
    assert (k5.wrapper, k5.num_splits, k5.num_buffers) == (
        da.decode_attention_pipelined, 8, 2)
    assert (k6.wrapper, k6.num_buffers) == (
        da.paged_decode_attention_pipelined, 2)
    assert (k9.wrapper, k9.num_buffers) == (
        da.paged_decode_attention_quantized_pipelined, 2)
    # the paged ops keep the classic split plan; K7 takes the db's split
    assert k6.num_splits == classic[2].num_splits
    assert (k7.wrapper, k7.num_splits, k7.num_buffers) == (
        da.decode_attention_quantized, 4, 1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNING", "off")
        assert routes()[0] == classic[0]
        assert [(r.wrapper, r.num_splits, r.num_buffers)
                for r in routes()[1:]] == [
            (r.wrapper, r.num_splits, r.num_buffers) for r in classic[1:]]


def test_routes_are_memoized_until_the_tuning_state_changes(warm_db,
                                                            monkeypatch):
    """A second call at the same shapes resolves without asking the db;
    a recorded winner, a new db view or another mode resolves afresh."""
    asked = []
    lookup = autotune_search.lookup_or_search

    def counted(kernel, **kw):
        asked.append(kernel)
        return lookup(kernel, **kw)

    monkeypatch.setattr(autotune_search, "lookup_or_search", counted)
    q = torch.zeros(3, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(3, 640, 2, 128, dtype=torch.bfloat16)
    qf = torch.zeros(1, 96, 16, 128, dtype=torch.bfloat16)
    kf = torch.zeros(1, 96, 2, 128, dtype=torch.bfloat16)
    first = da.route(q, k, k), fa.route(qf, kf, kf)
    assert len(asked) == 2
    assert (da.route(q, k, k), fa.route(qf, kf, kf)) == first
    assert len(asked) == 2
    _record(warm_db, "decode_attention", {"num_splits": 5, "num_buffers": 2},
            s=640, d=128, dtype="bfloat16", rows=6)
    plan = da.route(q, k, k)
    assert (plan.wrapper, plan.num_buffers) == (
        da.decode_attention_pipelined, 2) and len(asked) == 3
    autotune_search.set_db(autotune_search.TuningDB())
    assert da.route(q, k, k) == first[0] and len(asked) == 4
    monkeypatch.setenv("REPRO_TUNING", "off")
    assert da.route(q, k, k) == first[0] and len(asked) == 5
    assert fa.route(qf, kf, kf) == first[1] and len(asked) == 6


def test_routing_fits_the_depth_to_shared_memory():
    """A depth whose ring does not fit the 227 KB a block may use halves:
    MLA's absorbed decode (576, 512) takes depth 2 in bf16 (176 KB) and
    only depth 1 in f32; bf16 K4 at (192, 128) fits depth 4, and f32 K1
    (which has no ring) stays at depth 1."""
    for dtype, want in ((torch.bfloat16, 2), (torch.float32, 1)):
        q = torch.zeros(8, 16, 576, dtype=dtype)
        k = torch.zeros(8, 1024, 1, 576, dtype=dtype)
        v = torch.zeros(8, 1024, 1, 512, dtype=dtype)
        plan = da.route(q, k, v, num_buffers=4)
        assert plan.num_buffers == want
        assert plan.wrapper is (da.decode_attention_pipelined if want > 1
                                else da.decode_attention)
    q = torch.zeros(1, 488, 16, 192)
    assert fa.route(q, q, torch.zeros(1, 488, 16, 128), num_buffers=4) == (
        fa.flash_attention, 1, 16, 32)
    qb, vb = q.bfloat16(), torch.zeros(1, 488, 16, 128, dtype=torch.bfloat16)
    assert fa.route(qb, qb, vb, num_buffers=4) == (
        fa.flash_attention_pipelined, 4, 64, 64)


# (Dk, Dv) -> the bf16 tensor-core layout's (base, stage) and the f32
# CUDA-core layout's, in bytes, as csrc/flash_attention.cu lays them out
SMEM_LAYOUTS = {
    (16, 16): ((3_072, 6_144), (3_200, 4_608)),
    (128, 128): ((17_408, 34_816), (10_368, 33_280)),
    (192, 128): ((25_600, 43_008), (14_464, 41_472)),
    (24, 16): ((5_120, 8_192), (3_712, 5_632)),
}


@pytest.mark.parametrize("dk,dv", sorted(SMEM_LAYOUTS))
def test_pipelined_smem_has_a_layout_for_each_path(dk, dv):
    """bf16 K4 runs on the tensor cores: a 64-row query tile and 64-row
    K/V stages of raw bf16, each row padded by 16 bytes, Dk rounded up to
    16 (24 -> 32), and at another built tile its rows; f32 has no ring
    (its K1 runs at depth 1), so it has no layout.  The card tests hold
    the bf16 sizes to the library's own."""
    bf16, f32 = SMEM_LAYOUTS[(dk, dv)]
    assert fa.pipelined_smem(2, dk, dv) == bf16
    base, stage = bf16
    assert fa.pipelined_smem(2, dk, dv, block_q=16, block_k=32) == (
        base // 4, stage // 2)
    with pytest.raises(ValueError, match="ring"):
        fa.pipelined_smem(4, dk, dv)


def test_routing_fits_the_tensor_core_ring_to_shared_memory(monkeypatch):
    """Every bf16 pair fits depth 4 of the 64-row ring (MLA's (192, 128)
    takes 197,632 bytes of the 232,448); a smaller budget halves the
    depth until the ring fits, down to K1."""
    monkeypatch.setattr(fa, "_ROUTES", {})
    for dk, dv in fa.HEAD_DIM_PAIRS:
        q = torch.zeros(1, 64, 4, dk, dtype=torch.bfloat16)
        v = torch.zeros(1, 64, 4, dv, dtype=torch.bfloat16)
        base, stage = fa.pipelined_smem(2, dk, dv)
        assert base + 4 * stage <= 197_632
        assert fa.route(q, q, v, num_buffers=4)[:2] == (
            fa.flash_attention_pipelined, 4)
    q = torch.zeros(1, 512, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 1024, 2, 128, dtype=torch.bfloat16)
    for budget, want in ((156_672, 4), (156_671, 2), (87_039, 1)):
        monkeypatch.setattr(fa, "_ROUTES", {})
        monkeypatch.setattr(fa.autotune, "SMEM_BUDGET", budget)
        got = fa.route(q, k, k, num_buffers=4)
        assert got[:2] == ((fa.flash_attention_pipelined if want > 1
                            else fa.flash_attention), want)


# (Dk, Dv) -> the bf16 tensor-core decode layout's (base, stage) and the
# CUDA-core layout's for f32, in bytes, as csrc/decode_attention.cu lays
# them out (``DecodeMmaSmem`` and ``SplitRingSmem``)
DECODE_SMEM_LAYOUTS = {
    (16, 16): ((4_096, 6_656), (3_648, 4_864)),
    (128, 128): ((7_680, 35_328), (10_816, 33_536)),
    (576, 512): ((20_736, 70_912), (39_488, 140_032)),
    (40, 32): ((5_120, 12_800), (5_184, 9_984)),
}


@pytest.mark.parametrize("dk,dv", sorted(DECODE_SMEM_LAYOUTS))
def test_decode_pipelined_smem_has_a_layout_for_each_path(dk, dv):
    """bf16 K2 / K3 / K5 / K6 run on the tensor cores: a 16-row query
    tile, a [16, block_k] bf16 probability tile and stages of raw bf16
    K/V rows, 64 a stage (32 at (576, 512)), each row padded by 16 bytes,
    Dk rounded up to 16 (40 -> 48); f32 and the 1-byte caches keep the
    CUDA-core layout (32-row stages).  The card tests hold both to the
    library's own sizes."""
    bf16, f32 = DECODE_SMEM_LAYOUTS[(dk, dv)]
    assert da.pipelined_smem(2, dk, dv) == bf16
    assert da.pipelined_smem(4, dk, dv) == f32
    base, stage = bf16
    bk = 64 if dk + dv <= 256 else 32
    k_row, v_row = 2 * (-(-dk // 16) * 16 + 8), 2 * (dv + 8)
    assert stage == bk * (k_row + v_row + 8)
    assert base == 16 * k_row + 2 * 16 * (bk + 8) + 512 + 8 * bk


@pytest.mark.parametrize("dk,dv,want", [
    (128, 128, 4),      # 148,992 bytes at depth 4
    (576, 512, 2),      # 162,560 at depth 2; 304,384 at 4 does not fit
    (40, 32, 4),
])
def test_bf16_decode_depth_fits_the_tensor_core_ring(monkeypatch, dk, dv,
                                                     want):
    """The decode ops fit the depth to the tensor-core ring's real layout:
    depth 4 at the dense pairs; at MLA's (576, 512) depth 4 is refused
    (halved to 2); a smaller budget halves further, down to K2."""
    monkeypatch.setattr(da, "_ROUTES", {})
    q = torch.zeros(8, 16, dk, dtype=torch.bfloat16)
    k = torch.zeros(8, 1024, 1, dk, dtype=torch.bfloat16)
    v = torch.zeros(8, 1024, 1, dv, dtype=torch.bfloat16)
    base, stage = da.pipelined_smem(2, dk, dv)
    plan = da.route(q, k, v, num_buffers=4)
    assert plan.num_buffers == want
    assert base + want * stage <= 232_448
    assert want == 4 or base + 4 * stage > 232_448
    monkeypatch.setattr(da, "_ROUTES", {})
    monkeypatch.setattr(da.autotune, "SMEM_BUDGET", base + stage)
    plan = da.route(q, k, v, num_buffers=4)
    assert (plan.wrapper, plan.num_buffers) == (da.decode_attention, 1)


@pytest.mark.parametrize("dtype,store,want", [
    (torch.bfloat16, None, "mma"),
    (torch.float32, None, "cuda_cores"),
    (torch.bfloat16, torch.int8, "mma"),
    (torch.bfloat16, torch.float8_e4m3fn, "mma"),
    (torch.float32, torch.int8, "cuda_cores"),
])
def test_decode_ops_route_bf16_to_the_tensor_core_kernel(warm_db, dtype,
                                                         store, want):
    """A bf16 call of K2, K3, K5 or K6, and of K7, K8 or K9 over an int8
    or e4m3 cache, runs a tensor-core split kernel (the route names its
    path; K2 / K3 / K7 / K8 at depth 1, K5 / K6 / K9 at a db's depth 2, on
    the same wrappers as before); f32 queries, over an f32 or a 1-byte
    cache, stay on the CUDA cores."""
    name = autotune_search.dtype_name(store or dtype)
    qd = torch.zeros(8, 16, 128, dtype=dtype)
    kd = torch.zeros(8, 1024, 2, 128, dtype=store or dtype)
    pool = torch.zeros(513, 16, 2, 128, dtype=store or dtype)
    pt = torch.zeros(8, 64, dtype=torch.int32)
    quantized = store is not None
    assert da.path(qd, kd) == want

    def routes():
        return (da.route(qd, kd, kd, quantized=quantized),
                da.route(qd, pool, pool, page_table=pt, quantized=quantized))

    classic = routes()
    assert [r.path for r in classic] == [want, want]
    assert all(r.num_buffers == 1 for r in classic)
    _record(warm_db, "decode_attention", {"num_splits": 9, "num_buffers": 2},
            s=1024, d=128, dtype=name, rows=16)
    _record(warm_db, "paged_decode_attention", {"num_buffers": 2},
            s=1024, page_size=16, d=128, dtype=name, rows=16)
    ring = routes()
    assert [r.path for r in ring] == [want, want]
    wrappers = ((da.decode_attention_quantized,
                 da.paged_decode_attention_quantized_pipelined)
                if quantized else
                (da.decode_attention_pipelined,
                 da.paged_decode_attention_pipelined))
    assert [r.wrapper for r in ring] == list(wrappers)


@pytest.mark.parametrize("d", da.HEAD_DIMS)
def test_quantized_decode_rings_fit_at_every_head_dim(monkeypatch, d):
    """The 1-byte tensor-core layout (``QuantDecodeMmaSmem``: raw stages
    of 64 rows of d + 16 bytes of K and of V, the bf16 tile they become
    and its f32 scales beside K2's base) fits depths 2 and 4 within the
    227 KB a block may use at every head dim, so bf16 K9 keeps the depth
    asked for; f32 queries over the same pools keep the CUDA-core ring
    (``SplitRingSmem``)."""
    base, stage = da.pipelined_smem(1, d, d)
    assert (base, stage) == da.pipelined_smem(1, d, d, "mma")
    k_row = 2 * (d + 8)
    assert stage == 2 * 64 * (d + 16) + 8 * 64
    assert base == (16 * k_row + 2 * 16 * 72 + 512 + 8 * 64
                    + 64 * 2 * k_row + 2 * 4 * 64)
    assert base + 4 * stage <= 232_448
    assert da.pipelined_smem(1, d, d, "cuda_cores") == (
        4 * (16 * d + 16 * 32 + 16 + 2 * 32) + 8 * 32,
        32 * (2 * d + 16) + 8 * 32)
    pool = torch.zeros(33, 16, 2, d, dtype=torch.int8)
    pt = torch.zeros(8, 4, dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        monkeypatch.setattr(da, "_ROUTES", {})
        q = torch.zeros(8, 16, d, dtype=dtype)
        for depth in DEPTHS:
            plan = da.route(q, pool, pool, page_table=pt, quantized=True,
                            num_buffers=depth)
            assert (plan.wrapper, plan.num_buffers) == (
                da.paged_decode_attention_quantized_pipelined, depth)


@pytest.mark.parametrize("store", quant.quant_dtypes())
def test_quantized_decode_on_the_cpu_counts_no_launch(store):
    """K7, K8 and K9 on CPU tensors run their plain versions: no launch
    and no path is counted on their wrappers."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 4, 32).astype(np.float32)).to(
        torch.bfloat16)
    kv = torch.from_numpy(rng.randn(9, 8, 2, 32).astype(np.float32))
    kq, ks = quant.quantize(kv, dtype=store, scale_dtype=quant.SCALE_DTYPE)
    vq, vs = quant.quantize(kv * 2, dtype=store,
                            scale_dtype=quant.SCALE_DTYPE)
    pt = torch.tensor([[3, 1, 4], [5, 2, 6]], dtype=torch.int32)
    kl = torch.tensor([17, 5], dtype=torch.int32)
    wrappers = (da.decode_attention_quantized,
                da.paged_decode_attention_quantized,
                da.paged_decode_attention_quantized_pipelined)
    for fn in wrappers:
        fn.launches = 0
        fn.path_launches.clear()
    rows = [quant.as_bytes(t)[pt.long()].view(t.dtype).reshape(
        2, 24, *t.shape[2:]) for t in (kq, ks, vq, vs)]
    outs = (da.decode_attention_quantized(q, *rows, kl),
            da.paged_decode_attention_quantized(q, kq, ks, vq, vs, pt, kl),
            da.paged_decode_attention_quantized_pipelined(
                q, kq, ks, vq, vs, pt, kl, num_buffers=4))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert outs[0].shape == (2, 4, 32) and outs[0].dtype == torch.bfloat16
    assert [fn.launches for fn in wrappers] == [0, 0, 0]
    assert all(not fn.path_launches for fn in wrappers)
