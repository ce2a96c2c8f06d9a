"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the JAX package, so it runs on a machine that has
only the port's dependencies; there, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax.)  Tolerances,
absolute, on N(0, 1) inputs: f32 1e-4 (summation order only); bf16 2e-2
(both versions round their f32 result to bf16 once: one bf16 ulp).  The
quantized kernels (K7, K8, K10) are held to the same tolerances against
their plain versions (dequantize, then the float plain version) on the
same quantized inputs: the scale placement is exact arithmetic, so they
too differ in summation order and one final rounding only.  K3 must
equal K2, and K8 K7, on the gathered cache exactly: each pair shares one
split kernel.  K11 (flash backward) is held to its plain version with the
largest |difference| of each gradient relative to that gradient's largest
|value|: f32 1e-4 (summation order), bf16 1e-2 (both round an f32 result
to bf16 once: at most one bf16 ulp, 2^-8 of the value).  A reduced f32
train step on the card is held to the same step on the CPU: losses within
rtol 1e-4, and the params' change within 1e-3 of its own norm.  K12
(SSD scan) and K13 (its int8/fp8-x variant) are held to their plain
versions with the largest |difference| relative to the largest |value|:
y within 1e-5 in f32 (summation order) and 1e-2 in bf16 (one final bf16
rounding, at most 2^-7 of a value), the f32 final state within 1e-5; a
repeated call must give the same bits (no atomics).  K14 (grouped expert
matmul) and K15 (its int8/fp8-weight variant) likewise: the largest
|difference| relative to the largest |value|, 1e-5 in f32 (summation
order) and 1e-2 in bf16 (one final rounding, at most 2^-8 of a value);
K15 is held to K14 on the dequantized weights at the same tolerances
(the scale multiplies after the sum instead of before: f32 rounding).
bf16 at C > 32 runs on the tensor cores (f32 accumulators, another
summation order): the same bf16 tolerance.
K1 and K2 at MLA's (Dk, Dv) pairs keep the absolute tolerances above.
The pipelined kernels K4, K5, K6 and K9 must equal K1, K2, K3 and K8
exactly (out and lse; the same partials at the same split plan) at depths
2 and 4, under three page placements and with table entries past kv_len
out of the pool; gradients through K4 under autograd must equal K1's.
In bf16, K1, K4 and K11 run on the tensor cores (``mma.sync``, P and dS
rounded to bf16 as operands); the ``mma`` tests hold them to the same
tolerances at every (Dk, Dv) pair on ragged lengths, a per-row kv_len of
0, q_offset past kv_len, non-causal calls and rows that see no KV row
(out 0, lse <= -1e29), with K4 == K1 bit for bit at every depth.
Since then bf16 K12, K13 and K10 run on the tensor cores too; the
``mma_ssd`` tests hold K12 to its plain version at the same tolerances
(y 1e-2, state 1e-5) at every (P, N) on ragged, grouped, initial-state
and short shapes, bf16 K13 to bf16 K12 on the dequantized x rounded to
bf16 bit for bit, and the slice width to the same bits; the
``mma_flash_quant`` tests hold bf16 K10 to its plain version at 2e-2 on
K1's ragged cases at every head dim.  Then bf16 K7, K8, K9 and K15 at
C <= 32 moved to the tensor cores too; the ``mma_decode_quant`` tests
hold bf16 K7 to its plain version at 2e-2 at every head dim and group
size, int8 and e4m3, K8 == K7 on the gathered rows and K9 == K8 bit for
bit, and the ``mma_gmm_quant`` tests hold bf16 K15 on the weight stream
to its plain version and to K14 on the dequantized weights at 1e-2 of
the largest |value|.  The wrappers' ``path_launches`` name ``mma`` (or
``stream``) for bf16 and ``cuda_cores`` for f32.  The ``spec`` tests
hold the reduced bf16 model's ``verify_step`` to the per-position
``decode_step`` bit for bit (contiguous and paged, bf16 and int8
caches) and speculative serve to greedy serve bit for bit.  Head dim 80
(zamba2's shared attention block) is one more pair of every attention
kernel, K11 included: the parametrised tests above take it, and the ``d80``
tests hold K1, K2, K3, K7, K8 and K10 to their plain versions at 32
query heads on 32 KV heads (G = 1) in f32 and bf16 and serve the
reduced hybrid model at that head shape card against CPU.  The
``sampler`` test holds the temperature sampler's bits and uniforms on
the card to the CPU's bit for bit and its tokens equal; the
``temperature`` tests serve at temperature 0.8 card against CPU.
The ``calibrate`` tests hold the cost model's fit on the card to the same
fit on the CPU (the final loss within relative 1e-3, predictions within
1e-2, suggested blocks within 1); the ``remat`` test holds the reduced
bf16 model's loss and gradients under ``remat_policy="dots"`` to
``"full"``'s bit for bit (the same kernels on the same inputs) and
counts its projections as ``mm`` on the card.
K16 (the SSD backward) is held to its plain version (autograd of
``ssd_plain``) with the largest |difference| of each gradient relative to
its largest |value|: in f32 against the plain version run in f64 (the
exact gradient) within 1e-5 (on the CUDA cores), in bf16 against the
plain version on the same bf16 values within 1e-2 (on the tensor cores:
dx, dB and dC rounded to bf16 once, M, G o L and the weighted operands
rounded to bf16 where they enter a product); K11 likewise at head dim 80
and at the encoder-decoder and vision cross shapes (``BWD_TOL``); the
reduced SSM, hybrid, encoder-decoder and vision models' loss (rtol 1e-5)
and every gradient leaf (1e-3 of its largest |value|) on the card equal
the CPU's.
K17 (K14's backward: dx = dy w^T, dw = x^T dy) is held to its plain
version with ``GMM_TOL`` of each gradient's largest |value| (f32 on the
CUDA cores, bf16 on the tensor cores), repeated bit for bit, and its
autograd Function to autograd of K14's plain version; K11 at MLA's Dk !=
Dv pairs (192 / 128, 24 / 16) to its plain version with ``BWD_TOL``; the
reduced deepseek's loss, aux (rtol 1e-5) and every gradient leaf (1e-3
of its largest |value|) on the card to the CPU's.
The ``tuned`` tests hold every instance the autotuner picks among (bf16
K1 / K4's tiles at (128, 128) and every depth, K12 / K13's chunks, K14 /
K15's stream widths and wgmma heights and stage counts) to its plain
version at the tolerances above, check the bits the kernels' comments
claim (block_q and the depth; every K14 / K15 tile; K13 == K12 on the
rounded x at each chunk), hold the ops' instance lists to the libraries'
own, and check that an unbuilt tile or chunk raises before any launch.
The ``seq_decode`` tests hold K2's split kernel and its combine launched
apart (the sequence-sharded decode's entries) over 4 blocks of 256 cache
rows, laid side by side, to one K2 call at 4 x ns splits bit for bit
(qwen's tick shape and MLA's (576, 512), f32 and bf16, a row inside one
block and a row of length 0) and to the plain version at the tolerances
above; in a world of one NCCL rank, ``device_parallel_for`` on a (1,)
mesh equals ``torch.func.vmap`` exactly for every schedule, and the
sequence-sharded decode equals K2 bit for bit.
The ``wide_group`` tests hold K2, K3, K5-K9 and the partials entry at
query groups wider than a split block's 16 heads (G = 20, 32, 128: the
group split over blocks) to their plain versions at the tolerances
above, and to the same kernel on each 16-head slice of the group at the
same split count bit for bit; at G <= 16 the split count and the bits
are those of a call pinned to the classic count.
The ``seq_parallel`` tests cut a training sequence into 4 blocks and run
K1 and K11 on each block's queries over its K/V prefix: laid side by side,
out, lse and dq equal one whole call's bit for bit where the blocks start
on a query tile (within the tolerances above where they do not), dk and
dv summed over the blocks within ``BWD_TOL``; in a world of one NCCL
rank, 2 sequence-parallel steps of the reduced bf16 qwen and deepseek
equal the unsharded steps bit for bit.
Every test runs with ``REPRO_TUNING=off`` and ``REPRO_CALIBRATION=off``
(what the suite's conftest sets), unless it installs a db of its own, so
a tuning db or a calibration left in the checkout changes no choice.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import autotune_search
from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_ssd import ops as ss
from repro_torch.kernels.moe_gmm import ops as mg
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _hermetic_tuning(monkeypatch):
    monkeypatch.setenv("REPRO_TUNING", "off")
    monkeypatch.setenv("REPRO_CALIBRATION", "off")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,hq,hkv,d,kv_len,q_offset", [
    (8, 64, 4, 2, 16, 8, 0),          # bucket width 8 < the 16-row tile
    (16, 1024, 16, 2, 128, 16, 0),
    (40, 48, 8, 2, 64, None, None),   # Sq not a multiple of the tile
    (1, 48, 4, 2, 16, 9, 8),          # scalar-length decode of generate()
    (20, 64, 32, 8, 32, [64, 9], 0),  # per-row kv_len
    (37, 1024, 16, 2, 128, 293, 256),  # continuation prefill of a prefix hit
])
def test_flash_kernel_matches_plain(gen, dtype, sq, skv, hq, hkv, d, kv_len,
                                    q_offset):
    q = _randn(gen, dtype, 2, sq, hq, d)
    k = _randn(gen, dtype, 2, skv, hkv, d)
    v = _randn(gen, dtype, 2, skv, hkv, d)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, kv_len=kv_len, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_len=kv_len,
                                            q_offset=q_offset)
    assert _err(out, ref) <= TOL[dtype]
    assert _err(lse, ref_lse) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,kv_len,q_offset,causal,hq,hkv,d", [
    # seamless (16 on 16 heads of 64, G = 1): the encoder, the decoder's
    # self-attention at a 512-token prefill and at a generate() tick, the
    # cross-attention at a prefill and a tick
    (8, 128, 128, None, None, False, 16, 16, 64),
    (8, 512, 1024, 512, 0, True, 16, 16, 64),
    (8, 1, 1024, 513, 512, True, 16, 16, 64),
    (8, 512, 128, None, None, False, 16, 16, 64),
    (8, 1, 128, None, None, False, 16, 16, 64),
    # llama-vision (32 on 8 heads of 128, G = 4): the self blocks at the
    # same prefill and tick, the cross-attention over 1,601 patch rows
    (8, 512, 1024, 512, 0, True, 32, 8, 128),
    (8, 1, 1024, 513, 512, True, 32, 8, 128),
    (8, 512, 1601, None, None, False, 32, 8, 128),
    (8, 1, 1601, None, None, False, 32, 8, 128),
])
def test_flash_kernel_matches_plain_at_encdec_vlm_shapes(
        gen, dtype, b, sq, skv, kv_len, q_offset, causal, hq, hkv, d):
    """K1's calls in the encoder-decoder and vision families' prefills and
    ticks: G = 1 at D = 64, G = 4 at D = 128, a scalar kv_len over a
    1,024-row cache, a KV tail of one row past the last 64-row tile, a
    single query row against a whole cache."""
    q = _randn(gen, dtype, b, sq, hq, d)
    k = _randn(gen, dtype, b, skv, hkv, d)
    v = _randn(gen, dtype, b, skv, hkv, d)
    before = fa.flash_attention.path_launches[fa.path(q)]
    out, lse = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                  q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.path_launches[fa.path(q)] == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            kv_len=kv_len, q_offset=q_offset)
    assert _err(out, ref) <= TOL[dtype]
    assert _err(lse, ref_lse) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len", [
    (8, 1024, 16, 2, 128, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (4, 48, 4, 2, 16, [1, 48, 60, 7]),
    (3, 300, 32, 8, 64, [0, 299, 150]),
])
def test_decode_kernel_matches_plain(gen, dtype, b, s, hq, hkv, d, kv_len):
    q = _randn(gen, dtype, b, hq, d)
    k = _randn(gen, dtype, b, s, hkv, d)
    v = _randn(gen, dtype, b, s, hkv, d)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, kl)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert _err(out, da.decode_attention_plain(q, k, v, kl)) <= TOL[dtype]


def _pool_of(gen, dtype, b, pages, ps, hkv, d, kv_len):
    """A pool of b * pages + 1 pages (page 0 scratch) whose pages are placed
    by a seeded permutation; row 0's table is all scratch."""
    n_pool = b * pages + 1
    perm = torch.randperm(n_pool - 1, generator=torch.Generator().manual_seed(
        b + pages)) + 1
    pt = perm.reshape(b, pages).to(torch.int32)
    pt[0] = 0
    k_pool = _randn(gen, dtype, n_pool, ps, hkv, d)
    v_pool = _randn(gen, dtype, n_pool, ps, hkv, d)
    return (k_pool, v_pool, pt.cuda(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,pages,ps,hq,hkv,d,kv_len", [
    (8, 64, 16, 16, 2, 128, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (4, 6, 8, 4, 2, 16, [3, 48, 60, 17]),        # P * ps not a multiple of 32
    (3, 10, 32, 32, 8, 64, [0, 320, 150]),
])
def test_paged_decode_kernel_matches_plain_and_k2(gen, dtype, b, pages, ps,
                                                  hq, hkv, d, kv_len):
    """K3 against its plain version, and K3 on the pool equal bit for bit
    to K2 on the same rows gathered to a contiguous cache."""
    q = _randn(gen, dtype, b, hq, d)
    k_pool, v_pool, pt, kl = _pool_of(gen, dtype, b, pages, ps, hkv, d,
                                      kv_len)
    before = da.paged_decode_attention.launches
    out = da.paged_decode_attention(q, k_pool, v_pool, pt, kl)
    torch.cuda.synchronize()
    assert da.paged_decode_attention.launches == before + 1
    want = da.paged_decode_attention_plain(q, k_pool, v_pool, pt, kl)
    assert _err(out, want) <= TOL[dtype]
    k = k_pool[pt.long()].reshape(b, pages * ps, hkv, d)
    v = v_pool[pt.long()].reshape(b, pages * ps, hkv, d)
    assert torch.equal(out, da.decode_attention(q, k, v, kl))


QDTYPES = [getattr(torch, name) for name in quant.quant_dtypes()]


def _quantized(x, store):
    return quant.quantize(x, dtype=store, scale_dtype=quant.SCALE_DTYPE)


def _gather(pool, pt):
    """A pool's rows gathered through the page table to [B, P * ps, ...]
    (fp8 as bytes)."""
    b, pages = pt.shape
    got = quant.as_bytes(pool)[pt.long()].view(pool.dtype)
    return got.reshape(b, pages * pool.shape[1], *pool.shape[2:])


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,hq,hkv,d,kv_len,q_offset", [
    (512, 1024, 16, 2, 128, 512, 0),   # the serve prefill at width 512
    (16, 1024, 16, 2, 128, 9, 0),      # bucket width 16, a 9-token prompt
    (40, 48, 8, 2, 64, None, None),    # suffix alignment, ragged tile
    (1, 48, 4, 2, 16, 9, 8),           # scalar-length decode of generate()
    (20, 64, 32, 8, 32, [64, 9], 0),   # per-row kv_len
    (37, 1024, 16, 2, 128, 293, 256),  # continuation prefill of a prefix hit
])
def test_quantized_flash_kernel_matches_plain(gen, store, dtype, sq, skv, hq,
                                              hkv, d, kv_len, q_offset):
    """K10 against its plain version, with K1's kv_len and q_offset."""
    b = 1 if sq == 512 else 2
    q = _randn(gen, dtype, b, sq, hq, d)
    kq, ks = _quantized(_randn(gen, dtype, b, skv, hkv, d), store)
    vq, vs = _quantized(_randn(gen, dtype, b, skv, hkv, d), store)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = fa.flash_attention_quantized.launches
    out, lse = fa.flash_attention_quantized(q, kq, ks, vq, vs, kv_len=kv_len,
                                            q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_quantized.launches == before + 1
    ref, ref_lse = fa.flash_attention_quantized_plain(
        q, kq, ks, vq, vs, kv_len=kv_len, q_offset=q_offset)
    assert _err(out, ref) <= TOL[dtype]
    assert _err(lse, ref_lse) <= 1e-3


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,pages,ps,hq,hkv,d,kv_len", [
    (8, 64, 16, 16, 2, 128, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (4, 6, 8, 4, 2, 16, [3, 48, 60, 17]),        # P * ps not a multiple of 32
    (3, 10, 32, 32, 8, 64, [0, 320, 150]),
])
def test_quantized_decode_kernels_match_plain_and_each_other(
        gen, store, dtype, b, pages, ps, hq, hkv, d, kv_len):
    """K8 and K7 against their plain versions, and K8 on the pool equal
    bit for bit to K7 on the same rows (values and scales) gathered to a
    contiguous cache."""
    q = _randn(gen, dtype, b, hq, d)
    k_pool, v_pool, pt, kl = _pool_of(gen, dtype, b, pages, ps, hkv, d,
                                      kv_len)
    kq, ks = _quantized(k_pool, store)
    vq, vs = _quantized(v_pool, store)
    before = (da.paged_decode_attention_quantized.launches,
              da.decode_attention_quantized.launches)
    out = da.paged_decode_attention_quantized(q, kq, ks, vq, vs, pt, kl)
    rows = [_gather(t, pt) for t in (kq, ks, vq, vs)]
    k7 = da.decode_attention_quantized(q, *rows, kl)
    torch.cuda.synchronize()
    assert (da.paged_decode_attention_quantized.launches,
            da.decode_attention_quantized.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = da.paged_decode_attention_quantized_plain(q, kq, ks, vq, vs, pt,
                                                     kl)
    assert _err(out, want) <= TOL[dtype]
    assert _err(k7, da.decode_attention_quantized_plain(q, *rows, kl)) \
        <= TOL[dtype]
    assert torch.equal(out, k7)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = _randn(gen, torch.bfloat16, 1, 8, 4, 16)
    k = _randn(gen, torch.float32, 1, 16, 2, 16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k, k)
    q48 = _randn(gen, torch.float32, 1, 8, 4, 48)
    k48 = _randn(gen, torch.float32, 1, 16, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q48, k48, k48)
    kt = _randn(gen, torch.float32, 1, 2, 16, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(_randn(gen, torch.float32, 1, 8, 4, 16), kt, kt)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q[:, 0].float().contiguous(), k, k,
                            torch.tensor([3], device="cuda"))
    pool = _randn(gen, torch.float32, 5, 8, 2, 16)
    kl = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="page_table"):
        da.paged_decode_attention(q[:, 0].float().contiguous(), pool, pool,
                                  torch.zeros((1, 2), dtype=torch.long,
                                              device="cuda"), kl)
    kq, ks = _quantized(k, torch.int8)
    with pytest.raises(ValueError, match="storage dtype"):
        da.decode_attention_quantized(q[:, 0].float().contiguous(), k, ks,
                                      k, ks, kl)
    with pytest.raises(ValueError, match="scales"):
        fa.flash_attention_quantized(q.float(), kq, ks.float(), kq, ks)


def test_reduced_serve_on_card_equals_plain_path(gen):
    """The reduced f32 qwen2.5-3b served through the kernels gives the
    tokens the CPU serve (plain versions) gives, from the same weights."""
    cfg = get_config("qwen2.5-3b").reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    params_card = to_card(params)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 8)]
    scfg = ServeConfig(max_len=64, slots=3, refill_schedule="faa")
    want = Engine(cpu, params, scfg).serve(prompts, 10)
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    got = Engine(card, params_card, scfg).serve(prompts, 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert fa.flash_attention.launches > before[0]
    assert da.decode_attention.launches > before[1]


def test_reduced_paged_serve_on_card_equals_plain_path(gen):
    """Paged serve (prefix reuse on, a shared prefix, page pressure) of the
    reduced f32 qwen2.5-3b through K1 and K3 gives the CPU's tokens."""
    cfg = get_config("qwen2.5-3b").reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)
    params_card = _to_card(params)
    rng = np.random.RandomState(1)
    shared = rng.randint(1, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, cfg.vocab_size, n)])
               .astype(np.int32) for n in rng.randint(1, 30, 8)]
    scfg = ServeConfig(max_len=64, slots=3, refill_schedule="faa",
                       cache="paged", page_size=8, num_pages=14)
    want_eng = Engine(cpu, params, scfg)
    want = want_eng.serve(prompts, 10)
    before = (fa.flash_attention.launches, da.paged_decode_attention.launches,
              da.decode_attention.launches)
    eng = Engine(card, params_card, scfg)
    got = eng.serve(prompts, 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    rep = eng.last_report
    assert rep.prefix_hits == want_eng.last_report.prefix_hits > 0
    assert rep.deferred_admissions == want_eng.last_report.deferred_admissions
    assert fa.flash_attention.launches > before[0]
    assert da.paged_decode_attention.launches > before[1]
    assert da.decode_attention.launches == before[2]


@pytest.mark.parametrize("kv_dtype", quant.quant_dtypes())
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_reduced_quantized_serve_on_card_equals_plain_path(gen, cache,
                                                           kv_dtype):
    """Quantized-KV serve of the reduced f32 qwen2.5-3b through K10 and K7
    (or K8) gives the CPU's tokens, and reads the quantized cache through
    no float kernel."""
    cfg = get_config("qwen2.5-3b").reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 8)]
    kw = dict(max_len=64, slots=3, refill_schedule="faa", kv_dtype=kv_dtype)
    if cache == "paged":
        kw.update(cache="paged", page_size=8)
    want = Engine(cpu, params, ServeConfig(**kw)).serve(prompts, 10)
    counters = (fa.flash_attention, da.decode_attention,
                da.paged_decode_attention, fa.flash_attention_quantized,
                da.decode_attention_quantized,
                da.paged_decode_attention_quantized)
    before = [c.launches for c in counters]
    got = Engine(card, _to_card(params), ServeConfig(**kw)).serve(prompts, 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    grew = [c.launches > n for c, n in zip(counters, before)]
    assert grew == [False, False, False, True, cache == "contiguous",
                    cache == "paged"]


def _to_card(tree):
    return {k: _to_card(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


# ----------------------------------------------------------------- K11

BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rel(a, b):
    return _err(a, b) / b.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 256, 256, 16, 2, 128, True),     # the training shape, cut in S
    (1, 100, 100, 8, 8, 64, True),       # G = 1, S not a multiple of a tile
    (2, 40, 72, 8, 2, 32, False),        # not causal, Sq < Skv
    (1, 37, 90, 4, 1, 16, True),         # MQA, suffix alignment, ragged
])
def test_flash_bwd_kernel_matches_plain(gen, dtype, b, sq, skv, hq, hkv, d,
                                        causal):
    q = _randn(gen, dtype, b, sq, hq, d)
    k = _randn(gen, dtype, b, skv, hkv, d)
    v = _randn(gen, dtype, b, skv, hkv, d)
    do = _randn(gen, dtype, b, sq, hq, d)
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, w) <= BWD_TOL[dtype]
    # the same inputs give the same gradients, bit for bit (no atomics)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_grads_match_plain_autograd(gen, causal):
    """FlashAttentionFunction (K1 forward, K11 backward) against autograd
    through K1's plain version, f32, with a strided incoming gradient."""
    shapes = ((2, 48, 8, 64), (2, 48, 2, 64), (2, 48, 2, 64))
    ins = [_randn(gen, torch.float32, *s) for s in shapes]
    do = _randn(gen, torch.float32, 2, 8, 48, 64).transpose(1, 2)
    grads = []
    for fn in (fa.flash_attention_autograd,
               lambda q, k, v, causal: fa.flash_attention_plain(
                   q, k, v, causal=causal)[0]):
        leaves = [t.clone().requires_grad_() for t in ins]
        fn(*leaves, causal=causal).backward(do)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert _rel(g, w) <= BWD_TOL[torch.float32]


def test_flash_bwd_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q = _randn(gen, torch.float32, 1, 8, 4, 16)
    k = _randn(gen, torch.float32, 1, 8, 2, 16)
    out, lse = fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_bwd(q.half(), k.half(), k.half(), out.half(), lse,
                               q.half())
    q48, k48 = (_randn(gen, torch.float32, 1, 8, h, 48) for h in (4, 2))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q48, k48, k48, q48, lse, q48)
    strided = _randn(gen, torch.float32, 1, 4, 8, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, k, k, out, lse, strided)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, k, out, lse.transpose(1, 2), q)


def test_reduced_train_step_on_card_equals_cpu(gen):
    """Three steps of the reduced f32 qwen2.5-3b (microbatches 2) on the
    card, through K1 and K11, against the same steps on the CPU."""
    cfg = get_config("qwen2.5-3b").reduced()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for device in ("cpu", "cuda"):
        model = Model(cfg, device=device)
        params = _to_device(Model(cfg, device="cpu").init(0), device)
        state = opt.init_state(params, ocfg)
        step = make_train_step(model, ocfg, microbatches=2)
        rng = np.random.RandomState(3)
        before = fa.flash_attention_bwd.launches
        losses = []
        for _ in range(3):
            toks = torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(device)
            params, state, met = step(params, state, {"tokens": toks})
            losses.append(met["loss"].item())
        launched = fa.flash_attention_bwd.launches - before
        runs.append((losses, _to_device(params, "cpu"), launched))
    (cpu_loss, cpu_p, cpu_n), (card_loss, card_p, card_n) = runs
    assert cpu_n == 0 and card_n == 3 * 2 * cfg.n_layers
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-4)
    init = Model(cfg, device="cpu").init(0)
    diff, moved = _tree_dist(card_p, cpu_p), _tree_dist(cpu_p, init)
    assert diff <= 1e-3 * moved


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _tree_dist(a, b):
    total = 0.0
    for k in a:
        if isinstance(a[k], dict):
            total += _tree_dist(a[k], b[k]) ** 2
        else:
            total += (a[k].float() - b[k].float()).pow(2).sum().item()
    return total ** 0.5


# ------------------------------------------------------------ K12, K13

SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SSD_STATE_TOL = 1e-5


def _ssd_inputs(gen, dtype, b, s, h, p, g, n):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1)), a =
    -exp(N(0, 1)) in f32."""
    dt = torch.nn.functional.softplus(_randn(gen, torch.float32, b, s, h))
    a = -torch.exp(_randn(gen, torch.float32, h))
    return (_randn(gen, dtype, b, s, h, p), dt, a,
            _randn(gen, dtype, b, s, g, n), _randn(gen, dtype, b, s, g, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,with_state", [
    (1, 488, 48, 64, 1, 128, False),   # ragged: 7 chunks and 40 rows
    (2, 100, 16, 32, 2, 64, False),    # two groups
    (2, 70, 8, 16, 1, 16, True),       # an initial state, reduced widths
    (1, 5, 4, 64, 4, 128, True),       # shorter than a chunk, G = H
])
def test_ssd_kernel_matches_plain_and_repeats(gen, dtype, b, s, h, p, g, n,
                                              with_state):
    ins = _ssd_inputs(gen, dtype, b, s, h, p, g, n)
    init = _randn(gen, torch.float32, b, h, p, n) if with_state else None
    before = ss.ssd.launches
    y, st = ss.ssd(*ins, initial_state=init)
    y2, st2 = ss.ssd(*ins, initial_state=init)
    torch.cuda.synchronize()
    assert ss.ssd.launches == before + 2
    want_y, want_st = ss.ssd_plain(*ins, initial_state=init)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert _rel(y, want_y) <= SSD_TOL[dtype]
    assert _rel(st, want_st) <= SSD_STATE_TOL
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_quantized_kernel_matches_plain(gen, store, dtype):
    x, dt, a, b_in, c_in = _ssd_inputs(gen, dtype, 2, 150, 8, 64, 2, 128)
    xq, xs = _quantized(x, store)
    before = ss.ssd_quantized.launches
    y, st = ss.ssd_quantized(xq, xs, dt, a, b_in, c_in)
    torch.cuda.synchronize()
    assert ss.ssd_quantized.launches == before + 1
    want_y, want_st = ss.ssd_quantized_plain(xq, xs, dt, a, b_in, c_in)
    assert y.dtype == dtype
    assert _rel(y, want_y) <= SSD_TOL[dtype]
    assert _rel(st, want_st) <= SSD_STATE_TOL
    if dtype == torch.float32:
        # the same kernel as K12 on the dequantized x
        y12, st12 = ss.ssd(quant.dequantize(xq, xs), dt, a, b_in, c_in)
        assert _rel(y, y12) <= SSD_TOL[dtype]
        assert _rel(st, st12) <= SSD_STATE_TOL


def test_ssd_wrappers_reject_what_the_kernel_does_not_take(gen):
    x, dt, a, b_in, c_in = _ssd_inputs(gen, torch.float32, 1, 8, 4, 16, 1,
                                       16)
    with pytest.raises(ValueError, match="chunks of 64"):
        ss.ssd(x, dt, a, b_in, c_in, chunk=32)
    with pytest.raises(ValueError, match="share a dtype"):
        ss.ssd(x, dt, a, b_in.bfloat16(), c_in)
    with pytest.raises(ValueError, match="float32"):
        ss.ssd(x, dt.bfloat16(), a, b_in, c_in)
    x8 = _randn(gen, torch.float32, 1, 8, 8, 8)
    with pytest.raises(ValueError, match="head dim"):
        ss.ssd(x8, dt.repeat(1, 1, 2), a.repeat(2), b_in, c_in)
    with pytest.raises(ValueError, match="state dim"):
        b32 = _randn(gen, torch.float32, 1, 8, 1, 32)
        ss.ssd(x, dt, a, b32, b32)
    xt = _randn(gen, torch.float32, 1, 4, 8, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd(xt, dt, a, b_in, c_in)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.ssd(x, dt, a.cpu(), b_in, c_in)
    with pytest.raises(ValueError, match="initial_state"):
        ss.ssd(x, dt, a, b_in, c_in,
               initial_state=_randn(gen, torch.float32, 1, 4, 16, 8))
    xq, xs = _quantized(x, torch.int8)
    with pytest.raises(ValueError, match="x_scale"):
        ss.ssd_quantized(xq, xs.float(), dt, a, b_in, c_in)
    with pytest.raises(ValueError, match="x must be one of"):
        ss.ssd_quantized(x, xs, dt, a, b_in, c_in)


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_reduced_ssm_serve_on_card_equals_plain_path(gen, cache):
    """The reduced f32 mamba2-780m served through K12 gives the tokens the
    CPU serve (the plain scan) gives, at lengths past one chunk and a
    one-token prompt; K12 runs once per layer and multi-token prompt, and
    the paged backend allocates no page."""
    cfg = get_config("mamba2-780m").reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (1, 9, 64, 100, 130, 3)]
    scfg = ServeConfig(max_len=160, slots=3, refill_schedule="faa",
                       cache=cache, page_size=16)
    want = Engine(cpu, params, scfg).serve(prompts, 10)
    before = (ss.ssd.launches, fa.flash_attention.launches)
    eng = Engine(card, _to_card(params), scfg)
    got = eng.serve(prompts, 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert ss.ssd.launches - before[0] == cfg.n_layers * 5
    assert fa.flash_attention.launches == before[1]
    assert eng.last_report.pages_allocated == 0


# ------------------------------------------------------ K14, K15 (MoE)

GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
GMM_SHAPES = [
    (4, 8, 64, 32),          # the reduced model's gate / up product
    (64, 8, 2048, 1408),     # decode (8 slots): gate / up
    (64, 8, 1408, 2048),     # decode: down
    (64, 64, 2048, 1408),    # a 488-token prefill (capacity 64)
    (3, 24, 72, 40),         # ragged: C, d and f past no tile
    (2, 130, 48, 37),        # three 64-row tiles; f not 16-byte wide
    (2, 40, 36, 24),         # one ragged 64-row tile; d not 16-byte wide
]


def _rel(a, b):
    return _err(a, b) / max(b.float().abs().max().item(), 1e-30)


def _gmm_inputs(gen, dtype, e, c, d, f):
    x = _randn(gen, dtype, e, c, d)
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         / d ** 0.5).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_gmm_kernel_matches_plain_and_repeats(gen, dtype, e, c, d, f):
    x, w = _gmm_inputs(gen, dtype, e, c, d, f)
    before = mg.grouped_matmul.launches
    out = mg.grouped_matmul(x, w)
    again = mg.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert mg.grouped_matmul.launches == before + 2
    assert out.dtype == dtype and out.shape == (e, c, f)
    assert _rel(out, mg.grouped_matmul_plain(x, w)) <= GMM_TOL[dtype]
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("e,c,d,f", [GMM_SHAPES[1], GMM_SHAPES[3],
                                     GMM_SHAPES[4], GMM_SHAPES[5]])
def test_gmm_quantized_kernel_matches_plain_and_k14(gen, dtype, store, e, c,
                                                    d, f):
    x, w = _gmm_inputs(gen, torch.float32, e, c, d, f)
    x = x.to(dtype)
    w_q, w_scale = mg.quantize_expert_weights(w, dtype=store)
    before = mg.grouped_matmul_quantized.launches
    out = mg.grouped_matmul_quantized(x, w_q, w_scale)
    again = mg.grouped_matmul_quantized(x, w_q, w_scale)
    torch.cuda.synchronize()
    assert mg.grouped_matmul_quantized.launches == before + 2
    want = mg.grouped_matmul_quantized_plain(x, w_q, w_scale)
    assert _rel(out, want) <= GMM_TOL[dtype]
    assert torch.equal(out, again)
    k14 = mg.grouped_matmul(x, quant.dequantize(w_q, w_scale).to(dtype))
    assert _rel(out, k14) <= GMM_TOL[dtype]


def test_gmm_wrappers_reject_what_the_kernels_do_not_take(gen):
    x, w = _gmm_inputs(gen, torch.float32, 2, 8, 16, 8)
    with pytest.raises(ValueError, match="dtype"):
        mg.grouped_matmul(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        mg.grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match=r"\[E, d, f\]"):
        mg.grouped_matmul(x, w[:, :8])
    w_q, w_scale = mg.quantize_expert_weights(w)
    with pytest.raises(ValueError, match="w_scale"):
        mg.grouped_matmul_quantized(x, w_q, w_scale.half())
    with pytest.raises(ValueError, match="storage dtype"):
        mg.grouped_matmul_quantized(x, w, w_scale)


# ------------------------------------------- K1, K2, K3 at MLA's shapes

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,dk,dv,kv_len,q_offset", [
    (1, 488, 488, 16, 192, 128, None, None),   # full-width MLA prefill
    (2, 37, 64, 4, 24, 16, [37, 20], 0),       # reduced, per-row kv_len
    (1, 9, 16, 4, 24, 16, 9, 0),               # reduced, a short prompt
])
def test_flash_kernel_at_mla_pairs_matches_plain(gen, dtype, b, sq, skv, h,
                                                 dk, dv, kv_len, q_offset):
    q = _randn(gen, dtype, b, sq, h, dk)
    k = _randn(gen, dtype, b, skv, h, dk)
    v = _randn(gen, dtype, b, skv, h, dv)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = fa.flash_attention(q, k, v, kv_len=kv_len, q_offset=q_offset)
    torch.cuda.synchronize()
    assert out.shape == (b, sq, h, dv)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_len=kv_len,
                                            q_offset=q_offset)
    assert _err(out, ref) <= TOL[dtype]
    assert _err(lse, ref_lse) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,g,dk,dv,kv_len", [
    (8, 1024, 16, 576, 512, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (3, 40, 4, 40, 32, [1, 40, 17]),
])
def test_decode_kernels_at_mla_pairs_match_plain_and_each_other(
        gen, dtype, b, s, g, dk, dv, kv_len):
    """K2 at the absorbed decode's pairs (one latent KV head, V the first
    Dv columns of K, as MLA reads its cache) against its plain version,
    and K3 on a paged copy of the same rows equal to K2 bit for bit."""
    q = _randn(gen, dtype, b, g, dk)
    k = _randn(gen, dtype, b, s, 1, dk)
    v = k[..., :dv].contiguous()
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out = da.decode_attention(q, k, v, kl)
    torch.cuda.synchronize()
    assert out.shape == (b, g, dv)
    assert _err(out, da.decode_attention_plain(q, k, v, kl)) <= TOL[dtype]
    ps = 8
    pages = -(-s // ps)
    pad = pages * ps - s
    k_pad = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v_pad = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    pt = (torch.arange(b * pages, device="cuda", dtype=torch.int32)
          .reshape(b, pages) + 1)
    k_pool = torch.cat([k_pad.new_zeros((1, ps, 1, dk)),
                        k_pad.reshape(b * pages, ps, 1, dk)])
    v_pool = torch.cat([v_pad.new_zeros((1, ps, 1, dv)),
                        v_pad.reshape(b * pages, ps, 1, dv)])
    paged = da.paged_decode_attention(q, k_pool, v_pool, pt, kl)
    assert torch.equal(paged, da.decode_attention(q, k_pad, v_pad, kl))


def test_attention_wrappers_reject_unbuilt_pairs(gen):
    q = _randn(gen, torch.float32, 1, 8, 4, 192)
    k = _randn(gen, torch.float32, 1, 8, 4, 192)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, _randn(gen, torch.float32, 1, 8, 4, 64))
    kl = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q[:, 0].contiguous(), k, k[..., :128]
                            .contiguous(), kl)
    # a q that starts 4 bytes past an aligned address (the kernels read
    # q, k and v 16 bytes a load)
    flat = _randn(gen, torch.float32, 8 * 4 * 128 + 1)
    q_off = flat[1:].view(1, 8, 4, 128)
    k128 = _randn(gen, torch.float32, 1, 8, 4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q_off, k128, k128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.decode_attention(q_off[:, 0], k128, k128, kl)
    # any group size is taken (a group wider than a block is split over
    # blocks), but not a head count that is no multiple of the KV heads
    q35 = _randn(gen, torch.float32, 1, 35, 40)
    k1 = _randn(gen, torch.float32, 1, 8, 2, 40)
    with pytest.raises(ValueError, match="incompatible shapes"):
        da.decode_attention(q35, k1, k1[..., :32].contiguous(), kl)


def test_reduced_moe_on_card_equals_cpu(gen):
    """The reduced f32 deepseek-v2-lite-16b on the card (K1, K2 at the MLA
    pairs, K14) against the CPU (plain versions): prefill and decode
    logits within 1e-4, greedy serve tokens equal, K14 launched three
    times per MoE layer of every forward."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)
    params_card = _to_card(params)
    toks = np.random.RandomState(3).randint(1, cfg.vocab_size, (2, 24))
    n_moe = cfg.n_layers - cfg.first_dense_layers
    before = mg.grouped_matmul.launches
    want, cache = cpu.prefill(params, {"tokens": toks}, 64, torch.float32)
    got, cache_card = card.prefill(params_card, {"tokens": toks}, 64,
                                   torch.float32)
    assert mg.grouped_matmul.launches - before == 3 * n_moe
    assert _err(got.cpu(), want) <= 1e-4
    for step in range(3):
        nxt = np.random.RandomState(step).randint(1, cfg.vocab_size, (2, 1))
        want, cache = cpu.decode_step(params, nxt, cache)
        got, cache_card = card.decode_step(params_card, nxt, cache_card)
        assert _err(got.cpu(), want) <= 1e-4
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (1, 9, 30, 17, 5)]
    scfg = ServeConfig(max_len=64, slots=3, refill_schedule="faa")
    want = Engine(cpu, params, scfg).serve(prompts, 8)
    before = (mg.grouped_matmul.launches, da.decode_attention.launches)
    got = Engine(card, params_card, scfg).serve(prompts, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert mg.grouped_matmul.launches > before[0]
    assert da.decode_attention.launches > before[1]


# ------------------------------------------------- K4, K5, K6 and K9

DEPTHS = [2, 4]


class _PinnedDB(autotune_search.TuningDB):
    """A db whose every bucket holds ring depth ``depth`` (the split
    count left at the analytic pick)."""

    def __init__(self, depth):
        super().__init__()
        self.depth = depth

    def lookup(self, kernel, backend, bucket):
        return {"num_buffers": self.depth}


@pytest.fixture
def pinned(monkeypatch):
    """Install a db pinned to a depth, tuning mode on; restored after."""
    def install(depth):
        monkeypatch.setenv("REPRO_TUNING", "on")
        autotune_search.set_db(_PinnedDB(depth))

    yield install
    autotune_search.reset_db()


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dk,dv,kv_len,q_offset", [
    (1, 512, 1024, 16, 2, 128, 128, 512, 0),     # the serve prefill
    (1, 512, 1024, 16, 2, 128, 128, None, None),  # suffix alignment
    (1, 37, 1024, 16, 2, 128, 128, 293, 256),    # a prefix hit
    (2, 40, 64, 32, 8, 32, 32, [64, 9], 0),      # per-row kv_len
    (1, 8, 64, 4, 2, 16, 16, 8, 0),              # the reduced widths
    (1, 488, 488, 16, 16, 192, 128, None, None),  # MLA's prefill
    (2, 24, 24, 4, 4, 24, 16, None, None),       # reduced MLA
])
def test_pipelined_flash_equals_k1(gen, depth, dtype, b, sq, skv, hq, hkv,
                                   dk, dv, kv_len, q_offset):
    """bf16 K4 at depth 2 and 4: out and lse equal K1's bit for bit (and
    so its plain version's within the tolerance).  f32 has no ring: K4
    raises, and K1 asked for a depth runs at depth 1."""
    q = _randn(gen, dtype, b, sq, hq, dk)
    k = _randn(gen, dtype, b, skv, hkv, dk)
    v = _randn(gen, dtype, b, skv, hkv, dv)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = (fa.flash_attention.launches,
              fa.flash_attention_pipelined.launches)
    base = fa.flash_attention(q, k, v, kv_len=kv_len, q_offset=q_offset)
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="no ring"):
            fa.flash_attention_pipelined(q, k, v, kv_len=kv_len,
                                         q_offset=q_offset,
                                         num_buffers=depth)
        got = fa.flash_attention(q, k, v, kv_len=kv_len, q_offset=q_offset,
                                 num_buffers=depth)
        after = (before[0] + 2, before[1])
    else:
        got = fa.flash_attention_pipelined(q, k, v, kv_len=kv_len,
                                           q_offset=q_offset,
                                           num_buffers=depth)
        after = (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches,
            fa.flash_attention_pipelined.launches) == after
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    want = fa.flash_attention_plain(q, k, v, kv_len=kv_len, q_offset=q_offset)
    assert _err(got[0], want[0]) <= TOL[dtype]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,dk,dv,kv_len", [
    (8, 1024, 16, 2, 128, 128, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (4, 48, 4, 2, 16, 16, [1, 48, 60, 7]),
    (3, 300, 32, 8, 64, 64, [0, 299, 150]),
    (8, 1024, 16, 1, 576, 512, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (3, 40, 4, 1, 40, 32, [1, 40, 17]),
])
def test_pipelined_decode_equals_k2(gen, depth, dtype, b, s, hq, hkv, dk,
                                    dv, kv_len):
    """The decode op at ring depth 2 and 4 (fitted to the block's shared
    memory: MLA's (576, 512) takes depth 2 in bf16 and none in f32) runs
    K5 and gives K2's output bit for bit at the same split plan."""
    q = _randn(gen, dtype, b, hq, dk)
    k = _randn(gen, dtype, b, s, hkv, dk)
    v = _randn(gen, dtype, b, s, hkv, dv)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    plan = da.route(q, k, v, num_buffers=depth)
    base = da.decode_attention(q, k, v, kl, num_buffers=1)
    before = da.decode_attention_pipelined.launches
    got = da.decode_attention(q, k, v, kl, num_buffers=depth)
    torch.cuda.synchronize()
    if (dk, dv) == (576, 512):
        assert plan.num_buffers == (2 if dtype == torch.bfloat16 else 1)
    else:
        assert plan.num_buffers == depth
    assert da.decode_attention_pipelined.launches == before + (
        plan.num_buffers > 1)
    assert torch.equal(got, base)
    assert _err(got, da.decode_attention_plain(q, k, v, kl)) <= TOL[dtype]


def _placements(k_pool, v_pool, pt, kv_len, ps, *scales):
    """The same logical rows under three seeded permutations of the pool's
    pages (page 0 stays the scratch page), each table's entries past its
    row's kv_len set out of the pool: (pools..., table) per placement."""
    n_pool = k_pool.shape[0]
    live = -(-kv_len.clamp(max=pt.shape[1] * ps) // ps)
    past = (torch.arange(pt.shape[1], device="cuda")[None, :]
            >= live[:, None])
    out = []
    for seed in range(3):
        perm = torch.cat([torch.zeros(1, dtype=torch.long), torch.randperm(
            n_pool - 1, generator=torch.Generator().manual_seed(seed)) + 1])
        inv = torch.argsort(perm).cuda()
        pools = [quant.as_bytes(t)[inv].view(t.dtype)
                 for t in (k_pool, v_pool, *scales)]
        table = perm.cuda()[pt.long()].to(torch.int32)
        table[past] = 1 << 30
        out.append((*pools, table))
    return out


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,pages,ps,hq,hkv,d,kv_len", [
    (8, 64, 16, 16, 2, 128, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (4, 6, 8, 4, 2, 16, [3, 48, 60, 17]),        # P * ps not a multiple of 32
    (3, 10, 32, 32, 8, 64, [0, 320, 150]),
])
def test_pipelined_paged_decode_equals_k3_and_k5(gen, depth, dtype, b, pages,
                                                 ps, hq, hkv, d, kv_len):
    """K6 at depth 2 and 4 equals K3 bit for bit under three page
    placements with garbage past kv_len in the table, and equals K5 on the
    rows gathered to a contiguous cache."""
    q = _randn(gen, dtype, b, hq, d)
    k_pool, v_pool, pt, kl = _pool_of(gen, dtype, b, pages, ps, hkv, d,
                                      kv_len)
    base = da.paged_decode_attention(q, k_pool, v_pool, pt, kl,
                                     num_buffers=1)
    before = da.paged_decode_attention_pipelined.launches
    for kp, vp, table in _placements(k_pool, v_pool, pt, kl, ps):
        got = da.paged_decode_attention_pipelined(q, kp, vp, table, kl,
                                                  num_buffers=depth)
        assert torch.equal(got, base)
    k = k_pool[pt.long()].reshape(b, pages * ps, hkv, d)
    v = v_pool[pt.long()].reshape(b, pages * ps, hkv, d)
    k5 = da.decode_attention_pipelined(
        q, k, v, kl, num_splits=da.route(q, k_pool, v_pool,
                                         page_table=pt).num_splits,
        num_buffers=depth)
    torch.cuda.synchronize()
    assert da.paged_decode_attention_pipelined.launches == before + 3
    assert torch.equal(k5, base)
    assert _err(base, da.paged_decode_attention_plain(q, k_pool, v_pool, pt,
                                                      kl)) <= TOL[dtype]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,pages,ps,hq,hkv,d,kv_len", [
    (8, 64, 16, 16, 2, 128, [1, 100, 1024, 2000, 513, 64, 300, 777]),
    (4, 6, 8, 4, 1, 16, [3, 48, 60, 17]),        # Hkv = 1: 2-byte scales
    (3, 10, 32, 32, 8, 64, [0, 320, 150]),
])
def test_pipelined_quantized_paged_decode_equals_k8(gen, depth, store, dtype,
                                                    b, pages, ps, hq, hkv, d,
                                                    kv_len):
    """K9 at depth 2 and 4 equals K8 bit for bit under three page
    placements with garbage past kv_len in the table."""
    q = _randn(gen, dtype, b, hq, d)
    k_pool, v_pool, pt, kl = _pool_of(gen, dtype, b, pages, ps, hkv, d,
                                      kv_len)
    kq, ks = _quantized(k_pool, store)
    vq, vs = _quantized(v_pool, store)
    base = da.paged_decode_attention_quantized(q, kq, ks, vq, vs, pt, kl,
                                               num_buffers=1)
    before = da.paged_decode_attention_quantized_pipelined.launches
    for kp, vp, kss, vss, table in _placements(kq, vq, pt, kl, ps, ks, vs):
        got = da.paged_decode_attention_quantized_pipelined(
            q, kp, kss, vp, vss, table, kl, num_buffers=depth)
        assert torch.equal(got, base)
    torch.cuda.synchronize()
    assert (da.paged_decode_attention_quantized_pipelined.launches
            == before + 3)
    want = da.paged_decode_attention_quantized_plain(q, kq, ks, vq, vs, pt,
                                                     kl)
    assert _err(base, want) <= TOL[dtype]


@pytest.mark.parametrize("causal", [True, False])
def test_pipelined_flash_under_autograd_equals_k1(gen, pinned, causal):
    """FlashAttentionFunction with a db pinned to depth 2 runs K4 in the
    forward; its output and K11's gradients equal K1's bit for bit."""
    ins = [_randn(gen, torch.bfloat16, *s) for s in
           ((2, 256, 16, 128), (2, 256, 2, 128), (2, 256, 2, 128))]
    do = _randn(gen, torch.bfloat16, 2, 256, 16, 128)
    runs = []
    for depth in (None, 2):
        if depth is not None:
            pinned(depth)
        before = fa.flash_attention_pipelined.launches
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fa.flash_attention_autograd(*leaves, causal=causal)
        out.backward(do)
        torch.cuda.synchronize()
        assert fa.flash_attention_pipelined.launches == before + (
            depth is not None)
        runs.append([out] + [t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_pipelined_wrappers_raise_on_depths_they_cannot_launch(gen):
    """A depth the library is not built for, or whose ring does not fit
    the block's shared memory, raises; it never falls back."""
    q = _randn(gen, torch.bfloat16, 1, 16, 4, 16)
    k = _randn(gen, torch.bfloat16, 1, 32, 2, 16)
    with pytest.raises(RuntimeError, match="unsupported"):
        fa.flash_attention_pipelined(q, k, k, num_buffers=3)
    with pytest.raises(ValueError, match="num_buffers"):
        fa.flash_attention_pipelined(q, k, k, num_buffers=1)
    qd = _randn(gen, torch.float32, 2, 16, 576)
    kd = _randn(gen, torch.float32, 2, 64, 1, 576)
    vd = kd[..., :512].contiguous()
    kl = torch.tensor([64, 9], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):   # 289 KB ring
        da.decode_attention_pipelined(qd, kd, vd, kl, num_buffers=2)
    with pytest.raises(RuntimeError, match="unsupported"):
        da.decode_attention_pipelined(qd[..., :16].contiguous(),
                                      kd[..., :16].contiguous(),
                                      kd[..., :16].contiguous(), kl,
                                      num_buffers=8)
    before = (da.decode_attention.launches,
              da.decode_attention_pipelined.launches)
    da.decode_attention(qd, kd, vd, kl, num_buffers=4)   # fitted to K2
    torch.cuda.synchronize()
    assert (da.decode_attention.launches,
            da.decode_attention_pipelined.launches) == (before[0] + 1,
                                                        before[1])


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_smem_mirrors_equal_the_library(gen, depth, dtype):
    """The shared-memory bytes the ops fit the depth against
    (``pipelined_smem``, on the path of the query's dtype: the 1-byte
    tensor-core layout for bf16 queries over an int8 / e4m3 pool, the
    CUDA-core one for f32) are those the CUDA library lays out, for every
    (Dk, Dv) pair K4, K5 / K6 and K9 are built for (K4 in bf16 only: the
    f32 forward has no ring)."""
    for dk, dv in fa.HEAD_DIM_PAIRS:
        if dtype != torch.bfloat16:
            with pytest.raises(ValueError, match="ring"):
                fa.ring_smem_bytes(dk, dv, depth, dtype)
            continue
        base, stage = fa.pipelined_smem(dtype.itemsize, dk, dv)
        assert fa.ring_smem_bytes(dk, dv, depth, dtype) == base + \
            depth * stage, (dk, dv)
    stores = [(None, dtype, da.HEAD_DIM_PAIRS)] + [
        (store, store, [(d, d) for d in da.HEAD_DIMS])
        for store in quant.STORE_CODES]
    path = "mma" if dtype == torch.bfloat16 else "cuda_cores"
    for store, held, pairs in stores:
        for dk, dv in pairs:
            base, stage = da.pipelined_smem(held.itemsize, dk, dv, path)
            assert da.ring_smem_bytes(dk, dv, depth, dtype, store) == \
                base + depth * stage, (store, dk, dv)


@pytest.mark.parametrize("depth", DEPTHS)
def test_quantized_paged_op_routed_to_k9_checks_pool_alignment(gen, pinned,
                                                              depth):
    """An int8 pool that starts 4 bytes past a 16-byte aligned address,
    sent through K8's op while a pinned db routes it to K9: the op raises
    before launching (K9 reads the pools 16 bytes a load), as K9's own
    wrapper does."""
    q = _randn(gen, torch.bfloat16, 2, 8, 128)
    k_pool, v_pool, pt, kl = _pool_of(gen, torch.bfloat16, 2, 4, 16, 1, 128,
                                      [40, 64])
    kq, ks = _quantized(k_pool, torch.int8)
    vq, vs = _quantized(v_pool, torch.int8)
    flat = torch.empty(kq.numel() + 4, dtype=torch.int8, device="cuda")
    k_off = flat[4:].view(kq.shape)
    k_off.copy_(kq)
    pinned(depth)
    wrappers = (da.paged_decode_attention_quantized,
                da.paged_decode_attention_quantized_pipelined)
    before = [fn.launches for fn in wrappers]
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.paged_decode_attention_quantized(q, k_off, ks, vq, vs, pt, kl)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.paged_decode_attention_quantized_pipelined(
            q, k_off, ks, vq, vs, pt, kl, num_buffers=depth)
    assert [fn.launches for fn in wrappers] == before


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_reduced_serve_pinned_depth_equals_classic(gen, pinned, cache):
    """The reduced f32 qwen2.5-3b served with a db pinned to depth 2 gives
    the classic kernels' tokens and launches K5 / K6 in place of K2 / K3;
    its f32 prefill keeps K1 (the f32 forward has no ring)."""
    cfg = get_config("qwen2.5-3b").reduced()
    card = Model(cfg, device="cuda")
    params = card.init(0)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 6)]
    extra = dict(cache="paged", page_size=8) if cache == "paged" else {}
    scfg = ServeConfig(max_len=64, slots=3, refill_schedule="faa", **extra)
    want = Engine(card, params, scfg).serve(prompts, 8)
    pinned(2)
    decode = (da.paged_decode_attention_pipelined if cache == "paged"
              else da.decode_attention_pipelined)
    classic = (fa.flash_attention, da.decode_attention,
               da.paged_decode_attention)
    before = [fn.launches for fn in
              (fa.flash_attention_pipelined, decode, *classic)]
    got = Engine(card, params, scfg).serve(prompts, 8)
    after = [fn.launches for fn in
             (fa.flash_attention_pipelined, decode, *classic)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert after[0] == before[0] and after[1] > before[1]
    assert after[2] > before[2] and after[3:] == before[3:]


# ------------------------------- bf16 K1, K4, K11 on the tensor cores

# b, sq, skv, kv_len, q_offset, causal: ragged lengths on both sides of a
# 64-row tile, a per-row kv_len of 0, q_offset beyond kv_len, not causal,
# and Sq > Skv (suffix alignment: the first 63 queries see no KV row)
MMA_CASES = [
    (2, 1, 37, None, None, True),
    (2, 37, 63, [63, 0], 0, True),
    (2, 63, 65, None, None, True),
    (1, 65, 1000, 40, 100, True),
    (1, 488, 488, None, None, True),
    (1, 1000, 1000, [700], 0, False),
    (1, 100, 37, None, None, True),
]


def _mma_inputs(gen, b, sq, skv, dk, dv, kv_len):
    hq, hkv = (8, 2) if dk == dv else (4, 4)
    q = _randn(gen, torch.bfloat16, b, sq, hq, dk)
    k = _randn(gen, torch.bfloat16, b, skv, hkv, dk)
    v = _randn(gen, torch.bfloat16, b, skv, hkv, dv)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len


@pytest.mark.parametrize("dk,dv", fa.HEAD_DIM_PAIRS)
@pytest.mark.parametrize("b,sq,skv,kv_len,q_offset,causal", MMA_CASES)
def test_mma_flash_matches_plain(gen, dk, dv, b, sq, skv, kv_len, q_offset,
                                 causal):
    """bf16 K1 (the tensor-core kernel at depth 1) against its plain
    version at every (Dk, Dv) pair: out within 2e-2, lse within 1e-3; a
    query row that sees no KV row gets out 0 and lse <= -1e29."""
    q, k, v, kl = _mma_inputs(gen, b, sq, skv, dk, dv, kv_len)
    out, lse = fa.flash_attention(q, k, v, kv_len=kl, q_offset=q_offset,
                                  causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_len=kl,
                                            q_offset=q_offset, causal=causal)
    assert _err(out, ref) <= TOL[torch.bfloat16]
    assert _err(lse, ref_lse) <= 1e-3
    offset = skv - sq if q_offset is None else q_offset
    rows = torch.as_tensor(kv_len if kv_len is not None else skv,
                           device="cuda").clamp(0, skv).broadcast_to((b,))
    seen = rows[:, None].expand(b, sq)
    if causal:
        qpos = torch.arange(sq, device="cuda") + offset + 1
        seen = torch.minimum(seen, qpos[None, :])
    blind = seen <= 0                                     # [B, Sq]
    assert torch.all(out[blind] == 0)
    assert torch.all(lse.permute(0, 2, 1)[blind] <= -1e29)


@pytest.mark.parametrize("dk,dv", fa.HEAD_DIM_PAIRS)
@pytest.mark.parametrize("b,sq,skv,kv_len,q_offset,causal", MMA_CASES)
def test_mma_pipelined_flash_equals_k1(gen, dk, dv, b, sq, skv, kv_len,
                                       q_offset, causal):
    """bf16 K4 at depths 2 and 4 gives K1's out and lse bit for bit on the
    ragged cases (one mainloop, templated on the ring depth)."""
    q, k, v, kl = _mma_inputs(gen, b, sq, skv, dk, dv, kv_len)
    base = fa.flash_attention(q, k, v, kv_len=kl, q_offset=q_offset,
                              causal=causal, num_buffers=1)
    for depth in DEPTHS:
        got = fa.flash_attention_pipelined(q, k, v, kv_len=kl,
                                           q_offset=q_offset, causal=causal,
                                           num_buffers=depth)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 1024, 1024, 16, 2, 128, True),   # the training shape
    (1, 1000, 1000, 16, 2, 128, True),   # ragged
    (1, 65, 63, 4, 2, 16, True),         # Sq > Skv by one past a tile
    (2, 1, 37, 4, 2, 32, True),
    (2, 300, 700, 16, 2, 128, False),    # not causal, Sq < Skv
    (1, 63, 65, 8, 8, 64, False),
])
def test_mma_flash_bwd_matches_plain_and_repeats(gen, b, sq, skv, hq, hkv, d,
                                                 causal):
    """bf16 K11 (both passes on the tensor cores) against its plain
    version, each gradient within 1e-2 of its largest |value|, and a
    repeated call bit for bit (no atomics)."""
    dt = torch.bfloat16
    q, do = _randn(gen, dt, b, sq, hq, d), _randn(gen, dt, b, sq, hq, d)
    k, v = _randn(gen, dt, b, skv, hkv, d), _randn(gen, dt, b, skv, hkv, d)
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, w) <= BWD_TOL[dt]
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("causal", [True, False])
def test_mma_flash_attention_function_matches_plain_autograd(gen, causal):
    """FlashAttentionFunction in bf16 (K1 forward, K11 backward on the
    tensor cores) against autograd through K1's plain version on the same
    bf16 leaves: out within 2e-2, each gradient within 1e-2 of its
    largest |value|."""
    dt = torch.bfloat16
    ins = [_randn(gen, dt, *s) for s in
           ((2, 200, 8, 64), (2, 200, 2, 64), (2, 200, 2, 64))]
    do = _randn(gen, dt, 2, 200, 8, 64)
    runs = []
    for fn in (fa.flash_attention_autograd,
               lambda q, k, v, causal: fa.flash_attention_plain(
                   q, k, v, causal=causal)[0]):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fn(*leaves, causal=causal)
        out.backward(do)
        runs.append([out] + [t.grad for t in leaves])
    assert _err(runs[0][0], runs[1][0]) <= TOL[dt]
    for g, w in zip(runs[0][1:], runs[1][1:]):
        assert g.dtype == dt and _rel(g, w) <= BWD_TOL[dt]


def test_mma_paths_raise_on_what_they_cannot_take(gen):
    """A bf16 call the tensor-core kernels cannot take raises; nothing
    falls back to the f32 kernels or to a plain version."""
    dt = torch.bfloat16
    q48, k48 = (_randn(gen, dt, 1, 8, h, 48) for h in (4, 2))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q48, k48, k48)
    q, k = _randn(gen, dt, 1, 16, 4, 64), _randn(gen, dt, 1, 32, 2, 64)
    with pytest.raises(RuntimeError, match="unsupported"):
        fa.flash_attention_pipelined(q, k, k, num_buffers=3)
    q192, k192 = (_randn(gen, dt, 1, 8, h, 192) for h in (4, 2))
    out, lse = fa.flash_attention(q192, k192, k192[..., :128].contiguous())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q192, k192, k192, q192, lse, q192)
    before = [fn.launches for fn in (fa.flash_attention,
                                     fa.flash_attention_pipelined,
                                     fa.flash_attention_bwd)]
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.float(), k)
    assert [fn.launches for fn in (fa.flash_attention,
                                   fa.flash_attention_pipelined,
                                   fa.flash_attention_bwd)] == before


@pytest.mark.parametrize("which", ["out", "do"])
def test_mma_flash_bwd_checks_out_and_do_alignment(gen, which):
    """A contiguous bf16 ``out`` or ``do`` that starts 2 bytes past a
    16-byte aligned address: K11 raises before launching (its tensor-core
    passes read out and do 16 bytes a load) instead of faulting."""
    dt = torch.bfloat16
    q, k = _randn(gen, dt, 1, 32, 4, 64), _randn(gen, dt, 1, 32, 2, 64)
    out, lse = fa.flash_attention(q, k, k)
    do = _randn(gen, dt, 1, 32, 4, 64)
    flat = torch.empty(q.numel() + 1, dtype=dt, device="cuda")
    off = flat[1:].view(q.shape)
    off.copy_(out if which == "out" else do)
    args = (off, do) if which == "out" else (out, off)
    before = fa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bwd(q, k, k, args[0], lse, args[1])
    assert fa.flash_attention_bwd.launches == before


# ------------- bf16 K2, K3, K5, K6 and K14 (decode) on the tensor cores

def _mma_pool(k, v, ps, seed):
    """k [B, S, Hkv, Dk], v [.., Dv] as pages of ``ps`` rows of a pool
    (page 0 scratch) placed by a seeded permutation: (k_pool, v_pool,
    table, rows gathered back: k, v padded to whole pages)."""
    b, s = k.shape[:2]
    pages = -(-s // ps)
    pad = pages * ps - s
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    perm = torch.randperm(b * pages, generator=torch.Generator().manual_seed(
        seed)).cuda()
    pt = (perm.reshape(b, pages) + 1).to(torch.int32)
    k_pool = k.new_zeros((b * pages + 1, ps, *k.shape[2:]))
    v_pool = v.new_zeros((b * pages + 1, ps, *v.shape[2:]))
    k_pool[pt.long().flatten()] = kp.reshape(b * pages, ps, *k.shape[2:])
    v_pool[pt.long().flatten()] = vp.reshape(b * pages, ps, *v.shape[2:])
    return k_pool, v_pool, pt, kp, vp


@pytest.mark.parametrize("g", [1, 2, 8, 16])
@pytest.mark.parametrize("dk,dv", da.HEAD_DIM_PAIRS)
def test_mma_decode_matches_plain_at_every_depth_and_address(gen, dk, dv, g):
    """bf16 K2 (the tensor-core split kernel at depth 1) against its plain
    version within 2e-2 at every (Dk, Dv) pair and group size, with a
    kv_len of 0, one past S and ragged ones; K5 at depths 2 and 4 equal to
    K2, K3 on a pool equal to K2 on the gathered rows under two page
    placements, and K6 at depths 2 and 4 equal to K3, all bit for bit
    (the depth fitted where the ring does not fit: (576, 512) takes 2)."""
    hkv = 2 if dk == dv else 1
    b, s = 4, 300
    q = _randn(gen, torch.bfloat16, b, g * hkv, dk)
    k = _randn(gen, torch.bfloat16, b, s, hkv, dk)
    v = _randn(gen, torch.bfloat16, b, s, hkv, dv)
    kl = torch.tensor([0, 299, 1000, 65], dtype=torch.int32, device="cuda")
    assert da.path(q, k) == "mma"
    before = [fn.launches for fn in (da.decode_attention,
                                     da.decode_attention_pipelined)]
    base = da.decode_attention(q, k, v, kl, num_buffers=1)
    assert _err(base, da.decode_attention_plain(q, k, v, kl)) <= \
        TOL[torch.bfloat16]
    assert torch.all(base[0] == 0)                       # kv_len 0
    for depth in DEPTHS:
        plan = da.route(q, k, v, num_buffers=depth)
        assert plan.path == "mma"
        assert plan.num_buffers == (2 if (dk, dv) == (576, 512) else depth)
        assert torch.equal(da.decode_attention(q, k, v, kl,
                                               num_buffers=depth), base)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (da.decode_attention,
                                   da.decode_attention_pipelined)] == [
        before[0] + 1, before[1] + 2]
    for seed, ps in ((1, 16), (2, 8)):
        k_pool, v_pool, pt, kp, vp = _mma_pool(k, v, ps, seed)
        k3 = da.paged_decode_attention(q, k_pool, v_pool, pt, kl,
                                       num_buffers=1)
        assert torch.equal(k3, da.decode_attention(q, kp, vp, kl,
                                                   num_buffers=1))
        for depth in DEPTHS:
            assert torch.equal(da.paged_decode_attention_pipelined(
                q, k_pool, v_pool, pt, kl, num_buffers=min(
                    depth, da.route(q, k, v, num_buffers=depth).num_buffers)),
                k3)


@pytest.mark.parametrize("depth", DEPTHS)
def test_mma_decode_ring_smem_equals_the_library(gen, depth):
    """The bf16 layout of ``pipelined_smem`` (the tensor-core split
    kernel's stages, query and probability tiles) is the library's,
    at every (Dk, Dv) pair; depth 4 at (576, 512) does not fit."""
    for dk, dv in da.HEAD_DIM_PAIRS:
        base, stage = da.pipelined_smem(2, dk, dv)
        assert da.ring_smem_bytes(dk, dv, depth, torch.bfloat16) == \
            base + depth * stage, (dk, dv)
    base, stage = da.pipelined_smem(2, 576, 512)
    assert base + 4 * stage > 232_448 >= base + 2 * stage


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_mma_decode_serves_bf16_paged_and_tuned_as_classic(gen, pinned,
                                                           cache):
    """The reduced qwen2.5-3b in bf16 (every decode call on the tensor-core
    split kernel): paged serve gives the contiguous serve's tokens, and a
    db pinned to depth 2 (K5 / K6) gives the classic (K2 / K3) tokens."""
    cfg = get_config("qwen2.5-3b").reduced().with_dtype("bfloat16")
    card = Model(cfg, device="cuda")
    params = card.init(0)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 6)]
    base = dict(max_len=64, slots=3, refill_schedule="faa",
                cache_dtype="bfloat16")
    extra = (dict(cache="paged", page_size=8, prefix_cache=False)
             if cache == "paged" else {})
    contiguous = Engine(card, params, ServeConfig(**base)).serve(prompts, 8)
    before = [fn.launches for fn in (da.decode_attention,
                                     da.paged_decode_attention)]
    classic = Engine(card, params, ServeConfig(**base, **extra)).serve(
        prompts, 8)
    after = [fn.launches for fn in (da.decode_attention,
                                    da.paged_decode_attention)]
    assert after[cache == "paged"] > before[cache == "paged"]
    pinned(2)
    ring = (da.paged_decode_attention_pipelined if cache == "paged"
            else da.decode_attention_pipelined)
    before = ring.launches
    tuned = Engine(card, params, ServeConfig(**base, **extra)).serve(
        prompts, 8)
    assert ring.launches > before
    for c, p, t in zip(contiguous, classic, tuned):
        np.testing.assert_array_equal(p, c)
        np.testing.assert_array_equal(t, c)


MMA_GMM_SHAPES = GMM_SHAPES + [
    (5, 1, 64, 32),          # C = 1
    (4, 13, 96, 136),        # C = 13: two n-tiles, f past one 128-column tile
    (3, 32, 2048, 1408),     # C = 32: four n-tiles
    (2, 13, 36, 40),         # C = 13, d not 16-byte wide: the CUDA cores
    (2, 8, 48, 37),          # C = 8, f not 16-byte wide: the CUDA cores
    (3, 64, 256, 192),       # C = 64: one m64 warpgroup
    (64, 240, 2048, 1408),   # the training shape: one 256-row tile
    (2, 256, 128, 96),       # one full 256-row tile
    (2, 257, 128, 96),       # two 256-row tiles, one row in the second
    (1, 100, 64, 128),       # E = 1, two warpgroups of 64 rows
    (2, 48, 72, 40),         # d a multiple of 8, not of the 64-deep stage
    (2, 40, 36, 24),         # C > 32, d not 16-byte wide: mma
]


@pytest.mark.parametrize("e,c,d,f", MMA_GMM_SHAPES)
def test_mma_gmm_matches_plain_and_repeats(gen, e, c, d, f):
    """bf16 K14 at every ``GMM_SHAPES`` entry, at C = 1, 13 and 32 and at
    the wgmma kernel's tile edges: against its plain version within 1e-2 of
    the largest |value|, the same bits on a repeat (no atomics), the kernel
    the shape rule names (the weight stream at C <= 32 with 16-byte rows,
    the CUDA cores for the other C <= 32; at C > 32 the wgmma kernel with
    16-byte rows, the mma.sync tiles for the rest), one launch a call."""
    x, w = _gmm_inputs(gen, torch.bfloat16, e, c, d, f)
    rows16 = d % 8 == 0 and f % 8 == 0
    want = (("wgmma" if rows16 else "mma") if c > 32 else
            "stream" if rows16 else "cuda_cores")
    assert mg.path(x, w) == want
    before = mg.grouped_matmul.launches
    by_path = mg.grouped_matmul.path_launches[want]
    out = mg.grouped_matmul(x, w)
    again = mg.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert mg.grouped_matmul.launches == before + 2
    assert mg.grouped_matmul.path_launches[want] == by_path + 2
    assert out.shape == (e, c, f)
    assert _rel(out, mg.grouped_matmul_plain(x, w)) <= GMM_TOL[torch.bfloat16]
    assert torch.equal(out, again)


def test_wgmma_gmm_takes_the_rule_only(gen):
    """A bf16 prefill whose x starts one element off a 16-byte boundary
    cannot be a TMA map's base: the rule sends it to ``"mma"``, whose
    result holds the wgmma kernel's on the aligned copy within the
    tolerance."""
    x, w = _gmm_inputs(gen, torch.bfloat16, 2, 64, 128, 96)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    x_off = flat[1:].view(x.shape)
    x_off.copy_(x)
    assert (mg.path(x, w), mg.path(x_off, w)) == ("wgmma", "mma")
    before = mg.grouped_matmul.path_launches["mma"]
    got = mg.grouped_matmul(x_off, w)
    assert mg.grouped_matmul.path_launches["mma"] == before + 1
    assert _rel(got, mg.grouped_matmul(x, w)) <= GMM_TOL[torch.bfloat16]


def test_mma_gmm_stream_takes_the_rule_only(gen):
    """A bf16 call at C <= 32 whose w starts 8 bytes off a 16-byte
    boundary goes to the CUDA cores by the rule (the stream copies whole
    16-byte chunks), and gives the stream's result within the tolerance."""
    x, w = _gmm_inputs(gen, torch.bfloat16, 2, 8, 64, 32)
    flat = torch.empty(w.numel() + 4, dtype=torch.bfloat16, device="cuda")
    w_off = flat[4:].view(w.shape)
    w_off.copy_(w)
    assert (mg.path(x, w), mg.path(x, w_off)) == ("stream", "cuda_cores")
    got = mg.grouped_matmul(x, w_off)
    assert _rel(got, mg.grouped_matmul(x, w)) <= GMM_TOL[torch.bfloat16]


# ---------------------- bf16 K12, K13 and K10 on the tensor cores

# b, s, h, p, g, n, with an initial state: ragged (a last chunk of 40
# rows), two groups, an initial state, S shorter than a chunk with G = H,
# then every (P, N) the wrappers accept, ragged, with two groups and a state
MMA_SSD_CASES = [
    (1, 488, 48, 64, 1, 128, False),
    (2, 300, 16, 32, 2, 64, False),
    (2, 200, 8, 64, 1, 128, True),
    (1, 5, 4, 64, 4, 128, True),
] + [(1, 130, 4, p, 2, n, True) for p in ss.HEAD_DIMS for n in ss.STATE_DIMS]


@pytest.mark.parametrize("b,s,h,p,g,n,with_state", MMA_SSD_CASES)
def test_mma_ssd_matches_plain_and_repeats(gen, b, s, h, p, g, n,
                                           with_state):
    """bf16 K12 on the tensor cores against its plain version: y within
    1e-2 and the f32 final state within 1e-5 of their largest |value|, a
    repeated call bit for bit, both launches on the ``mma`` path."""
    ins = _ssd_inputs(gen, torch.bfloat16, b, s, h, p, g, n)
    init = _randn(gen, torch.float32, b, h, p, n) if with_state else None
    assert ss.path(ins[0], ins[3]) == "mma"
    before = ss.ssd.path_launches["mma"]
    y, st = ss.ssd(*ins, initial_state=init)
    y2, st2 = ss.ssd(*ins, initial_state=init)
    torch.cuda.synchronize()
    assert ss.ssd.path_launches["mma"] == before + 2
    want_y, want_st = ss.ssd_plain(*ins, initial_state=init)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert _rel(y, want_y) <= SSD_TOL[torch.bfloat16]
    assert _rel(st, want_st) <= SSD_STATE_TOL
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("b,s,h,p,g,n,with_state", MMA_SSD_CASES[:4])
def test_mma_ssd_quantized_equals_k12_on_rounded_x(gen, store, b, s, h, p,
                                                   g, n, with_state):
    """bf16 K13 (int8 and e4m3 x) equals bf16 K12 on
    ``dequantize(x_q, x_scale).bfloat16()`` bit for bit (the oracle rounds
    the dequantized x to B's dtype, R5), and holds its plain version's
    tolerances; both on the ``mma`` path."""
    x, dt, a, b_in, c_in = _ssd_inputs(gen, torch.bfloat16, b, s, h, p, g,
                                       n)
    xq, xs = _quantized(x, store)
    before = ss.ssd_quantized.path_launches["mma"]
    y, st = ss.ssd_quantized(xq, xs, dt, a, b_in, c_in)
    y12, st12 = ss.ssd(quant.dequantize(xq, xs).bfloat16(), dt, a, b_in,
                       c_in)
    torch.cuda.synchronize()
    assert ss.ssd_quantized.path_launches["mma"] == before + 1
    assert torch.equal(y, y12) and torch.equal(st, st12)
    want_y, want_st = ss.ssd_quantized_plain(xq, xs, dt, a, b_in, c_in)
    assert _rel(y, want_y) <= SSD_TOL[torch.bfloat16]
    assert _rel(st, want_st) <= SSD_STATE_TOL


def test_mma_ssd_f32_stays_on_the_cuda_cores(gen):
    """f32 K12 and K13 keep the CUDA-core kernel (the parity dtype)."""
    x, dt, a, b_in, c_in = _ssd_inputs(gen, torch.float32, 1, 70, 4, 64, 1,
                                       128)
    xq, xs = _quantized(x, torch.int8)
    assert ss.path(x, b_in) == ss.path(xq, b_in) == "cuda_cores"
    before = (ss.ssd.path_launches["cuda_cores"],
              ss.ssd_quantized.path_launches["cuda_cores"])
    ss.ssd(x, dt, a, b_in, c_in)
    ss.ssd_quantized(xq, xs, dt, a, b_in, c_in)
    torch.cuda.synchronize()
    assert (ss.ssd.path_launches["cuda_cores"],
            ss.ssd_quantized.path_launches["cuda_cores"]) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("b,sq,skv,kv_len,q_offset,causal", MMA_CASES)
def test_mma_flash_quant_matches_plain(gen, store, d, b, sq, skv, kv_len,
                                       q_offset, causal):
    """bf16 K10 (int8 and e4m3 K/V) on the tensor cores against its plain
    version at every head dim: out within 2e-2, lse within 1e-3, on
    ragged Sq / Skv, a per-row kv_len with a 0, q_offset past kv_len, a
    non-causal call and rows that see no KV row (out 0, lse <= -1e29);
    the launch on the ``mma`` path."""
    q, k, v, kl = _mma_inputs(gen, b, sq, skv, d, d, kv_len)
    kq, ks = _quantized(k, store)
    vq, vs = _quantized(v, store)
    assert fa.path(q) == "mma"
    before = fa.flash_attention_quantized.path_launches["mma"]
    out, lse = fa.flash_attention_quantized(q, kq, ks, vq, vs, kv_len=kl,
                                            q_offset=q_offset,
                                            causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_quantized.path_launches["mma"] == before + 1
    ref, ref_lse = fa.flash_attention_quantized_plain(
        q, kq, ks, vq, vs, kv_len=kl, q_offset=q_offset, causal=causal)
    assert _err(out, ref) <= TOL[torch.bfloat16]
    assert _err(lse, ref_lse) <= 1e-3
    offset = skv - sq if q_offset is None else q_offset
    rows = torch.as_tensor(kv_len if kv_len is not None else skv,
                           device="cuda").clamp(0, skv).broadcast_to((b,))
    seen = rows[:, None].expand(b, sq)
    if causal:
        qpos = torch.arange(sq, device="cuda") + offset + 1
        seen = torch.minimum(seen, qpos[None, :])
    blind = seen <= 0                                     # [B, Sq]
    assert torch.all(out[blind] == 0)
    assert torch.all(lse.permute(0, 2, 1)[blind] <= -1e29)


def test_mma_flash_quant_f32_stays_on_the_cuda_cores(gen):
    """f32 K10 keeps the CUDA-core kernel, and the f32 and bf16 paths
    agree within the bf16 tolerance on the same quantized cache."""
    q, k, v, _ = _mma_inputs(gen, 1, 65, 200, 64, 64, None)
    kq, ks = _quantized(k, torch.int8)
    vq, vs = _quantized(v, torch.int8)
    before = dict(fa.flash_attention_quantized.path_launches)
    out32, _ = fa.flash_attention_quantized(q.float(), kq, ks, vq, vs)
    out16, _ = fa.flash_attention_quantized(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    after = fa.flash_attention_quantized.path_launches
    assert after["cuda_cores"] == before.get("cuda_cores", 0) + 1
    assert after["mma"] == before.get("mma", 0) + 1
    assert _err(out16, out32) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("which", ["k", "v"])
def test_mma_flash_quant_checks_k_and_v_alignment(gen, which, store):
    """A contiguous 1-byte k or v that starts 4 bytes past a 16-byte
    aligned address: bf16 K10 raises before launching (its tensor-core
    ring reads K/V rows 16 bytes a ``cp.async``) instead of faulting; f32
    K10, which reads them a word at a time, still takes it."""
    q, k, v, _ = _mma_inputs(gen, 1, 32, 64, 64, 64, None)
    kq, ks = _quantized(k, store)
    vq, vs = _quantized(v, store)
    src = kq if which == "k" else vq
    flat = torch.empty(src.numel() + 4, dtype=src.dtype, device="cuda")
    off = flat[4:].view(src.shape)
    off.copy_(src)
    assert off.data_ptr() % 16 == 4
    args = (off, ks, vq, vs) if which == "k" else (kq, ks, off, vs)
    fn = fa.flash_attention_quantized
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(q, *args)
    assert fn.launches == before
    out32, _ = fn(q.float(), *args)
    want, _ = fn(q.float(), kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(out32, want)


# ------------- bf16 K7, K8, K9 and K15 (1-byte operands) on the tensor cores

MMA_QUANT_LENS = [1, 100, 1024, 2000, 513, 64, 300, 777, 0]


def _quant_pool(kq, ks, vq, vs, ps, seed):
    """1-byte values and f16 scales [B, S, Hkv, ..] as pages of ``ps`` rows
    of pools placed by one seeded permutation (``_mma_pool``; fp8 moved as
    bytes): (k_pool, k_scale, v_pool, v_scale pools, table)."""
    kb, vb = (quant.as_bytes(t) for t in (kq, vq))
    k_pool, v_pool, pt, _, _ = _mma_pool(kb, vb, ps, seed)
    ks_pool, vs_pool, pt_s, _, _ = _mma_pool(ks, vs, ps, seed)
    assert torch.equal(pt, pt_s)
    return (k_pool.view(kq.dtype), ks_pool, v_pool.view(vq.dtype), vs_pool,
            pt)


@pytest.mark.parametrize("g", [1, 2, 8, 16])
@pytest.mark.parametrize("d", da.HEAD_DIMS)
@pytest.mark.parametrize("store", QDTYPES)
def test_mma_decode_quant_matches_plain_at_every_head_dim(gen, store, d, g):
    """bf16 K7 (the 1-byte tensor-core split kernel, contiguous rows)
    against its plain version within 2e-2 at every head dim and group
    size, int8 and e4m3, on ragged lengths with one past S and a 0 (out
    0); a repeated call gives the same bits; K8 on a pool equals K7 on the
    gathered values and scales under two page placements, and K9 at
    depths 2 and 4 equals K8, bit for bit; every launch on ``mma``."""
    b, s, hkv = len(MMA_QUANT_LENS), 1024, 2
    q = _randn(gen, torch.bfloat16, b, g * hkv, d)
    kq, ks = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    vq, vs = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    kl = torch.tensor(MMA_QUANT_LENS, dtype=torch.int32, device="cuda")
    assert da.path(q, kq) == "mma"
    wrappers = (da.decode_attention_quantized,
                da.paged_decode_attention_quantized,
                da.paged_decode_attention_quantized_pipelined)
    before = [dict(fn.path_launches) for fn in wrappers]
    k7 = da.decode_attention_quantized(q, kq, ks, vq, vs, kl)
    again = da.decode_attention_quantized(q, kq, ks, vq, vs, kl)
    torch.cuda.synchronize()
    assert _err(k7, da.decode_attention_quantized_plain(
        q, kq, ks, vq, vs, kl)) <= TOL[torch.bfloat16]
    assert torch.equal(k7, again)
    assert torch.all(k7[-1] == 0)                        # kv_len 0
    for seed, ps in ((1, 16), (2, 8)):
        pools = _quant_pool(kq, ks, vq, vs, ps, seed)
        k8 = da.paged_decode_attention_quantized(q, *pools, kl,
                                                 num_buffers=1)
        assert torch.equal(k8, k7), (seed, ps)
        for depth in DEPTHS:
            k9 = da.paged_decode_attention_quantized_pipelined(
                q, *pools, kl, num_buffers=depth)
            assert torch.equal(k9, k8), (seed, ps, depth)
    torch.cuda.synchronize()
    after = [dict(fn.path_launches) for fn in wrappers]
    assert [a.get("mma", 0) - bf.get("mma", 0)
            for a, bf in zip(after, before)] == [2, 2, 4]
    assert all(a.get("cuda_cores", 0) == bf.get("cuda_cores", 0)
               for a, bf in zip(after, before))


@pytest.mark.parametrize("store", QDTYPES)
def test_mma_decode_quant_f32_stays_on_the_cuda_cores(gen, store):
    """f32 K7, K8 and K9 keep the CUDA-core kernels (K9 == K8 there too),
    and the f32 and bf16 paths agree within the bf16 tolerance on the same
    1-byte cache (320 rows: whole pages, so K8's split plan is K7's)."""
    b, s, hkv, d = 3, 320, 2, 64
    q = _randn(gen, torch.bfloat16, b, 8 * hkv, d)
    kq, ks = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    vq, vs = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    kl = torch.tensor([0, 299, 150], dtype=torch.int32, device="cuda")
    assert da.path(q.float(), kq) == "cuda_cores"
    fn = da.decode_attention_quantized
    before = dict(fn.path_launches)
    out32 = fn(q.float(), kq, ks, vq, vs, kl)
    out16 = fn(q, kq, ks, vq, vs, kl)
    pools = _quant_pool(kq, ks, vq, vs, 16, 3)
    k8 = da.paged_decode_attention_quantized(q.float(), *pools, kl,
                                             num_buffers=1)
    k9 = da.paged_decode_attention_quantized_pipelined(q.float(), *pools,
                                                       kl, num_buffers=2)
    torch.cuda.synchronize()
    assert fn.path_launches["cuda_cores"] == before.get("cuda_cores", 0) + 1
    assert fn.path_launches["mma"] == before.get("mma", 0) + 1
    assert out32.dtype == torch.float32 and out16.dtype == torch.bfloat16
    assert _err(out16, out32) <= TOL[torch.bfloat16]
    assert torch.equal(k8, out32) and torch.equal(k9, k8)


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("which", ["k", "v"])
def test_mma_decode_quant_checks_k_and_v_alignment(gen, which, store):
    """A contiguous 1-byte k or v that starts 4 bytes past a 16-byte
    aligned address: bf16 K7 and K8 raise before launching (their
    tensor-core ring reads K/V rows 16 bytes a ``cp.async``) instead of
    faulting; f32 K7, which reads them a word at a time, still takes it."""
    b, s, hkv, d = 2, 64, 2, 64
    q = _randn(gen, torch.bfloat16, b, 4 * hkv, d)
    kq, ks = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    vq, vs = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    kl = torch.tensor([64, 17], dtype=torch.int32, device="cuda")
    src = kq if which == "k" else vq
    flat = torch.empty(src.numel() + 4, dtype=src.dtype, device="cuda")
    off = flat[4:].view(src.shape)
    quant.as_bytes(off).copy_(quant.as_bytes(src))
    assert off.data_ptr() % 16 == 4
    args = (off, ks, vq, vs) if which == "k" else (kq, ks, off, vs)
    pt = torch.arange(b * 4, dtype=torch.int32, device="cuda").reshape(b, 4)
    pool_args = [t.reshape(b * 4, 16, *t.shape[2:]) for t in args]
    fns = (da.decode_attention_quantized,
           da.paged_decode_attention_quantized)
    before = [fn.launches for fn in fns]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fns[0](q, *args, kl)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fns[1](q, *pool_args, pt, kl)
    assert [fn.launches for fn in fns] == before
    out32 = fns[0](q.float(), *args, kl)
    want = fns[0](q.float(), kq, ks, vq, vs, kl)
    torch.cuda.synchronize()
    assert torch.equal(out32, want)


@pytest.mark.parametrize("kv_dtype", quant.quant_dtypes())
def test_mma_decode_quant_serves_bf16_paged_and_tuned_as_contiguous(
        gen, pinned, kv_dtype):
    """The reduced qwen2.5-3b in bf16 on a 1-byte cache (every decode call
    on the 1-byte tensor-core kernel): paged serve (K8) gives the
    contiguous serve's (K7) tokens, and a db pinned to depth 2 (K9) gives
    them too."""
    cfg = get_config("qwen2.5-3b").reduced().with_dtype("bfloat16")
    card = Model(cfg, device="cuda")
    params = card.init(0)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 6)]
    base = dict(max_len=64, slots=3, refill_schedule="faa",
                kv_dtype=kv_dtype)
    paged = dict(base, cache="paged", page_size=8, prefix_cache=False)
    wrappers = (da.decode_attention_quantized,
                da.paged_decode_attention_quantized,
                da.paged_decode_attention_quantized_pipelined)
    before = [dict(fn.path_launches) for fn in wrappers]
    contiguous = Engine(card, params, ServeConfig(**base)).serve(prompts, 8)
    classic = Engine(card, params, ServeConfig(**paged)).serve(prompts, 8)
    pinned(2)
    tuned = Engine(card, params, ServeConfig(**paged)).serve(prompts, 8)
    after = [dict(fn.path_launches) for fn in wrappers]
    assert all(a.get("mma", 0) > bf.get("mma", 0)
               for a, bf in zip(after, before))
    assert all(a.get("cuda_cores", 0) == bf.get("cuda_cores", 0)
               for a, bf in zip(after, before))
    for c, p, t in zip(contiguous, classic, tuned):
        np.testing.assert_array_equal(p, c)
        np.testing.assert_array_equal(t, c)


MMA_GMM_QUANT_SHAPES = [
    (5, 1, 64, 32),          # C = 1
    (64, 8, 2048, 1408),     # decode (8 slots): gate / up
    (64, 8, 1408, 2048),     # decode: down
    (4, 13, 96, 144),        # C = 13: two n-tiles, f past one 128-column tile
    (3, 32, 2048, 1408),     # C = 32: four n-tiles
]


@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("e,c,d,f", MMA_GMM_QUANT_SHAPES)
def test_mma_gmm_quant_streams_and_matches_plain(gen, store, e, c, d, f):
    """bf16 K15 at C <= 32 runs the weight stream (the 1-byte chunk made
    into bf16 once a stage, the column scale on the finished sum): within
    1e-2 of its largest |value| against its plain version and against K14
    on the dequantized weights, the same bits on a repeat, one ``stream``
    launch a call."""
    x, w = _gmm_inputs(gen, torch.float32, e, c, d, f)
    x = x.bfloat16()
    w_q, w_scale = mg.quantize_expert_weights(w, dtype=store)
    assert mg.path(x, w_q) == "stream"
    fn = mg.grouped_matmul_quantized
    before = dict(fn.path_launches)
    out = fn(x, w_q, w_scale)
    again = fn(x, w_q, w_scale)
    torch.cuda.synchronize()
    assert fn.path_launches["stream"] == before.get("stream", 0) + 2
    assert sum(fn.path_launches.values()) == sum(before.values()) + 2
    assert out.shape == (e, c, f) and out.dtype == torch.bfloat16
    want = mg.grouped_matmul_quantized_plain(x, w_q, w_scale)
    assert _rel(out, want) <= GMM_TOL[torch.bfloat16]
    assert torch.equal(out, again)
    k14 = mg.grouped_matmul(x, quant.dequantize(w_q, w_scale).to(
        torch.bfloat16))
    assert _rel(out, k14) <= GMM_TOL[torch.bfloat16]


def test_mma_gmm_quant_takes_the_rule_only(gen):
    """bf16 K15 at C <= 32 with f not a multiple of 16 (rows of whole
    16-byte copies) or w 8 bytes off a 16-byte boundary goes to the CUDA
    cores by the rule, and agrees with the stream; f32 x stays on the CUDA
    cores; C > 32 runs the tile kernel."""
    x, w = _gmm_inputs(gen, torch.float32, 2, 8, 64, 48)
    w_q, w_scale = mg.quantize_expert_weights(w, dtype=torch.int8)
    xb = x.bfloat16()
    flat = torch.empty(w_q.numel() + 8, dtype=torch.int8, device="cuda")
    w_off = flat[8:].view(w_q.shape)
    w_off.copy_(w_q)
    narrow = w_q[:, :, :40].contiguous()
    assert (mg.path(xb, w_q), mg.path(xb, w_off), mg.path(xb, narrow),
            mg.path(x, w_q)) == ("stream", "cuda_cores", "cuda_cores",
                                 "cuda_cores")
    fn = mg.grouped_matmul_quantized
    before = dict(fn.path_launches)
    streamed = fn(xb, w_q, w_scale)
    got = fn(xb, w_off, w_scale)
    got40 = fn(xb, narrow, w_scale[:, :, :40].contiguous())
    torch.cuda.synchronize()
    assert fn.path_launches["cuda_cores"] == before.get("cuda_cores", 0) + 2
    assert _rel(got, streamed) <= GMM_TOL[torch.bfloat16]
    assert _rel(got40, streamed[:, :, :40]) <= GMM_TOL[torch.bfloat16]
    xp, wp = _gmm_inputs(gen, torch.float32, 2, 40, 64, 48)
    wpq, wps = mg.quantize_expert_weights(wp, dtype=torch.int8)
    assert mg.path(xp.bfloat16(), wpq) == "mma"


# -------------------------------------------------- speculative decoding

SPEC_K = 3


def _spec_model():
    cfg = get_config("qwen2.5-3b").reduced().with_dtype("bfloat16")
    model = Model(cfg, device="cuda")
    return model, model.init(0)


def _spec_cache(model, params, kv_dtype, lens, paged, ps=8, max_len=64):
    """A serve-form cache after a pad-masked prefill of seeded prompts of
    ``lens`` tokens; ``paged`` moves it into a page pool at a seeded
    placement (row r owns ``ceil((len + SPEC_K + 1) / ps)`` pages, the
    table entries past them stay 0)."""
    rng = np.random.RandomState(5)
    toks = rng.randint(1, model.cfg.vocab_size,
                       (len(lens), max(lens))).astype(np.int32)
    _, cache = model.prefill_padded(
        params, {"tokens": toks, "lengths": np.asarray(lens, np.int32)},
        max_len, kv_dtype)
    if not paged:
        return cache
    per_seq = max_len // ps
    pool = model.init_paged_cache(len(lens), max_len, len(lens) * per_seq,
                                  ps, kv_dtype)
    spec = model.cache_page_spec(dtype=kv_dtype)
    order = rng.permutation(len(lens) * per_seq) + 1
    for row, length in enumerate(lens):
        used = -(-(length + SPEC_K + 1) // ps)
        pages = order[row * per_seq: row * per_seq + used]
        single = {key: leaf[:, row:row + 1] for key, leaf in cache.items()
                  if key != "len"}
        model.write_page(pool, single, list(pages), list(range(used)),
                         spec=spec, page_size=ps)
        pool["pt"][:, row, :used] = torch.from_numpy(pages.astype(np.int32))
        pool["len"][:, row] = length
    return pool


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("paged", [False, True])
def test_spec_verify_equals_per_position_decode(gen, paged, kv_dtype):
    """The reduced qwen2.5-3b in bf16: ``verify_step``'s logits at every
    position equal, bit for bit, those of the ``decode_step`` that
    consumes the same tokens (K2 / K3, K7 / K8 once a position and layer,
    as a tick's), and both caches end with the same bytes."""
    model, params = _spec_model()
    lens = [5, 40, 17, 1]
    c1 = _spec_cache(model, params, kv_dtype, lens, paged)
    c2 = _spec_cache(model, params, kv_dtype, lens, paged)
    block = np.random.RandomState(6).randint(
        1, model.cfg.vocab_size, (len(lens), SPEC_K + 1)).astype(np.int32)
    quantized = kv_dtype == torch.int8
    fn = {(False, False): da.decode_attention,
          (True, False): da.paged_decode_attention,
          (False, True): da.decode_attention_quantized,
          (True, True): da.paged_decode_attention_quantized}[paged,
                                                             quantized]
    before = dict(fn.path_launches)
    vlogits, c1 = model.verify_step(params, block, c1)
    torch.cuda.synchronize()
    assert fn.path_launches["mma"] - before.get("mma", 0) \
        == (SPEC_K + 1) * model.cfg.n_layers
    for j in range(SPEC_K + 1):
        dlogits, c2 = model.decode_step(params, block[:, j:j + 1], c2)
        assert torch.equal(vlogits[:, j], dlogits), f"position {j}"
    for key in c1:
        assert torch.equal(quant.as_bytes(c1[key]),
                           quant.as_bytes(c2[key])), key


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
@pytest.mark.parametrize("drafter", ["self", "cold"])
def test_spec_serve_equals_greedy_on_card(gen, drafter, cache):
    """Speculative serve of the reduced bf16 qwen2.5-3b equals greedy
    serve bit for bit with the self drafter (which then accepts every
    proposal the budget does not cut) and with a cold 2-layer drafter."""
    import dataclasses

    from repro_torch.serve import SpecConfig

    model, params = _spec_model()
    if drafter == "self":
        draft, dparams = model, params
    else:
        draft = Model(dataclasses.replace(model.cfg, n_layers=2),
                      device="cuda")
        dparams = draft.init(1)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, model.cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 6)]
    base = dict(max_len=64, slots=3, refill_schedule="faa",
                cache_dtype="bfloat16")
    if cache == "paged":
        base.update(cache="paged", page_size=8, prefix_cache=False)
    n_new = 9
    want = Engine(model, params, ServeConfig(**base)).serve(prompts, n_new)
    eng = Engine(model, params, ServeConfig(**base, spec=SpecConfig(
        draft=draft, draft_params=dparams, k=SPEC_K)))
    got = eng.serve(prompts, n_new)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    rep = eng.last_report
    assert rep.drafted_tokens == rep.accepted_tokens + rep.wasted_tokens
    if drafter == "self":
        # n_new - 1 tokens after the first: full spans of SPEC_K + 1
        span = SPEC_K + 1
        ticks = -(-(n_new - 1) // span)
        assert rep.decode_slot_ticks == ticks * len(prompts)
        assert rep.accepted_tokens == len(prompts) * (
            (n_new - 1) - ticks)


# ---------------------------------- head_dim 80 (zamba2) and the sampler

D80 = 80


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(32, 32), (8, 2)])
def test_d80_kernels_match_plain(gen, dtype, hq, hkv):
    """K1, K2, K3, K7, K8 and K10 at head_dim 80 (zamba2's G = 1 shape and
    a grouped one) against their plain versions, f32 on the CUDA cores and
    bf16 on the tensor cores: a causal prefill into a longer cache and a
    ragged one; decode with a kv_len of 0 and one past S; K3 == K2 and K8
    == K7 on the gathered rows, bit for bit; the launches on the dtype's
    path."""
    path = "mma" if dtype == torch.bfloat16 else "cuda_cores"
    q = _randn(gen, dtype, 2, 77, hq, D80)
    k = _randn(gen, dtype, 2, 256, hkv, D80)
    v = _randn(gen, dtype, 2, 256, hkv, D80)
    kl = torch.tensor([77, 200], dtype=torch.int32, device="cuda")
    for args in (dict(kv_len=77, q_offset=0), dict(kv_len=kl, q_offset=0),
                 dict(kv_len=kl, q_offset=100, causal=False)):
        out, lse = fa.flash_attention(q, k, v, **args)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **args)
        assert _err(out, ref) <= TOL[dtype]
        assert _err(lse, ref_lse) <= 1e-3
        for store in QDTYPES:
            kq, ks = _quantized(k, store)
            vq, vs = _quantized(v, store)
            out, lse = fa.flash_attention_quantized(q, kq, ks, vq, vs, **args)
            ref, ref_lse = fa.flash_attention_quantized_plain(
                q, kq, ks, vq, vs, **args)
            assert _err(out, ref) <= TOL[dtype]
            assert _err(lse, ref_lse) <= 1e-3
    b = 4
    qd = _randn(gen, dtype, b, hq, D80)
    kd = _randn(gen, dtype, b, 256, hkv, D80)
    vd = _randn(gen, dtype, b, 256, hkv, D80)
    kl = torch.tensor([0, 255, 1000, 65], dtype=torch.int32, device="cuda")
    before = dict(da.decode_attention.path_launches)
    k2 = da.decode_attention(qd, kd, vd, kl)
    assert _err(k2, da.decode_attention_plain(qd, kd, vd, kl)) <= TOL[dtype]
    assert torch.all(k2[0] == 0)
    assert da.decode_attention.path_launches[path] == before.get(path, 0) + 1
    kp, vp, pt, _, _ = _mma_pool(kd, vd, 16, 3)
    k3 = da.paged_decode_attention(qd, kp, vp, pt, kl)
    assert torch.equal(k3, k2)
    for store in QDTYPES:
        kq, ks = _quantized(kp.to(torch.bfloat16), store)
        vq, vs = _quantized(vp.to(torch.bfloat16), store)
        k8 = da.paged_decode_attention_quantized(qd, kq, ks, vq, vs, pt, kl)
        rows = [quant.as_bytes(t)[pt.long()].flatten(1, 2).view(t.dtype)
                for t in (kq, ks, vq, vs)]
        k7 = da.decode_attention_quantized(qd, *rows, kl)
        assert _err(k7, da.decode_attention_quantized_plain(
            qd, *rows, kl)) <= TOL[dtype]
        assert torch.equal(k8, k7)


def test_d80_is_built_for_k11(gen):
    """K11 takes head dim 80 (the hybrid family trains) and holds to its
    plain version there; a square dim it is not built for still raises."""
    q = _randn(gen, torch.bfloat16, 1, 64, 4, D80)
    out, lse = fa.flash_attention(q, q, q)
    got = fa.flash_attention_bwd(q, q, q, out, lse, q)
    want = fa.flash_attention_bwd_plain(q, q, q, out, lse, q)
    for x, w in zip(got, want):
        assert _rel(x, w) <= BWD_TOL[torch.bfloat16]
    q48 = _randn(gen, torch.bfloat16, 1, 64, 4, 48)
    out48, lse48 = fa.flash_attention_plain(q48, q48, q48)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q48, q48, q48, out48.contiguous(), lse48,
                               q48)


def test_sampler_on_card_equals_cpu(gen):
    """The sampler's bits and uniforms on the card equal the CPU's bit for
    bit (int64 words), its gumbels within 4 eps (the device's logarithms),
    and its tokens over [8, V] logits equal the CPU's."""
    from repro_torch.serve import sampling

    rids = torch.arange(8, dtype=torch.int64) * 97 + 3
    steps = torch.arange(8, dtype=torch.int64) * 5
    keys = {dev: sampling.fold_in(sampling.fold_in(
        sampling.prng_key(11, dev), rids.to(dev)), steps.to(dev))
        for dev in ("cpu", "cuda")}
    for width in (8, 16, 32):
        assert torch.equal(sampling.random_bits(keys["cuda"], width,
                                                (5000,)).cpu(),
                           sampling.random_bits(keys["cpu"], width, (5000,)))
    for dtype in (torch.float32, torch.bfloat16):
        tiny = torch.finfo(dtype).tiny
        assert torch.equal(
            sampling.uniform(keys["cuda"], (5000,), dtype, tiny).cpu(),
            sampling.uniform(keys["cpu"], (5000,), dtype, tiny))
        eps = torch.finfo(dtype).eps
        torch.testing.assert_close(
            sampling.gumbel(keys["cuda"], (5000,), dtype).cpu().float(),
            sampling.gumbel(keys["cpu"], (5000,), dtype).float(),
            atol=4 * eps, rtol=4 * eps)
    logits = torch.randn((8, 151_936), generator=gen, device="cuda") * 3
    got = sampling.sample(logits, 11, rids, steps, 0.8)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), sampling.sample(logits.cpu(), 11, rids,
                                                  steps, 0.8))


def _hybrid_d80():
    import dataclasses

    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              head_dim=D80, n_heads=4, n_kv_heads=4)
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)
    return cpu, params, card, _to_card(params)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_reduced_hybrid_serve_on_card_equals_cpu(gen, kv_dtype):
    """The reduced f32 zamba2-2.7b at the full model's head shape (80, 4
    query heads on 4 KV heads) served on the card (K12, K1 / K10, K2 / K7,
    K3 / K8) gives the CPU's tokens, contiguous and paged, and paged equals
    contiguous; every multi-token prompt runs K12 once per SSD layer."""
    cpu, params, card, params_card = _hybrid_d80()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, n).astype(np.int32)
               for n in (1, 9, 40, 100, 17, 64)]
    outs = {}
    for cache in ("contiguous", "paged"):
        scfg = ServeConfig(max_len=128, slots=3, cache=cache, page_size=16,
                           kv_dtype=kv_dtype)
        want = Engine(cpu, params, scfg).serve(prompts, 8)
        before = ss.ssd.launches
        outs[cache] = Engine(card, params_card, scfg).serve(prompts, 8)
        for w, g in zip(want, outs[cache]):
            np.testing.assert_array_equal(g, w)
        assert ss.ssd.launches - before == card.cfg.n_layers * 5
    for a, b in zip(outs["contiguous"], outs["paged"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["continuous", "rounds"])
def test_temperature_serve_on_card_equals_cpu(gen, mode):
    """The reduced f32 qwen2.5-3b at temperature 0.8: the card's draws
    (the sampler on the device) give the CPU's tokens, continuous and
    rounds."""
    cfg = get_config("qwen2.5-3b").reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, n).astype(np.int32)
               for n in rng.randint(3, 30, 7)]
    scfg = ServeConfig(max_len=64, slots=3, temperature=0.8, mode=mode)
    want = Engine(cpu, params, scfg).serve(prompts, 10, seed=2)
    got = Engine(card, _to_card(params), scfg).serve(prompts, 10, seed=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_reduced_encdec_vlm_generate_on_card_equals_cpu(gen, arch):
    """The reduced f32 encoder-decoder and vision configs (the vision
    family's cross gates at 0.5) through ``generate`` on the card give the
    CPU's greedy tokens; every prefill and tick runs K1 once an attention
    call (the encoder's, the decoder's self and cross calls)."""
    from repro_torch.configs.inputs import make_dummy_batch

    cfg = get_config(arch).reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(0)
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            params["groups"]["cross"][name].fill_(0.5)
    batch = make_dummy_batch(cfg, 2, 24, seed=3, device="cpu")
    scfg = ServeConfig(max_len=64)
    want = Engine(cpu, params, scfg).generate(batch, 6)
    before = fa.flash_attention.launches
    got = Engine(card, _to_card(params), scfg).generate(_to_card(batch), 6)
    np.testing.assert_array_equal(got, want)
    calls = (cfg.cross_attn_groups * (cfg.self_per_group + 1)
             if cfg.family == "vlm" else 2 * cfg.n_layers)
    prefill = calls + (cfg.n_encoder_layers if cfg.family == "encdec" else 0)
    assert fa.flash_attention.launches - before == prefill + 6 * calls


# ------------------------------------- the cost model's fit, selective remat

@pytest.mark.parametrize("case", ["paper", "fast_points"])
def test_calibrate_fit_on_card_equals_cpu(gen, case):
    """``train_cost_model`` on the card (its default) against the same fit
    on the CPU: the paper's inference rows at the default arguments, and
    the fast calibration points at the fast fit's settings."""
    import importlib

    from repro_torch.core import cost_model as cm

    cal = importlib.import_module("repro_torch.core.runtime.calibrate")
    if case == "paper":
        x, y = cm.paper_normalized_features(cm.PAPER_INFERENCE_ROWS)
        kw = {}
    else:
        x, y, _ = cal.generate_points(fast=True)
        kw = dict(steps=2500, restarts=4)
    card, card_losses = cm.train_cost_model(x, y, **kw)
    cpu, cpu_losses = cm.train_cost_model(x, y, device="cpu", **kw)
    assert card_losses.shape == cpu_losses.shape
    assert abs(card_losses[-1] - cpu_losses[-1]) <= 1e-3 * cpu_losses[-1]
    want = cm.predict(cpu, x)
    assert np.max(np.abs(cm.predict(card, x) - want) / np.abs(want)) <= 1e-2
    for row in cm.PAPER_INFERENCE_ROWS:
        feats = cm.WorkloadFeatures(
            core_groups=int(row[0]) // 100, threads=int(row[1]),
            unit_read=2 ** int(row[2]), unit_write=2 ** int(row[3]),
            unit_comp=2 ** int(10 * row[4]))
        assert abs(cm.suggest_block_size(feats, params=card)
                   - cm.suggest_block_size(feats, params=cpu)) <= 1


def test_remat_dots_on_card_equals_full(gen):
    """The reduced qwen2.5-3b in bf16 on the card: ``remat_policy="dots"``
    gives ``"full"``'s loss and gradients bit for bit, runs K1 twice per
    layer as ``"full"`` does, and each projection ``x @ w`` is one
    ``aten.mm`` (the op the policy saves), never a ``bmm``."""
    import dataclasses

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.checkpoint.checkpoint import flatten

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.calls:
                self.calls[name] += 1
            return func(*args, **(kwargs or {}))

    cfg = get_config("qwen2.5-3b").reduced().with_dtype("bfloat16")
    params = _to_device(Model(cfg, device="cpu").init(0), "cuda")
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).to("cuda")
    runs = {}
    for policy in ("full", "dots"):
        model = Model(dataclasses.replace(cfg, remat_policy=policy),
                      device="cuda")
        tree = opt.tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = opt.tree_leaves(tree)
        before = fa.flash_attention.launches
        with Products() as products:
            loss, _ = model.loss(tree, {"tokens": toks})
            grads = torch.autograd.grad(loss, leaves)
        runs[policy] = (loss, grads, fa.flash_attention.launches - before,
                        products.calls)
    (lf, gf, kf, cf), (ld, gd, kd, cd) = runs["full"], runs["dots"]
    assert torch.equal(lf, ld)
    names = list(flatten(params))       # tree_leaves' order
    for name, a, b in zip(names, gf, gd):
        assert torch.equal(a, b), f"first leaf that differs: {name}"
    assert kf == kd == 2 * cfg.n_layers
    assert cd["mm"] < cf["mm"] and cd["bmm"] == cf["bmm"]


# ------------------------------------------- K16 and the trained families

# (B, S, H, P, G, N, initial state and d_final): mamba2-780m's and
# zamba2-2.7b's training shapes (a microbatch of 2 x 1024 tokens), a
# ragged length, two groups, a state with a final-state gradient, the
# reduced widths; then the edges of the tensor-core kernel's warp layout:
# P = 32, N = 64 with G = 2 and a state (one 16-column slab of dx a
# parity), P = 16 at N = 128 (dx's columns in one parity) and P = 64 at
# N = 16 (fewer state units than warps), G = 4 at one whole chunk
SSD_BWD_CASES = [(2, 1024, 48, 64, 1, 128, False),
                 (2, 1024, 80, 64, 1, 64, False),
                 (2, 1000, 48, 64, 1, 128, False),
                 (2, 300, 16, 32, 2, 64, False),
                 (2, 200, 48, 64, 1, 128, True),
                 (3, 37, 8, 16, 1, 16, True),
                 (2, 200, 8, 32, 2, 64, True),
                 (1, 100, 4, 16, 1, 128, False),
                 (1, 64, 8, 64, 4, 16, True)]
SSD_BWD_PATH = {torch.float32: "cuda_cores", torch.bfloat16: "mma"}


def _f64(t):
    return None if t is None else t.double()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,with_state", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain_and_repeats(gen, dtype, b, s, h, p,
                                                  g, n, with_state):
    """K16 against its plain version (autograd of ssd_plain): f32 (on the
    CUDA cores) against the plain version run in f64 (the exact gradient)
    within 1e-5 of each gradient's largest |value|, bf16 (on the tensor
    cores) against the plain version on the same bf16 values within
    1e-2."""
    ins = _ssd_inputs(gen, dtype, b, s, h, p, g, n)
    dy = _randn(gen, dtype, b, s, h, p)
    extra = {}
    if with_state:
        extra = {"initial_state": _randn(gen, torch.float32, b, h, p, n),
                 "d_final": _randn(gen, torch.float32, b, h, p, n)}
    before = (ss.ssd_bwd.launches,
              ss.ssd_bwd.path_launches[SSD_BWD_PATH[dtype]])
    got = ss.ssd_bwd(*ins, dy, **extra)
    again = ss.ssd_bwd(*ins, dy, **extra)
    torch.cuda.synchronize()
    assert (ss.ssd_bwd.launches,
            ss.ssd_bwd.path_launches[SSD_BWD_PATH[dtype]]) == (
                before[0] + 2, before[1] + 2)
    assert all(x is None or torch.equal(x, y) for x, y in zip(got, again))
    want = ss.ssd_bwd_plain(*ins, dy, **extra)
    if dtype == torch.float32:
        want = ss.ssd_bwd_plain(*map(_f64, ins), _f64(dy),
                                **{k: _f64(v) for k, v in extra.items()})
    assert (got[5] is None) == (not with_state)
    for x, w, t in zip(got, want, ins + (extra.get("initial_state"),)):
        if t is None:
            continue
        assert x.dtype == t.dtype and x.shape == t.shape
        assert _rel(x, w) <= SSD_TOL[dtype]


def test_ssd_function_grads_match_plain_autograd(gen):
    """SSDFunction (K12 forward, K16 backward) against autograd of
    ssd_plain in f64, f32 inputs, y and final-state cotangents."""
    b, s, h, p, g, n = 2, 130, 8, 32, 2, 64
    ins = list(_ssd_inputs(gen, torch.float32, b, s, h, p, g, n))
    ins.append(_randn(gen, torch.float32, b, h, p, n))
    dy = _randn(gen, torch.float32, b, s, h, p)
    dfin = _randn(gen, torch.float32, b, h, p, n)
    grads = []
    for fn, cast in ((ss.ssd_autograd, lambda t: t),
                     (ss.ssd_plain, _f64)):
        leaves = [cast(t).clone().requires_grad_() for t in ins]
        y, st = fn(*leaves[:5], initial_state=leaves[5])
        grads.append(torch.autograd.grad(
            (y * cast(dy)).sum() + (st * cast(dfin)).sum(), leaves))
    for x, w in zip(*grads):
        assert _rel(x, w) <= SSD_TOL[torch.float32]


def test_ssd_bwd_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x, dt, a, b_in, c_in = _ssd_inputs(gen, torch.float32, 1, 8, 4, 16, 1,
                                       16)
    with pytest.raises(ValueError, match="dy"):
        ss.ssd_bwd(x, dt, a, b_in, c_in, x.bfloat16())
    with pytest.raises(ValueError, match="d_final"):
        ss.ssd_bwd(x, dt, a, b_in, c_in, x,
                   d_final=_randn(gen, torch.float32, 1, 4, 16, 8))
    with pytest.raises(ValueError, match="chunks of 64"):
        ss.ssd_bwd(x, dt, a, b_in, c_in, x, chunk=32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 1024, 1024, 32, 32, 80, True),    # zamba2's shared attention
    (1, 300, 300, 4, 4, 80, True),        # ragged, D = 80
    (2, 128, 128, 16, 16, 64, False),     # seamless's encoder
    (2, 512, 128, 16, 16, 64, False),     # seamless's cross-attention
    (2, 512, 1601, 32, 8, 128, False),    # llama-vision's: a 1-row tail
])
def test_flash_bwd_kernel_at_d80_and_cross_shapes(gen, dtype, b, sq, skv,
                                                  hq, hkv, d, causal):
    q = _randn(gen, dtype, b, sq, hq, d)
    k = _randn(gen, dtype, b, skv, hkv, d)
    v = _randn(gen, dtype, b, skv, hkv, d)
    do = _randn(gen, dtype, b, sq, hq, d)
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    fa.flash_attention_bwd.path_launches.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert dict(fa.flash_attention_bwd.path_launches) == {
        fa.path(q): 1}
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    for x, w in zip(got, want):
        assert _rel(x, w) <= BWD_TOL[dtype]


@pytest.mark.parametrize("arch,heads", [
    ("mamba2-780m", {}),
    ("zamba2-2.7b", dict(head_dim=80, n_heads=4, n_kv_heads=4)),
    ("seamless-m4t-large-v2", dict(head_dim=64, n_heads=4, n_kv_heads=4)),
    ("llama-3.2-vision-11b", dict(head_dim=128, n_heads=8, n_kv_heads=2)),
])
def test_reduced_family_loss_and_grads_on_card_equal_cpu(gen, arch, heads):
    """The reduced f32 model at the full model's head shape (the vision
    gates at 0.5) over 2 rows of 100 tokens: the loss within rtol 1e-5
    and every gradient leaf within 1e-3 of its largest |value| on the
    card (K12/K16, K1/K11) and on the CPU (the plain versions); K16 once
    per SSD layer and K11 once per attention call of the forward."""
    from repro_torch.configs.inputs import make_dummy_batch

    cfg = dataclasses.replace(get_config(arch).reduced(), **heads)
    params = Model(cfg, device="cpu").init(0)
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            params["groups"]["cross"][name].fill_(0.5)
    batch = make_dummy_batch(cfg, 2, 100, 0, device="cpu")
    runs = []
    for device in ("cpu", "cuda"):
        tree = opt.tree_map(lambda t: t.detach().to(device).requires_grad_(),
                            params)
        counts = (ss.ssd_bwd.launches, fa.flash_attention_bwd.launches)
        loss, _ = Model(cfg, device=device).loss(
            tree, {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, opt.tree_leaves(tree))
        runs.append((loss.item(), [x.cpu() for x in grads],
                     ss.ssd_bwd.launches - counts[0],
                     fa.flash_attention_bwd.launches - counts[1]))
    (lc, gc_, _, _), (lg, gg, k16, k11) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for x, w in zip(gg, gc_):
        assert _err(x, w) <= 1e-3 * w.abs().max().item()
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
              "encdec": cfg.n_encoder_layers + 2 * cfg.n_layers,
              "vlm": cfg.cross_attn_groups * (cfg.self_per_group + 1)}
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert (k16, k11) == (n_ssd, n_attn[cfg.family])


# ------------------------------------- K17 and K11 at MLA's (Dk, Dv)

def _k17_path(dtype, d, f) -> str:
    """K17's rule on fresh (aligned) operands."""
    if dtype == torch.float32:
        return "cuda_cores"
    return "wgmma" if d % 8 == 0 and f % 8 == 0 else "mma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [
    (64, 240, 2048, 1408),    # the training shape: gate / up
    (64, 240, 1408, 2048),    # down
    (3, 37, 72, 44),          # ragged C, d and f: mma
    (4, 24, 128, 96),         # C <= 32
    (2, 50, 36, 40),          # rows not of whole 16-byte copies: mma
    (4, 16, 64, 32),          # the reduced widths
    (3, 64, 128, 96),         # C = 64: one m64 warpgroup for dx
    (2, 256, 136, 72),        # one full 256-row tile; d past a 128 tile
    (2, 257, 128, 96),        # two 256-row tiles; dw's K 257 deep
    (1, 100, 64, 128),        # E = 1
    (2, 48, 72, 40),          # d and f multiples of 8, not of 64
])
def test_k17_matches_plain_and_repeats(gen, dtype, e, c, d, f):
    """K17 (dx = dy w^T, dw = x^T dy) against its plain version within
    ``GMM_TOL`` of each gradient's largest |value|, two launches on the
    rule's path (bf16: wgmma with 16-byte rows, mma.sync else), and a
    repeated call bit for bit (no atomics)."""
    x = _randn(gen, dtype, e, c, d)
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         / d ** 0.5).to(dtype)
    dy = _randn(gen, dtype, e, c, f)
    mg.grouped_matmul_bwd.path_launches.clear()
    got = mg.grouped_matmul_bwd(x, w, dy)
    again = mg.grouped_matmul_bwd(x, w, dy)
    torch.cuda.synchronize()
    want_path = _k17_path(dtype, d, f)
    assert mg.bwd_path(x, w, dy) == want_path
    assert dict(mg.grouped_matmul_bwd.path_launches) == {want_path: 4}
    want = mg.grouped_matmul_bwd_plain(x, w, dy)
    for g, wt, t in zip(got, want, (x, w)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, wt) <= GMM_TOL[dtype]
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_k17_misaligned_view_takes_mma(gen):
    """bf16 K17 whose x starts one element off a 16-byte boundary cannot
    be a TMA map's base: the rule sends it to ``"mma"``, and its gradients
    hold the wgmma kernel's on the aligned copy within the tolerance."""
    e, c, d, f = 2, 64, 128, 96
    x = _randn(gen, torch.bfloat16, e, c, d)
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         / d ** 0.5).bfloat16()
    dy = _randn(gen, torch.bfloat16, e, c, f)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    x_off = flat[1:].view(x.shape)
    x_off.copy_(x)
    assert (mg.bwd_path(x, w, dy), mg.bwd_path(x_off, w, dy)) == (
        "wgmma", "mma")
    mg.grouped_matmul_bwd.path_launches.clear()
    got = mg.grouped_matmul_bwd(x_off, w, dy)
    want = mg.grouped_matmul_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert dict(mg.grouped_matmul_bwd.path_launches) == {"mma": 2,
                                                         "wgmma": 2}
    for g, wt in zip(got, want):
        assert _rel(g, wt) <= GMM_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_function_matches_plain_autograd(gen, dtype):
    """GroupedMatmulFunction (K14 forward, K17 backward) against autograd
    of ``grouped_matmul_plain``: output and gradients within
    ``GMM_TOL``."""
    x = _randn(gen, dtype, 4, 40, 72)
    w = (torch.randn((4, 72, 48), generator=gen, device="cuda")
         / 72 ** 0.5).to(dtype)
    dy = _randn(gen, dtype, 4, 40, 48)
    runs = []
    for fn in (mg.grouped_matmul_autograd, mg.grouped_matmul_plain):
        lx, lw = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(lx, lw)
        runs.append([out, *torch.autograd.grad(out, (lx, lw), dy)])
    for g, wt in zip(*runs):
        assert _rel(g, wt) <= GMM_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dk,dv,causal", [
    (2, 1024, 1024, 16, 16, 192, 128, True),   # deepseek's MLA prefill
    (1, 1000, 1000, 16, 16, 192, 128, True),   # ragged
    (1, 200, 300, 4, 2, 192, 128, False),      # GQA, not causal
    (2, 100, 100, 4, 4, 24, 16, True),         # the reduced config's
    (1, 70, 70, 4, 2, 24, 16, True),           # GQA, ragged
])
def test_flash_bwd_kernel_at_mla_pairs(gen, dtype, b, sq, skv, hq, hkv, dk,
                                       dv, causal):
    """K11 at Dk != Dv against its plain version (``BWD_TOL``), on the
    dtype's path, repeated bit for bit."""
    q, k = _randn(gen, dtype, b, sq, hq, dk), _randn(gen, dtype, b, skv, hkv,
                                                     dk)
    v, do = _randn(gen, dtype, b, skv, hkv, dv), _randn(gen, dtype, b, sq, hq,
                                                        dv)
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    fa.flash_attention_bwd.path_launches.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert dict(fa.flash_attention_bwd.path_launches) == {fa.path(q): 2}
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    for x, w, t in zip(got, want, (q, k, v)):
        assert x.shape == t.shape
        assert _rel(x, w) <= BWD_TOL[dtype]
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_reduced_moe_loss_and_grads_on_card_equal_cpu(gen):
    """The reduced f32 deepseek-v2-lite-16b over 2 rows of 100 tokens: the
    loss and aux within rtol 1e-5 and every gradient leaf within 1e-3 of
    its largest |value| on the card (K1/K11 at (24, 16), K14/K17) and on
    the CPU (the plain versions); K11 once per layer, K17 six times per
    MoE layer."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    params = Model(cfg, device="cpu").init(0)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (2, 100)))
    runs = []
    for device in ("cpu", "cuda"):
        tree = opt.tree_map(lambda t: t.detach().to(device).requires_grad_(),
                            params)
        counts = (fa.flash_attention_bwd.launches,
                  mg.grouped_matmul_bwd.launches)
        loss, met = Model(cfg, device=device).loss(tree, {"tokens": toks})
        grads = torch.autograd.grad(loss, opt.tree_leaves(tree))
        runs.append((loss.item(), met["aux"].item(),
                     [x.cpu() for x in grads],
                     fa.flash_attention_bwd.launches - counts[0],
                     mg.grouped_matmul_bwd.launches - counts[1]))
    (lc, ac, gc_, _, _), (lg, ag, gg, k11, k17) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(ag, ac, rtol=1e-5)
    for x, w in zip(gg, gc_):
        assert _err(x, w) <= 1e-3 * w.abs().max().item()
    assert (k11, k17) == (cfg.n_layers,
                          6 * (cfg.n_layers - cfg.first_dense_layers))


# ----------------------- the tuned instances: K1/K4 tiles, K12/K13 chunks,
# ----------------------- K14/K15 tiles (the autotuner's template choices)

def test_tuned_instances_are_the_library_instances(gen):
    """The tiles and chunks the ops (and the search's candidates) offer
    are exactly those the CUDA libraries report they build, and the ring
    layout ``pipelined_smem`` fits each tile's depth against is the
    library's."""
    for dk, dv in fa.HEAD_DIM_PAIRS:
        assert fa.library_tiles(dk, dv) == fa.tile_options(dk, dv)
        for bq, bk in fa.tile_options(dk, dv):
            base, stage = fa.pipelined_smem(2, dk, dv, block_q=bq,
                                            block_k=bk)
            for depth in DEPTHS:
                assert fa.ring_smem_bytes(
                    dk, dv, depth, torch.bfloat16, block_q=bq,
                    block_k=bk) == base + depth * stage, (dk, dv, bq, bk)
    for p in ss.HEAD_DIMS:
        for n in ss.STATE_DIMS:
            for dtype in (torch.float32, torch.bfloat16):
                assert ss.library_chunks(p, n, dtype) == ss.chunks(p, n,
                                                                   dtype)
    want = [(k, cfg["block_c"], cfg["block_f"], cfg["block_d"],
             cfg["stages"]) for k, c in (("wgmma", 64), ("stream", 8),
                                         ("stream", 16), ("stream", 32))
            for cfg in mg.tile_options(k, c)]
    assert sorted(mg.library_tiles()) == sorted(want)


TUNED_FLASH_CASES = [
    # b, sq, skv, hq, hkv, kv_len, q_offset, causal
    (1, 512, 1024, 16, 2, 512, 0, True),     # the serve prefill
    (8, 1, 1601, 32, 8, None, None, False),  # the vision cross tick
    (2, 100, 300, 8, 2, [300, 37], 200, True),  # ragged, per-row kv_len
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,kv_len,q_offset,causal",
                         TUNED_FLASH_CASES)
def test_tuned_flash_tiles_match_plain_and_block_q_keeps_bits(
        gen, b, sq, skv, hq, hkv, kv_len, q_offset, causal):
    """bf16 K1 and K4 at every built tile at (128, 128): out within 2e-2
    and lse within 1e-3 of the plain version; at one block_k every
    block_q and depth gives the same bits (block_q changes no sum);
    launches counted by tile."""
    dt = torch.bfloat16
    q = _randn(gen, dt, b, sq, hq, 128)
    k, v = (_randn(gen, dt, b, skv, hkv, 128) for _ in range(2))
    kl = (torch.tensor(kv_len, dtype=torch.int32, device="cuda")
          if isinstance(kv_len, list) else kv_len)
    kw = dict(kv_len=kl, q_offset=q_offset, causal=causal)
    want = fa.flash_attention_plain(q, k, v, **kw)
    by_bk = {}
    for bq, bk in fa.tile_options(128, 128):
        before = fa.flash_attention.tile_launches[(bq, bk, 1)]
        runs = [fa.flash_attention(q, k, v, num_buffers=1, block_q=bq,
                                   block_k=bk, **kw)]
        runs += [fa.flash_attention_pipelined(q, k, v, num_buffers=depth,
                                              block_q=bq, block_k=bk, **kw)
                 for depth in DEPTHS]
        torch.cuda.synchronize()
        assert fa.flash_attention.tile_launches[(bq, bk, 1)] == before + 1
        for out, lse in runs:
            assert _err(out, want[0]) <= TOL[dt], (bq, bk)
            assert _err(lse, want[1]) <= 1e-3, (bq, bk)
        ref = by_bk.setdefault(bk, runs[0])
        for out, lse in runs:
            assert torch.equal(out, ref[0]) and torch.equal(lse, ref[1])


@pytest.mark.parametrize("p,n", [(64, 128), (64, 64), (32, 64)])
def test_tuned_ssd_chunks_match_plain(gen, p, n):
    """bf16 K12 at every built chunk against the plain version at that
    chunk (y 1e-2, the f32 state 1e-5 of the largest |value|) on a ragged
    length with an initial state, repeated bit for bit; bf16 K13 at each
    chunk equal to K12 on the dequantized x rounded to bf16 bit for bit;
    the chunks agree with each other within the same tolerances (the
    chunk moves rounding only)."""
    ins = _ssd_inputs(gen, torch.bfloat16, 1, 300, 8, p, 1, n)
    init = _randn(gen, torch.float32, 1, 8, p, n)
    xq, xs = _quantized(ins[0].float(), torch.int8)
    xr = quant.dequantize(xq, xs).to(torch.bfloat16)
    assert ss.chunks(p, n) == ss.CHUNKS
    base = None
    for chunk in ss.chunks(p, n):
        before = ss.ssd.chunk_launches[chunk]
        y, st = ss.ssd(*ins, chunk=chunk, initial_state=init)
        y2, st2 = ss.ssd(*ins, chunk=chunk, initial_state=init)
        torch.cuda.synchronize()
        assert ss.ssd.chunk_launches[chunk] == before + 2
        assert torch.equal(y, y2) and torch.equal(st, st2)
        want_y, want_st = ss.ssd_plain(*ins, chunk=chunk, initial_state=init)
        assert _rel(y, want_y) <= SSD_TOL[torch.bfloat16], chunk
        assert _rel(st, want_st) <= SSD_STATE_TOL, chunk
        yq, stq = ss.ssd_quantized(xq, xs, *ins[1:], chunk=chunk)
        y12, st12 = ss.ssd(xr, *ins[1:], chunk=chunk)
        assert torch.equal(yq, y12) and torch.equal(stq, st12), chunk
        if base is None:
            base = (y, st)
        assert _rel(y, base[0]) <= SSD_TOL[torch.bfloat16]
        assert _rel(st, base[1]) <= SSD_STATE_TOL


@pytest.mark.parametrize("e,c,d,f", [
    (64, 8, 2048, 1408),     # the decode's gate / up (the stream)
    (4, 13, 64, 40),         # NT = 2, f a multiple of 8
    (4, 32, 256, 96),        # NT = 4
    (64, 64, 2048, 1408),    # the 488-token prefill (wgmma)
    (8, 240, 512, 256),      # the training capacity (wgmma)
])
def test_tuned_gmm_tiles_match_plain_and_keep_bits(gen, e, c, d, f):
    """bf16 K14 at every built tile of the path C takes (the stream's
    widths; wgmma's heights and stage counts): within 1e-2 of the plain
    version's largest |value|, and every tile the same bits (no tile
    moves a sum); K15 (int8, e4m3) on the stream likewise at every
    width; launches counted by tile."""
    x, w = _gmm_inputs(gen, torch.bfloat16, e, c, d, f)
    kernel = mg.path(x, w)
    assert kernel == ("stream" if c <= 32 else "wgmma")
    want = mg.grouped_matmul_plain(x, w)
    outs = []
    for cfg in mg.tile_options(kernel, c):
        key = (kernel, cfg["block_c"], cfg["block_f"], cfg["stages"])
        before = mg.grouped_matmul.tile_launches[key]
        outs.append(mg.grouped_matmul(x, w, tiles=cfg))
        torch.cuda.synchronize()
        assert mg.grouped_matmul.tile_launches[key] == before + 1
        assert _rel(outs[-1], want) <= GMM_TOL[torch.bfloat16], cfg
    assert all(torch.equal(o, outs[0]) for o in outs)
    if kernel != "stream":
        return
    for store in QDTYPES:
        wq, wsc = mg.quantize_expert_weights(w.float(), dtype=store)
        want_q = mg.grouped_matmul_quantized_plain(x, wq, wsc)
        # 1-byte rows of f = 40 are not whole 16-byte copies: the CUDA
        # cores' one tile
        kq = mg.path(x, wq)
        assert kq == ("stream" if f % 16 == 0 else "cuda_cores")
        outs = [mg.grouped_matmul_quantized(x, wq, wsc, tiles=cfg)
                for cfg in mg.tile_options(kq, c)]
        assert all(_rel(o, want_q) <= GMM_TOL[torch.bfloat16] for o in outs)
        assert all(torch.equal(o, outs[0]) for o in outs)


def test_tuned_tiles_not_built_raise(gen):
    """A tile or chunk the library has not built raises before any
    launch, on the op's own check and on the library's; an f32 K4 call
    raises (f32 has no ring); nothing falls back."""
    dt = torch.bfloat16
    q, k = _randn(gen, dt, 1, 16, 4, 64), _randn(gen, dt, 1, 64, 2, 64)
    counts = [fn.launches for fn in (fa.flash_attention,
                                     fa.flash_attention_pipelined,
                                     ss.ssd, ss.ssd_quantized,
                                     mg.grouped_matmul)]
    with pytest.raises(ValueError, match="not built"):
        fa.flash_attention(q, k, k, block_q=16, block_k=32)
    with pytest.raises(ValueError, match="not built"):
        fa.flash_attention_pipelined(q, k, k, block_q=128, block_k=64)
    q128, k128 = (_randn(gen, dt, 1, 16, h, 128) for h in (4, 2))
    with pytest.raises(ValueError, match="not built"):
        fa.flash_attention(q128, k128, k128, block_q=32, block_k=64)
    with pytest.raises(ValueError, match="no ring"):
        fa.flash_attention_pipelined(q.float(), k.float(), k.float())
    ins = _ssd_inputs(gen, dt, 1, 40, 4, 16, 1, 16)
    with pytest.raises(ValueError, match="chunks of 64 rows"):
        ss.ssd(*ins, chunk=32)
    ins = _ssd_inputs(gen, dt, 1, 40, 4, 64, 1, 128)
    with pytest.raises(ValueError, match="got chunk=96"):
        ss.ssd(*ins, chunk=96)
    xq, xs = _quantized(ins[0].float(), torch.int8)
    with pytest.raises(ValueError, match="got chunk=256"):
        ss.ssd_quantized(xq, xs, *ins[1:], chunk=256)
    x, w = _gmm_inputs(gen, dt, 2, 64, 64, 64)
    for bad in ({"block_c": 32, "block_f": 128, "block_d": 64, "stages": 6},
                {"block_c": 256, "block_f": 128, "block_d": 64,
                 "stages": 6},
                {"block_c": 64, "block_f": 64, "block_d": 64}):
        with pytest.raises(ValueError, match="not built"):
            mg.grouped_matmul(x, w, tiles=bad)
    with pytest.raises(ValueError, match="not built"):
        mg.grouped_matmul(x[:, :8].contiguous(), w,
                          tiles={"block_c": 8, "block_f": 96,
                                 "block_d": 64, "stages": 4})
    assert [fn.launches for fn in (fa.flash_attention,
                                   fa.flash_attention_pipelined,
                                   ss.ssd, ss.ssd_quantized,
                                   mg.grouped_matmul)] == counts
    # the library refuses an unbuilt tile on its own, past the op's check
    lib = mg._build.load("moe_gmm", mg._ENTRY_POINTS)
    out = torch.empty(2, 64, 64, dtype=dt, device="cuda")
    rc = lib.moe_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(), 2, 64, 64,
                     64, 1, mg.PATHS["wgmma"], 64, 128, 5,
                     torch.cuda.current_stream().cuda_stream)
    assert rc == -1


# The sequence-sharded decode's two entries (K2's split kernel and its
# combine, launched apart): (b, s, hq, hkv, dk, dv) of qwen's tick and of
# MLA's absorbed decode (16 query heads, and 236b's 128); kv_len: a row inside block 0, one of length 0,
# one past the cache
SEQ_DECODE_CASES = [(8, 1024, 16, 2, 128, 128), (8, 1024, 16, 1, 576, 512),
                    (8, 1024, 128, 1, 576, 512)]
SEQ_KV_LEN = [100, 0, 1024, 2000, 513, 256, 300, 777]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,dk,dv", SEQ_DECODE_CASES)
def test_seq_decode_blocks_equal_one_k2_call(gen, dtype, b, s, hq, hkv, dk,
                                             dv):
    q = _randn(gen, dtype, b, hq, dk)
    k = _randn(gen, dtype, b, s, hkv, dk)
    v = _randn(gen, dtype, b, s, hkv, dv)
    kl = torch.tensor(SEQ_KV_LEN, dtype=torch.int32, device="cuda")
    blocks, ns = 4, 2
    rows = s // blocks
    before = (da.decode_attention_partials.launches,
              da.decode_combine.launches)
    parts = []
    for r in range(blocks):
        local = (kl - r * rows).clamp(0, rows).to(torch.int32)
        parts.append(da.decode_attention_partials(
            q, k[:, r * rows:(r + 1) * rows].contiguous(),
            v[:, r * rows:(r + 1) * rows].contiguous(), local,
            num_splits=ns))
    o, m, l = (torch.cat(t, dim=2).contiguous() for t in zip(*parts))
    assert o.shape == (b, hkv, blocks * ns, hq // hkv, dv)
    got = da.decode_combine(o, m, l, dtype)
    want = da.decode_attention(q, k, v, kl, num_splits=blocks * ns,
                               num_buffers=1)
    torch.cuda.synchronize()
    assert (da.decode_attention_partials.launches,
            da.decode_combine.launches) == (before[0] + blocks,
                                            before[1] + 1)
    assert torch.equal(got, want)
    plain = da.decode_attention_plain(q, k, v, kl)
    assert _err(got, plain) <= TOL[dtype]
    assert float(got[1].float().abs().max()) == 0.0
    # the tick's plan on the whole rows: the partials against their plain
    # version (m and o / l absolutely, l relatively), their combine
    # against the combine's plain version and bit for bit against K2
    tick = da.route(q, k, v).num_splits
    o, m, l = da.decode_attention_partials(q, k, v, kl)
    po, pm, pl = da.decode_attention_partials_plain(q, k, v, kl,
                                                    num_splits=tick)
    assert o.shape == po.shape and m.shape == pm.shape == l.shape
    live = pl > 0
    assert _err(m, pm) <= TOL[dtype]
    assert float(((l - pl).abs() / pl.clamp_min(1)).max()) <= TOL[dtype]
    assert _err(torch.where(live, o / l.clamp_min(1e-30), 0.0),
                torch.where(live, po / pl.clamp_min(1e-30), 0.0)) <= TOL[dtype]
    got = da.decode_combine(o, m, l, dtype)
    assert _err(got, da.decode_combine_plain(o, m, l, dtype)) <= TOL[dtype]
    assert torch.equal(got, da.decode_attention(q, k, v, kl))


@pytest.fixture
def nccl_rank(gen):
    """A world of one NCCL rank (no address: a HashStore), destroyed
    after."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_seq_decode_and_device_parallel_for_at_one_rank(gen, nccl_rank):
    from repro_torch.core import parallel_for as pf
    from repro_torch.core import schedulers as sched
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import distributed_decode_attention

    host = make_mesh((1,), ("data",), device="cuda")
    items = _randn(gen, torch.float32, 37, 5)

    def fn(x):
        return torch.tanh(x) * 3 - x.sum()

    want = torch.func.vmap(fn)(items)
    for schedule in sched.available_schedulers():
        got = pf.device_parallel_for(fn, items, mesh=host,
                                     schedule=schedule)
        assert torch.equal(got, want), schedule
    for bs in (5, 6):
        assert torch.equal(pf.device_parallel_for(fn, items, mesh=host,
                                                  block_size=bs), want)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    b, s, hq, hkv, dk, dv = SEQ_DECODE_CASES[0]
    q = _randn(gen, torch.bfloat16, b, hq, dk)
    k = _randn(gen, torch.bfloat16, b, s, hkv, dk)
    v = _randn(gen, torch.bfloat16, b, s, hkv, dv)
    kl = torch.tensor(SEQ_KV_LEN, dtype=torch.int32, device="cuda")
    assert torch.equal(distributed_decode_attention(q, k, v, kl, mesh=mesh),
                       da.decode_attention(q, k, v, kl))


# ------------------------------------------ sequence-parallel training blocks

# (b, s, hq, hkv, dk, dv): qwen2.5-3b's training microbatch, deepseek's MLA
# prefill, and a ragged one whose blocks of 250 rows cut the 64-row tiles
SEQ_PARALLEL_CASES = [(2, 1024, 16, 2, 128, 128),
                      (2, 1024, 16, 16, 192, 128),
                      (1, 1000, 16, 2, 128, 128)]
SEQ_PARALLEL_BLOCKS = 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,dk,dv", SEQ_PARALLEL_CASES)
def test_seq_parallel_blocks_equal_one_whole_call(gen, dtype, b, s, hq, hkv,
                                                  dk, dv):
    """A sequence-parallel rank's attention: the sequence cut into 4
    blocks, K1 and K11 on each block's queries over K/V rows [0, offset
    + S_loc) (the suffix alignment is the offset).  Where the blocks
    start on a query tile (64 rows on the tensor cores, 16 on the CUDA
    cores) their out, lse and dq laid side by side equal one whole call's
    bit for bit: each tile walks the same K/V tiles in the same order;
    blocks of 250 rows hold them within ``TOL`` / ``BWD_TOL``.  Their dk
    and dv, zero-padded and summed, are within ``BWD_TOL`` of the whole
    call's, and each block within the tolerances of the plain versions."""
    q, do = _randn(gen, dtype, b, s, hq, dk), _randn(gen, dtype, b, s, hq, dv)
    k, v = _randn(gen, dtype, b, s, hkv, dk), _randn(gen, dtype, b, s, hkv, dv)
    out, lse = fa.flash_attention(q, k, v, causal=True)
    dq, dk_, dv_ = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    n = s // SEQ_PARALLEL_BLOCKS
    outs, lses, dqs = [], [], []
    dks = torch.zeros(k.shape, dtype=torch.float32, device="cuda")
    dvs = torch.zeros(v.shape, dtype=torch.float32, device="cuda")
    for c in range(SEQ_PARALLEL_BLOCKS):
        end = (c + 1) * n
        qc, doc = (t[:, c * n:end].contiguous() for t in (q, do))
        kc, vc = (t[:, :end].contiguous() for t in (k, v))
        oc, lc = fa.flash_attention(qc, kc, vc, causal=True)
        po, pl = fa.flash_attention_plain(qc, kc, vc, causal=True)
        assert _err(oc, po) <= TOL[dtype] and _err(lc, pl) <= 1e-3
        g = fa.flash_attention_bwd(qc, kc, vc, oc, lc, doc, causal=True)
        pg = fa.flash_attention_bwd_plain(qc, kc, vc, oc, lc, doc,
                                          causal=True)
        assert all(_rel(x, w) <= BWD_TOL[dtype] for x, w in zip(g, pg))
        outs.append(oc)
        lses.append(lc)
        dqs.append(g[0])
        dks[:, :end] += g[1].float()
        dvs[:, :end] += g[2].float()
    got = (torch.cat(outs, 1), torch.cat(lses, 2), torch.cat(dqs, 1))
    if n % 64 == 0:
        assert all(torch.equal(x, w) for x, w in zip(got, (out, lse, dq)))
    else:
        assert _err(got[0], out) <= TOL[dtype] and _err(got[1], lse) <= 1e-3
        assert _rel(got[2], dq) <= BWD_TOL[dtype]
    assert _rel(dks, dk_) <= BWD_TOL[dtype]
    assert _rel(dvs, dv_) <= BWD_TOL[dtype]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_seq_parallel_one_rank_step_equals_unsharded(gen, nccl_rank, arch):
    """A world of one NCCL rank, mesh (1, 1): 2 steps of the reduced bf16
    model under ``ShardingPolicy(seq_parallel=True)`` ("tp" and "fsdp";
    deepseek with 4 claim groups) equal the unsharded steps bit for bit
    (at model size 1 the block is the whole sequence and nothing is
    gathered), launching the same kernels."""
    from repro_torch.core.tree import flatten
    from repro_torch.distributed import params as psh
    from repro_torch.distributed.sharding import ShardingPolicy, policy
    from repro_torch.launch.mesh import make_mesh

    cfg = get_config(arch).reduced().with_dtype("bfloat16")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_dispatch_groups=4)
    model = Model(cfg, device="cuda")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    toks = [torch.from_numpy(np.random.RandomState(i).randint(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)).to("cuda")
        for i in range(2)]
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")

    def run(layout=None):
        params, lays = model.init(0), None
        if layout is not None:
            lays = psh.param_shardings(params, mesh, layout)
            params = psh.shard_tree(params, lays)
        state = opt.init_state(params, ocfg)
        step = make_train_step(model, ocfg, microbatches=2,
                               grad_shardings=lays)
        before = (fa.flash_attention.launches,
                  fa.flash_attention_bwd.launches)
        losses = []
        for t in toks:
            if layout is None:
                params, state, met = step(params, state, {"tokens": t})
            else:
                with policy(ShardingPolicy(mesh, seq_parallel=True,
                                           fsdp_pure=layout == "fsdp")):
                    params, state, met = step(params, state, {"tokens": t})
            losses.append(met["loss"].item())
        launched = (fa.flash_attention.launches - before[0],
                    fa.flash_attention_bwd.launches - before[1])
        return losses, flatten(params), launched

    want = run()
    for layout in ("tp", "fsdp"):
        got = run(layout)
        assert got[0] == want[0] and got[2] == want[2]
        assert all(torch.equal(got[1][k], w) for k, w in want[1].items())


# ------------------- query groups wider than a split block (G > 16)

WIDE_GROUPS = [20, 32, 128]
WIDE_LENS = [0, 1, 299, 1000, 65]


def _slices(fn, q, hkv, *args, **kw):
    """``fn`` on each 16-head slice of every KV head's group of q [B, Hkv
    * G, Dk] (the last slice shorter where 16 does not divide G), laid
    back in q's head order."""
    b, hq, dk = q.shape
    g = hq // hkv
    qg = q.view(b, hkv, g, dk)
    outs = [fn(qg[:, :, i:i + da.QUERY_ROWS].reshape(b, -1, dk).contiguous(),
               *args, **kw) for i in range(0, g, da.QUERY_ROWS)]
    return torch.cat([o.view(b, hkv, -1, o.shape[-1]) for o in outs],
                     dim=2).reshape(b, hq, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", WIDE_GROUPS)
@pytest.mark.parametrize("dk,dv,hkv", [(576, 512, 1), (40, 32, 1),
                                       (128, 128, 2)])
def test_wide_group_decode_matches_plain_and_its_slices(gen, dtype, g, dk,
                                                        dv, hkv):
    """K2 at G > 16 against its plain version and against K2 on its
    16-head slices at the same split count (bit for bit); K5 at every
    depth whose ring fits equal to K2; K3 on a pool equal to K2 on the
    gathered rows and K6 to K3; the partials entry and the combine equal
    to K2 at its plan, the partials within the tolerance of their plain
    version; every launch on the dtype's path."""
    b, s = len(WIDE_LENS), 300
    q = _randn(gen, dtype, b, g * hkv, dk)
    k = _randn(gen, dtype, b, s, hkv, dk)
    v = k[..., :dv].contiguous() if dk != dv else _randn(gen, dtype, b, s,
                                                         hkv, dv)
    kl = torch.tensor(WIDE_LENS, dtype=torch.int32, device="cuda")
    path = "mma" if dtype == torch.bfloat16 else "cuda_cores"
    before = dict(da.decode_attention.path_launches)
    out = da.decode_attention(q, k, v, kl, num_buffers=1)
    torch.cuda.synchronize()
    assert da.decode_attention.path_launches[path] == before.get(path, 0) + 1
    assert out.shape == (b, g * hkv, dv)
    assert _err(out, da.decode_attention_plain(q, k, v, kl)) <= TOL[dtype]
    assert torch.all(out[0] == 0)                       # kv_len 0
    ns = da.route(q, k, v).num_splits
    assert torch.equal(out, _slices(da.decode_attention, q, hkv, k, v, kl,
                                    num_splits=ns, num_buffers=1))
    depths = {da.route(q, k, v, num_buffers=d).num_buffers for d in DEPTHS}
    for depth in depths - {1}:
        assert torch.equal(out, da.decode_attention_pipelined(
            q, k, v, kl, num_splits=ns, num_buffers=depth)), depth
    k_pool, v_pool, pt, kp, vp = _mma_pool(k, v, 16, 1)
    k3 = da.paged_decode_attention(q, k_pool, v_pool, pt, kl, num_buffers=1)
    assert torch.equal(k3, da.decode_attention(q, kp, vp, kl,
                                               num_buffers=1))
    for depth in depths - {1}:
        assert torch.equal(da.paged_decode_attention_pipelined(
            q, k_pool, v_pool, pt, kl, num_buffers=depth), k3), depth
    o, m, l = da.decode_attention_partials(q, k, v, kl)
    assert o.shape == (b, hkv, ns, g, dv)
    assert torch.equal(da.decode_combine(o, m, l, dtype), out)
    po, pm, pl = da.decode_attention_partials_plain(q, k, v, kl,
                                                    num_splits=ns)
    live = pl > 0
    assert _err(m, pm) <= TOL[dtype]
    assert _err(torch.where(live, o / l.clamp_min(1e-30), 0.0),
                torch.where(live, po / pl.clamp_min(1e-30), 0.0)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", QDTYPES)
@pytest.mark.parametrize("g", WIDE_GROUPS)
def test_wide_group_quantized_decode_matches_plain(gen, dtype, store, g):
    """K7 at G > 16 (2 KV heads of 128) against its plain version and
    against K7 on its 16-head slices bit for bit; K8 on a pool equal to
    K7 on the gathered rows, K9 at depths 2 and 4 equal to K8."""
    b, s, hkv, d = len(WIDE_LENS), 320, 2, 128
    q = _randn(gen, dtype, b, g * hkv, d)
    kq, ks = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    vq, vs = _quantized(_randn(gen, torch.bfloat16, b, s, hkv, d), store)
    kl = torch.tensor(WIDE_LENS, dtype=torch.int32, device="cuda")
    k7 = da.decode_attention_quantized(q, kq, ks, vq, vs, kl)
    torch.cuda.synchronize()
    assert _err(k7, da.decode_attention_quantized_plain(
        q, kq, ks, vq, vs, kl)) <= TOL[dtype]
    ns = da.route(q, kq, vq, quantized=True).num_splits
    assert torch.equal(k7, _slices(da.decode_attention_quantized, q, hkv,
                                   kq, ks, vq, vs, kl, num_splits=ns))
    pools = _quant_pool(kq, ks, vq, vs, 16, 1)
    k8 = da.paged_decode_attention_quantized(q, *pools, kl, num_buffers=1)
    assert torch.equal(k8, k7)
    for depth in DEPTHS:
        assert torch.equal(da.paged_decode_attention_quantized_pipelined(
            q, *pools, kl, num_buffers=depth), k8), depth


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 8, 16])
@pytest.mark.parametrize("b,s,hkv,dk,dv", [(8, 1024, 2, 128, 128),
                                           (8, 1024, 1, 576, 512),
                                           (8, 1024, 32, 80, 80)])
def test_wide_group_leaves_small_groups_as_they_were(gen, dtype, g, b, s,
                                                     hkv, dk, dv):
    """At G <= 16 (one block a KV head) the analytic split count is the
    classic one, and K2's output equals a call pinned to it bit for
    bit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    classic = max(1, min(-(-sms // (b * hkv)), s // da.MIN_SPLIT_ROWS))
    q = _randn(gen, dtype, b, g * hkv, dk)
    k = _randn(gen, dtype, b, s, hkv, dk)
    v = _randn(gen, dtype, b, s, hkv, dv)
    kl = torch.tensor([1, 100, 1024, 2000, 513, 64, 300, 777],
                      dtype=torch.int32, device="cuda")
    assert da.route(q, k, v).num_splits == da.split_plan(s, classic)[0]
    assert da.num_splits(b, hkv, s, sms, g=g) == classic
    assert torch.equal(da.decode_attention(q, k, v, kl),
                       da.decode_attention(q, k, v, kl, num_splits=classic))
