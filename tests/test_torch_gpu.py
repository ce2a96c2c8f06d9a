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
rtol 1e-4, and the params' change within 1e-3 of its own norm.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.gpu


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
