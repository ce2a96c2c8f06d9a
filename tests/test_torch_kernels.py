"""The port's attention kernels (K1 flash-attention forward, K2 split-K
decode) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the reference oracles (``ref.py``) and the Pallas kernels in
interpret mode, on the same inputs made with numpy from a seed.  f32
tolerance: atol = rtol = 1e-5 (the versions differ in summation order
only).  The CUDA kernels themselves are held against the plain versions
on the card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.decode_attention.kernel import decode_attention_fwd
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models.attention import chunked_attention as jax_chunked
from repro.models.attention import naive_attention as jax_naive

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.attention import chunked_attention, naive_attention

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ----------------------------------------------------------------- K1 plain

@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,bq,bk", [
    (1, 32, 32, 2, 2, 16, True, 8, 16),
    (2, 16, 64, 4, 2, 16, True, 8, 32),      # GQA + suffix alignment
    (2, 32, 32, 8, 8, 32, False, 16, 16),    # MHA, non-causal
])
def test_flash_plain_matches_reference_and_pallas(b, sq, skv, hq, hkv, d,
                                                  causal, bq, bk):
    q, k, v = _qkv(sq + hq, b, sq, skv, hq, hkv, d)
    out, lse = fa.flash_attention_plain(*_t(q, k, v), causal=causal,
                                        block_k=bk)
    ref = np.asarray(flash_attention_ref(q, k, v, causal=causal))
    pallas, pallas_lse = flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(pallas_lse), **TOL)


@pytest.mark.parametrize("kv_len,q_offset", [
    (13, 5),                  # prefill continuing a 5-token cache
    (8, 0),                   # bucketed prefill: width 8, empty cache
    ([40, 9], 0),             # per-row valid lengths
    ([7, 30], 6),
])
def test_flash_plain_kv_len_q_offset_matches_naive(kv_len, q_offset):
    q, k, v = _qkv(3, 2, 8, 40, 4, 2, 16)
    kl = np.asarray(kv_len)
    out, _ = fa.flash_attention_plain(*_t(q, k, v), kv_len=torch.tensor(kl),
                                      q_offset=q_offset, block_k=16)
    ref = np.asarray(jax_naive(q, k, v, kv_len=jnp.asarray(kl),
                               q_offset=q_offset))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        naive_attention(*_t(q, k, v), kv_len=torch.tensor(kl),
                        q_offset=q_offset).numpy(), ref, **TOL)


@pytest.mark.parametrize("block_k", [8, 16, 64])
def test_chunked_attention_matches_reference_at_every_block(block_k):
    """The model's CPU path, at the reference's block sizes, with the
    prefill's kv_len/q_offset."""
    q, k, v = _qkv(5, 2, 12, 40, 4, 2, 16)
    got = chunked_attention(*_t(q, k, v), block_k=block_k, kv_len=17,
                            q_offset=5)
    want = jax_chunked(q, k, v, block_k=block_k, kv_len=17, q_offset=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = _t(*_qkv(4, 1, 8, 24, 4, 2, 16))
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, kv_len=11, q_offset=3)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_len=11, q_offset=3)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert fa.flash_attention.launches == before   # no kernel on the CPU
    assert out.shape == (1, 8, 4, 16) and lse.shape == (1, 4, 8)


# ----------------------------------------------------------------- K2 plain

@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len,ns", [
    (4, 64, 4, 2, 16, [1, 64, 33, 17], 4),     # ragged; row 0 leaves 3 of
                                               # its 4 splits wholly masked
    (2, 48, 8, 2, 32, [48, 5], 3),
    (3, 32, 4, 4, 16, [32, 1, 16], 2),          # MHA
])
def test_decode_plain_matches_reference_and_pallas(b, s, hq, hkv, d, kv_len,
                                                   ns):
    rng = np.random.RandomState(s + hq)
    q = rng.randn(b, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    kl = np.asarray(kv_len, np.int32)
    out = da.decode_attention_plain(*_t(q, k, v), torch.from_numpy(kl))
    ref = np.asarray(decode_attention_ref(q, k, v, jnp.asarray(kl)))
    pallas = np.asarray(decode_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kl),
        num_splits=ns, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)


def test_decode_plain_clamps_kv_len_to_the_cache():
    """An idle serve slot's length runs past the cache: kv_len > S reads
    the whole cache, exactly as kv_len = S does."""
    rng = np.random.RandomState(7)
    q, k, v = _t(rng.randn(2, 4, 16).astype(np.float32),
                 rng.randn(2, 24, 2, 16).astype(np.float32),
                 rng.randn(2, 24, 2, 16).astype(np.float32))
    over = da.decode_attention_plain(q, k, v, torch.tensor([90, 25]))
    full = da.decode_attention_plain(q, k, v, torch.tensor([24, 24]))
    assert torch.equal(over, full)


def test_decode_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.RandomState(8)
    q, k, v = _t(rng.randn(3, 4, 16).astype(np.float32),
                 rng.randn(3, 40, 2, 16).astype(np.float32),
                 rng.randn(3, 40, 2, 16).astype(np.float32))
    kl = torch.tensor([1, 40, 13], dtype=torch.int32)
    before = da.decode_attention.launches
    assert torch.equal(da.decode_attention(q, k, v, kl),
                       da.decode_attention_plain(q, k, v, kl))
    assert da.decode_attention.launches == before


@pytest.mark.parametrize("b,hkv,s,sms,want", [
    (8, 2, 1024, 132, 9),      # 16 (row, head) pairs: 9 splits cover 132 SMs
    (1, 2, 1024, 132, 16),     # capped at 1024 / 64 rows
    (64, 8, 4096, 132, 1),     # enough blocks already
    (2, 2, 48, 132, 1),        # a cache shorter than two splits
])
def test_decode_num_splits(b, hkv, s, sms, want):
    ns = da.num_splits(b, hkv, s, sms)
    assert ns == want
    assert ns == 1 or s // ns >= da.MIN_SPLIT_ROWS
