"""K2 at query groups wider than one split block, and the deepseek-v2-236b
slice that needs them, against the JAX package on the CPU.

deepseek-v2-236b decodes its 128 query heads on one latent KV head: a
group of G = 128, where a split block of K2 holds 16 query heads
(``da.QUERY_ROWS``), so the group is split over ``da.group_blocks(G)``
blocks.  On the CPU the wrappers run their plain versions; these tests
hold those, and the split plan the card would launch, to the JAX
package.

Kernel level, f32: ``decode_attention_plain`` at G in {20, 32, 128} and
at MLA's (Dk, Dv) pairs (576, 512) and (40, 32) (one latent KV head, V
the first Dv columns of K) and at (128, 128) on two KV heads, against the
Pallas ``decode_attention_fwd`` in interpret mode and the oracle
``decode_attention_ref`` (both square: V is zero-padded to Dk and their
first Dv output columns taken, which adds nothing to a sum) and, at the
MLA pairs, against ``chunked_attention`` (what the JAX model's absorbed
decode runs).  Tolerance ``MODULE_TOL``, atol = rtol = 1e-5: summation
order only.  ``decode_attention_partials_plain`` + ``decode_combine_plain``
at G = 128 against the same, at 1 and 4 splits.  The split plan on CPU
tensors (``da.route``, ``da.num_splits``, the partials' split axis):
unchanged at G <= 16 for the main path's ticks, and counting B * Hkv *
8 blocks at G = 128; nothing launched.

Model level, f32, params bridged from the JAX tree through
``params_from_numpy`` (as ``test_torch_moe.py`` does): ``mla_apply`` at
128 heads (the q-lora branch) within ``MODULE_TOL`` through a prefill
and scalar- and per-row-length absorbed decodes; the reduced
deepseek-v2-236b widened to 128 heads within ``LOGIT_TOL`` (1e-4) of the
JAX ``Model`` through a prefill and 3 decode steps; its greedy serve
tokens equal to the JAX engine's under ``faa`` and ``static``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.decode_attention.kernel import decode_attention_fwd
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.models import Model as JaxModel
from repro.models import attention as jax_attn
from repro.models import mla as jax_mla
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.models import Model
from repro_torch.models import mla as mla_mod
from repro_torch.models import transformer as tfm
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "deepseek-v2-236b"
HEADS = 128              # 236b's query heads, all on one latent KV head
MAX_LEN = 64
GROUPS = [20, 32, 128]
# (Dk, Dv, Hkv): MLA's absorbed-decode pairs on one latent head, and a
# square head dim on two KV heads (each KV head's group split alike)
PAIRS = [(576, 512, 1), (40, 32, 1), (128, 128, 2)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _tree(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _wide(cfg):
    """A reduced config widened to 236b's 128 query heads."""
    return dataclasses.replace(cfg.reduced(), n_heads=HEADS)


def _decode_inputs(b, s, g, dk, dv, hkv, seed=0):
    """q [B, G * Hkv, Dk], k [B, S, Hkv, Dk], v [.., Dv] (MLA's: the first
    Dv columns of k), lengths with one row of 1, one past the cache."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, g * hkv, dk).astype(np.float32)
    k = rng.randn(b, s, hkv, dk).astype(np.float32)
    v = (np.ascontiguousarray(k[..., :dv]) if dk != dv
         else rng.randn(b, s, hkv, dv).astype(np.float32))
    kv_len = np.asarray([1, s - 27, s + 3][:b], np.int32)
    return q, k, v, kv_len


def _jax_square(fn, q, k, v, kv_len, **kw):
    """A square JAX decode (Dv must equal Dk) on V zero-padded to Dk: its
    first Dv output columns are the attention over V."""
    dv = v.shape[-1]
    pad = np.zeros((*v.shape[:-1], q.shape[-1] - dv), np.float32)
    vp = np.concatenate([v, pad], axis=-1)
    out = fn(*map(jnp.asarray, (q, k, vp, kv_len)), **kw)
    return np.asarray(out)[..., :dv]


def _pallas(q, k, v, kv_len, num_splits):
    return _jax_square(functools.partial(decode_attention_fwd,
                                         num_splits=num_splits,
                                         interpret=True), q, k, v, kv_len)


# ----------------------------------------------------- K2's plain version

@pytest.mark.parametrize("dk,dv,hkv", PAIRS)
@pytest.mark.parametrize("g", GROUPS)
def test_decode_plain_matches_pallas_and_reference_at_wide_groups(g, dk, dv,
                                                                  hkv):
    q, k, v, kl = _decode_inputs(3, 64, g, dk, dv, hkv, seed=g)
    got = _np(da.decode_attention_plain(*map(torch.from_numpy,
                                             (q, k, v, kl))))
    assert got.shape == (3, g * hkv, dv)
    np.testing.assert_allclose(got, _pallas(q, k, v, kl, 4), **MODULE_TOL)
    np.testing.assert_allclose(
        got, _jax_square(decode_attention_ref, q, k, v, kl), **MODULE_TOL)
    if dk != dv:                     # the JAX model's absorbed decode
        want = jax_attn.chunked_attention(
            jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
            causal=False, kv_len=jnp.asarray(kl), q_offset=0)[:, 0]
        np.testing.assert_allclose(got, np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("num_splits", [1, 4])
@pytest.mark.parametrize("dk,dv,hkv", PAIRS[:2])
def test_partials_and_combine_plain_match_pallas_at_g128(dk, dv, hkv,
                                                          num_splits):
    """K2's two halves' plain versions at G = 128: the partials in the
    Pallas layout [B, Hkv, ns, G, Dv] (a split wholly past a row's length
    gives m = NEG_INF, l = 0, o = 0), their combine equal to the whole
    plain version and within ``MODULE_TOL`` of the Pallas kernel at the
    same split count."""
    q, k, v, kl = _decode_inputs(3, 64, HEADS, dk, dv, hkv, seed=3)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, kl))
    o, m, l = da.decode_attention_partials_plain(tq, tk, tv, tl,
                                                 num_splits=num_splits)
    assert o.shape == (3, hkv, num_splits, HEADS, dv)
    assert m.shape == l.shape == (3, hkv, num_splits, HEADS, 1)
    if num_splits > 1:               # row 0 (length 1): splits 1.. empty
        assert torch.all(m[0, :, 1:] == da.NEG_INF)
        assert torch.all(l[0, :, 1:] == 0) and torch.all(o[0, :, 1:] == 0)
    got = _np(da.decode_combine_plain(o, m, l, torch.float32))
    np.testing.assert_allclose(got, _pallas(q, k, v, kl, num_splits),
                               **MODULE_TOL)
    np.testing.assert_allclose(
        got, _np(da.decode_attention_plain(tq, tk, tv, tl)), **MODULE_TOL)
    np.testing.assert_allclose(
        got, _jax_square(decode_attention_ref, q, k, v, kl), **MODULE_TOL)


# ------------------------------------------------------------ split plan

def _classic(b, hkv, s):
    """The split count every G <= 16 call ran before groups were split:
    enough (row, KV head) blocks to cover the SMs, no split under 64
    rows."""
    sms = da.autotune.sm_count()
    return max(1, min(-(-sms // (b * hkv)), s // da.MIN_SPLIT_ROWS))


# (B, S, Hq, Hkv, Dk, Dv): qwen2.5-3b's tick, deepseek-v2-lite's absorbed
# tick, zamba2-2.7b's (G = 1), and 236b's at G = 128 and at 8 rows of
# 2 and 32 blocks
PLAN_CASES = [(8, 1024, 16, 2, 128, 128), (8, 1024, 16, 1, 576, 512),
              (8, 1024, 32, 32, 80, 80), (8, 1024, 128, 1, 576, 512),
              (1, 1024, 128, 1, 576, 512), (3, 300, 40, 2, 40, 32)]


@pytest.mark.parametrize("b,s,hq,hkv,dk,dv", PLAN_CASES)
def test_split_plan_counts_the_group_blocks(b, s, hq, hkv, dk, dv):
    """On CPU tensors ``da.route`` resolves the plan a card call would
    launch, launching nothing: at G <= 16 the classic split count (one
    block a KV head), at G > 16 the count whose B * Hkv * ceil(G / 16)
    blocks cover the SMs; the partials' plain version splits alike."""
    g = hq // hkv
    blocks = b * hkv * -(-g // 16)
    assert da.group_blocks(g) == -(-g // 16)
    q = torch.zeros(b, hq, dk)
    k = torch.zeros(b, s, hkv, dk)
    v = torch.zeros(b, s, hkv, dv)
    launches = [fn.launches for fn in (da.decode_attention,
                                       da.decode_attention_partials)]
    plan = da.route(q, k, v)
    sms = da.autotune.sm_count()
    want = max(1, min(-(-sms // blocks), s // da.MIN_SPLIT_ROWS))
    assert (plan.num_splits, plan.split_size) == da.split_plan(s, want)
    assert da.num_splits(b, hkv, s, sms, g=g) == want
    if g <= 16:
        assert want == _classic(b, hkv, s) == da.num_splits(b, hkv, s, sms)
    else:
        assert blocks == b * hkv * da.group_blocks(g) > b * hkv
    o, m, _ = da.decode_attention_partials(q, k, v, torch.full(
        (b,), s, dtype=torch.int32))
    assert o.shape[2] == m.shape[2] == plan.num_splits
    assert [fn.launches for fn in (da.decode_attention,
                                   da.decode_attention_partials)] == launches


def test_g128_tick_takes_three_splits_of_eight_group_blocks():
    """236b's tick (8 rows, one latent head, 128 query heads): 64 blocks a
    split, so 3 splits of 342 rows fill 192 blocks on the H100's 132 SMs,
    where the lite model's 16 heads take 16 splits of 64."""
    sms = 132
    assert da.num_splits(8, 1, 1024, sms, g=128) == 3
    assert da.split_plan(1024, 3) == (3, 342)
    assert da.num_splits(8, 1, 1024, sms, g=16) == 16
    assert da.num_splits(8, 1, 1024, sms) == 16


# ------------------------------------------------------------ MLA, model

def _mla_pair():
    cfg = _wide(jax_config(ARCH))
    jcfg = jax_mla.MLAConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim)
    tcfg = tfm.mla_cfg(_wide(get_config(ARCH)))
    jp = jax_mla.mla_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, jp, tcfg, _tree(jp)


_jax_mla_apply = jax.jit(jax_mla.mla_apply, static_argnums=1)


def test_mla_apply_matches_reference_at_128_heads():
    """The q-lora branch at 128 heads: a prefill into an empty cache, one
    absorbed decode with a scalar length, then two with per-row lengths
    (one row past the cache's end, where the write clamps): outputs and
    the latent cache within ``MODULE_TOL``."""
    jcfg, jp, tcfg, tp = _mla_pair()
    assert tcfg.n_heads == HEADS and "wq_b" in tp
    rng = np.random.RandomState(12)
    x = rng.randn(2, 9, jcfg.d_model).astype(np.float32)
    smax = 16
    jc = jax_mla.init_mla_cache(jcfg, 2, smax, jnp.float32)
    tc = mla_mod.init_mla_cache(tcfg, 2, smax, torch.float32, device="cpu")
    want, jc = _jax_mla_apply(jp, jcfg, jnp.asarray(x), cache=jc)
    got, tc = mla_mod.mla_apply(tp, tcfg, torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)
    x1 = rng.randn(2, 1, jcfg.d_model).astype(np.float32)
    want, jc = _jax_mla_apply(jp, jcfg, jnp.asarray(x1), cache=jc)
    got, tc = mla_mod.mla_apply(tp, tcfg, torch.from_numpy(x1), cache=tc)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)
    lens = np.asarray([11, smax + 2], np.int32)
    jc = dict(jc, len=jnp.asarray(lens))
    tc = dict(tc, len=torch.from_numpy(lens))
    for _ in range(2):
        x1 = rng.randn(2, 1, jcfg.d_model).astype(np.float32)
        want, jc = _jax_mla_apply(jp, jcfg, jnp.asarray(x1), cache=jc)
        got, tc = mla_mod.mla_apply(tp, tcfg, torch.from_numpy(x1), cache=tc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)
    for key in ("ckv", "kr"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                   **MODULE_TOL)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params): the reduced
    deepseek-v2-236b widened to 128 query heads, f32."""
    jm = JaxModel(_wide(jax_config(ARCH)))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, Model(_wide(get_config(ARCH)), device="cpu"), _tree(jp)


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, shape).astype(
        np.int32)


def test_wide_236b_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    assert tm.cfg.n_heads == HEADS and tm.cfg.q_lora_rank
    toks = _tokens(jm.cfg.vocab_size, (2, 20))
    jl, jc = jax.jit(jm.prefill, static_argnums=(2, 3))(
        jp, {"tokens": toks}, MAX_LEN, jnp.float32)
    decode = jax.jit(jm.decode_step)
    tl, tc = tm.prefill(tp, {"tokens": toks}, MAX_LEN, torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for step in range(3):
        nxt = _tokens(jm.cfg.vocab_size, (2, 1), seed=step + 1)
        jl, jc = decode(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, nxt, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for part in ("dense0", "blocks"):
        for key in ("ckv", "kr"):
            np.testing.assert_allclose(_np(tc[part][key]),
                                       np.asarray(jc[part][key]),
                                       **LOGIT_TOL)


@pytest.mark.parametrize("policy", ["faa", "static"])
def test_wide_236b_serve_tokens_equal_jax(pair, policy):
    """Greedy serve through two slots (every decode tick's attention is
    the absorbed call at G = 128) equals the JAX engine's tokens."""
    jm, jp, tm, tp = pair
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, n).astype(np.int32)
               for n in (6, 1, 23, 12, 30)]
    want = JaxEngine(jm, jp, JaxServeConfig(
        max_len=MAX_LEN, slots=2, refill_schedule=policy)).serve(prompts, 5)
    got = Engine(tm, tp, ServeConfig(
        max_len=MAX_LEN, slots=2, refill_schedule=policy)).serve(prompts, 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
