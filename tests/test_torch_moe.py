"""The port's MoE/MLA slice (deepseek-v2) against the JAX package, on the CPU.

Kernel level: the plain version of K14 (``grouped_matmul_plain``) against
the Pallas ``gmm`` in interpret mode (explicit tiles) and the oracle
``gmm_ref``; the plain K15 (``grouped_matmul_quantized_plain``) against
``gmm_quantized`` in interpret mode and ``gmm_quant_ref``;
``quantize_expert_weights`` bytes against the reference's.  Tolerances,
the largest |difference| relative to the largest |value|: f32 1e-5
(summation order; K15's oracle dequantizes before the sum, the kernels
scale after it: f32 rounding); bf16 2^-7 (both round an f32 result to
bf16 once: one ulp is at most 2^-8 of a value).  The Dv-aware plain
attention (K1's and K2's plain versions at MLA's (Dk, Dv) pairs) against
the reference's ``chunked_attention`` at 1e-5 (summation order).

Model level, f32, params bridged from the JAX tree: the slot claims of
``prefix_sum_slots`` equal the reference's and a simulated FAA counter's
exactly; ``moe_apply`` within 1e-5 (summation order of the expert
products and the combine), the same number of dropped choices,
``aux_loss`` within 1e-6 relative; ``mla_apply`` (prefill, absorbed decode with per-row and scalar
lengths, both q branches) within 1e-5; reduced deepseek-v2-lite-16b
logits within 1e-4 of the JAX ``Model``; greedy serve tokens equal to the
JAX engine's under every admission policy on the contiguous cache, with
the batch inside expert capacity and past it.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import quant as jq
from repro.kernels.moe_gmm.kernel import gmm, gmm_quantized
from repro.kernels.moe_gmm.ref import expert_ffn_ref, gmm_quant_ref, gmm_ref
from repro.models import Model as JaxModel
from repro.models import attention as jax_attn
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.schedulers import available_schedulers
from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.moe_gmm import ops as mg
from repro_torch.models import Model
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.serve import Engine, ServeConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

REL = {jnp.float32: 1e-5, jnp.bfloat16: 2.0 ** -7}
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
POLICIES = list(available_schedulers())
MAX_LEN = 96
ARCH = "deepseek-v2-lite-16b"


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


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tree(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


# the reference's modules, compiled once per configuration (op-by-op
# dispatch of their eager forms dominates this file's time otherwise)
_jax_moe_apply = jax.jit(jax_moe.moe_apply, static_argnums=1,
                         static_argnames="capacity")
_jax_mla_apply = jax.jit(jax_mla.mla_apply, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _jax_model(arch, dtype="float32"):
    """The reduced reference model and its params from key 0 (the init
    compiled as one program, once per configuration)."""
    jm = JaxModel(jax_config(arch).reduced().with_dtype(dtype))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))




# ----------------------------------------------------- K14 / K15 plain

GMM_SHAPES = [(4, 8, 64, 32), (3, 24, 72, 40), (2, 16, 48, 24)]


def _gmm_inputs(e, c, d, f, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(e, c, d).astype(np.float32)
    w = (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_grouped_matmul_plain_matches_pallas_and_reference(dtype, e, c, d,
                                                           f):
    x, w = _gmm_inputs(e, c, d, f)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    pallas = gmm(xj, wj, block_c=8, block_f=16, block_d=16, interpret=True)
    got = mg.grouped_matmul(_t(xj), _t(wj))       # the CPU runs the plain
    assert got.dtype == _t(xj).dtype and got.shape == (e, c, f)
    assert _rel(_np(got), pallas.astype(jnp.float32)) <= REL[dtype]
    assert _rel(_np(got), gmm_ref(xj, wj).astype(jnp.float32)) <= REL[dtype]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("store", quant.quant_dtypes())
def test_grouped_matmul_quantized_plain_matches_pallas_and_reference(
        store, dtype):
    x, w = _gmm_inputs(3, 24, 72, 40, seed=1)
    xj = jnp.asarray(x, dtype)
    wq, ws = jq.quantize(jnp.asarray(w), dtype=getattr(jnp, store), axis=1)
    pallas = gmm_quantized(xj, wq, ws, block_c=8, block_f=8, block_d=24,
                           interpret=True)
    got = mg.grouped_matmul_quantized(_t(xj), _t(wq), _t(ws))
    assert _rel(_np(got), pallas.astype(jnp.float32)) <= REL[dtype]
    want = gmm_quant_ref(xj, wq, ws).astype(jnp.float32)
    assert _rel(_np(got), want) <= REL[dtype]


@pytest.mark.parametrize("store", quant.quant_dtypes())
def test_quantize_expert_weights_gives_the_reference_bytes(store):
    _, w = _gmm_inputs(4, 8, 64, 32, seed=2)
    want_q, want_s = jq.quantize(jnp.asarray(w), dtype=getattr(jnp, store),
                                 axis=1)
    got_q, got_s = mg.quantize_expert_weights(torch.from_numpy(w),
                                              dtype=getattr(torch, store))
    assert tuple(got_s.shape) == (4, 1, 32) and got_s.dtype == torch.float32
    np.testing.assert_array_equal(quant.as_bytes(got_q).numpy().view(np.uint8),
                                  np.asarray(want_q).view(np.uint8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_expert_ffn_matches_reference():
    x, gate = _gmm_inputs(4, 8, 64, 32, seed=3)
    _, up = _gmm_inputs(4, 8, 64, 32, seed=4)
    down = (np.random.RandomState(5).randn(4, 32, 64) / np.sqrt(32)).astype(
        np.float32)
    want = expert_ffn_ref(*map(jnp.asarray, (x, gate, up, down)))
    got = mg.expert_ffn(*map(torch.from_numpy, (x, gate, up, down)))
    assert _rel(_np(got), want) <= 1e-5


# ------------------------------------------- Dv-aware plain attention

@pytest.mark.parametrize("kv_len,q_offset", [(None, None), ([20, 37], 0),
                                             ([14, 9], 5)])
def test_flash_plain_with_dv_matches_reference(kv_len, q_offset):
    """K1's plain version at the reduced MLA prefill pair (Dk 24, Dv 16)
    against the reference's chunked_attention."""
    rng = np.random.RandomState(6)
    sq = 37 if q_offset == 0 else 9
    q = rng.randn(2, sq, 4, 24).astype(np.float32)
    k = rng.randn(2, 37, 4, 24).astype(np.float32)
    v = rng.randn(2, 37, 4, 16).astype(np.float32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jax_attn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, block_k=8,
        kv_len=None if kl is None else jnp.asarray(kl), q_offset=q_offset)
    got, _ = fa.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), causal=True, block_k=8,
        kv_len=None if kl is None else torch.from_numpy(kl),
        q_offset=q_offset)
    assert got.shape == (2, sq, 4, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)


def test_decode_plain_with_dv_matches_reference():
    """K2's plain version at the reduced absorbed-decode pair (Dk 40, Dv
    32, one latent KV head, V the first 32 columns of K) with per-row
    lengths, one of them past the cache."""
    rng = np.random.RandomState(7)
    q = rng.randn(3, 4, 40).astype(np.float32)
    k = rng.randn(3, 24, 1, 40).astype(np.float32)
    v = np.ascontiguousarray(k[..., :32])
    kl = np.asarray([1, 24, 30], np.int32)
    want = jax_attn.chunked_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        causal=False, kv_len=jnp.asarray(kl), q_offset=0)[:, 0]
    got = da.decode_attention_plain(*map(torch.from_numpy, (q, k, v, kl)))
    assert got.shape == (3, 4, 32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)


# ------------------------------------------------------------- MoE

@pytest.mark.parametrize("t,e,k,cap,seed", [
    (1, 1, 1, 1, 0), (17, 4, 2, 8, 1), (64, 8, 2, 8, 2), (200, 16, 4, 3, 3),
    (33, 3, 3, 64, 4), (128, 64, 6, 16, 5), (50, 5, 1, 2, 6)])
def test_prefix_sum_slots_match_reference_and_faa(t, e, k, cap, seed):
    """The slots equal the reference's and those a per-expert FAA counter
    hands out in k-major (choice, token) order; keep = slot < capacity."""
    idx = np.random.RandomState(seed).randint(0, e, (t, k))
    slot, keep = moe_mod.prefix_sum_slots(torch.from_numpy(idx), e, cap)
    want_slot, want_keep = jax_moe.prefix_sum_slots(jnp.asarray(idx), e, cap)
    assert slot.dtype == torch.int32
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    counters = np.zeros(e, np.int64)
    for kk in range(k):
        for tt in range(t):
            assert slot[tt, kk] == counters[idx[tt, kk]]
            counters[idx[tt, kk]] += 1
    np.testing.assert_array_equal(keep.numpy(), slot.numpy() < cap)


def test_prefix_sum_slots_groups_claim_independently():
    """A leading group axis gives each group its own counters, as the
    reference's vmap over groups does."""
    idx = np.random.RandomState(8).randint(0, 6, (4, 30, 2))
    slot, keep = moe_mod.prefix_sum_slots(torch.from_numpy(idx), 6, 8)
    want = jax.vmap(lambda i: jax_moe.prefix_sum_slots(i, 6, 8))(
        jnp.asarray(idx))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want[1]))


# the FAA ticket's splits of a batch over ranks: (rows ranks, sequence
# blocks, a rank's rows b, its positions s); the group counts tried cut
# the blocks at every kind of boundary
TICKET_SPLITS = {
    "rows": (4, 1, 2, 12),          # 4 ranks of 24 tokens
    "seq": (2, 4, 2, 4),            # rows of 16 positions in 4 blocks
    "seq_cut": (2, 3, 3, 5),        # rows of 15 in 3 blocks of 5
}


def _owned(lay, e):
    """{(group, expert, slot): local row} of the buffer rows ``lay``'s rank
    owns: of each group it holds as the q-th of R holders, the rows [q E C
    / R, (q + 1) E C / R) of the group's E x C in (expert, slot) order,
    each at its place in its block."""
    out, offset = {}, 0
    for e0, ne, rows, grps, lo in lay.blocks:
        for j, g in enumerate(grps):
            h = lay.holders[g]
            q = h.index(lay.me)
            for f in range(q * e * lay.cap // len(h),
                           (q + 1) * e * lay.cap // len(h)):
                x, slot = divmod(f, lay.cap)
                out[g, x, slot] = (offset + (x - e0) * rows * len(grps)
                                   + j * rows + slot - (lo if x == e0 else 0))
        offset += ne * rows * len(grps)
    return out


@pytest.mark.parametrize("split", sorted(TICKET_SPLITS))
@pytest.mark.parametrize("k", [1, 2, 6])
def test_ticket_slots_equal_one_prefix_sum(k, split):
    """The FAA ticket across ranks, simulated in one process: each rank's
    pieces (``claim_pieces``) and their claim counts (``piece_claims``),
    the counts stacked as the all-gather would, then ``piece_bases``: every
    claim's slot and keep bit equal ``prefix_sum_slots`` (held to the
    reference's above) over each group of the whole batch exactly, at every
    group count that divides the batch, under the row split, the
    sequence split, and blocks that the groups cut.  The exchange plan of
    every rank (``_exchange_plan``) agrees with the others' (the rows each
    sends an owner are the rows that owner receives from it), counts the
    batch's kept claims, and places each received row at its (group,
    expert, slot) in the owner's buffers, every kept claim once (6 ranks
    over 8 experts: runs that end inside an expert)."""
    n_rows, m, b, s = TICKET_SPLITS[split]
    e, batch, seq = 8, b * n_rows, s * m
    t = batch * seq
    rng = np.random.RandomState(k * 31 + len(split))
    blocks = tuple((i, c) for i in range(n_rows) for c in range(m))
    for g in [x for x in range(1, t + 1) if t % x == 0]:
        tg, cap = t // g, 8
        top = torch.from_numpy(np.stack(
            [rng.choice(e, k, replace=False) for _ in range(t)]))
        want, want_keep = moe_mod.prefix_sum_slots(top.reshape(g, tg, k), e,
                                                   cap)
        want = want.reshape(batch, seq, k).long()
        want_keep = want_keep.reshape(batch, seq, k)
        pieces = moe_mod.claim_pieces(b, s, m, tg, blocks)
        local, counts, ranks = [], [], []
        for (i, c), pc in zip(blocks, pieces):
            top_r = top.reshape(batch, seq, k)[i * b:(i + 1) * b,
                                               c * s:(c + 1) * s]
            local.append(top_r.reshape(-1, k))
            n, r = moe_mod.piece_claims(local[-1], pc, e)
            counts.append(n.numpy())
            ranks.append(r)
        pmax = max(len(pc) for pc in pieces)
        stacked = np.zeros((len(blocks), pmax, k, e), np.int32)
        for r, n in enumerate(counts):
            stacked[r, :len(n)] = n
        bases = moe_mod.piece_bases(stacked, pieces)
        claims = {}                     # rank -> its kept (group, e, slot)
        for r, ((i, c), pc) in enumerate(zip(blocks, pieces)):
            piece = np.repeat(np.arange(len(pc)), pc[:, 1])
            slot = torch.from_numpy(bases[r, :len(pc)])[
                torch.from_numpy(piece)[:, None], torch.arange(k),
                local[r]] + ranks[r]
            block = (slice(i * b, (i + 1) * b), slice(c * s, (c + 1) * s))
            assert torch.equal(slot, want[block].reshape(-1, k)), (g, r)
            assert torch.equal(slot < cap, want_keep[block].reshape(-1, k))
            grp = np.repeat(pc[:, 2], pc[:, 1])
            claims[r] = sorted(
                (int(grp[u]), int(local[r][u, j]), int(slot[u, j]))
                for u in range(len(grp)) for j in range(k)
                if slot[u, j] < cap)
        plans = []
        for me in range(len(blocks)):
            lay = moe_mod.ticket_layout(b, s, m, tg, blocks, me, e, cap)
            plans.append((lay, moe_mod._exchange_plan(lay, stacked, k, e)))
        placed = set()
        for o, (lay, plan) in enumerate(plans):
            assert plan["kept"] == int(want_keep.sum())
            assert plan["recv"] == [p["send"][o] for _, p in plans]
            owned = _owned(lay, e)
            rows, at = plan["rows"].tolist(), 0
            for r, n in enumerate(plan["recv"]):
                mine = [cl for cl in claims[r] if cl in owned]
                assert rows[at:at + n] == [owned[cl] for cl in mine], (g, o)
                placed.update(mine)
                at += n
            assert at == len(rows)
        assert placed == {cl for r in claims for cl in claims[r]}
        assert sum(sum(p["recv"]) for _, p in plans) == len(placed)


def _moe_pair(shared=2, **kw):
    cfg = dict(d_model=32, n_experts=8, top_k=2, d_ff=16,
               n_shared_experts=shared, capacity_factor=1.25)
    cfg.update(kw)
    jcfg, tcfg = jax_moe.MoEConfig(**cfg), moe_mod.MoEConfig(**cfg)
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, _tree(jp)


@pytest.mark.parametrize("groups,capacity,shared,experts", [
    (0, None, 2, 8),        # one global claim, shared experts
    (2, None, 0, 8),        # two token groups
    (3, None, 1, 8),        # 3 does not divide 40 tokens: halved to 1
    (0, 8, 0, 8),           # an explicit small capacity: drops
    (2, 8, 1, 4),           # 40 claims a group on 4 experts of 8 rows: drops
])
def test_moe_apply_matches_reference(groups, capacity, shared, experts):
    jcfg, jp, tcfg, tp = _moe_pair(shared=shared, dispatch_groups=groups,
                                   n_experts=experts)
    x = np.random.RandomState(9).randn(2, 20, 32).astype(np.float32)
    want, wm = _jax_moe_apply(jp, jcfg, jnp.asarray(x), capacity=capacity)
    got, gm = moe_mod.moe_apply(tp, tcfg, torch.from_numpy(x),
                                capacity=capacity)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)
    # the same choices are dropped: equal counts (the fraction itself
    # rounds by how each side takes the mean)
    claims = x.shape[0] * x.shape[1] * tcfg.top_k
    assert (round(float(gm["dropped"]) * claims)
            == round(float(wm["dropped"]) * claims))
    np.testing.assert_allclose(float(gm["aux_loss"]), float(wm["aux_loss"]),
                               rtol=1e-6)
    if capacity:
        assert float(gm["dropped"]) > 0


def test_capacity_matches_reference_rounding():
    cfg = moe_mod.MoEConfig(d_model=8, n_experts=64, top_k=6, d_ff=8)
    # decode: 8 slots need 0.94 rows an expert, floor 8; the 488-token
    # prefill 57.2, rounded up to 64
    assert moe_mod.capacity_of(cfg, 8) == 8
    assert moe_mod.capacity_of(cfg, 488) == 64
    assert moe_mod.capacity_of(cfg, 488, capacity=13) == 16


# ------------------------------------------------------------- MLA

def _mla_pair(arch):
    cfg = jax_config(arch).reduced()
    jcfg = jax_mla.MLAConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim)
    tcfg = tfm.mla_cfg(get_config(arch).reduced())
    jp = jax_mla.mla_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, jp, tcfg, _tree(jp)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
def test_mla_apply_matches_reference(arch):
    """Prefill (no cache, and into an empty cache), then absorbed decode
    with a scalar length and with per-row lengths (one row at the cache's
    end, where the write clamps), for the wq (lite) and q-lora (236b)
    branches."""
    jcfg, jp, tcfg, tp = _mla_pair(arch)
    assert ("wq_b" in tp) == (arch != ARCH)
    rng = np.random.RandomState(10)
    x = rng.randn(2, 12, jcfg.d_model).astype(np.float32)
    want, _ = _jax_mla_apply(jp, jcfg, jnp.asarray(x))
    got, none = mla_mod.mla_apply(tp, tcfg, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODULE_TOL)

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
    lens = np.asarray([13, smax + 2], np.int32)      # row 1 past the end
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
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_mla_multi_token_call_on_a_filled_cache_raises():
    """R7: the reference attends to the new tokens alone there."""
    _, _, tcfg, tp = _mla_pair(ARCH)
    tc = mla_mod.init_mla_cache(tcfg, 1, 16, torch.float32, device="cpu")
    tc["len"] = torch.tensor(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="R7"):
        mla_mod.mla_apply(tp, tcfg, torch.zeros(1, 3, tcfg.d_model), cache=tc)


# ----------------------------------------------------------- model

@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params): reduced
    deepseek-v2-lite-16b, f32."""
    jm, jp = _jax_model(ARCH)
    return jm, jp, Model(get_config(ARCH).reduced(), device="cpu"), _tree(jp)


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, shape).astype(
        np.int32)


def test_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, (2, 24))
    jl, jc = jax.jit(jm.prefill, static_argnums=(2, 3))(
        jp, {"tokens": toks}, MAX_LEN, jnp.float32)
    decode = jax.jit(jm.decode_step)
    tl, tc = tm.prefill(tp, {"tokens": toks}, MAX_LEN, torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    assert set(tc) == set(jc) == {"dense0", "blocks"}
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


def test_backbone_sums_the_moe_layers_aux_loss(pair):
    """The aux (balance + z) loss summed over the MoE layers equals the
    reference loss's ``aux`` metric on the same tokens."""
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, (2, 16), seed=11)
    _, metrics = jax.jit(jm.loss)(jp, {"tokens": toks})
    x = tp["embed"]["table"][torch.from_numpy(toks).long()]
    _, _, aux = tm._backbone(tp, x)
    np.testing.assert_allclose(float(aux), float(metrics["aux"]), rtol=1e-5)


@pytest.fixture(scope="module")
def prompts():
    """Mixed lengths, one of them a one-token prompt (the absorbed-decode
    branch at prefill)."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).astype(np.int32)
            for n in [8, 1, 30, 64, 5, 17, 40]]


@pytest.fixture(scope="module")
def engines(pair):
    """(JAX engine, port engine), two slots each (2 x top-2 = 4 claims per
    expert set, within the capacity floor of 8)."""
    jm, jp, tm, tp = pair
    return (JaxEngine(jm, jp, JaxServeConfig(max_len=MAX_LEN, slots=2)),
            Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2)))


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


def test_serve_equals_generate_within_capacity(pair, prompts):
    """slots x top_k = 8 stays within the capacity floor, so no choice is
    dropped that a batch of one would keep: each request's tokens equal
    its own ``generate()``."""
    _, _, tm, tp = pair
    engine = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=4))
    for r, g in zip(prompts, engine.serve(prompts, 6)):
        solo = engine.generate({"tokens": r[None, :]}, len(g))
        np.testing.assert_array_equal(solo[0], g)


def test_serve_past_capacity_equals_jax(pair, prompts):
    """8 slots x top-2 = 16 claims against a capacity floor of 8: the idle
    slots' stale tokens compete for expert rows (one slot idles from the
    start, the others as their requests finish), and the tokens still
    equal the JAX engine's, batched the same way."""
    jm, jp, tm, tp = pair
    want = JaxEngine(jm, jp, JaxServeConfig(
        max_len=MAX_LEN, slots=8, refill_schedule="faa")).serve(prompts, 8)
    got = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=8,
                                     refill_schedule="faa")).serve(prompts, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------ init, bridge, refusals

@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
def test_init_follows_reference_tree_and_dtypes(arch):
    """Model.init draws the reference's tree: the same leaves and shapes;
    in a bf16 model the router stays f32 as in the reference; the expert
    weights have std 1/sqrt(d) (gate, up) and 1/sqrt(f) (down)."""
    cfg = get_config(arch).reduced().with_dtype("bfloat16")
    _, jp = _jax_model(arch, "bfloat16")
    params = Model(cfg, device="cpu").init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    assert len(flat) == len(list(tfm.leaves(params)))
    for path, leaf in flat:
        node = params
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name, path
    experts = params["blocks"]["moe"]
    assert experts["router"]["w"].dtype == torch.float32
    for name, fan_in in (("gate", cfg.d_model), ("up", cfg.d_model),
                         ("down", cfg.moe_d_ff)):
        std = experts[name].float().std().item()
        assert abs(std * math.sqrt(fan_in) - 1) < 0.1, name


def test_bridge_casts_norms_and_keeps_the_router_f32(tmp_path):
    """``dtype="bfloat16"`` casts kv_norm / q_norm like every other norm
    and keeps the router f32, leaf for leaf as the reference's bf16
    init."""
    arch = "deepseek-v2-236b"                     # has the q-lora branch
    _, jp = _jax_model(arch)
    _, jp16 = _jax_model(arch, "bfloat16")
    want = {jax.tree_util.keystr(path): leaf.dtype.name for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp16)[0]}
    cast = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype="bfloat16")
    got = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = cast
        for p in path:
            node = node[p.key]
        got[jax.tree_util.keystr(path)] = str(node.dtype).split(".")[-1]
    assert got == want
    attn = cast["blocks"]["attn"]
    assert attn["kv_norm"]["scale"].dtype == torch.bfloat16
    assert attn["q_norm"]["scale"].dtype == torch.bfloat16


def test_unported_moe_paths_raise(pair):
    """The paths the port does not take raise; training, which it now
    takes, gives a finite loss (tests/test_torch_train_moe.py holds it and
    its gradients to the reference)."""
    _, _, tm, tp = pair
    loss, met = tm.loss(tp, {"tokens": _tokens(256, (1, 8))})
    assert bool(torch.isfinite(loss)) and met["aux"].item() > 0.0
    with pytest.raises(ValueError, match="no paged decode path"):
        Engine(tm, tp, ServeConfig(max_len=MAX_LEN, cache="paged",
                                   page_size=16)).serve([_tokens(256, (4,))],
                                                        2)
    with pytest.raises(ValueError, match="quantized KV cache"):
        tm.init_cache(1, 16, torch.int8)
    with pytest.raises(ValueError, match="no paged decode path"):
        tm.init_paged_cache(2, 16, 4, 8)
    # moe_impl="sharded" without an active policy is moe_apply, as in the
    # reference (its expert-parallel body: tests/test_torch_distributed.py)
    sharded = Model(dataclasses.replace(get_config(ARCH).reduced(),
                                        moe_impl="sharded"), device="cpu")
    batch = {"tokens": _tokens(256, (1, 4))}
    assert torch.equal(sharded.prefill(tp, batch, 16)[0],
                       tm.prefill(tp, batch, 16)[0])
    assert not (tm.supports_paged_kv or tm.prefix_shareable
                or tm.pad_safe_prefill)


@pytest.mark.parametrize("dtype,e,c,d,f,offset,want", [
    (torch.bfloat16, 64, 8, 2048, 1408, 0, "stream"),    # decode gate / up
    (torch.bfloat16, 64, 8, 1408, 2048, 0, "stream"),    # decode down
    (torch.bfloat16, 3, 24, 72, 40, 0, "stream"),        # aligned, ragged
    (torch.bfloat16, 4, 1, 64, 32, 0, "stream"),
    (torch.bfloat16, 2, 32, 48, 16, 0, "stream"),
    (torch.bfloat16, 2, 13, 36, 40, 0, "cuda_cores"),    # d not 16-byte rows
    (torch.bfloat16, 2, 8, 48, 37, 0, "cuda_cores"),     # f not 16-byte rows
    (torch.bfloat16, 2, 8, 64, 32, 8, "cuda_cores"),     # w 8 bytes off
    (torch.bfloat16, 64, 64, 2048, 1408, 0, "wgmma"),    # a 488-token prefill
    (torch.bfloat16, 64, 240, 2048, 1408, 0, "wgmma"),   # a training step
    (torch.bfloat16, 64, 240, 1408, 2048, 0, "wgmma"),   # its down product
    (torch.bfloat16, 4, 257, 128, 96, 0, "wgmma"),       # C past one tile
    (torch.bfloat16, 2, 64, 64, 32, 8, "mma"),           # w 8 bytes off
    (torch.bfloat16, 2, 40, 36, 24, 0, "mma"),           # C > 32, ragged
    (torch.bfloat16, 2, 40, 72, 44, 0, "mma"),           # f not 16-byte rows
    (torch.float32, 64, 8, 2048, 1408, 0, "cuda_cores"),
    (torch.float32, 64, 64, 2048, 1408, 0, "cuda_cores"),
])
def test_k14_shape_rule_names_the_kernel_each_call_runs(dtype, e, c, d, f,
                                                        offset, want):
    """K14's launcher takes its kernel by an explicit shape rule: bf16 at
    C <= 32 with d and f multiples of 8 and 16-byte aligned operands
    streams the weights on the tensor cores, the other bf16 decode shapes
    go to the CUDA-core kernel; bf16 at C > 32 runs the wgmma kernel where
    TMA can address x and w (d and f multiples of 8, 16-byte aligned),
    else the mma.sync tile kernel; f32 always the CUDA cores; the code
    passed to the library is the rule's."""
    x = torch.empty(e, c, d, dtype=dtype)   # the rule reads no value
    flat = torch.empty(e * d * f + 8, dtype=dtype)
    w = flat[offset // dtype.itemsize:][:e * d * f].view(e, d, f)
    assert mg.path(x, w) == want
    assert mg.PATHS[want] == {"cuda_cores": 0, "mma": 1, "stream": 2,
                              "wgmma": 3}[want]
    assert (want == "stream") == (
        dtype == torch.bfloat16 and c <= mg.STREAM_MAX_ROWS and d % 8 == 0
        and f % 8 == 0 and w.data_ptr() % 16 == 0)
    assert (want == "wgmma") == (
        dtype == torch.bfloat16 and c > mg.STREAM_MAX_ROWS and d % 8 == 0
        and f % 8 == 0 and w.data_ptr() % 16 == 0)


def test_k14_rule_sends_a_misaligned_x_view_to_mma():
    """A bf16 prefill whose x is a view starting one element (2 bytes)
    off a 16-byte boundary cannot be a TMA map's base: the rule names
    ``"mma"``; the aligned tensor it was cut from runs ``"wgmma"``."""
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16)
    w = torch.zeros(2, 128, 96, dtype=torch.bfloat16)
    x_off = flat[1:].view(2, 64, 128)
    x = flat[:-1].view(2, 64, 128)
    assert x_off.data_ptr() % 16 == 2
    assert (mg.path(x, w), mg.path(x_off, w)) == ("wgmma", "mma")


@pytest.mark.parametrize("store", quant.quant_dtypes())
@pytest.mark.parametrize("e,c,d,f,offset,want", [
    (64, 8, 2048, 1408, 0, "stream"),    # decode gate / up
    (64, 8, 1408, 2048, 0, "stream"),    # decode down
    (3, 32, 2048, 1408, 0, "stream"),    # the stream's 4 n-tiles
    (64, 64, 2048, 1408, 0, "mma"),      # a 488-token prefill
    (2, 8, 64, 40, 0, "cuda_cores"),     # f: 40 bytes, not whole copies
    (2, 32, 64, 24, 0, "cuda_cores"),    # f: 24 bytes
    (2, 8, 64, 32, 8, "cuda_cores"),     # w 8 bytes off
    (2, 8, 36, 32, 0, "cuda_cores"),     # x rows not 16-byte wide
])
def test_k15_takes_its_kernel_by_the_same_rule(store, e, c, d, f, offset,
                                               want):
    """K15 over int8 or e4m3 weights takes its kernel by K14's rule
    (:func:`path`): bf16 x at C <= 32 streams the weights when d is a
    multiple of 8, each weight row fills whole 16-byte copies (f a
    multiple of 16) and x and w start 16-byte aligned; C > 32 runs the
    tile kernel; other decode shapes and f32 x the CUDA cores.  The code
    the launcher hands the library is the rule's; on the CPU nothing is
    launched or counted."""
    x = torch.zeros(e, c, d, dtype=torch.bfloat16)
    flat = torch.zeros(e * d * f + 16, dtype=torch.uint8)
    w = flat[offset:][:e * d * f].view(getattr(torch, store)).view(
        e, d, f)
    assert mg.path(x, w) == want
    assert (want == "stream") == (
        c <= mg.STREAM_MAX_ROWS and d % 8 == 0 and f % 16 == 0
        and w.data_ptr() % 16 == 0)
    assert mg.path(x.float(), w) == "cuda_cores"
    fn = mg.grouped_matmul_quantized
    fn.launches = 0
    fn.path_launches.clear()
    out = fn(x[:1, :2], w[:1], torch.ones(1, 1, f))
    assert out.shape == (1, 2, f) and out.dtype == torch.bfloat16
    assert fn.launches == 0 and not fn.path_launches


# ------------------------------------------------ the tile as a tuned choice

def _spec_triples():
    """The (block_c, block_f, block_d) triples the moe_gmm spec offers on
    every path (the stream's at C <= 8, 16, 32; wgmma's; the one tile of
    ``mma`` and of the CUDA cores)."""
    out = set()
    for kernel, c in (("stream", 8), ("stream", 16), ("stream", 32),
                      ("wgmma", 256), ("mma", 64), ("cuda_cores", 64)):
        for cfg in mg.tile_options(kernel, c):
            out.add((cfg["block_c"], cfg["block_f"], cfg["block_d"]))
    return sorted(out)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bc,bf,bd", _spec_triples())
def test_grouped_matmul_plain_matches_pallas_at_the_spec_tiles(dtype, bc, bf,
                                                               bd):
    """The reference's ``gmm`` (interpret mode) at each tile triple the
    port's ``moe_gmm`` spec can pick equals the plain version the card
    holds K14 to, within the file's tolerance: the tile moves no sum
    beyond rounding."""
    e, c, d, f = 2, 256, 128, 256
    x, w = _gmm_inputs(e, c, d, f, seed=bc + bf)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    pallas = gmm(xj, wj, block_c=bc, block_f=bf, block_d=bd, interpret=True)
    got = mg.grouped_matmul_plain(_t(xj), _t(wj))
    assert _rel(_np(got), pallas.astype(jnp.float32)) <= REL[dtype]


@pytest.mark.parametrize("store", quant.quant_dtypes())
def test_grouped_matmul_quantized_plain_matches_pallas_at_the_stream_tiles(
        store):
    """The reference's ``gmm_quantized`` (the ``moe_gmm`` spec's K15
    runner) at the stream's tiles equals K15's plain version."""
    e, c, d, f = 2, 8, 128, 256
    x, w = _gmm_inputs(e, c, d, f)
    wq, ws = jq.quantize(jnp.asarray(w), dtype=jnp.dtype(store), axis=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = mg.grouped_matmul_quantized_plain(_t(xj), _t(wq), _t(ws))
    for cfg in mg.tile_options("stream", c):
        pallas = gmm_quantized(xj, wq, ws, block_c=cfg["block_c"],
                               block_f=cfg["block_f"],
                               block_d=cfg["block_d"], interpret=True)
        assert _rel(_np(want), pallas.astype(jnp.float32)) <= REL[
            jnp.bfloat16]


def test_gmm_tile_options_and_the_analytic_rule():
    """The tiles each path offers are the library's instances (wgmma: 64
    rows at 4, 6, 8 stages, 128 at 4, 6, 256 at 4; the stream: 64, 128,
    256 columns at the rows C takes), and the analytic pick is the rule
    the kernels ran before the tile was a choice."""
    assert [(t["block_c"], t["stages"]) for t in mg.tile_options(
        "wgmma", 240)] == list(mg.WGMMA_TILES)
    for c, rows in ((1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32)):
        opts = mg.tile_options("stream", c)
        assert [t["block_f"] for t in opts] == list(mg.STREAM_COLUMNS)
        assert {t["block_c"] for t in opts} == {rows}
        rule = mg.autotune.gmm_tiles(c, path="stream").config()
        assert rule == {"block_c": rows, "block_f": 128, "block_d": 64,
                        "stages": 4} and rule in opts
    for c, bm, st in ((33, 64, 6), (64, 64, 6), (65, 128, 6), (128, 128, 6),
                      (129, 256, 4), (240, 256, 4), (1000, 256, 4)):
        rule = mg.autotune.gmm_tiles(c, path="wgmma").config()
        assert rule == {"block_c": bm, "block_f": 128, "block_d": 64,
                        "stages": st} and rule in mg.tile_options("wgmma", c)
    assert mg.tile_options("mma", 64) == [
        {"block_c": 64, "block_f": 64, "block_d": 64}]
    assert [t["block_c"] for c in (8, 32, 64) for t in mg.tile_options(
        "cuda_cores", c)] == [8, 32, 64]


def test_resolve_tiles_reads_the_db_for_its_path_only(tmp_path, monkeypatch):
    """A K14 call resolves its tile through the ``moe_gmm`` bucket on the
    paths with a choice (here the CPU's db, a recorded winner), memoized
    until the db changes; a path without a choice keeps its tile whatever
    the db holds; ``REPRO_TUNING=off`` gives the rule."""
    from repro_torch.core import autotune_search

    monkeypatch.setenv("REPRO_TORCH_TUNING_DB", str(tmp_path / "db.json"))
    monkeypatch.setenv("REPRO_TUNING", "on")
    autotune_search.reset_db()
    spec = autotune_search.SPECS["moe_gmm"]
    try:
        x = torch.zeros(4, 240, 64, dtype=torch.bfloat16)
        w = torch.zeros(4, 64, 48, dtype=torch.bfloat16)
        rule = {"block_c": 256, "block_f": 128, "block_d": 64, "stages": 4}
        assert mg.resolve_tiles(x, w, "wgmma") == rule
        won = {"block_c": 128, "block_f": 128, "block_d": 64, "stages": 6}
        autotune_search.get_db().record(
            "moe_gmm", "cpu", spec.bucket_key(spec.bucket(
                c=240, d=64, f=48, dtype="bfloat16")), won)
        before = autotune_search.measurement_count()
        assert mg.resolve_tiles(x, w, "wgmma") == won
        assert mg.resolve_tiles(x, w, "mma") == {
            "block_c": 64, "block_f": 64, "block_d": 64}
        assert autotune_search.measurement_count() == before
        monkeypatch.setenv("REPRO_TUNING", "off")
        assert mg.resolve_tiles(x, w, "wgmma") == rule
    finally:
        autotune_search.reset_db()
