"""The port's speculative decoding against the JAX package, on the CPU.

Mirrors ``tests/test_serve_spec.py`` case by case on the port (the
reduced qwen2.5-3b target and the reduced granite-3-2b cold drafter, in
f32, parameters bridged from the JAX trees), and adds what the reference
cannot test: the port's speculative tokens equal the JAX speculative
engine's and the port's greedy tokens; ``verify_step`` logits match JAX's
``verify_step``; ``verify_step`` equals the per-position ``decode_step``
bit for bit on contiguous, paged and int8 caches; the speculation cost
model and ``TuningContext.draft_span`` give the reference's answers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import cost_model as jax_cm
from repro.core import faults as jax_faults
from repro.core import runtime as jax_rt
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import SpecConfig as JaxSpecConfig

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.core import faults
from repro_torch.core import runtime as rt
from repro_torch.core.faults import DecodeStall, FaultPlan, PoisonRequest
from repro_torch.core.schedulers import available_schedulers
from repro_torch.models import Model
from repro_torch.serve import Engine, Request, ServeConfig, SpecConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

MAX_NEW = 6
K = 3
MAX_LEN = 48
TOL = dict(atol=1e-4, rtol=1e-4)     # f32 logits across frameworks


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def setup():
    """(target, params, drafter, drafter params, prompts, JAX twins)."""
    jm = JaxModel(jax_config("qwen2.5-3b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    jd = JaxModel(jax_config("granite-3-2b").reduced())
    jdp = jd.init(jax.random.PRNGKey(1))
    model = Model(get_config("qwen2.5-3b").reduced(), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    draft = Model(get_config("granite-3-2b").reduced(), device="cpu")
    dparams = params_from_numpy(jax.tree.map(np.asarray, jdp), device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, model.cfg.vocab_size, n).astype(np.int32)
               for n in [8, 8, 5, 8, 5, 11, 3]]
    return model, params, draft, dparams, prompts, (jm, jp, jd, jdp)


def _cfg(cache="contiguous", **kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("slots", 2)
    kw.setdefault("refill_schedule", "faa")
    if cache == "paged":
        kw.setdefault("page_size", 8)
        kw.setdefault("prefix_cache", False)
    return dict(cache=cache, **kw)


def _engine(setup, *, spec=None, cache="contiguous", **kw):
    model, params = setup[:2]
    return Engine(model, params, ServeConfig(spec=spec, **_cfg(cache, **kw)))


def _self_spec(setup, k=K):
    return SpecConfig(draft=setup[0], draft_params=setup[1], k=k)


def _cold_spec(setup, k=K):
    return SpecConfig(draft=setup[2], draft_params=setup[3], k=k)


_JAX_ENGINES: dict = {}


def _jax_engine(setup, drafter=None, k=K, cache="contiguous", **kw):
    """The JAX engine of one configuration, built once (its jit
    specializations are kept across serves)."""
    jm, jp, jd, jdp = setup[5]
    key = (drafter, k, cache, tuple(sorted(kw.items())))
    if key not in _JAX_ENGINES:
        spec = None
        if drafter is not None:
            spec = JaxSpecConfig(
                draft=jm if drafter == "self" else jd,
                draft_params=jp if drafter == "self" else jdp, k=k)
        _JAX_ENGINES[key] = JaxEngine(jm, jp, JaxServeConfig(
            spec=spec, **_cfg(cache, **kw)))
    eng = _JAX_ENGINES[key]
    eng.cfg.refill_schedule = "faa"     # a test may have set another
    return eng


@pytest.fixture(scope="module")
def greedy(setup):
    """The port's plain greedy tokens, per cache backend."""
    return {cache: _engine(setup, cache=cache).serve(setup[4], MAX_NEW)
            for cache in ("contiguous", "paged")}


def _assert_same(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


# ------------------------------------------------------------ bit identity

@pytest.mark.parametrize("cache", ["contiguous", "paged"])
@pytest.mark.parametrize("drafter", ["self", "cold"])
def test_spec_bit_identical_to_greedy(setup, greedy, cache, drafter):
    """Speculative output equals non-speculative greedy output bit for
    bit on both backends, whether the drafter agrees perfectly (self) or
    mostly disagrees (cold) — and equals the JAX speculative engine's."""
    prompts = setup[4]
    spec = (_self_spec if drafter == "self" else _cold_spec)(setup)
    eng = _engine(setup, spec=spec, cache=cache)
    out = eng.serve(prompts, MAX_NEW)
    _assert_same(greedy[cache], out)
    jeng = _jax_engine(setup, drafter, cache=cache)
    _assert_same(jeng.serve(prompts, MAX_NEW), out)
    rep, jrep = eng.last_report, jeng.last_report
    assert rep.spec_k == K
    assert rep.drafted_tokens == rep.accepted_tokens + rep.wasted_tokens
    assert rep.drafted_tokens > 0
    for f in ("drafted_tokens", "accepted_tokens", "decode_slot_ticks",
              "total_ticks", "total_tokens"):
        assert getattr(rep, f) == getattr(jrep, f), f
    if drafter == "self":
        # the self drafter proposes the target's own stream: nothing it
        # proposed within budget is ever rejected
        assert rep.wasted_tokens < rep.drafted_tokens


@pytest.mark.parametrize("policy", list(available_schedulers()))
def test_spec_bit_identical_under_every_policy(setup, greedy, policy):
    """Admission order is policy-shaped; outputs must not be: every
    registered scheduler drives the speculative engine to the greedy faa
    baseline's tokens and to the JAX speculative engine's."""
    prompts = setup[4]
    eng = _engine(setup, spec=_self_spec(setup), refill_schedule=policy)
    out = eng.serve(prompts, MAX_NEW)
    _assert_same(greedy["contiguous"], out)
    assert eng.refill_stats[0].schedule == policy
    jeng = _jax_engine(setup, "self")
    jeng.cfg.refill_schedule = policy
    _assert_same(jeng.serve(prompts, MAX_NEW), out)


def test_spec_eos_early_exit_matches_greedy(setup):
    """Mid-span eos: the accepted span is cut at the first eos the target
    emits, the request exits early, and the padded tail matches the
    non-speculative run exactly."""
    prompts = setup[4]
    probe = _engine(setup).generate(
        {"tokens": np.asarray(prompts[0])[None, :]}, MAX_NEW)
    eos = int(probe[0, 1])      # emitted at step 1 -> cut inside a span
    ref = _engine(setup, eos_id=eos).serve(prompts, MAX_NEW)
    out = _engine(setup, spec=_self_spec(setup), eos_id=eos).serve(
        prompts, MAX_NEW)
    stopped_early = 0
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
        hits = np.nonzero(b == eos)[0]
        if hits.size and hits[0] < MAX_NEW - 1:
            stopped_early += 1
            assert (b[hits[0]:] == eos).all()
    assert stopped_early >= 1


@pytest.mark.parametrize("k", [0, 1, 4])
def test_spec_every_span_is_exact(setup, greedy, k):
    """k is a pure performance knob: every span (k=0 included) yields the
    greedy tokens and the JAX speculative engine's."""
    prompts = setup[4]
    eng = _engine(setup, spec=_cold_spec(setup, k=k))
    out = eng.serve(prompts, MAX_NEW)
    _assert_same(greedy["contiguous"], out)
    assert eng.last_report.spec_k == k
    _assert_same(_jax_engine(setup, "cold", k=k).serve(prompts, MAX_NEW),
                 out)


def test_spec_k_none_resolves_from_calibrator(setup, greedy):
    """SpecConfig.k=None defers the grain choice to the tuning context
    (TuningContext.draft_span), which picks the reference's span."""
    prompts = setup[4]
    eng = _engine(setup, spec=_self_spec(setup, k=None))
    assert eng._spec_k() == rt.tuning().draft_span() \
        == jax_rt.tuning().draft_span()
    out = eng.serve(prompts, MAX_NEW)
    _assert_same(greedy["contiguous"], out)
    assert eng.last_report.spec_k == rt.tuning().draft_span()


# ----------------------------------------------------------- amortization

def test_spec_amortizes_faa_per_token(setup):
    """One verify tick amortizes the per-(slot, tick) bookkeeping over the
    accepted span: the self drafter's FAA-per-token beats the baseline."""
    prompts = setup[4]
    base = _engine(setup)
    base.serve(prompts, MAX_NEW)
    base_rep = base.last_report
    eng = _engine(setup, spec=_self_spec(setup))
    eng.serve(prompts, MAX_NEW)
    rep = eng.last_report
    assert rep.total_tokens == base_rep.total_tokens
    assert rep.faa_per_token < base_rep.faa_per_token
    assert rep.decode_slot_ticks < base_rep.decode_slot_ticks
    assert 0.0 < rep.acceptance_rate <= 1.0


# ----------------------------------------------------------- fault paths

def test_poisoned_draft_degrades_not_fails(setup, greedy):
    """A poisoned drafter costs amortization, never correctness: every
    affected tick degrades to k=0, no request fails, the output stays
    bit-identical — and the JAX engine degrades the same ticks."""
    prompts = setup[4]
    specs = dict(rids=(0, 2), site="draft")
    eng = _engine(setup, spec=_self_spec(setup))
    with faults.fault_scope(FaultPlan(seed=3, specs=(
            PoisonRequest(**specs),))):
        out = eng.serve(prompts, MAX_NEW)
    rep = eng.last_report
    _assert_same(greedy["contiguous"], out)
    assert rep.failed_requests == 0 and rep.shed_requests == 0
    assert rep.draft_degraded_ticks > 0
    assert rep.drafted_tokens == rep.accepted_tokens + rep.wasted_tokens
    jeng = _jax_engine(setup, "self")
    with jax_faults.fault_scope(jax_faults.FaultPlan(seed=3, specs=(
            jax_faults.PoisonRequest(**specs),))):
        jeng.serve(prompts, MAX_NEW)
    assert rep.draft_degraded_ticks == jeng.last_report.draft_degraded_ticks
    assert rep.accepted_tokens == jeng.last_report.accepted_tokens


def test_decode_stall_leaves_spec_output_exact(setup, greedy):
    """An injected straggler tick charges the stall ledger but cannot
    perturb the accepted tokens."""
    eng = _engine(setup, spec=_self_spec(setup))
    with faults.fault_scope(FaultPlan(seed=5, specs=(
            DecodeStall(ticks=(1, 2, 3), duration_s=0.001),))):
        out = eng.serve(setup[4], MAX_NEW)
    _assert_same(greedy["contiguous"], out)
    assert eng.last_report.injected_stall_s > 0


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_poisoned_decode_fails_only_victim_under_spec(setup, greedy, cache):
    """A decode-poisoned request cancels mid-span and goes terminal FAILED
    (retry budget 0); the survivors stay bit-identical to the fault-free
    run, and the statuses and tokens equal the JAX engine's under the
    same plan."""
    prompts = setup[4]
    specs = dict(rids=(2,), site="decode", steps=(2,))
    eng = _engine(setup, spec=_self_spec(setup), cache=cache)
    with faults.fault_scope(FaultPlan(seed=7, specs=(
            PoisonRequest(**specs),))):
        out = eng.serve(prompts, MAX_NEW)
    rep = eng.last_report
    by_rid = {t.rid: t for t in rep.requests}
    assert by_rid[2].status == "failed"
    assert rep.failed_requests == 1
    for rid, (a, b) in enumerate(zip(greedy[cache], out)):
        if rid != 2:
            np.testing.assert_array_equal(a, b)
    assert all(t.status in ("ok", "failed") for t in rep.requests)
    assert rep.ok_requests + rep.failed_requests == rep.n_requests
    jeng = _jax_engine(setup, "self", cache=cache)
    with jax_faults.fault_scope(jax_faults.FaultPlan(seed=7, specs=(
            jax_faults.PoisonRequest(**specs),))):
        want = jeng.serve(prompts, MAX_NEW)
    _assert_same(want, out)
    assert [t.status for t in rep.requests] == [
        t.status for t in jeng.last_report.requests]


# ------------------------------------------------------------- edge cases

def test_zero_budget_request_terminal_ok_under_spec(setup):
    """max_new_tokens=0 is a valid degenerate request: empty output,
    terminal ok at its admission tick, no drafter work charged — in both
    the speculative and plain engines."""
    prompts = setup[4]
    reqs = [Request(i, p, max_new_tokens=(0 if i in (1, 4) else None))
            for i, p in enumerate(prompts)]
    for spec in (None, _self_spec(setup)):
        eng = _engine(setup, spec=spec)
        out = eng.serve(reqs, MAX_NEW)
        rep = eng.last_report
        by_rid = {t.rid: t for t in rep.requests}
        for rid in (1, 4):
            assert out[rid].shape == (0,)
            assert by_rid[rid].status == "ok"
            assert by_rid[rid].finish_tick == by_rid[rid].admit_tick
            assert by_rid[rid].drafted_tokens == 0
        assert rep.failed_requests == 0
        assert rep.ok_requests == len(prompts)


# ------------------------------------------------------------- validation

def test_spec_rejects_temperature(setup):
    """Speculation is greedy-only: at temperature > 0 serve() raises the
    reference's ValueError, as the JAX engine does under the same
    config."""
    for eng in (_engine(setup, spec=_self_spec(setup), temperature=0.5),
                _jax_engine(setup, "self", temperature=0.5)):
        with pytest.raises(ValueError, match="greedy-only"):
            eng.serve(setup[4][:2], 2)


def test_spec_rejects_rounds_mode(setup):
    """The rounds barrier has no per-slot decode loop: serve() raises the
    reference's ValueError, as the JAX engine does."""
    for eng in (_engine(setup, spec=_self_spec(setup), mode="rounds"),
                _jax_engine(setup, "self", mode="rounds")):
        with pytest.raises(ValueError, match="continuous"):
            eng.serve(setup[4][:2], 2)


def test_spec_rejects_non_rollback_families(setup):
    """Rollback is a cache-length truncation; families whose state is not
    a length-masked KV cache (SSM recurrence, MLA latents) are rejected
    up front, as drafter or as target."""
    model, params, _, _, prompts, _ = setup
    ssm = Model(get_config("mamba2-780m").reduced(), device="cpu")
    assert not ssm.supports_speculation
    eng = _engine(setup, spec=SpecConfig(draft=ssm,
                                         draft_params=ssm.init(2), k=K))
    with pytest.raises(ValueError, match="cannot speculate"):
        eng.serve(prompts[:2], 2)
    mla = Model(get_config("deepseek-v2-lite-16b").reduced(), device="cpu")
    assert not mla.supports_speculation
    eng = Engine(mla, mla.init(3), ServeConfig(
        max_len=MAX_LEN, slots=2,
        spec=SpecConfig(draft=model, draft_params=params, k=K)))
    with pytest.raises(ValueError, match="cannot speculate"):
        eng.serve(prompts[:2], 2)
    with pytest.raises(ValueError, match="cannot verify"):
        ssm.verify_step(None, np.zeros((1, 2), np.int32), None)


def test_spec_rejects_vocab_mismatch(setup):
    model, _, _, _, prompts, _ = setup
    small = dataclasses.replace(get_config("granite-3-2b").reduced(),
                                vocab_size=model.cfg.vocab_size // 2)
    draft = Model(small, device="cpu")
    eng = _engine(setup, spec=SpecConfig(draft=draft,
                                         draft_params=draft.init(4), k=K))
    with pytest.raises(ValueError, match="vocab"):
        eng.serve(prompts[:2], 2)


def test_spec_rejects_missing_headroom(setup):
    """prompt + budget + k - 1 must fit max_len: a verify step near the
    budget would otherwise write past the cache."""
    model, params = setup[:2]
    eng = Engine(model, params, ServeConfig(
        max_len=16, slots=2, spec=_self_spec(setup)))
    prompt = np.arange(1, 9, dtype=np.int32)        # 8 + 8 == max_len
    with pytest.raises(ValueError, match="draft span"):
        eng.serve([prompt], 8)
    out = Engine(model, params, ServeConfig(
        max_len=16, slots=2)).serve([prompt], 8)
    assert out[0].shape == (8,)


# ------------------------------------------------- verify_step, the model

def _per_row_cache(model, params, kv_dtype, lens, seed=0):
    """A serve-form (per-row ``len``) contiguous cache after a pad-masked
    prefill of random prompts of ``lens`` tokens."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, model.cfg.vocab_size,
                       (len(lens), max(lens))).astype(np.int32)
    batch = {"tokens": toks, "lengths": np.asarray(lens, np.int32)}
    return batch, model.prefill_padded(params, batch, MAX_LEN, kv_dtype)[1]


def _paged_copy(model, cache, ps=8, scatter_seed=0):
    """The contiguous per-row ``cache`` moved into a page pool at a seeded
    placement: each row owns ``MAX_LEN // ps`` pages, the table entries
    past the row's first ``ceil((len + K + 1) / ps)`` pages stay 0."""
    b = cache["k"].shape[1]
    per_seq = MAX_LEN // ps
    paged = model.init_paged_cache(b, MAX_LEN, b * per_seq, ps,
                                   cache["k"].dtype)
    order = np.random.RandomState(scatter_seed).permutation(b * per_seq) + 1
    for row in range(b):
        length = int(cache["len"][0, row])
        used = -(-(length + K + 1) // ps)
        pages = order[row * per_seq: row * per_seq + used]
        pt = np.zeros(per_seq, np.int32)
        pt[:used] = pages
        single = {key: (leaf[:, row:row + 1] if key != "len"
                        else leaf[:, row]) for key, leaf in cache.items()}
        model.write_page(paged, single, list(pages), list(range(used)),
                         spec=model.cache_page_spec(dtype=cache["k"].dtype),
                         page_size=ps)
        paged["pt"][:, row] = torch.from_numpy(pt)
        paged["len"][:, row] = length
    return paged


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_verify_equals_per_position_decode(setup, cache, kv_dtype):
    """verify_step's logits at position j equal, bit for bit, the logits
    of the decode_step that consumes tokens[:, :j + 1] at row lengths
    len + j; both caches end with the same lengths and K/V rows."""
    model, params = setup[:2]
    lens = [5, 11, 8]
    _, c1 = _per_row_cache(model, params, kv_dtype, lens)
    _, c2 = _per_row_cache(model, params, kv_dtype, lens)
    if cache == "paged":
        c1, c2 = _paged_copy(model, c1), _paged_copy(model, c2)
    block = np.random.RandomState(1).randint(
        1, model.cfg.vocab_size, (len(lens), K + 1)).astype(np.int32)
    vlogits, c1 = model.verify_step(params, block, c1)
    assert vlogits.shape == (len(lens), K + 1, model.cfg.vocab_size)
    for j in range(K + 1):
        dlogits, c2 = model.decode_step(params, block[:, j:j + 1], c2)
        assert torch.equal(vlogits[:, j], dlogits), f"position {j}"
    assert torch.equal(c1["len"], c2["len"])
    for key in ("k", "v") + (("ks", "vs") if kv_dtype == torch.int8 else ()):
        assert torch.equal(c1[key], c2[key]), key


def test_verify_matches_jax_verify_step(setup):
    """verify_step's logits against JAX's verify_step on the same
    per-row caches, within the model tolerance, f32 and int8 caches."""
    model, params, *_, (jm, jp, _, _) = setup
    lens = [5, 11, 8]
    block = np.random.RandomState(2).randint(
        1, model.cfg.vocab_size, (len(lens), K + 1)).astype(np.int32)
    for kv_dtype, jdt in ((torch.float32, jnp.float32),
                          (torch.int8, jnp.int8)):
        batch, cache = _per_row_cache(model, params, kv_dtype, lens)
        _, jcache = jm.prefill_padded(jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                                      MAX_LEN, jdt)
        got, _ = model.verify_step(params, block, cache)
        want, _ = jm.verify_step(jp, jnp.asarray(block), jcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert (got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).all()


def test_verify_clamps_the_write_start_as_the_reference(setup):
    """A row whose len + s runs past the cache writes its s tokens at
    Smax - s .. Smax - 1 (the reference's vmapped dynamic_update_slice),
    with RoPE at the unclamped positions; the other rows write at len."""
    model, params, *_, (jm, jp, _, _) = setup
    lens = [5, MAX_LEN - 2]
    batch, cache = _per_row_cache(model, params, torch.float32, lens)
    _, jcache = jm.prefill_padded(jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                                  MAX_LEN, jnp.float32)
    block = np.random.RandomState(3).randint(
        1, model.cfg.vocab_size, (2, K + 1)).astype(np.int32)
    _, cache = model.verify_step(params, block, cache)
    _, jcache = jm.verify_step(jp, jnp.asarray(block), jcache)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(jcache["len"]))


def test_paged_verify_past_the_budget_lands_in_scratch(setup):
    """Verify positions past a row's allocated pages resolve to table
    entries that are 0, so they land in scratch page 0: no other row's
    page (nor any unallocated page) changes, and the table stays as it
    was."""
    model, params = setup[:2]
    lens = [13, 7]
    _, cache = _per_row_cache(model, params, torch.float32, lens)
    paged = _paged_copy(model, cache)
    # row 0 keeps only its first two pages: positions 16.. have no page
    paged["pt"][:, 0, 2:] = 0
    owned = {int(p) for p in paged["pt"][0].flatten() if p}
    before = {key: paged[key].clone() for key in ("k", "v", "pt")}
    block = np.ones((2, K + 2), np.int32)       # row 0 writes 13..17
    model.verify_step(params, block, paged)
    assert torch.equal(paged["pt"], before["pt"])
    for key in ("k", "v"):
        changed = {p for p in range(paged[key].shape[1])
                   if not torch.equal(paged[key][:, p], before[key][:, p])}
        assert 0 in changed                      # 16, 17 of row 0
        assert changed <= owned | {0}


def test_rollback_masks_rejected_positions(setup):
    """override_cache_lengths truncates each row in place; positions past
    the new length never reach attention: overwriting them with garbage
    leaves the next decode tick's logits unchanged, bit for bit
    (contiguous and paged: K2's and K3's plain versions)."""
    model, params = setup[:2]
    lens = [5, 11, 8]
    block = np.random.RandomState(4).randint(
        1, model.cfg.vocab_size, (3, K + 1)).astype(np.int32)
    nxt = block[:, :1]
    for paged in (False, True):
        _, cache = _per_row_cache(model, params, torch.float32, lens)
        if paged:
            cache = _paged_copy(model, cache)
        model.verify_step(params, block, cache)
        keep = np.array([6, 11, 10], np.int32)    # 1, 0 and 2 accepted
        assert model.override_cache_lengths(cache, keep) is cache
        assert (cache["len"].numpy() == keep).all()
        clean = {key: cache[key].clone() for key in ("k", "v")}
        want, _ = model.decode_step(params, nxt, cache)
        model.override_cache_lengths(cache, keep)
        for key in ("k", "v"):
            cache[key].copy_(clean[key])
            if paged:
                for row, n in enumerate(keep):
                    for pos in range(n, MAX_LEN):
                        page = int(cache["pt"][0, row, pos // 8])
                        cache[key][:, page, pos % 8] = 1e4
            else:
                for row, n in enumerate(keep):
                    cache[key][:, row, n:] = 1e4
        got, _ = model.decode_step(params, nxt, cache)
        assert torch.equal(got, want)


# ------------------------------------------------------------- cost model

def test_draft_span_and_cost_model_match_reference():
    """expected_accept_span, speculative_token_cost, best_draft_span and
    TuningContext.draft_span give the reference's answers exactly."""
    for k in range(0, 9):
        for a in (0.0, 0.3, 0.75, 0.99, 1.0, 1.5, -0.2):
            assert cm.expected_accept_span(k, a) == \
                jax_cm.expected_accept_span(k, a)
            kw = dict(draft_cost=2.5, verify_cost=10.0, sync_cost=1.5)
            assert cm.speculative_token_cost(k, a, **kw) == \
                jax_cm.speculative_token_cost(k, a, **kw)
    with pytest.raises(ValueError):
        cm.expected_accept_span(-1, 0.5)
    for a in (0.0, 0.2, 0.5, 0.75, 0.9, 1.0):
        for draft_cost in (0.1, 1.0, 5.0):
            for max_k in (0, 4, 8):
                kw = dict(draft_cost=draft_cost, verify_cost=4.0,
                          sync_cost=0.5, max_k=max_k)
                assert cm.best_draft_span(a, **kw) == \
                    jax_cm.best_draft_span(a, **kw)
    ours, ref = rt.tuning(), jax_rt.tuning()
    for a in (0.1, 0.5, 0.75, 0.95):
        for ratio in (0.05, 0.25, 1.0):
            for max_k in (2, 4, 8):
                kw = dict(acceptance=a, draft_cost_ratio=ratio, max_k=max_k)
                assert ours.draft_span(**kw) == ref.draft_span(**kw)
    assert ours.draft_span() == ref.draft_span()
