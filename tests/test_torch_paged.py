"""The port's paged serve against the JAX package, on the CPU: K3's plain
version, the model's paged hooks, the page allocator and prefix trie, and
the paged engine.

K3's plain version is held against the reference oracle
(``paged_decode_attention_ref``) and the Pallas kernel in interpret mode
at atol = rtol = 1e-5 (f32; the versions differ in summation order only).
Paged serve of the reduced qwen2.5-3b in f32 (parameters bridged from the
JAX tree) must give the JAX paged engine's tokens under every admission
policy and, for the deterministic ``static`` policy, its page counters.
Inside the port, paged serve must equal contiguous serve bit for bit.
The allocator and trie property checks mirror ``tests/test_serve_paged.py``
over the port's policies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import parallel_for as jax_pf
from repro.core.faults import FaultInjector as JaxFaultInjector
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.kernels.decode_attention.kernel import paged_decode_attention_fwd
from repro.kernels.decode_attention.ref import paged_decode_attention_ref
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import faults
from repro_torch.core import parallel_for as pf
from repro_torch.core.schedulers import available_schedulers
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.models import Model
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.paged_cache import PageAllocator, PrefixCache

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

PS = 8          # page size throughout (divides MAX_LEN)
MAX_LEN = 48
POLICIES = list(available_schedulers())
TOL = dict(atol=1e-5, rtol=1e-5)
COUNTERS = ("pages_allocated", "pages_freed", "peak_pages_live",
            "prefix_hits", "prefix_hit_tokens", "deferred_admissions")


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_config("qwen2.5-3b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("qwen2.5-3b").reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def mixed_prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).astype(np.int32)
            for n in [8, 8, 5, 8, 5, 11, 3]]


def _prefix_prompts(seed, n_shared, tails):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 256, n_shared).astype(np.int32)
    return [np.concatenate([shared, rng.randint(1, 256, n).astype(np.int32)])
            for n in tails]


def _paged(**kw):
    return ServeConfig(max_len=MAX_LEN, slots=2, cache="paged", page_size=PS,
                       **kw)


def _contiguous(tm, tp, prompts, max_new, **kw):
    return Engine(tm, tp, ServeConfig(max_len=MAX_LEN, **kw)).serve(
        prompts, max_new)


def _assert_same(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


# ------------------------------------------------------------- K3, plain

def _paged_inputs(seed, b, pages, ps, hq, hkv, d, kv_len, spare=3):
    """A pool of b * pages + spare + 1 pages whose rows are placed by a
    seeded permutation (page 0 is scratch and only row 0 names it)."""
    rng = np.random.RandomState(seed)
    n_pool = b * pages + spare + 1
    pt = (rng.permutation(n_pool - 1)[: b * pages] + 1).reshape(b, pages)
    pt[0] = 0
    return (rng.randn(b, hq, d).astype(np.float32),
            rng.randn(n_pool, ps, hkv, d).astype(np.float32),
            rng.randn(n_pool, ps, hkv, d).astype(np.float32),
            pt.astype(np.int32), np.asarray(kv_len, np.int32))


@pytest.mark.parametrize("b,pages,ps,hq,hkv,d,kv_len", [
    (4, 6, 8, 4, 2, 16, [0, 48, 17, 60]),       # scratch row; past P * ps
    (3, 4, 16, 8, 2, 32, [64, 1, 33]),
    (2, 3, 8, 4, 4, 16, [5, 24]),                # MHA
    (5, 2, 4, 8, 2, 16, [8, 3, 4, 7, 1]),
])
def test_paged_plain_matches_reference_and_pallas(b, pages, ps, hq, hkv, d,
                                                  kv_len):
    q, kp, vp, pt, kl = _paged_inputs(b + pages, b, pages, ps, hq, hkv, d,
                                      kv_len)
    out = da.paged_decode_attention_plain(*map(torch.from_numpy,
                                               (q, kp, vp, pt, kl)))
    ref = np.asarray(paged_decode_attention_ref(q, kp, vp, jnp.asarray(pt),
                                                jnp.asarray(kl)))
    pallas = np.asarray(paged_decode_attention_fwd(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(kl), interpret=True))
    # a kv_len = 0 row: the oracle's softmax over all-masked scores is
    # uniform, while the kernels' masked-split guard (and the port) give 0
    live = kl > 0
    np.testing.assert_allclose(out.numpy()[live], ref[live], **TOL)
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)
    assert not out.numpy()[~live].any()


def test_paged_plain_is_placement_invariant():
    """The same logical rows placed on other pool pages give the same
    output bit for bit."""
    q, kp, vp, pt, kl = _paged_inputs(1, 3, 4, 8, 4, 2, 16, [30, 9, 32])
    perm = np.random.RandomState(2).permutation(kp.shape[0] - 1) + 1
    perm = np.concatenate([[0], perm])          # scratch stays page 0
    inv = np.argsort(perm)
    kp2, vp2 = kp[perm], vp[perm]               # page p moves to inv[p]
    pt2 = inv[pt].astype(np.int32)
    a = da.paged_decode_attention_plain(*map(torch.from_numpy,
                                             (q, kp, vp, pt, kl)))
    b = da.paged_decode_attention_plain(*map(torch.from_numpy,
                                             (q, kp2, vp2, pt2, kl)))
    assert torch.equal(a, b)


def test_paged_wrapper_on_cpu_runs_the_plain_version():
    args = [torch.from_numpy(a) for a in _paged_inputs(
        3, 2, 4, 8, 4, 2, 16, [20, 7])]
    before = da.paged_decode_attention.launches
    assert torch.equal(da.paged_decode_attention(*args),
                       da.paged_decode_attention_plain(*args))
    assert da.paged_decode_attention.launches == before


def test_paged_plain_out_of_range_table_raises():
    q, kp, vp, pt, kl = _paged_inputs(4, 2, 2, 8, 4, 2, 16, [9, 9], spare=0)
    pt[1, 1] = kp.shape[0]
    with pytest.raises(IndexError):
        da.paged_decode_attention_plain(*map(torch.from_numpy,
                                             (q, kp, vp, pt, kl)))


# ------------------------------------------------------- model paged hooks

def test_paged_cache_layout(models):
    jm, _, tm, _ = models
    spec = tm.cache_page_spec(dtype=torch.float32)
    assert spec == jax.tree.map(int, jm.cache_page_spec(dtype=jnp.float32))
    assert tm.supports_paged_kv and tm.prefix_shareable
    c = tm.init_paged_cache(3, MAX_LEN, 10, PS, torch.float32)
    want = jax.eval_shape(lambda: jm.init_paged_cache(3, MAX_LEN, 10, PS,
                                                      jnp.float32))
    assert set(c) == set(want)
    for key in want:
        assert tuple(c[key].shape) == want[key].shape, key
        assert str(c[key].dtype).split(".")[-1] == str(want[key].dtype)
    with pytest.raises(ValueError, match="multiple"):
        tm.init_paged_cache(3, MAX_LEN, 10, 7, torch.float32)


def test_write_page_and_gather_round_trip(models):
    """Prompt pages written to scattered pool pages gather back to the
    prefill cache's rows, and admit_paged_slot / release touch only their
    slot's table row and length."""
    from repro_torch.serve.paged_cache import _release_slot

    _, _, tm, tp = models
    spec = tm.cache_page_spec(dtype=torch.float32)
    axes = tm.cache_batch_axes(dtype=torch.float32)
    rng = np.random.RandomState(5)
    toks = rng.randint(1, 256, (1, 24)).astype(np.int32)
    _, pre = tm.prefill_padded(tp, {"tokens": toks, "lengths": [21]},
                               MAX_LEN, torch.float32)
    pool = tm.init_paged_cache(2, MAX_LEN, 9, PS, torch.float32)
    pages = [7, 2, 5]
    pool = tm.write_page(pool, pre, pages, [0, 1, 2], spec=spec,
                         page_size=PS)
    pt_row = np.zeros(MAX_LEN // PS, np.int32)
    pt_row[:3] = pages
    view = tm.gather_prefix_cache(pool, pt_row, 21, spec=spec, page_size=PS)
    for key in ("k", "v"):
        assert torch.equal(view[key][:, :, :24], pre[key][:, :, :24])
    assert view["len"].shape == (tm.cfg.n_layers,) and int(view["len"][0]) == 21
    pool = tm.admit_paged_slot(pool, pre, 1, 21, pt_row, spec=spec,
                               axes=axes)
    assert (pool["pt"][:, 1] == torch.from_numpy(pt_row)).all()
    assert (pool["len"][:, 1] == 21).all() and (pool["len"][:, 0] == 0).all()
    assert not pool["pt"][:, 0].any()
    _release_slot(pool, 1)
    assert not pool["pt"].any() and not pool["len"].any()


# --------------------------------------------------- serve against the JAX

@pytest.fixture(scope="module")
def paged_engines(models):
    """One paged engine per framework, reused across policies (the JAX one
    keeps its jit specializations); both keep their pools and tries across
    calls, so they stay in step."""
    jm, jp, tm, tp = models
    kw = dict(max_len=MAX_LEN, slots=2, cache="paged", page_size=PS,
              num_pages=10)
    return (JaxEngine(jm, jp, JaxServeConfig(**kw)),
            Engine(tm, tp, ServeConfig(**kw)))


@pytest.mark.parametrize("policy", POLICIES)
def test_paged_serve_tokens_equal_jax_under_every_policy(paged_engines,
                                                         policy):
    jax_engine, engine = paged_engines
    jax_engine.cfg.refill_schedule = policy
    engine.cfg.refill_schedule = policy
    prompts = _prefix_prompts(11, 2 * PS, [5, 3, 9, 1, 12, 4])
    want = jax_engine.serve(prompts, 5)
    got = engine.serve(prompts, 5)
    _assert_same(want, got)
    rep, jrep = engine.last_report, jax_engine.last_report
    assert rep.schedule == policy and rep.cache == "paged"
    assert rep.prefix_hits == jrep.prefix_hits > 0


@pytest.mark.parametrize("scenario", ["prefix", "pressure"])
def test_page_counters_equal_jax_static(models, scenario):
    """Under the deterministic static policy, the port's page counters are
    the JAX report's, number for number."""
    jm, jp, tm, tp = models
    if scenario == "prefix":
        prompts = _prefix_prompts(12, 2 * PS, [5, 3, 7, 2, 10])
        kw = dict()
    else:
        rng = np.random.RandomState(13)
        prompts = [rng.randint(1, 256, n).astype(np.int32)
                   for n in (9, 6, 14, 3, 11, 8)]
        kw = dict(num_pages=5, prefix_cache=False)
    base = dict(max_len=MAX_LEN, slots=3, cache="paged", page_size=PS,
                refill_schedule="static", **kw)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**base))
    eng = Engine(tm, tp, ServeConfig(**base))
    _assert_same(jeng.serve(prompts, 6), eng.serve(prompts, 6))
    got, want = eng.last_report, jeng.last_report
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name
    assert [t.deferred_ticks for t in got.requests] == \
        [t.deferred_ticks for t in want.requests]
    assert len(got.page_alloc_stats) == len(want.page_alloc_stats)
    for a, b in zip(got.page_alloc_stats, want.page_alloc_stats):
        assert (a.schedule, a.n, a.faa_total) == (b.schedule, b.n,
                                                  b.faa_total)
    if scenario == "pressure":
        assert got.deferred_admissions > 0
    else:
        assert got.prefix_hits == len(prompts) - 1


# ------------------------------------------------ invariants in the port

def test_paged_equals_contiguous_bit_for_bit(models, mixed_prompts,
                                             monkeypatch):
    """Prefix cache off: tokens equal the contiguous engine's.  Before
    every decode tick, each live slot's table names exactly its pages,
    none of them the scratch page 0."""
    _, _, tm, tp = models
    engine = Engine(tm, tp, _paged(refill_schedule="faa",
                                   prefix_cache=False))
    ticks = []
    decode = Model.decode_step

    def checked(self, params, tokens, cache):
        backend = engine._backend
        for s, pages in enumerate(backend.slot_pages):
            row = cache["pt"][:, s]
            if pages:
                assert (row[:, : len(pages)] == torch.tensor(pages)).all()
                assert 0 not in pages
            else:
                assert not row.any()
        ticks.append(1)
        return decode(self, params, tokens, cache)

    monkeypatch.setattr(Model, "decode_step", checked)
    got = engine.serve(mixed_prompts, 4)
    monkeypatch.undo()
    _assert_same(_contiguous(tm, tp, mixed_prompts, 4, slots=2,
                             refill_schedule="faa"), got)
    rep = engine.last_report
    assert ticks and rep.pages_allocated > 0
    assert rep.pages_freed == rep.pages_allocated
    assert rep.peak_pages_live <= rep.num_pages


def test_paged_equals_contiguous_with_eos_early_exit(models, mixed_prompts):
    """Early eos frees pages mid-serve; the freed slot's dead decode
    writes land on scratch and never corrupt a reused page."""
    _, _, tm, tp = models
    probe = Engine(tm, tp, ServeConfig(max_len=MAX_LEN)).generate(
        {"tokens": mixed_prompts[0][None, :]}, 4)
    eos = int(probe[0, 1])
    got = Engine(tm, tp, _paged(refill_schedule="faa", eos_id=eos)).serve(
        mixed_prompts, 4)
    _assert_same(_contiguous(tm, tp, mixed_prompts, 4, slots=2,
                             refill_schedule="faa", eos_id=eos), got)
    assert sum(1 for o in got if (o[:3] == eos).any()) >= 1


def test_prefix_hit_zero_recompute_and_bit_identity(models):
    _, _, tm, tp = models
    prompts = _prefix_prompts(3, 2 * PS, [5, 3, 7, 2])
    engine = Engine(tm, tp, _paged(refill_schedule="faa"))
    got = engine.serve(prompts, 4)
    _assert_same(_contiguous(tm, tp, prompts, 4, slots=2,
                             refill_schedule="faa"), got)
    rep = engine.last_report
    assert rep.prefix_hits == len(prompts) - 1
    assert rep.prefix_hit_tokens == (len(prompts) - 1) * 2 * PS
    for t in rep.requests:
        assert t.prefill_tokens + t.prefix_hit_tokens == t.prompt_len
        if t.prefix_hit_tokens:
            assert t.prefill_tokens == t.prompt_len - 2 * PS
    assert rep.prefill_tokens == sum(map(len, prompts)) \
        - rep.prefix_hit_tokens


def test_prefix_cache_survives_second_serve_and_reset(models):
    """The trie outlives the call that filled it: every request of a
    second call hits, the report covers that call alone, and
    reset_cache() starts cold again."""
    _, _, tm, tp = models
    prompts = _prefix_prompts(4, PS, [3, 3, 3])
    engine = Engine(tm, tp, _paged(refill_schedule="faa"))
    out1 = engine.serve(prompts, 2)
    assert engine.last_report.prefix_hits == 2
    out2 = engine.serve(prompts, 2)
    rep = engine.last_report
    assert rep.prefix_hits == 3 and rep.prefix_hit_tokens == 3 * PS
    ref = _contiguous(tm, tp, prompts, 2, slots=2)
    _assert_same(ref, out1)
    _assert_same(ref, out2)
    engine.reset_cache()
    engine.serve(prompts, 2)
    assert engine.last_report.prefix_hits == 2


def test_backend_rebuilt_when_cache_changes(models, mixed_prompts):
    _, _, tm, tp = models
    engine = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2))
    want = engine.serve(mixed_prompts, 3)
    assert engine._backend.name == "contiguous"
    engine.cfg.cache, engine.cfg.page_size = "paged", PS
    _assert_same(want, engine.serve(mixed_prompts, 3))
    assert engine._backend.name == engine.last_report.cache == "paged"


def _starvation_scenario():
    rng = np.random.RandomState(8)

    def mk(plen, budget):
        return Request(prompt=rng.randint(1, 256, plen).astype(np.int32),
                       max_new_tokens=budget)

    # static admission splits 15 requests [0..6] / [7..14]: slot 0 churns
    # 2-page smalls; slot 1 opens with a desynchronizing small and then
    # wants the 4-page big request (rid 8)
    return ([mk(8, 8) for _ in range(7)] + [mk(9, 7), mk(16, 16)]
            + [mk(8, 8) for _ in range(6)])


def test_deferred_request_not_starved(models):
    """max_deferred_ticks bars other admissions once the big request ages
    past it, so its deferral ends at the bound plus one drain; without
    the barrier it starves until the churn is over."""
    _, _, tm, tp = models

    def run(mdt):
        engine = Engine(tm, tp, _paged(num_pages=4, prefix_cache=False,
                                       refill_schedule="static",
                                       max_deferred_ticks=mdt))
        return engine.serve(_starvation_scenario(), 16), engine.last_report

    _, rep_off = run(None)
    assert rep_off.requests[8].deferred_ticks > 50
    outs, rep = run(5)
    assert rep.requests[8].deferred_ticks <= 5 + 10
    assert rep.requests[8].admit_tick < rep_off.requests[8].admit_tick
    _assert_same(_contiguous(tm, tp, _starvation_scenario(), 16, slots=2,
                             refill_schedule="static"), outs)


def test_partial_admission_defers_without_deadlock(models):
    _, _, tm, tp = models
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 256, 8).astype(np.int32) for _ in range(6)]
    engine = Engine(tm, tp, ServeConfig(
        max_len=MAX_LEN, slots=4, cache="paged", page_size=PS, num_pages=4,
        prefix_cache=False, refill_schedule="faa"))
    got = engine.serve(prompts, 6)
    _assert_same(_contiguous(tm, tp, prompts, 6, slots=4,
                             refill_schedule="faa"), got)
    rep = engine.last_report
    assert rep.deferred_admissions > 0 and rep.peak_pages_live <= 4
    assert any(t.deferred_ticks > 0 for t in rep.requests)


def test_concurrency_beyond_slot_parity(models):
    """At the KV bytes of two contiguous slots, more than two requests are
    in flight at once."""
    _, _, tm, tp = models
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, 6).astype(np.int32) for _ in range(8)]
    budget = 2 * MAX_LEN // PS
    engine = Engine(tm, tp, ServeConfig(
        max_len=MAX_LEN, slots=4, cache="paged", page_size=PS,
        num_pages=budget, prefix_cache=False, refill_schedule="faa"))
    got = engine.serve(prompts, 6)
    _assert_same(_contiguous(tm, tp, prompts, 6, slots=4,
                             refill_schedule="faa"), got)
    rep = engine.last_report
    live = [sum(1 for t in rep.requests if t.admit_tick <= k < t.finish_tick)
            for k in range(rep.total_ticks + 1)]
    assert max(live) > 2 and rep.peak_pages_live <= budget


def test_injected_page_failure_defers_and_matches(models, mixed_prompts):
    """A PageFailure plan makes claims report pressure while pages are
    free: the requests defer and the tokens do not change.  (Claims 1 and
    3 fail while another slot is live; a failure with no slot live would
    be an admission deadlock, which raises.)"""
    _, _, tm, tp = models
    plan = faults.FaultPlan(seed=3, specs=[faults.PageFailure(allocs=(1,
                                                                      3))])
    engine = Engine(tm, tp, _paged(refill_schedule="faa",
                                   prefix_cache=False))
    with faults.fault_scope(plan):
        got = engine.serve(mixed_prompts, 3)
    assert faults.active() is None
    assert engine.last_report.deferred_admissions == 2
    _assert_same(_contiguous(tm, tp, mixed_prompts, 3, slots=2,
                             refill_schedule="faa"), got)


def test_paged_rejects_what_it_cannot_serve(models):
    _, _, tm, tp = models
    rng = np.random.RandomState(7)
    engine = Engine(tm, tp, _paged(num_pages=2))
    with pytest.raises(ValueError, match="pages"):
        engine.serve([rng.randint(1, 100, 20).astype(np.int32)], 6)
    with pytest.raises(ValueError, match="multiple"):
        Engine(tm, tp, ServeConfig(max_len=MAX_LEN, cache="paged",
                                   page_size=7)).serve([np.arange(1, 6)], 2)
    with pytest.raises(ValueError, match="on_pressure"):
        Engine(tm, tp, ServeConfig(on_pressure="drop")).serve(
            [np.arange(1, 6)], 2)


def test_page_size_none_resolves_through_the_tuning_db(models, mixed_prompts,
                                                       monkeypatch):
    """ServeConfig(page_size=None) resolves the page size as the JAX
    engine does: under REPRO_TUNING=off the analytic 16 in both, with
    equal tokens; with a warm db the open bucket's tuned page size."""
    jm, jp, tm, tp = models
    kw = dict(max_len=MAX_LEN, slots=2, cache="paged", page_size=None,
              refill_schedule="faa")
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    eng = Engine(tm, tp, ServeConfig(**kw))
    _assert_same(jeng.serve(mixed_prompts, 4), eng.serve(mixed_prompts, 4))
    assert eng._backend.ps == jeng._backend.ps == 16

    from repro_torch.core import autotune_search
    spec = autotune_search.SPECS["paged_decode_attention"]
    hd = tm.cfg.resolved_head_dim
    bucket = spec.bucket(s=MAX_LEN, page_size=0, d=hd, dv=hd,
                         dtype="float32", rows=2 * tm.cfg.n_kv_heads)
    db = autotune_search.TuningDB()
    db.record("paged_decode_attention", "cpu", spec.bucket_key(bucket),
              {"page_size": 8, "num_buffers": 2})
    monkeypatch.setenv("REPRO_TUNING", "on")
    autotune_search.set_db(db)
    try:
        before = autotune_search.measurement_count()
        tuned = Engine(tm, tp, ServeConfig(**kw))
        got = tuned.serve(mixed_prompts, 4)
        assert tuned._backend.ps == PS == 8
        assert autotune_search.measurement_count() == before
    finally:
        autotune_search.reset_db()
    _assert_same(Engine(tm, tp, _paged(refill_schedule="faa")).serve(
        mixed_prompts, 4), got)


# -------------------------------------------- allocator and trie properties

def _run_interleaved(schedule, ops, pool, slots, block):
    """Interpret a (kind, salt) op stream against a PageAllocator next to
    an oracle refcount array; assert the contract at every step."""
    alloc = PageAllocator(pool, slots=slots, schedule=schedule,
                          block_size=block)
    held, forks = [], []
    model_ref = np.zeros(pool + 1, np.int64)
    for kind, salt in ops:
        if kind == "alloc":
            n = salt % (pool + 2)          # occasionally exceeds the pool
            before = alloc.free_count
            got = alloc.try_alloc(n)
            if n > before:
                assert got is None and alloc.free_count == before
                continue
            assert got is not None and len(set(got)) == n   # exactly once
            for p in got:
                assert 1 <= p <= pool and model_ref[p] == 0
                model_ref[p] = 1
            if n:
                held.append(got)
        elif kind == "free" and held:
            pages = held.pop(salt % len(held))
            alloc.free(pages)
            model_ref[pages] -= 1
        elif kind == "fork" and held:
            pages = held[salt % len(held)]
            alloc.share(pages)
            forks.append(pages)
            model_ref[pages] += 1
        elif kind == "release_fork" and forks:
            pages = forks.pop(salt % len(forks))
            alloc.free(pages)
            model_ref[pages] -= 1
        live = int((model_ref > 0).sum())
        assert alloc.free_count == pool - live == pool - alloc.live_count
        np.testing.assert_array_equal(alloc.refcount[1:], model_ref[1:])
        assert not (set(alloc._free) & set(np.nonzero(model_ref)[0]))
    for stats in alloc.stats:
        assert stats.schedule == schedule
        local = stats.faa_per_thread - stats.faa_shared_per_thread
        assert (local >= 0).all()
        assert stats.faa_total == stats.faa_shared + int(local.sum())
        assert sum(sz * c for sz, c in stats.claim_sizes.items()) == stats.n
        assert int(stats.items_per_thread.sum()) == stats.n
    assert alloc.pages_allocated == sum(s.n for s in alloc.stats)


_KINDS = ["alloc", "alloc", "free", "fork", "release_fork"]


@pytest.mark.parametrize("schedule", POLICIES)
def test_allocator_interleaved_ops_invariants(schedule):
    rng = np.random.RandomState(0xC0FFEE)
    for _ in range(8):
        pool = int(rng.randint(1, 25))
        slots = int(rng.randint(1, 7))
        block = None if rng.rand() < 0.5 else int(rng.randint(1, 9))
        ops = [(_KINDS[rng.randint(len(_KINDS))],
                int(rng.randint(0, 10 ** 6)))
               for _ in range(rng.randint(1, 41))]
        _run_interleaved(schedule, ops, pool, slots, block)


@pytest.mark.parametrize("schedule", POLICIES)
def test_allocator_double_free_and_uaf_raise(schedule):
    alloc = PageAllocator(8, slots=2, schedule=schedule)
    pages = alloc.alloc(3)
    alloc.free(pages)
    with pytest.raises(RuntimeError, match="double free"):
        alloc.free([pages[0]])
    with pytest.raises(RuntimeError, match="use-after-free"):
        alloc.share([pages[0]])
    with pytest.raises(ValueError, match="scratch"):
        alloc.free([0])
    with pytest.raises(ValueError, match="out of range"):
        alloc.share([9])


@pytest.mark.parametrize("schedule", POLICIES)
def test_shared_pages_survive_any_single_free(schedule):
    pool, nshare = 8, 3
    alloc = PageAllocator(pool, slots=2, schedule=schedule)
    pages = alloc.alloc(2)
    for _ in range(nshare):
        alloc.share(pages)
    for i in range(nshare):
        alloc.free(pages)
        assert alloc.free_count == pool - 2
        assert all(alloc.refcount[p] == nshare - i for p in pages)
    alloc.free(pages)
    assert alloc.free_count == pool and not alloc.refcount[pages].any()


def _run_trie_fuzz(seed, pool):
    rng = np.random.RandomState(seed)
    alloc = PageAllocator(pool, slots=2, schedule="faa")
    cache = PrefixCache(alloc, page_size=4)
    prompts = []
    for _ in range(rng.randint(1, 6)):
        plen = rng.randint(1, 3 * 4 + 2)
        prompt = rng.randint(0, 5, plen).astype(np.int32)
        need = -(-plen // 4)
        if need > alloc.free_count:
            cache.evict(need - alloc.free_count)
        got = alloc.try_alloc(need)
        if got is None:
            continue
        assert len(cache.match(prompt)) <= (plen - 1) // 4
        cache.insert(prompt, got)
        prompts.append(prompt)
        alloc.free(got)      # request finishes; cache refs keep pages
    if cache.evictions == 0:
        for p in prompts:
            assert len(cache.match(p)) == min(len(p) // 4, (len(p) - 1) // 4)
    live_before = alloc.live_count
    assert cache.evict(pool) == live_before
    assert alloc.free_count == pool and len(cache) == 0


def test_prefix_cache_trie_and_eviction_fuzz():
    for seed in range(12):
        _run_trie_fuzz(seed, pool=int(6 + 2 * seed))


def test_prefix_cache_never_evicts_shared_page():
    alloc = PageAllocator(4, slots=1, schedule="faa")
    cache = PrefixCache(alloc, page_size=2)
    pages = alloc.alloc(2)
    cache.insert(np.asarray([1, 2, 3, 4], np.int32), pages)
    matched = cache.match(np.asarray([1, 2, 3, 4, 5], np.int32))
    assert matched == pages
    alloc.share(matched)
    alloc.free(pages)
    assert cache.evict(4) == 0
    assert all(alloc.refcount[p] == 2 for p in pages)
    alloc.free(matched)
    assert cache.evict(4) == 2 and alloc.free_count == 4


# ------------------------------------------------- ParallelFor and faults

@pytest.mark.parametrize("schedule", POLICIES)
def test_parallel_for_exactly_once_under_every_policy(schedule):
    seen = np.zeros(37, np.int64)
    stats = pf.parallel_for_stats(lambda i: np.add.at(seen, i, 1), 37,
                                  n_threads=3, schedule=schedule,
                                  block_size=4, layer="test")
    assert (seen == 1).all() and stats.schedule == schedule
    assert int(stats.items_per_thread.sum()) == 37
    if schedule == "static":
        want = jax_pf.parallel_for_stats(lambda i: None, 37, n_threads=3,
                                         schedule="static", block_size=4)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(np.asarray(getattr(stats, f.name)),
                                          np.asarray(getattr(want, f.name)))


def test_block_layout_and_fault_decisions_match_reference():
    for n, b, w in ((10, 3, 4), (16, 4, 2), (7, 8, 3)):
        np.testing.assert_array_equal(pf.block_cyclic_assignment(n, b, w),
                                      jax_pf.block_cyclic_assignment(n, b, w))
        assert pf.grain_sizes(n, b) == jax_pf.grain_sizes(n, b)
    ours = faults.FaultInjector(faults.FaultPlan(seed=7))
    ref = JaxFaultInjector(JaxFaultPlan(seed=7))
    for key in (("palloc", 0, 3), ("poison", "decode", 1, 4, 2)):
        assert ours._rand(*key) == ref._rand(*key)
