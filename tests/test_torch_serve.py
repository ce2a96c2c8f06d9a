"""The port's continuous-batching serve engine and its framework-free
core, against the JAX package, on the CPU.

Greedy tokens must be equal to the JAX engine's under every registered
admission policy (the reduced qwen2.5-3b in f32, parameters bridged
from the JAX tree).  Inside the port, serve must equal per-request
``generate()``.  The admission plans and the cost model's forward half
must give the reference's answers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import cost_model as jax_cm
from repro.core import runtime as jax_rt
from repro.core.schedulers import available_schedulers as jax_policies
from repro.core.schedulers import plan_admission as jax_plan
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.queue import Request as JaxRequest

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.core import runtime as rt
from repro_torch.core.schedulers import available_schedulers, plan_admission
from repro_torch.models import Model
from repro_torch.serve import Engine, Request, ServeConfig, SpecConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

POLICIES = list(available_schedulers())
MAX_LEN = 48


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_config("qwen2.5-3b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("qwen2.5-3b").reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def engines(models):
    """One engine per framework, reused across policies (the JAX one keeps
    its jit specializations)."""
    jm, jp, tm, tp = models
    return (JaxEngine(jm, jp, JaxServeConfig(max_len=MAX_LEN, slots=2)),
            Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2)))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).astype(np.int32)
            for n in [8, 8, 5, 8, 5, 11, 3]]


def test_policies_match_reference_registry():
    assert POLICIES == list(jax_policies())


@pytest.mark.parametrize("policy", POLICIES)
def test_serve_tokens_equal_jax_under_every_policy(engines, prompts, policy):
    jax_engine, engine = engines
    jax_engine.cfg.refill_schedule = policy
    engine.cfg.refill_schedule = policy
    want = jax_engine.serve(prompts, 4)
    got = engine.serve(prompts, 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    rep = engine.last_report
    assert rep.schedule == policy and rep.n_requests == len(prompts)
    assert rep.total_tokens == 4 * len(prompts)
    assert rep.prefill_tokens == sum(len(p) for p in prompts)


def test_serve_equals_per_request_generate(engines, prompts):
    _, engine = engines
    engine.cfg.refill_schedule = "faa"
    outs = engine.serve(prompts, 5)
    for p, out in zip(prompts, outs):
        solo = engine.generate({"tokens": p[None, :]}, 5)
        np.testing.assert_array_equal(solo[0], out)


def test_generate_padded_batch_equals_solo(engines, prompts):
    """generate() over a right-padded mixed-length batch (per-row cache
    lengths, the serve path's decode) equals one generate() per prompt."""
    _, engine = engines
    batch = prompts[:4]
    width = max(len(p) for p in batch)
    toks = np.zeros((len(batch), width), np.int32)
    for i, p in enumerate(batch):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in batch], np.int32)
    out = engine.generate({"tokens": toks}, 4, lengths=lens)
    for p, row in zip(batch, out):
        np.testing.assert_array_equal(
            engine.generate({"tokens": p[None, :]}, 4)[0], row)


def test_eos_early_exit_and_per_request_budgets(models, prompts):
    """A token the model emits becomes eos: requests stop early and stay
    eos-padded, per-request budgets cap outputs, and every output still
    equals per-request generate()."""
    _, _, tm, tp = models
    probe = Engine(tm, tp, ServeConfig(max_len=MAX_LEN)).generate(
        {"tokens": prompts[0][None, :]}, 4)
    eos = int(probe[0, 1])
    engine = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2,
                                        refill_schedule="faa", eos_id=eos))
    reqs = [Request(prompt=p, max_new_tokens=3 if i % 2 else None)
            for i, p in enumerate(prompts)]
    outs = engine.serve(reqs, 4)
    stopped = 0
    for r, out in zip(reqs, outs):
        solo = engine.generate({"tokens": r.prompt[None, :]}, len(out))
        np.testing.assert_array_equal(solo[0], out)
        hits = np.nonzero(out == eos)[0]
        if hits.size and hits[0] < len(out) - 1:
            stopped += 1
            assert (out[hits[0]:] == eos).all()
    assert stopped >= 1
    assert [len(o) for o in outs] == [4, 3, 4, 3, 4, 3, 4]


def test_idle_slot_runs_past_max_len(models):
    """More decode ticks than max_len while a slot sits idle: the idle
    slot's length keeps growing past the cache (the reference clamps its
    writes silently), and the output still equals the JAX engine's and
    per-request generate()."""
    jm, jp, tm, tp = models
    max_len = 8
    rng = np.random.RandomState(1)
    # (prompt, budget): under the static plan slot 0 serves requests 0 and
    # 1 (1 finishes at admission, tick 3) and then idles for 6 ticks while
    # slot 1 serves 2 and then 3 — 9 ticks in all, slot 0's length 12
    reqs = [Request(prompt=rng.randint(1, 256, p).astype(np.int32),
                    max_new_tokens=b)
            for p, b in ((1, 4), (6, 1), (1, 4), (1, 7))]
    engine = Engine(tm, tp, ServeConfig(max_len=max_len, slots=2))
    outs = engine.serve(reqs, 7)
    assert engine.last_report.total_ticks > max_len
    assert int(engine._backend.cache["len"][0, 0]) > max_len
    want = JaxEngine(jm, jp, JaxServeConfig(max_len=max_len, slots=2)).serve(
        [JaxRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
         for r in reqs], 7)
    for r, w, g in zip(reqs, want, outs):
        np.testing.assert_array_equal(g, w)
        solo = engine.generate({"tokens": r.prompt[None, :]}, len(g))
        np.testing.assert_array_equal(solo[0], g)


@pytest.mark.parametrize("field,value", [
    ("mode", "rounds"), ("temperature", 0.7)])
def test_unported_options_raise(models, prompts, field, value):
    """The last two options of the reference engine are ported and no
    longer raise: the round barrier serves the greedy tokens of the
    continuous engine, and a temperature serves each request's
    ``generate(rids=...)`` draws (tests/test_torch_sampling.py holds both
    to the JAX engine).  The name is kept from when both options raised;
    the test now holds what they serve."""
    _, _, tm, tp = models
    engine = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2,
                                        **{field: value}))
    got = engine.serve(prompts, 4)
    if field == "mode":
        want = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2)).serve(
            prompts, 4)
    else:
        want = [engine.generate({"tokens": p[None, :]}, 4, rids=[rid])[0]
                for rid, p in enumerate(prompts)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("field,value", [
    ("spec", "self"), ("deadline_ticks", 4), ("max_retries", 1),
    ("on_pressure", "shed"), ("on_pressure", "defer")])
def test_spec_and_degradation_options_serve(models, prompts, field, value):
    """The speculation and degradation options are ported: the engine
    builds with each and, with no fault plan installed, serves the greedy
    tokens."""
    _, _, tm, tp = models
    if field == "spec":
        value = SpecConfig(draft=tm, draft_params=tp, k=2)
    want = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2)).serve(
        prompts, 4)
    engine = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2,
                                        **{field: value}))
    for w, g in zip(want, engine.serve(prompts, 4)):
        np.testing.assert_array_equal(g, w)
    assert engine.last_report.ok_requests == len(prompts)


@pytest.mark.parametrize("kv_dtype", ["int8", "float8_e4m3fn"])
def test_engine_accepts_quantized_kv_dtypes(models, kv_dtype):
    """A quantized kv_dtype is ported: the engine builds, its caches hold
    1-byte values beside f16 scales, and it serves."""
    _, _, tm, tp = models
    engine = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, slots=2,
                                        kv_dtype=kv_dtype))
    assert engine.kv_dtype == getattr(torch, kv_dtype)
    out = engine.serve([np.arange(1, 6, dtype=np.int32)], 3)
    assert out[0].shape == (3,)
    cache = engine._backend.cache
    assert cache["k"].dtype == engine.kv_dtype
    assert cache["ks"].dtype == torch.float16
    with pytest.raises(ValueError, match="KV cache dtype"):
        Engine(tm, tp, ServeConfig(kv_dtype="int16"))


def test_unported_families_raise():
    """Every family builds now, the encoder-decoder and vision families
    included; those two serve through ``generate`` only, and ``serve()``
    refuses them, as the reference does (tests/test_torch_encdec_vlm.py
    holds them to it)."""
    assert Model(get_config("zamba2-2.7b").reduced(),
                 device="cpu").cfg.family == "hybrid"
    for arch, family in (("seamless-m4t-large-v2", "encdec"),
                         ("llama-3.2-vision-11b", "vlm")):
        model = Model(get_config(arch).reduced(), device="cpu")
        assert model.cfg.family == family
        engine = Engine(model, model.init(seed=0), ServeConfig(max_len=32))
        with pytest.raises(ValueError, match="needs modal inputs"):
            engine.serve([np.arange(1, 5, dtype=np.int32)], 2)


# ------------------------------------------------------------------ core

@pytest.mark.parametrize("policy", POLICIES)
def test_admission_plan_matches_reference(policy):
    """Every policy claims each request exactly once; the deterministic
    static plan is equal to the reference's, stats and all."""
    got = plan_admission(23, 4, policy, block_size=2)
    want = jax_plan(23, 4, policy, block_size=2)
    assert sorted(got.claim_order) == list(range(23))
    assert got.stats.schedule == want.stats.schedule
    assert int(got.stats.items_per_thread.sum()) == 23
    if policy == "static":
        np.testing.assert_array_equal(got.assignment, want.assignment)
        for f in dataclasses.fields(want.stats):
            a, b = getattr(got.stats, f.name), getattr(want.stats, f.name)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cost_model_forward_matches_reference():
    x, _ = jax_cm.paper_normalized_features(jax_cm.PAPER_INFERENCE_ROWS)
    np.testing.assert_allclose(
        cm.predict(cm.PAPER_WEIGHTS, x),
        np.asarray(jax_cm.predict(jax_cm.PAPER_WEIGHTS, x)), rtol=1e-5)
    for g in (1, 2, 4):
        for t in (2, 8, 32):
            feats = dict(core_groups=g, threads=t, unit_read=1 << 10,
                         unit_write=1 << 12, unit_comp=1 << 20)
            for n in (None, 100, 4096):
                assert cm.suggest_block_size(
                    cm.WorkloadFeatures(**feats), n=n) == \
                    jax_cm.suggest_block_size(
                        jax_cm.WorkloadFeatures(**feats), n=n)
    args = (4096, 16, 90.0, 40.0, 8)
    kw = dict(groups=2, faa_remote_cost=300.0)
    assert cm.analytic_cost(*args, 0.35, **kw) == \
        jax_cm.analytic_cost(*args, 0.35, **kw)
    assert cm.analytic_hierarchical_cost(*args, 0.35, **kw) == \
        jax_cm.analytic_hierarchical_cost(*args, 0.35, **kw)
    assert cm.rank_schedules(*args, **kw) == jax_cm.rank_schedules(*args,
                                                                   **kw)
    assert cm.analytic_best_block(4096, 90.0, 40.0, 8) == \
        jax_cm.analytic_best_block(4096, 90.0, 40.0, 8)


def test_tuning_context_matches_reference_default():
    """Under REPRO_CALIBRATION=off the reference's context is its default;
    the port's is the same numbers and admits in the same blocks."""
    ours, ref = rt.tuning(), jax_rt.tuning()
    for f in ("faa_cost", "faa_remote_cost", "per_item_cost",
              "host_groups"):
        assert getattr(ours, f) == getattr(ref, f)
    for n in (1, 7, 64, 1000):
        for slots in (1, 4, 8):
            assert ours.admission_block(n, slots) == \
                ref.admission_block(n, slots)
