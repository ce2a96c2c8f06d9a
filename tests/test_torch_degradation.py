"""The port's graceful degradation, the chaos differential of the serve
engine, against the JAX package on the CPU.

Mirrors ``tests/test_serve_degradation.py`` case by case on the port
(the reduced qwen2.5-3b in f32, parameters bridged from the JAX tree):
every request ends with exactly one terminal status, the survivors'
tokens equal the no-fault run bit for bit, pages are freed exactly once,
and an empty plan changes nothing.  Each faulted run is also held to the
JAX engine under the same :class:`FaultPlan` (the reference's plan
classes built from the port's specs): the same statuses and the same
tokens, failed rows included.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import faults as jax_faults
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.queue import Request as JaxRequest

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import faults
from repro_torch.core.faults import (DecodeStall, FaultPlan, PageFailure,
                                     PoisonRequest, WorkerStall)
from repro_torch.models import Model
from repro_torch.serve import Engine, Request, ServeConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

PS = 8          # page size (divides max_len=48)
MAX_NEW = 4


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(jax_config("qwen2.5-3b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(get_config("qwen2.5-3b").reduced(), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, model.cfg.vocab_size, n).astype(np.int32)
               for n in [8, 8, 5, 8, 5, 11, 3]]
    return model, params, prompts, (jm, jp)


def _cfg(cache, kw):
    kw = dict(kw)
    kw.setdefault("max_len", 48)
    kw.setdefault("slots", 2)
    if cache == "paged":
        kw.setdefault("page_size", PS)
        kw.setdefault("prefix_cache", False)
    return dict(cache=cache, **kw)


def _serve(setup, plan=None, cache="paged", prompts=None, **kw):
    model, params, base, _ = setup
    prompts = base if prompts is None else prompts
    eng = Engine(model, params, ServeConfig(**_cfg(cache, kw)))
    if plan is None:
        out = eng.serve(prompts, MAX_NEW)
    else:
        with faults.fault_scope(plan):
            out = eng.serve(prompts, MAX_NEW)
    return out, eng.last_report


_JAX_ENGINES: dict = {}


def _jax_plan(plan: FaultPlan):
    """The reference's FaultPlan with the same seed and specs."""
    return jax_faults.FaultPlan(seed=plan.seed, specs=tuple(
        getattr(jax_faults, type(sp).__name__)(**dataclasses.asdict(sp))
        for sp in plan.specs))


def _serve_jax(setup, plan=None, cache="paged", prompts=None, **kw):
    """The JAX engine under the reference twin of ``plan`` (one engine per
    configuration, so its jit specializations are kept)."""
    jm, jp = setup[3]
    prompts = setup[2] if prompts is None else [
        JaxRequest(r.rid, r.prompt, max_new_tokens=r.max_new_tokens)
        for r in prompts]
    key = (cache, tuple(sorted(kw.items())))
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JaxEngine(jm, jp, JaxServeConfig(**_cfg(cache,
                                                                     kw)))
    eng = _JAX_ENGINES[key]
    eng.reset_cache()
    if plan is None:
        out = eng.serve(prompts, MAX_NEW)
    else:
        with jax_faults.fault_scope(_jax_plan(plan)):
            out = eng.serve(prompts, MAX_NEW)
    return out, eng.last_report


def _assert_jax_twin(setup, plan, out, rep, **kw):
    """The same statuses, retries and tokens (failed rows included) as
    the JAX engine under the same plan."""
    want, jrep = _serve_jax(setup, plan, **kw)
    assert [(t.status, t.retries) for t in rep.requests] == [
        (t.status, t.retries) for t in jrep.requests]
    for i, (w, g) in enumerate(zip(want, out)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


@pytest.fixture(scope="module")
def no_fault(setup):
    """The port's fault-free tokens, per (cache, schedule)."""
    memo = {}

    def get(cache="paged", schedule=None):
        key = (cache, schedule)
        if key not in memo:
            kw = {} if schedule is None else {"refill_schedule": schedule}
            memo[key] = _serve(setup, cache=cache, **kw)[0]
        return memo[key]

    return get


def _check_partition(rep):
    """Statuses partition the submitted set and the report counts agree;
    a paged run frees every page it claimed."""
    st = [t.status for t in rep.requests]
    assert all(s in ("ok", "failed", "shed") for s in st)
    assert st.count("failed") == rep.failed_requests
    assert st.count("shed") == rep.shed_requests
    assert st.count("ok") == rep.ok_requests
    assert rep.ok_requests + rep.failed_requests + rep.shed_requests \
        == rep.n_requests
    if rep.cache == "paged":
        assert rep.pages_freed == rep.pages_allocated   # exactly-once pages


def _assert_survivors_identical(ref, out, rep):
    for t in rep.requests:
        if t.status == "ok":
            np.testing.assert_array_equal(ref[t.rid], out[t.rid],
                                          err_msg=f"survivor {t.rid}")
        else:
            assert t.fail_reason


# ---------------------------------------------------------------------------
# Per-request failure isolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_poisoned_admission_is_isolated(setup, no_fault, cache):
    plan = FaultPlan(seed=1, specs=[PoisonRequest(rids=(2,))])
    out, rep = _serve(setup, plan, cache=cache)
    _check_partition(rep)
    assert rep.failed_requests == 1
    assert {t.rid: t.status for t in rep.requests}[2] == "failed"
    assert "RequestPoisoned" in rep.requests[2].fail_reason
    _assert_survivors_identical(no_fault(cache), out, rep)
    assert (out[2] == -1).all()
    _assert_jax_twin(setup, plan, out, rep, cache=cache)


@pytest.mark.parametrize("schedule", ["faa", "stealing", "hierarchical"])
def test_survivor_bit_identity_across_admission_policies(setup, no_fault,
                                                         schedule):
    plan = FaultPlan(seed=1, specs=[PoisonRequest(rids=(2, 5))])
    out, rep = _serve(setup, plan, refill_schedule=schedule)
    _check_partition(rep)
    assert rep.failed_requests == 2
    _assert_survivors_identical(no_fault("paged", schedule), out, rep)
    _assert_jax_twin(setup, plan, out, rep, refill_schedule=schedule)


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_poisoned_decode_cancels_mid_stream(setup, no_fault, cache):
    """A decode-time poison frees the slot (and its pages) mid-generation;
    the batch around it is untouched."""
    plan = FaultPlan(seed=1, specs=[
        PoisonRequest(rids=(0,), site="decode", steps=(2,))])
    out, rep = _serve(setup, plan, cache=cache)
    _check_partition(rep)
    st = {t.rid: t for t in rep.requests}
    assert st[0].status == "failed" and "decode" in st[0].fail_reason
    _assert_survivors_identical(no_fault(cache), out, rep)
    _assert_jax_twin(setup, plan, out, rep, cache=cache)


def test_zero_budget_requests_terminal_ok_under_chaos(setup):
    """max_new_tokens=0 admits, emits nothing and goes terminal ok at its
    admission tick, while poison fails a sibling."""
    base = setup[2]
    reqs = [Request(i, p, max_new_tokens=(0 if i in (1, 4) else None))
            for i, p in enumerate(base)]
    ref, _ = _serve(setup, prompts=reqs)
    plan = FaultPlan(seed=1, specs=[PoisonRequest(rids=(2,))])
    out, rep = _serve(setup, plan, prompts=reqs)
    _check_partition(rep)
    by_rid = {t.rid: t for t in rep.requests}
    for rid in (1, 4):
        assert out[rid].shape == (0,)
        assert by_rid[rid].status == "ok"
        assert by_rid[rid].finish_tick == by_rid[rid].admit_tick
        assert by_rid[rid].decode_tokens == 0
    assert by_rid[2].status == "failed"
    _assert_survivors_identical(ref, out, rep)
    _assert_jax_twin(setup, plan, out, rep, prompts=reqs)


def test_isolation_off_restores_propagate_everything(setup):
    plan = FaultPlan(seed=1, specs=[PoisonRequest(rids=(2,))])
    with pytest.raises(faults.RequestPoisoned):
        _serve(setup, plan, isolate_failures=False)


# ---------------------------------------------------------------------------
# Deadlines, retries, backoff
# ---------------------------------------------------------------------------


def test_retry_after_transient_poison_recovers_everything(setup, no_fault):
    """A times=1 poison fails the first admission attempt only: with a
    retry budget the request re-enters after backoff and the whole run is
    bit-identical to no-fault."""
    plan = FaultPlan(seed=1, specs=[PoisonRequest(rids=(2,), times=1)])
    out, rep = _serve(setup, plan, max_retries=2, backoff=1.0)
    _check_partition(rep)
    assert rep.failed_requests == 0 and rep.retries == 1
    assert rep.requests[2].retries == 1
    for i, want in enumerate(no_fault()):
        np.testing.assert_array_equal(want, out[i])
    _assert_jax_twin(setup, plan, out, rep, max_retries=2, backoff=1.0)


def test_retry_budget_exhausts_to_terminal_failed(setup):
    plan = FaultPlan(seed=1, specs=[PoisonRequest(rids=(2,), times=10)])
    out, rep = _serve(setup, plan, max_retries=2, backoff=1.0)
    _check_partition(rep)
    tm = rep.requests[2]
    assert tm.status == "failed" and tm.retries == 2
    _assert_jax_twin(setup, plan, out, rep, max_retries=2, backoff=1.0)


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_deadline_cancels_and_fails_without_retries(setup, cache):
    """deadline_ticks below every request's decode need: all cancelled,
    none lost, no raise — and pages come back."""
    out, rep = _serve(setup, cache=cache, deadline_ticks=2)
    _check_partition(rep)
    assert rep.failed_requests == rep.n_requests
    assert all("deadline" in t.fail_reason for t in rep.requests)
    assert all((o == -1).all() for o in out)


def test_deadline_with_headroom_changes_nothing(setup, no_fault):
    out, rep = _serve(setup, deadline_ticks=64, max_retries=3)
    _check_partition(rep)
    assert rep.failed_requests == 0 and rep.retries == 0
    for i, want in enumerate(no_fault()):
        np.testing.assert_array_equal(want, out[i])


def test_deadline_with_retries_matches_jax(setup):
    """A deadline that cancels, with a retry budget: each request retries
    after its backoff and fails the same way the reference's does."""
    out, rep = _serve(setup, deadline_ticks=2, max_retries=1, backoff=2.0)
    _check_partition(rep)
    assert rep.retries == rep.n_requests
    _assert_jax_twin(setup, None, out, rep, deadline_ticks=2, max_retries=1,
                     backoff=2.0)


# ---------------------------------------------------------------------------
# Page pressure: deferral aging, shedding, graceful completion
# ---------------------------------------------------------------------------


def test_transient_page_pressure_defers_then_recovers(setup, no_fault):
    """Injected allocation failures bounce admissions through push_back;
    once the budget dries up every request admits and the tokens match
    the no-fault run exactly."""
    plan = FaultPlan(seed=3, specs=[PageFailure(p=0.5, times=6)])
    out, rep = _serve(setup, plan)
    _check_partition(rep)
    assert rep.failed_requests == 0 and rep.shed_requests == 0
    assert rep.deferred_admissions > 0
    assert sum(t.deferred_ticks for t in rep.requests) \
        == rep.deferred_admissions
    for i, want in enumerate(no_fault()):
        np.testing.assert_array_equal(want, out[i])
    _assert_jax_twin(setup, plan, out, rep)


def test_pushback_interleaved_with_aging_barrier_under_pressure(setup,
                                                                no_fault):
    """push_back deferral x max_deferred_ticks aging under injected
    pressure: the aging bound engages and the run converges to all-ok
    with exact allocator accounting."""
    plan = FaultPlan(seed=5, specs=[PageFailure(allocs=(1, 2, 3))])
    out, rep = _serve(setup, plan, max_deferred_ticks=2)
    _check_partition(rep)
    assert rep.failed_requests == 0 and rep.shed_requests == 0
    assert max(t.deferred_ticks for t in rep.requests) > 2
    for i, want in enumerate(no_fault()):
        np.testing.assert_array_equal(want, out[i])


def test_on_pressure_shed_drops_youngest_and_serves_the_rest(setup,
                                                             no_fault):
    """A hard admission deadlock under the shed policy drops the youngest
    deferred request(s) with SHED status; survivors complete identically,
    and the reference sheds the same requests."""
    plan = FaultPlan(seed=3, specs=[PageFailure(p=1.0, times=4)])
    out, rep = _serve(setup, plan, on_pressure="shed")
    _check_partition(rep)
    assert rep.shed_requests > 0 and rep.failed_requests == 0
    assert rep.survival_rate < 1.0
    for t in rep.requests:
        if t.status == "shed":
            assert "load shed" in t.fail_reason
            assert (out[t.rid] == -1).all()
    _assert_survivors_identical(no_fault(), out, rep)
    _assert_jax_twin(setup, plan, out, rep, on_pressure="shed")


def test_on_pressure_defer_completes_without_raising(setup):
    plan = FaultPlan(seed=3, specs=[PageFailure(p=1.0)])
    out, rep = _serve(setup, plan, on_pressure="defer")
    _check_partition(rep)
    assert rep.failed_requests == rep.n_requests
    assert all((o == -1).all() for o in out)
    _assert_jax_twin(setup, plan, out, rep, on_pressure="defer")


def test_on_pressure_raise_keeps_the_loud_default(setup):
    plan = FaultPlan(seed=3, specs=[PageFailure(p=1.0)])
    with pytest.raises(RuntimeError, match="refill deadlock"):
        _serve(setup, plan)


@pytest.mark.parametrize("field,value,match", [
    ("on_pressure", "panic", "on_pressure"),
    ("max_retries", -1, "max_retries"),
    ("deadline_ticks", 0, "deadline_ticks")])
def test_degradation_knobs_validated_at_serve(setup, field, value, match):
    """As in the reference, the knobs are checked when serve() runs."""
    model, params, prompts, _ = setup
    eng = Engine(model, params, ServeConfig(**{field: value}))
    with pytest.raises(ValueError, match=match):
        eng.serve(prompts, MAX_NEW)


# ---------------------------------------------------------------------------
# Straggler telemetry: injected stalls surface as exposed wait
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_decode_stalls_charge_the_report_ledger(setup, no_fault, cache):
    """Injected straggler ticks surface in ServeReport.injected_stall_s
    without perturbing a single output token (virtual clock)."""
    _, rep0 = _serve(setup, cache=cache)
    assert rep0.injected_stall_s == 0.0
    plan = FaultPlan(seed=1, specs=[DecodeStall(p=1.0, duration_s=0.003)])
    out, rep = _serve(setup, plan, cache=cache)
    _check_partition(rep)
    # one stall per decode tick, exactly
    assert rep.injected_stall_s == pytest.approx(0.003 * rep.total_ticks)
    assert plan.clock.elapsed_s == pytest.approx(rep.injected_stall_s)
    for i, want in enumerate(no_fault(cache)):
        np.testing.assert_array_equal(want, out[i])


def test_page_alloc_stalls_roll_up_into_the_report(setup, no_fault):
    """A straggler inside the page-claim ParallelFor is charged to that
    run's ScheduleStats and rolled up into the serve report's ledger."""
    plan = FaultPlan(seed=2, specs=[
        WorkerStall(layer="paged_alloc", p=1.0, duration_s=0.001)])
    out, rep = _serve(setup, plan)
    _check_partition(rep)
    assert rep.injected_stall_s > 0.0
    assert sum(s.injected_stall_s for s in rep.page_alloc_stats) \
        == pytest.approx(rep.injected_stall_s)
    for i, want in enumerate(no_fault()):
        np.testing.assert_array_equal(want, out[i])


# ---------------------------------------------------------------------------
# Disabled hooks == pre-PR behavior
# ---------------------------------------------------------------------------


def _tick_telemetry(rep):
    """The deterministic (non-wall-clock) slice of a report."""
    return {
        "ticks": rep.total_ticks,
        "tokens": rep.total_tokens,
        "statuses": [(t.rid, t.status, t.admit_tick, t.finish_tick,
                      t.decode_tokens, t.deferred_ticks, t.retries)
                     for t in rep.requests],
        "pages": (rep.pages_allocated, rep.pages_freed,
                  rep.peak_pages_live),
        "deferred": rep.deferred_admissions,
        "failed": rep.failed_requests,
        "shed": rep.shed_requests,
        "stall": rep.injected_stall_s,
    }


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_empty_plan_is_semantics_neutral(setup, cache):
    """An installed-but-empty plan exercises every hook site; tokens and
    tick-level telemetry match the no-plan run and the reference's."""
    ref, rep_off = _serve(setup, cache=cache)
    out, rep_on = _serve(setup, FaultPlan(seed=0, specs=[]), cache=cache)
    for i in range(len(ref)):
        np.testing.assert_array_equal(ref[i], out[i])
    assert _tick_telemetry(rep_off) == _tick_telemetry(rep_on)
    assert rep_on.injected_stall_s == 0.0
    _, jrep = _serve_jax(setup, cache=cache)
    want = _tick_telemetry(jrep)
    got = _tick_telemetry(rep_off)
    assert got["statuses"] == want["statuses"]
    assert (got["ticks"], got["tokens"], got["pages"]) == (
        want["ticks"], want["tokens"], want["pages"])


def test_default_row_shape_untouched_without_faults(setup):
    """as_row carries the degradation columns with inert no-fault values
    (ok == requests, zeros elsewhere)."""
    _, rep = _serve(setup)
    row = rep.as_row()
    assert row["ok"] == row["requests"]
    assert row["failed"] == 0 and row["shed"] == 0
    assert row["retries"] == 0 and row["injected_stall_s"] == 0.0
