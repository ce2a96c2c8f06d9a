"""Temperature sampling and rounds mode in the port against the JAX
package, on the CPU.

The sampler (``repro_torch.serve.sampling``) re-creates the ``jax.random``
draws the reference engine makes: keys, bits and uniforms must equal
JAX's exactly, in f32 and bf16.  The gumbel noise goes through two
logarithms, which the two libraries round independently (each within an
ulp of the true value): it is held within 4 eps absolute, or 4 eps
relative above 1.  Categorical tokens must be equal.

The engine at temperature 0.8 (reduced qwen2.5-3b in f32, params bridged
from the JAX tree) must give the JAX engine's tokens, continuous and
rounds; inside the port, serve equals per-request ``generate(rids=...)``,
does not depend on the admission policy or the slot count, rounds equals
continuous and paged equals contiguous.  Rounds mode under greedy
decoding must give JAX's tokens under every policy, and its refill stats
equal JAX's under the deterministic ``static`` policy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.schedulers import available_schedulers
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig, SpecConfig
from repro_torch.serve import sampling

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

POLICIES = list(available_schedulers())
MAX_LEN = 48
TEMP = 0.8
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
STREAMS = [(0, 0, 0), (1, 3, 7), (12345, 99, 1000), (2 ** 31 - 1, 5, 2),
           (-1, 2 ** 20, 31)]


def _jax_key(seed, rid, step):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 rid), step)


def _key(seed, rid, step):
    return sampling.fold_in(sampling.fold_in(sampling.prng_key(seed), rid),
                            step)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("seed,rid,step", STREAMS)
def test_keys_equal_jax(seed, rid, step):
    want = np.asarray(jax.random.key_data(_jax_key(seed, rid, step)))
    got = _key(seed, rid, step)
    assert [int(w) for w in want] == [int(g) for g in got]


@pytest.mark.parametrize("width,dtype", [(32, jnp.uint32), (16, jnp.uint16),
                                         (8, jnp.uint8)])
@pytest.mark.parametrize("seed,rid,step", STREAMS)
def test_bits_equal_jax(seed, rid, step, width, dtype):
    want = np.asarray(jax.random.bits(_jax_key(seed, rid, step), (3000,),
                                      dtype)).astype(np.int64)
    got = sampling.random_bits(_key(seed, rid, step), width, (3000,))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("seed,rid,step", STREAMS)
def test_uniforms_equal_jax(seed, rid, step, jdt, tdt):
    """On [0, 1) and on [tiny, 1), the range the gumbel draws from; a
    2-D shape counts its elements in row-major order, as JAX does."""
    jk, tk = _jax_key(seed, rid, step), _key(seed, rid, step)
    for lo in (0.0, float(jnp.finfo(jdt).tiny)):
        want = jax.random.uniform(jk, (40, 100), jdt, minval=lo, maxval=1.0)
        got = sampling.uniform(tk, (40, 100), tdt, minval=lo)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("seed,rid,step", STREAMS)
def test_gumbels_within_4_eps_of_jax(seed, rid, step, jdt, tdt):
    """-log(-log(u)) from the same uniforms, within 4 eps absolute plus 4
    eps relative.  Two ulp cannot hold: XLA's and torch's log may differ
    by an ulp at each of the two logs, and the outer log turns the inner
    one's relative error into an absolute error of g, so near g = 0 (u
    near 1/e) the difference is some eps however small g is."""
    want = _f32(jax.random.gumbel(_jax_key(seed, rid, step), (5000,), jdt))
    got = sampling.gumbel(_key(seed, rid, step), (5000,), tdt)
    assert got.dtype == tdt
    eps = float(jnp.finfo(jdt).eps)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=4 * eps,
                               atol=4 * eps)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_categorical_tokens_equal_jax(seed, jdt, tdt):
    """The engine's batched draw: row b of [B, V] logits with its own
    (rid, step) stream, at temperature 0.8, against the JAX engine's
    vmapped ``categorical``."""
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(64, 256)).astype(np.float32)
    rids = rng.randint(0, 1000, 64)
    steps = rng.randint(0, 100, 64)

    def one(row, rid, step):
        return jax.random.categorical(_jax_key(seed, rid, step), row / TEMP)

    want = np.asarray(jax.jit(jax.vmap(one))(
        jnp.asarray(logits, jdt), jnp.asarray(rids), jnp.asarray(steps)))
    got = sampling.sample(torch.from_numpy(logits).to(tdt), seed, rids,
                          steps, TEMP)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_refuses_what_it_cannot_draw():
    key = sampling.prng_key(0)
    with pytest.raises(ValueError, match="8, 16 or 32"):
        sampling.random_bits(key, 64, (4,))
    with pytest.raises(ValueError, match="uniform draws"):
        sampling.uniform(key, (4,), torch.float64)


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_config("qwen2.5-3b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("qwen2.5-3b").reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).astype(np.int32)
            for n in [8, 8, 5, 8, 5, 11, 3]]


def _serve(tm, tp, prompts, n_new, *, seed=3, **kw):
    eng = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, **kw))
    return eng.serve(prompts, n_new, seed=seed), eng


@pytest.mark.parametrize("mode", ["continuous", "rounds"])
def test_temperature_serve_equals_jax(models, prompts, mode):
    jm, jp, tm, tp = models
    want = JaxEngine(jm, jp, JaxServeConfig(
        max_len=MAX_LEN, slots=2, temperature=TEMP, mode=mode)).serve(
            prompts, 6, seed=3)
    got, eng = _serve(tm, tp, prompts, 6, slots=2, temperature=TEMP,
                      mode=mode)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert eng.last_report.mode == mode


def test_temperature_serve_equals_per_request_generate(models, prompts):
    _, _, tm, tp = models
    got, eng = _serve(tm, tp, prompts, 6, slots=2, temperature=TEMP,
                      refill_schedule="faa")
    for rid, (p, out) in enumerate(zip(prompts, got)):
        solo = eng.generate({"tokens": p[None, :]}, 6, seed=3, rids=[rid])
        np.testing.assert_array_equal(solo[0], out)
    # the streams are the seed's: another seed draws other tokens
    other, _ = _serve(tm, tp, prompts, 6, seed=4, slots=2,
                      temperature=TEMP)
    assert any((a != b).any() for a, b in zip(got, other))


def test_temperature_serve_invariant_to_policy_slots_mode_and_cache(
        models, prompts):
    """Every admission order (each policy, 1 to 4 slots), the rounds
    barrier and the paged cache give the same sampled tokens."""
    _, _, tm, tp = models
    want, _ = _serve(tm, tp, prompts, 5, slots=2, temperature=TEMP)
    runs = [dict(slots=2, refill_schedule=p) for p in POLICIES]
    runs += [dict(slots=s) for s in (1, 3, 4)]
    runs += [dict(slots=3, mode="rounds"),
             dict(slots=2, cache="paged", page_size=8)]
    for kw in runs:
        got, _ = _serve(tm, tp, prompts, 5, temperature=TEMP, **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w, err_msg=str(kw))


@pytest.mark.parametrize("policy", POLICIES)
def test_rounds_greedy_equals_jax_under_every_policy(models, prompts, policy):
    jm, jp, tm, tp = models
    jeng = JaxEngine(jm, jp, JaxServeConfig(
        max_len=MAX_LEN, slots=2, mode="rounds", refill_schedule=policy))
    want = jeng.serve(prompts, 4)
    got, eng = _serve(tm, tp, prompts, 4, slots=2, mode="rounds",
                      refill_schedule=policy)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    rep, jrep = eng.last_report, jeng.last_report
    assert (rep.mode, rep.schedule, rep.total_ticks, rep.total_tokens) == (
        jrep.mode, jrep.schedule, jrep.total_ticks, jrep.total_tokens)
    assert len(eng.refill_stats) == len(jeng.refill_stats) == 4
    for st, jst in zip(eng.refill_stats, jeng.refill_stats):
        assert (st.schedule, st.n, st.n_threads) == (jst.schedule, jst.n,
                                                     jst.n_threads)
        assert int(st.items_per_thread.sum()) == st.n
        if policy == "static":     # no claim depends on thread timing
            for f in dataclasses.fields(jst):
                np.testing.assert_array_equal(
                    np.asarray(getattr(st, f.name)),
                    np.asarray(getattr(jst, f.name)), err_msg=f.name)


def test_rounds_greedy_equals_continuous_with_eos_and_budgets(models,
                                                              prompts):
    """Per-request budgets and an eos the model emits: the rounds barrier
    gives the continuous engine's tokens and counts the same emitted
    tokens."""
    _, _, tm, tp = models
    probe, _ = _serve(tm, tp, prompts[:1], 4, slots=1)
    eos = int(probe[0][1])
    from repro_torch.serve import Request
    reqs = [Request(prompt=p, max_new_tokens=3 if i % 2 else None)
            for i, p in enumerate(prompts)]
    want, ceng = _serve(tm, tp, reqs, 4, slots=3, eos_id=eos)
    got, reng = _serve(tm, tp, reqs, 4, slots=3, eos_id=eos, mode="rounds")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert reng.last_report.total_tokens == ceng.last_report.total_tokens


def test_modes_refuse_what_the_reference_refuses(models, prompts):
    """The reference's ValueErrors, at serve(): speculation at temperature
    > 0 or in rounds mode, a paged cache in rounds mode, an unknown
    mode."""
    _, _, tm, tp = models
    spec = SpecConfig(draft=tm, draft_params=tp, k=2)
    cases = [(dict(spec=spec, temperature=0.5), "greedy-only"),
             (dict(spec=spec, mode="rounds"), "continuous"),
             (dict(cache="paged", mode="rounds"), "continuous"),
             (dict(mode="bogus"), "unknown serve mode")]
    for kw, match in cases:
        eng = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, **kw))
        with pytest.raises(ValueError, match=match):
            eng.serve(prompts, 2)
