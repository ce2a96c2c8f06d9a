"""The port's cost-model training half and host calibrator against the JAX
package (``repro.core.cost_model``, ``repro.core.runtime``), on the CPU.

The same numpy inputs go through both packages.  Tolerances:

* the random inits (JAX's threefry draws through ``prng.normal``, whose
  erfinv differs from XLA's by at most an ulp or two): relative 1e-6;
  ``prng.split`` bit for bit;
* ``loss_fn`` and its gradients against ``jax.value_and_grad``: relative
  1e-5 (summation order);
* ``_train`` step by step over 100 steps, 1 and 16 restarts, from JAX's
  inits: the loss curve and the parameters within relative 1e-4.  Only
  short horizons: the rational form is chaotic near its poles, and a
  relative 1e-7 difference in an init grows to 0.5 % of a restart's loss
  by step 1000 in JAX alone;
* a whole fit (``train_cost_model``): the final loss within relative
  1e-3, ``predict`` on every row within relative 1e-2, ``suggest_block``
  within 1.  Never the raw parameters or the winning restart: the
  numerator and denominator of the rational form can scale together;
* ``lstsq_init``, ``generate_points`` and every field of a calibration but
  its parameters and fit loss: equal.

Persistence crosses packages both ways; ``REPRO_CALIBRATION`` selects the
file as in the reference; the reference's calibrator tests
(``tests/test_runtime.py``) are ported; the launchers run on the CPU.
"""

import dataclasses
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jax_autotune
from repro.core import cost_model as jcm
from repro.core import runtime as jrt
from repro.core.autotune_search import kernels as jax_kernels

from repro_torch.core import autotune
from repro_torch.core import cost_model as cm
from repro_torch.core import parallel_for as pf
from repro_torch.core import prng
from repro_torch.core import runtime as rt
from repro_torch.core.atomic_sim import UnitTask
from repro_torch.core.topology import AMD3970X, GOLD5225R, W3225R
from repro_torch.launch import calibrate as launch_calibrate
from repro_torch.launch import train as launch_train

# ``runtime.calibrate`` is the function that shadows each package's module
jcal = importlib.import_module("repro.core.runtime.calibrate")
cal = importlib.import_module("repro_torch.core.runtime.calibrate")

torch.set_num_threads(1)

TOPOLOGIES = (W3225R, GOLD5225R, AMD3970X)
# one fixed host: 8 cores, FAA 750 ns, contended FAA 840 ns, dispatch 580
HOST = dict(faa_ns=750.0, transfer_ns=840.0, dispatch_ns=580.0, cores=8,
            transfer_measured=True)
PAPER_X, PAPER_Y = cm.paper_normalized_features(cm.PAPER_INFERENCE_ROWS)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _row_features(row) -> cm.WorkloadFeatures:
    """The raw workload behind a normalized paper row (G, T, R, W, C)."""
    return cm.WorkloadFeatures(
        core_groups=int(row[0]) // 100, threads=int(row[1]),
        unit_read=2 ** int(row[2]), unit_write=2 ** int(row[3]),
        unit_comp=2 ** int(10 * row[4]))


def _platform_features(topo) -> cm.WorkloadFeatures:
    t = topo.total_cores
    task = UnitTask()
    return cm.WorkloadFeatures(
        core_groups=topo.groups_used(t), threads=t,
        unit_read=task.unit_read, unit_write=task.unit_write,
        unit_comp=task.unit_comp)


@pytest.fixture
def restore_tuning(monkeypatch):
    """Both packages' process contexts resolved afresh around the test,
    with no calibration file."""
    monkeypatch.setenv("REPRO_CALIBRATION", "off")
    rt.reset_tuning()
    jrt.reset_tuning()
    yield
    monkeypatch.setenv("REPRO_CALIBRATION", "off")
    rt.reset_tuning()
    jrt.reset_tuning()


# ------------------------------------------------------------ the draws

@pytest.mark.parametrize("seed", range(4))
def test_init_params_draws_equal_jax(seed):
    want1 = jcm.init_params(jax.random.PRNGKey(seed))
    got1 = cm.init_params(prng.prng_key(seed))
    keys = jax.random.split(jax.random.PRNGKey(seed), 16)
    want16 = jax.vmap(lambda k: jcm.init_params(k, 4))(keys)
    got16 = cm.init_params(prng.split(prng.prng_key(seed), 16), 4)
    for want, got in ((want1, got1), (want16, got16)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32
            assert tuple(got[k].shape) == np.shape(want[k])
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_prng_split_and_normal_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    k1, k2 = prng.split(prng.prng_key(seed), 9)
    want = np.asarray(jax.random.split(key, 9)).astype(np.int64)
    assert np.array_equal(np.stack([k1.numpy(), k2.numpy()], -1), want)
    # a batched key splits each of its keys, as under vmap
    b1, b2 = prng.split((k1, k2), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(
        jax.random.split(key, 9))).astype(np.int64)
    assert np.array_equal(np.stack([b1.numpy(), b2.numpy()], -1), want)
    for shape in ((1,), (4,), (3, 5), (2000,)):
        np.testing.assert_allclose(
            prng.normal(prng.prng_key(seed), shape).numpy(),
            np.asarray(jax.random.normal(key, shape)), rtol=1e-6, atol=0)


# ---------------------------------------------------- loss and training

@pytest.mark.parametrize("which", ["paper", "random"])
def test_loss_and_gradients_equal_jax(which):
    params = (jcm.PAPER_WEIGHTS if which == "paper"
              else jcm.init_params(jax.random.PRNGKey(5)))
    jloss, jgrads = jax.value_and_grad(jcm.loss_fn)(
        params, jnp.asarray(PAPER_X), jnp.asarray(PAPER_Y))
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in params.items()}
    loss = cm.loss_fn(leaves, torch.from_numpy(PAPER_X),
                      torch.from_numpy(PAPER_Y))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("restarts", [1, 16])
def test_train_equals_jax_over_100_steps(restarts):
    x, y = jnp.asarray(PAPER_X), jnp.asarray(PAPER_Y)
    if restarts == 1:
        inits = jcm.init_params(jax.random.PRNGKey(0))
        want_p, want_l = jcm._train(inits, x, y, 100, 0.01)
    else:
        keys = jax.random.split(jax.random.PRNGKey(0), restarts)
        inits = jax.vmap(lambda k: jcm.init_params(k, 4))(keys)
        want_p, want_l = jax.vmap(
            lambda p: jcm._train(p, x, y, 100, 0.01))(inits)
    got_p, got_l = cm._train({k: np.array(v) for k, v in inits.items()},
                             torch.from_numpy(PAPER_X),
                             torch.from_numpy(PAPER_Y), 100, 0.01)
    assert tuple(got_l.shape) == np.shape(want_l)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4)
    for k in want_p:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("rows", ["paper", "fast_points"])
def test_lstsq_init_bit_equal(rows):
    x, y = ((PAPER_X, PAPER_Y) if rows == "paper"
            else jcal.generate_points(fast=True)[:2])
    want, got = jcm.lstsq_init(x, y), cm.lstsq_init(x, y)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], np.asarray(want[k])), k


# (data, keyword arguments) of each whole fit, at the reference's defaults
# where the case names none
FITS = {
    "paper": ("paper", {}),
    "fast_points": ("fast_points", dict(steps=2500, restarts=4)),
    "lstsq": ("paper", dict(init="lstsq")),
    "single_init": ("paper", dict(init="single")),
}


@pytest.fixture(scope="module", params=sorted(FITS))
def fit(request):
    data, kw = FITS[request.param]
    x, y = ((PAPER_X, PAPER_Y) if data == "paper"
            else jcal.generate_points(fast=True)[:2])
    jparams, jlosses = jcm.train_cost_model(x, y, **kw)
    params, losses = cm.train_cost_model(x, y, device="cpu", **kw)
    steps = kw.get("steps", 30_000)
    return x, y, (jparams, np.asarray(jlosses)), (params, losses), steps


def test_fit_loss_equals_jax(fit):
    _, _, (_, jlosses), (params, losses), steps = fit
    assert isinstance(losses, np.ndarray) and losses.shape == (steps,)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in params.values())
    assert np.isfinite(losses[-1])
    assert _rel(losses[-1], jlosses[-1]) <= 1e-3


def test_fit_predictions_equal_jax(fit):
    x, _, (jparams, _), (params, _), _ = fit
    assert _rel(cm.predict(params, x), jcm.predict(jparams, x)) <= 1e-2
    for row in cm.PAPER_INFERENCE_ROWS:
        feats = _row_features(row)
        assert np.array_equal(feats.normalized(), row[:5])
        for n in (None, 512):
            got = cm.suggest_block_size(feats, n=n, params=params)
            want = jcm.suggest_block_size(feats, n=n, params=jparams)
            assert abs(got - want) <= 1, (row, n, got, want)


def test_fit_on_the_card_by_default_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.train_cost_model(PAPER_X, PAPER_Y, steps=2, restarts=2)


# -------------------------------------------------- points, calibration

@pytest.mark.parametrize("case", ["fast", "full", "host"])
def test_generate_points_equal_reference(case):
    if case == "host":
        host = cal.host_topology(cal.HostMeasurement(**HOST))
        jhost = jcal.host_topology(jcal.HostMeasurement(**HOST))
        assert dataclasses.asdict(host) == dataclasses.asdict(jhost)
        got = cal.generate_points(
            topologies=list(cal._PAPER_TOPOLOGIES) + [host])
        want = jcal.generate_points(
            topologies=list(jcal._PAPER_TOPOLOGIES) + [jhost])
    else:
        got = cal.generate_points(fast=case == "fast")
        want = jcal.generate_points(fast=case == "fast")
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.fixture(scope="module", params=["simulated", "measured"])
def calibrated(request):
    """(reference context, port context) of ``run_calibration`` at full
    size: simulate-only, and with the fixed host measurement."""
    if request.param == "simulated":
        return (jcal.run_calibration(simulate_only=True),
                cal.run_calibration(simulate_only=True, device="cpu"))
    return (jcal.run_calibration(measurement=jcal.HostMeasurement(**HOST)),
            cal.run_calibration(measurement=cal.HostMeasurement(**HOST),
                                device="cpu"))


def test_run_calibration_equals_reference(calibrated):
    jctx, ctx = calibrated
    want, got = jctx.as_json_dict(), ctx.as_json_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in ("params", "fit_loss"):
            assert got[k] == want[k], k
    assert _rel(ctx.fit_loss, jctx.fit_loss) <= 1e-3
    for topo in TOPOLOGIES:
        feats = _platform_features(topo)
        for n in (None, 512):
            assert abs(ctx.suggest_block(feats, n=n)
                       - jctx.suggest_block(feats, n=n)) <= 1, topo.name


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_calibration_file_loads_in_the_other_package(tmp_path, writer,
                                                     calibrated):
    jctx, ctx = calibrated
    path = tmp_path / "calibration.json"
    if writer == "reference":
        src, _ = jctx, jcal.save_calibration(jctx, path)
        loaded = cal.load_calibration(path)
    else:
        src, _ = ctx, cal.save_calibration(ctx, path)
        loaded = jcal.load_calibration(path)
    assert loaded is not None
    assert loaded.as_json_dict() == src.as_json_dict()
    for topo in TOPOLOGIES:
        for t in (2, 4, topo.total_cores):
            feats = cm.WorkloadFeatures(
                core_groups=topo.groups_used(t), threads=t, unit_read=1024,
                unit_write=1024, unit_comp=1024)
            for n in (None, 512, 4096):
                assert (loaded.suggest_block(feats, n=n)
                        == src.suggest_block(feats, n=n))


def test_bare_payload_loads_and_a_torn_file_falls_back(tmp_path,
                                                       monkeypatch,
                                                       calibrated,
                                                       restore_tuning):
    _, ctx = calibrated
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps(ctx.as_json_dict()))   # pre-envelope file
    assert cal.load_calibration(path).as_json_dict() == ctx.as_json_dict()
    torn = json.dumps({"kind": cal.CALIBRATION_KIND,
                       "version": cal.CALIBRATION_VERSION,
                       "payload": ctx.as_json_dict()})
    for text in (torn[:len(torn) // 2],
                 json.dumps({"kind": cal.CALIBRATION_KIND,
                             "version": cal.CALIBRATION_VERSION,
                             "payload": {"source": "measured"}})):
        path.write_text(text)
        assert cal.load_calibration(path) is None
        monkeypatch.setenv("REPRO_CALIBRATION", str(path))
        rt.reset_tuning()
        assert rt.tuning().source == "default"
    assert cal.load_calibration(tmp_path / "missing.json") is None


def test_calibration_path_follows_repro_calibration(tmp_path, monkeypatch):
    for off in ("off", "0", "none", "OFF"):
        monkeypatch.setenv("REPRO_CALIBRATION", off)
        assert rt.calibration_path() is None
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "c.json"))
    assert rt.calibration_path() == tmp_path / "c.json"
    monkeypatch.delenv("REPRO_CALIBRATION")
    path = rt.calibration_path()
    root = Path(rt.__file__).resolve().parents[4]
    assert path == root / "results" / "calibration_torch.json"
    # beside the port's tuning db, never the reference's calibration file
    assert path != jrt.calibration_path()


def test_reset_tuning_resolves_the_context_again(tmp_path, monkeypatch,
                                                 calibrated,
                                                 restore_tuning):
    _, ctx = calibrated
    path = tmp_path / "calibration_torch.json"
    monkeypatch.setenv("REPRO_CALIBRATION", str(path))
    rt.reset_tuning()
    assert rt.tuning().source == "default"              # no file yet
    cal.save_calibration(ctx, path)
    assert rt.tuning().source == "default"              # still cached
    rt.reset_tuning()
    assert rt.tuning().as_json_dict() == ctx.as_json_dict()
    monkeypatch.setenv("REPRO_CALIBRATION", "off")
    rt.reset_tuning()
    assert rt.tuning().source == "default"


# ------------------------------ the reference's calibrator tests, ported

@pytest.fixture(scope="module")
def sim_ctx():
    """Fast simulate-only calibration — the 1-core CI fallback path."""
    return rt.calibrate(simulate_only=True, fast=True, persist=False,
                        install=False, device="cpu")


def test_calibration_fits_from_points_not_published_weights(sim_ctx):
    assert sim_ctx.source == "simulated"
    assert sim_ctx.n_points >= 12
    assert np.isfinite(sim_ctx.fit_loss)
    for key in ("alpha", "beta", "delta0", "delta1"):
        assert not np.allclose(np.asarray(sim_ctx.params[key]),
                               np.asarray(cm.PAPER_WEIGHTS[key])), key


def test_calibrated_block_below_nt_on_all_topologies(sim_ctx):
    """The paper's empirical law, reproduced by the refit: B* < N/T on
    every simulated platform, at small and full thread counts."""
    n = 1024
    for topo in TOPOLOGIES:
        for t in (4, topo.total_cores):
            feats = cm.WorkloadFeatures(
                core_groups=topo.groups_used(t), threads=t,
                unit_read=1024, unit_write=1024, unit_comp=1024)
            b = sim_ctx.suggest_block(feats, n=n)
            assert 1 <= b < n / t, (topo.name, t, b)


def test_calibrated_ranking_consistent_with_sim(sim_ctx):
    """The fitted model and the event model agree on block-size ordering
    (rank correlation) and the fitted block lands near the simulated
    optimum on all three paper platforms; the rows are the reference's
    for the same context."""
    jctx = jcal.TuningContext.from_json_dict(sim_ctx.as_json_dict())
    jtopos = {t.name: t for t in jcal._PAPER_TOPOLOGIES}
    for topo in TOPOLOGIES:
        row = rt.ranking_consistency(sim_ctx, topo, topo.total_cores,
                                     UnitTask())
        assert row["spearman_sim_vs_analytic"] >= 0.3, row
        assert row["model_within_nt"], row
        assert (row["sim_at_model_block"]
                <= 3.0 * row["sim_at_best_block"]), row
        assert row == jrt.ranking_consistency(
            jctx, jtopos[topo.name], topo.total_cores,
            importlib.import_module("repro.core.atomic_sim").UnitTask())


def test_hierarchical_shared_faa_cut_at_calibrated_block(sim_ctx):
    """At the calibrated B, hierarchical claiming still cuts the shared
    counter traffic by the fanout factor — the cut survives recalibration
    because it is structural, not a weight artifact."""
    n, t, fanout = 2048, 8, 8
    feats = cm.WorkloadFeatures(core_groups=2, threads=t, unit_read=1024,
                                unit_write=1024, unit_comp=1024)
    b = sim_ctx.suggest_block(feats, n=n)
    flat = pf.parallel_for_stats(lambda i: None, n, n_threads=t,
                                 schedule="faa", block_size=b)
    hier = pf.parallel_for_stats(lambda i: None, n, n_threads=t,
                                 schedule="hierarchical", block_size=b)
    assert flat.faa_shared == -(-n // b) + t
    assert hier.faa_shared <= -(-n // (b * fanout)) + t
    assert hier.faa_shared < flat.faa_shared


def test_tuning_context_feeds_every_knob(sim_ctx):
    """The knobs all answer from one context; the microbatch count is the
    one not ported, and says so."""
    assert sim_ctx.admission_block(0, 4) == 1
    assert sim_ctx.admission_block(7, 2) <= 2      # small queue stays dynamic
    deep = sim_ctx.admission_block(4096, 8)
    assert 1 <= deep <= 4096 // (2 * 8)
    assert sim_ctx.data_grain(4096, host_threads=8) >= 1
    assert sim_ctx.choose_block(4096, 8) >= 1
    assert 0 <= sim_ctx.draft_span() <= 4
    with pytest.raises(NotImplementedError,
                       match=r"the measured autotuner's training half "
                             r"\(microbatch count\)"):
        sim_ctx.microbatches(256, grad_bytes=2 * 3e9, step_flops=1e18)


def test_host_measurement_falls_back_on_small_hosts(monkeypatch):
    """measure_host never fails: on a 1-core host the transfer ratio falls
    back to the reference platform and is flagged as such."""
    meas = rt.measure_host()
    assert meas.faa_ns > 0 and meas.dispatch_ns > 0
    assert meas.transfer_ns >= meas.faa_ns
    assert meas.cores >= 1
    assert np.isfinite(meas.transfer_clocks()) and meas.transfer_clocks() > 0
    monkeypatch.setattr(cal.os, "cpu_count", lambda: 1)
    one = rt.measure_host()
    assert one.cores == 1 and not one.transfer_measured
    ratio = ((W3225R.r_same_group + W3225R.e_faa + W3225R.o_misc)
             / cal._REF_LOCAL_CLOCKS)
    np.testing.assert_allclose(one.transfer_ns, one.faa_ns * ratio)


# ----------------------------------------- choose_block and the prior

def test_choose_block_equals_reference(calibrated, restore_tuning):
    jctx, ctx = calibrated
    grid = [(n, w) for n in (1, 7, 64, 512, 1000, 4096, 100_000)
            for w in (1, 2, 8, 32, 64)]
    for installed in (False, True):
        if installed:          # both packages under the calibrated context
            rt.set_tuning(ctx)
            jrt.set_tuning(jctx)
        for n, w in grid:
            assert autotune.choose_block(n, w) == \
                jax_autotune.choose_block(n, w)
            assert autotune.choose_block(n, w, 25e-6, 1e-7) == \
                jax_autotune.choose_block(n, w, 25e-6, 1e-7)
            assert autotune.choose_block(n, w, candidates=[3, 48, 200]) == \
                jax_autotune.choose_block(n, w, candidates=[3, 48, 200])
    for args in ((64, 4, 1e-5, None), (64, 4, None, 1e-7)):
        with pytest.raises(ValueError) as got:
            autotune.choose_block(*args)
        with pytest.raises(ValueError) as want:
            jax_autotune.choose_block(*args)
        assert str(got.value) == str(want.value)


def test_dispatch_overhead_prior_is_clamped_as_the_reference(
        restore_tuning):
    """A calibrated host measures a Python dispatch well under a launch:
    the kernel prior floors it at 1 us, as the reference does off the
    TPU; the default's 25 us passes unchanged."""
    assert autotune._overhead() == jax_kernels._overhead_s() == 25e-6
    ctx, jctx = cal.default_context(), jcal.default_context()
    ctx.dispatch_overhead_s = jctx.dispatch_overhead_s = 5e-8
    rt.set_tuning(ctx)
    jrt.set_tuning(jctx)
    assert autotune._overhead() == jax_kernels._overhead_s() == 1e-6


# ------------------------------------------------------- the launchers

@pytest.mark.parametrize("flags", [[], ["--simulate-only"]])
def test_calibrate_cli_runs_on_the_cpu(flags, capsys, restore_tuning):
    ctx = launch_calibrate.main(["--fast", "--no-persist", "--device",
                                 "cpu"] + flags)
    out = capsys.readouterr().out
    assert f"calibration [{ctx.source}]: {ctx.n_points} points" in out
    assert "persisted" not in out
    assert ("host:" in out) == (not flags)
    assert ctx.source in (("simulated",) if flags
                          else ("measured", "simulated"))
    assert np.isfinite(ctx.fit_loss) and ctx.n_points > 0
    assert rt.tuning() is ctx                        # installed


def test_train_cli_calibrates_persists_and_trains(tmp_path, monkeypatch,
                                                  capsys, restore_tuning):
    path = tmp_path / "calibration_torch.json"
    monkeypatch.setenv("REPRO_CALIBRATION", str(path))
    out = launch_train.main([
        "--arch", "qwen2.5-3b", "--reduced", "--device", "cpu", "--steps",
        "2", "--batch", "2", "--seq", "16", "--microbatches", "1",
        "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "1",
        "--calibrate"])
    assert out["final_step"] == 2 and len(out["history"]) == 2
    loaded = cal.load_calibration(path)
    assert loaded is not None and loaded.source in ("measured", "simulated")
    assert "[calibrate]" in capsys.readouterr().out
    rt.reset_tuning()
    assert rt.tuning().as_json_dict() == loaded.as_json_dict()
