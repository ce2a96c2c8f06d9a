import os

import jax

# Smoke tests and kernels run on the default single CPU device.  The
# 512-device override lives ONLY in launch/dryrun.py (see the assignment).
jax.config.update("jax_enable_x64", False)

# Hermetic tuning: a calibration persisted by an earlier benchmark/launch
# run must not leak into test expectations — tests that exercise the
# calibrator build their own TuningContext explicitly.
os.environ.setdefault("REPRO_CALIBRATION", "off")

# Same hermeticity for the kernel tuning db: a results/tuning_db.json
# written by a previous `repro.launch.tune` run must not change which
# block sizes the kernel ops resolve — tests that exercise the measured
# search opt in with their own REPRO_TUNING / REPRO_TUNING_DB (see
# tests/test_autotune_search.py).
os.environ.setdefault("REPRO_TUNING", "off")

# Hypothesis profiles: CI runs derandomized (fixed seed — a red build must
# be reproducible, not a lottery) with no deadline (shared runners stall
# arbitrarily; a deadline flake teaches nothing).  Local runs keep fresh
# examples but also drop the deadline, since the property sweeps spawn real
# thread pools.  Select explicitly with HYPOTHESIS_PROFILE=ci|dev.
try:
    from hypothesis import HealthCheck, settings
except ImportError:
    pass
else:
    settings.register_profile(
        "ci",
        derandomize=True,
        deadline=None,
        max_examples=30,
        print_blob=True,
        suppress_health_check=[HealthCheck.too_slow],
    )
    settings.register_profile("dev", deadline=None)
    settings.load_profile(
        os.environ.get("HYPOTHESIS_PROFILE",
                       "ci" if os.environ.get("CI") else "dev"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
