"""Test harness config.

Runs the suite on the CPU backend with 8 fake XLA devices, set BEFORE jax
is imported anywhere, so the multi-device data-parallel and row-band
paths (BASELINE.json:11) are testable on one host (SURVEY.md §4.4).
`JAX_PLATFORMS` is only defaulted here: the suite is written for the CPU
backend, and chip_smoke.py is what drives the accelerator.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# entry points called in-process (cli.main) point the persistent compile
# cache at the checkout; the suite compiles for the CPU backend only and
# keeps nothing between runs
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-horizon tests (run by default; deselect "
        "with -m 'not slow')")


# --- XLA:CPU compiler-state hygiene -----------------------------------
# A single pytest process accumulating ~200 XLA:CPU compiles segfaults
# deterministically inside backend_compile (reproduced at
# test_models.py::test_ukf_matches_ekf_on_constant_flow, test #206 — the
# test itself is healthy and passes alone; the crash moves with the
# cumulative compile count, not the test). Dropping every live executable
# periodically keeps the in-process compiler state below the trigger.
# Cost: the session fixtures' callables recompile after each flush
# (~tens of seconds over the whole suite) — cheap next to a dead run.
_TESTS_PER_CACHE_FLUSH = 64
_test_count = {"n": 0}


@pytest.fixture(autouse=True)
def _xla_cpu_compile_hygiene():
    yield
    _test_count["n"] += 1
    if _test_count["n"] % _TESTS_PER_CACHE_FLUSH == 0:
        jax.clear_caches()


@pytest.fixture(scope="session")
def blob_clip():
    """Seeded 128x128 moving-blob clip + truth (config-1 style)."""
    from kalman_hydra_tpu.io.synthetic import moving_blob_clip
    frames, truth = moving_blob_clip(
        num_frames=8, height=128, width=128, num_points=8, seed=0)
    return frames, truth


@pytest.fixture(scope="session")
def trans_pair():
    """Frame pair with constant analytic flow."""
    from kalman_hydra_tpu.io.synthetic import translating_pair
    return translating_pair(height=128, width=128, shift=(3.0, -2.0), seed=0)


@pytest.fixture()
def rng():
    # function-scoped: every test gets a fresh, identical stream (a shared
    # session generator makes results depend on test execution order)
    return np.random.default_rng(1234)
