"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite forces ``JAX_PLATFORMS=cpu`` with 8 virtual host devices before jax
initializes a backend, so multi-device sharding paths are exercised without
hardware. Tests marked ``gpu`` need the card: the ``gpu_device`` fixture skips
them here. On a GPU machine ``python -m pytest -m gpu tests/`` keeps JAX's
default (GPU) platform and runs them.
"""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    # Runs before any test module touches a jax backend. Only a run that
    # selects exactly the gpu marker keeps the default platform.
    if config.getoption("markexpr", "") == "gpu":
        jax.config.update("jax_enable_x64", True)
    else:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    from tci_tpu.utils.compile_cache import setup_compile_cache

    # Most of the suite's wall time is XLA:CPU compiles of the device-tier
    # programs; the persistent cache keys by HLO hash, so code changes
    # invalidate exactly the programs they alter.
    setup_compile_cache(".jax_cache_tests")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default platform is {dev.platform}")
    return dev


_MODULES_SINCE_CLEAR = [0]


@pytest.fixture(autouse=True, scope="module")
def _jax_cache_reset_between_modules():
    """Free compiler state periodically at module boundaries.

    A full-suite run accumulates hundreds of compiled XLA:CPU programs in
    one process; past a threshold the CPU backend's compiler has been
    observed to segfault while compiling yet another program (reproducible
    only in long runs — every module passes in isolation; ~24 modules of
    accumulation crashed). Clearing jax's caches every third module bounds
    the accumulation far below that threshold while limiting the recompile
    overhead for shared kernels."""
    yield
    _MODULES_SINCE_CLEAR[0] += 1
    if _MODULES_SINCE_CLEAR[0] >= 3:
        _MODULES_SINCE_CLEAR[0] = 0
        jax.clear_caches()
