"""Test harness: run everything on CPU with an 8-device virtual mesh so
multi-device sharding paths are exercised without an accelerator
(SURVEY.md §4). Must set the env before jax initializes.

Tests marked `gpu` need a card. They skip on the CPU and run on a machine
with one GPU as

    MCS_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
"""

import os

if os.environ.get("MCS_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

# Persistent XLA compilation cache: warm re-runs compile far less, and
# fewer in-process compiles also lowers the exposure to a rare XLA-CPU
# compiler segfault observed once ~75% into a monolithic cold suite run
# (round 5; every chunk passed on re-run).
from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """Reset jax's in-process executable caches between test modules.

    A monolithic suite run accumulates ~500 compiled executables in one
    process and twice segfaulted inside an XLA-CPU compile at the same
    ~75% point (rc=139, backend_compile_and_load; the same module passes
    standalone and in chunked runs). Clearing per module bounds the
    in-process state, and with the persistent disk cache above the
    re-loads cost ~0.2 s instead of recompiles."""
    jax.clear_caches()
    yield


@pytest.fixture
def gpu():
    """The GPU a `gpu`-marked test runs on; skips when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX found {dev.platform!r}); run with "
                    "MCS_TESTS_ON_GPU=1 python -m pytest -m gpu tests/")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)
