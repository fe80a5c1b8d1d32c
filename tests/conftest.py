"""Test configuration: run everything on a virtual 8-device CPU mesh so the
multi-device sharded paths can be exercised without a GPU.  Must set the
environment before the first jax import.

With SPASM_TPU_DEVICE_TESTS=1 the CPU pin is left off, so the tests marked
``chip`` run on the accelerator JAX finds (``python -m pytest -m chip``
with that variable set, on a machine with a GPU)."""

import os

ON_DEVICE = bool(os.environ.get("SPASM_TPU_DEVICE_TESTS"))

if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# importing the package sets the persistent compilation cache (the
# checkout's .jax_cache/ unless JAX_COMPILATION_CACHE_DIR says otherwise)
from spasm_tpu.utils.hostmem import tune_host_malloc

# first-touch page faults can be far slower than warm pages; keep large
# temporaries heap-resident (utils/hostmem.py)
tune_host_malloc()

import numpy as np
import pytest

# dense-kernel compiles dominate test time: cache the shorter ones too
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); run "
                    "with SPASM_TPU_DEVICE_TESTS=1 -m chip on a GPU host")
    return dev
