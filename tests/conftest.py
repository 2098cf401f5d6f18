"""Test configuration: the CPU backend with 8 virtual devices.

Tests run on the CPU so they are hermetic and can emulate an 8-device mesh
(SURVEY.md §4); the platform is pinned through the config API before any
backend is initialized.  Tests marked ``gpu`` need the card: they take the
``gpu`` fixture, which skips them here.  chip_smoke.py runs them on the
GPU inside its own process with ``PPOC_TEST_PLATFORM=gpu``, where the
platform is left as that process found it.
"""
import os
import sys

import jax  # noqa: E402

if os.environ.get("PPOC_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided when the test runs,
    never at import: every xdist worker must collect the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs the gpu-marked tests "
                    "on the card")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_state():
    """Clear jit/compilation caches between test MODULES.

    The full suite compiles thousands of distinct executables in one
    process; past ~400 tests the accumulated XLA:CPU backend state
    segfaults inside backend_compile (observed deterministically at the
    same test in clean runs with 120 GB free, while every half-suite
    subset passes).  Bounding the live-executable set per module keeps the
    process inside the backend's tested envelope; within a module, shared
    compiles still amortize.
    """
    yield
    jax.clear_caches()
