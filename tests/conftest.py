"""Test configuration: run on CPU with 8 virtual devices and float64.

The 8-device CPU mesh is the stand-in backend for multi-device sharding
tests; x64 gives reference parity. The platform is forced through
jax.config before the first backend initialization, so the suite runs on
the CPU even on a machine with a GPU. Tests that need the card carry the
``gpu`` marker and the ``gpu_device`` fixture: they skip here and run
with ``python -m pytest -m gpu`` on the card (a run that selects only the
``gpu`` marker leaves the platform to JAX).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# no persistent XLA compile cache inside the suite: CLI paths enable it
# process-wide mid-run, and two full-suite runs segfaulted inside
# compile/cache paths late in the run (jax 0.9.0 CPU); standalone module
# runs without the cache have never crashed
os.environ["PHOSKINTIME_DISABLE_COMPILE_CACHE"] = "1"

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    if (config.option.markexpr or "").strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none (decided
    when the test runs, never at import or collection)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _bound_compiler_state():
    """Drop compiled executables between test modules.

    Hundreds of live jitted programs accumulate over the full suite; the
    two observed late-suite segfaults were inside XLA compile/cache
    paths, and bounding resident compiler state is the effective
    mitigation (standalone module runs never crash). Costs recompiles of
    the few cross-module shared programs."""
    yield
    jax.clear_caches()
