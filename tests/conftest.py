"""Test configuration: CPU with a virtual 8-device mesh and float64.

Must run before jax is imported anywhere (hence env vars at module import).
Multi-device sharding tests run against this virtual mesh (SURVEY §4: the
reference has no cluster tests at all — we add them on CPU). The platform
is the CPU unless JAX_PLATFORMS already names one: the ``gpu``-marked tests
run on the card with ``JAX_PLATFORMS=cuda,cpu pytest -m gpu -p no:xdist``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# NOTE: do NOT enable the persistent XLA:CPU compilation cache here — cached
# executables reload with mismatched machine-feature flags on this host
# (cpu_aot_loader "+prefer-no-scatter … could lead to SIGILL" warnings) and
# the suite segfaults when they execute.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """``gpu``-marked tests need a GPU; decided here, never at import."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu "
                    "pytest -m gpu -p no:xdist)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """The XLA:CPU compiler has segfaulted (exit 139, faulthandler stack in
    backend_compile_and_load) late in long single-process runs after hundreds
    of accumulated compilations; dropping the executable caches between test
    modules avoids the pathological state."""
    yield
    jax.clear_caches()
