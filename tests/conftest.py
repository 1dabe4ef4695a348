"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated without a cluster via
``--xla_force_host_platform_device_count`` — the standard JAX trick.

``RPF_TEST_ON_CHIP=1`` leaves JAX on its default platform (the GPU) so
the tests marked ``chip`` run on the card:

    RPF_TEST_ON_CHIP=1 python -m pytest tests/ -m chip

Whether a card or an 8-device mesh is present is decided in the
fixtures below, per test — never while a module is imported or in a
collection hook, so every pytest-xdist worker collects the same tests.
"""

import os
import sys

import pytest

_ON_CHIP = os.environ.get("RPF_TEST_ON_CHIP") == "1"

if not _ON_CHIP:
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    # Keep the suite hermetic: no persistent compile cache from the
    # entry points' configure_compile_cache(), here or in the CLI
    # subprocesses the tests start.
    os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402

if not _ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Tests that need the 8-device mesh (substrings of their node ids).
_MESH8 = ("test_sharding", "test_bigfft", "shard_transform", "multistream")


@pytest.fixture(autouse=True)
def _device_requirements(request):
    """Skip a ``chip`` test unless JAX runs on a GPU, and a mesh test
    unless 8 devices are visible."""
    if request.node.get_closest_marker("chip") is not None:
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU (JAX runs on {dev.platform}; "
                        "set RPF_TEST_ON_CHIP=1 on the card)")
    nodeid = request.node.nodeid.lower()
    if any(k in nodeid for k in _MESH8) and len(jax.devices()) < 8:
        pytest.skip("needs an 8-device mesh (CPU harness)")
