"""Test configuration: run JAX on a virtual 8-device CPU mesh.

This is the standard JAX trick for testing shard_map/collective code without
several real devices; the Pallas kernels run in the interpreter there.
What needs the GPU (compiled Triton kernels at real widths) is run by
``python chip_smoke.py`` on the card; tests marked ``gpu`` skip here.

The platform is also pinned through jax.config, in case jax was imported
before this file set JAX_PLATFORMS.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU; decided when the test runs, never at
    import or collection, so every worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py on the"
                    " card)")
