"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding correctness (1 device vs N devices bit-identical) is validated
here without a GPU.  Tests marked `gpu` need an NVIDIA card and skip
elsewhere; `python chip_smoke.py` runs the same checks at full size on
the card.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` skip unless JAX's default backend is a GPU (decided
    here, at run time, so every worker collects the same tests)."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` there")
