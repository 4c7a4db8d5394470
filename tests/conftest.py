"""Test configuration: CPU backend, 8 virtual devices, float64.

Multi-device sharding tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``), the standard JAX analogue of
multi-device testing without the devices (SURVEY.md section 4).  Tests that
need a real GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture,
which skips them on the CPU; ``python chip_smoke.py`` runs what they cover
on the card, and ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``
runs the tests themselves there.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.3")

import jax
import pytest

from incompressibleeulerhdg.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return gpus[0]
