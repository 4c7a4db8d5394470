"""The chip smoke test's device gate and the tests that need a GPU.

``chip_smoke.py`` is the proof that the solver runs on the card; here only
its refusal to run anywhere else is checked.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_device_gate_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices("cpu"))
    assert exc.value.code not in (0, None)


@pytest.mark.gpu
def test_block_inverse_on_gpu(gpu_device):
    """The batch-last block inverse on the card agrees with numpy in f32."""
    from incompressibleeulerhdg.linalg.smallinv import gauss_jordan_inv_bl

    rng = np.random.default_rng(3)
    n, m = 20, 4096
    A = rng.standard_normal((m, n, n)) * 0.3 + 2.0 * n ** 0.5 * np.eye(n)
    with jax.default_device(gpu_device):
        X = gauss_jordan_inv_bl(jnp.asarray(A.transpose(1, 2, 0), jnp.float32))
    ref = np.linalg.inv(A).transpose(1, 2, 0)
    assert np.abs(np.asarray(X) - ref).max() < 1e-4 * np.abs(ref).max()
