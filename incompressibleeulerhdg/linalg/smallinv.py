"""Batched inverse of small batch-last matrices (n, n, m).

The blocks inverted here are the tentative preconditioner's own-cell and
patch Schur blocks (n = 2 d1 = 12-30).  They go to the GPU's batched LU
(``jnp.linalg.inv`` on batch-first blocks, partial pivoting).  It beat the
elementwise Gauss-Jordan sweep over the batch-last array that it replaced
on an H100 80GB HBM3 (400 W limit, f32): 15.9 vs 31.7 ms at (20, 20,
524288), 8.8 vs 26.0 ms at (30, 30, 131072) (``chip_smoke.py`` phase 1).
"""

import jax.numpy as jnp

__all__ = ["inv_bl"]


def inv_bl(A):
    """Inverse of batch-LAST matrices: (n, n, m) -> (n, n, m)."""
    return jnp.linalg.inv(A.transpose(2, 0, 1)).transpose(1, 2, 0)
