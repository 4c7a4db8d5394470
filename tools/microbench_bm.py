"""Microbenchmark: batch-last block matvec formulations.

Compares, per block size (the (3, 3, nf) block-Jacobi, the (9, 9, nc) trace
matvec and the (20, 20, .) tentative tables):

- jnp.einsum("ijn,jn->in", A, x)          (the current _bm form)
- unrolled over j: sum_j A[:, j, :] * x[j]  (elementwise FMAs)
- broadcast-multiply + sum over axis 1

Usage: PROF_NX=512 python tools/microbench_bm.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

jax.config.update("jax_default_matmul_precision", "highest")
from incompressibleeulerhdg.utils.compile_cache import enable_compile_cache

enable_compile_cache()

def sync(out):
    """Wait for every array of ``out`` to be computed."""
    return jax.block_until_ready(out)


def timeit_scan(name, apply_fn, x0, args, n=50, reps=3, nbytes=None):
    @jax.jit
    def chained(x, a):
        def body(c, _):
            y = apply_fn(c, a)
            return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-30), None

        out, _ = lax.scan(body, x, None, length=n)
        return out

    out = chained(x0, args)
    sync(out)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = chained(x0, args)
        sync(out)
        best = min(best, (time.perf_counter() - t0))
    ms = best / n * 1e3
    bw = f"  ({nbytes / best * n / 1e9:6.0f} GB/s eff)" if nbytes else ""
    print(f"{name:>40s} : {ms:9.3f} ms/app{bw}")
    return ms


def einsum_bm(x, A):
    return jnp.einsum("ijn,jn->in", A, x)


def unrolled_bm(x, A):
    out = 0.0
    for j in range(A.shape[1]):
        out = out + A[:, j, :] * x[None, j, :]
    return out


def bcast_bm(x, A):
    return jnp.sum(A * x[None, :, :], axis=1)


def main():
    nx = int(os.environ.get("PROF_NX", 512))
    nf = 3 * nx * nx + 2 * nx
    nc = 2 * nx * nx
    rng = np.random.default_rng(5)
    for (n, m, label) in ((3, nf, "Sdiag_inv (3,3,nf)"),
                          (9, nc, "trace S (9,9,nc)"),
                          (20, nf, "tentative (20,20,nf)")):
        A = jnp.asarray(rng.standard_normal((n, n, m)), jnp.float32)
        x = jnp.asarray(rng.standard_normal((n, m)), jnp.float32)
        nb = (n * n * m + 2 * n * m) * 4
        print(f"-- {label}: table {n*n*m*4/1e6:.0f} MB")
        timeit_scan("einsum ijn,jn->in", einsum_bm, x, A, nbytes=nb)
        timeit_scan("unrolled FMA over j", unrolled_bm, x, A, nbytes=nb)
        timeit_scan("broadcast-mul + sum", bcast_bm, x, A, nbytes=nb)


if __name__ == "__main__":
    main()
