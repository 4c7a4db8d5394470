"""Microbenchmark: where does the GTMG V-cycle / pressure solve spend time?

This breaks gtmg_apply into its components (trace matvec, block-Jacobi
smoother, restrict/prolong transfers, FFT coarse solve) and times one full
preconditioned pressure-GMRES iteration body (scan-chained timing).  Not
part of the test suite.

Usage: PROF_NX=512 python tools/microbench_gtmg.py
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

from incompressibleeulerhdg.mesh.generators import unit_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.linalg import gtmg as G
from incompressibleeulerhdg.linalg.condense import trace_matvec
from incompressibleeulerhdg.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332,
)

def sync(out):
    """Wait for every array of ``out`` to be computed."""
    return jax.block_until_ready(out)


def timeit_scan(name, apply_fn, x0, n=30, reps=3, nbytes=None):
    @jax.jit
    def chained(x):
        def body(c, _):
            y = apply_fn(c)
            return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-30), None

        out, _ = lax.scan(body, x, None, length=n)
        return out

    out = chained(x0)
    sync(out)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = chained(x0)
        sync(out)
        best = min(best, (time.perf_counter() - t0))
    ms = best / n * 1e3
    bw = f"  ({nbytes / best * n / 1e9:6.0f} GB/s eff)" if nbytes else ""
    print(f"{name:>44s} : {ms:9.3f} ms/app{bw}")
    return ms


def main():
    nx = int(os.environ.get("PROF_NX", 512))
    degree = int(os.environ.get("PROF_DEGREE", 2))
    disc = HDGDiscretisation(unit_square_mesh(nx), degree, dtype=jnp.float32)
    geom = disc.geom
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, 1.0 / nx)
    cs = stepper._cs
    pc = stepper._gtmg
    nt, nf, nc = cs.nt, geom.n_facets, geom.n_cells
    nv = pc.n_vertices
    print(f"nx={nx} k={degree} nt={nt} nf={nf} nc={nc} nv={nv} "
          f"coarse={pc.coarse_kind} cheb_fine={pc.cheb_fine}")
    f4 = 4

    rng = np.random.default_rng(3)
    lam = jnp.asarray(rng.standard_normal((nt, nf)), jnp.float32)
    lam_flat = lam.ravel()
    rc = jnp.asarray(rng.standard_normal(nv), jnp.float32)

    b_S = (3 * nt) ** 2 * nc * f4  # cs.S table
    b_lam = nt * nf * f4
    b_Sd = nt * nt * nf * f4

    # full V-cycle (the preconditioner application inside the trace GMRES)
    timeit_scan(
        "gtmg_apply (full V-cycle)",
        lambda v: G.gtmg_apply(geom, cs, pc, v),
        lam_flat,
        nbytes=4 * b_S + 4 * b_Sd + 12 * b_lam + 4 * nv * f4,
    )

    # components
    timeit_scan(
        "  trace_matvec (A)",
        lambda v: trace_matvec(geom, cs, v),
        lam,
        nbytes=b_S + 3 * b_lam,
    )
    timeit_scan(
        "  block-Jacobi Dinv",
        lambda v: jnp.einsum("ijf,jf->if", cs.Sdiag_inv, v),
        lam,
        nbytes=b_Sd + 2 * b_lam,
    )
    timeit_scan(
        "  chebyshev(fine) pre-smooth",
        lambda v: G._chebyshev(
            lambda w: pc.sign * trace_matvec(geom, cs, w),
            lambda w: pc.sign * jnp.einsum("ijf,jf->if", cs.Sdiag_inv, w),
            v, pc.cheb_fine, pc.lmax_fine,
        ),
        lam,
        nbytes=b_S + 2 * b_Sd + 4 * b_lam,
    )
    timeit_scan(
        "  restrict (trace -> P1)",
        lambda v: v * 0.0 + jnp.sum(G.restrict(pc, v)),
        lam,
        nbytes=b_lam + nv * f4,
    )
    timeit_scan(
        "  coarse FFT solve",
        lambda v: G._coarse_solve(pc, v),
        rc,
        nbytes=2 * nv * f4,
    )
    timeit_scan(
        "  prolong (P1 -> trace)",
        lambda v: v * 0.0 + jnp.sum(G.prolong(pc, v)),
        rc,
        nbytes=b_lam + nv * f4,
    )

    # one full preconditioned GMRES iteration body: V-cycle + trace matvec
    def it_body(v):
        z = G.gtmg_apply(geom, cs, pc, v)
        return trace_matvec(geom, cs, z.reshape(nt, nf)).ravel()

    timeit_scan(
        "V-cycle + trace matvec (one GMRES iter)",
        it_body,
        lam_flat,
        nbytes=5 * b_S + 4 * b_Sd + 15 * b_lam,
    )


if __name__ == "__main__":
    main()
