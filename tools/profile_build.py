"""Break the per-stage tentative operator build into timed pieces.

Isolates which stage of the build (own-cell D assembly, D inverse, cross
blocks Bx/Cx, per-color Schur factorisation) owns its time.

Usage: PROF_NX=512 python tools/profile_build.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_default_matmul_precision", "highest")
from incompressibleeulerhdg.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from incompressibleeulerhdg.mesh.generators import unit_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.models.problems import TaylorGreen
from incompressibleeulerhdg.ops.forms import star_fields
from incompressibleeulerhdg.ops.projection import project_bdm
from incompressibleeulerhdg.linalg import preconditioners as P
from incompressibleeulerhdg.linalg.smallinv import inv_bl
from incompressibleeulerhdg.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332,
)

def sync(out):
    """Wait for every array of ``out`` to be computed."""
    return jax.block_until_ready(out)


def timeit(label, fn, *args, n=3):
    out = fn(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    sync(out)
    dt_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"{label:>38s} : {dt_ms:9.2f} ms")
    return out


nx = int(os.environ.get("PROF_NX", "512"))
dtype = jnp.float32
disc = HDGDiscretisation(unit_square_mesh(nx), 2, dtype=dtype)
geom = disc.geom
dt = 1.0 / nx
c = 0.5 * dt
stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
problem = TaylorGreen(disc)
Q0 = jax.jit(lambda: disc.interpolate_velocity(problem.initial_condition()[0]))()
star = jax.jit(lambda Q: star_fields(geom, project_bdm(geom, stepper._proj, Q)))(Q0)
print(f"nx={nx} n_cells={geom.n_cells} n_facets={geom.n_facets}")

# full build
j_full = jax.jit(lambda s: P.build_tentative_operator(geom, s, c, 1.0, True))
op = timeit("full build", j_full, star)

# stage pieces: replicate the build's internal staging by calling the build
# with early-exit monkeypatches is intrusive; instead time the dominant
# primitives it is composed of, on the same shapes.
nu = 2 * geom.d1

op_D, op_Bx, op_Cx = jax.jit(lambda o: P.dense_blocks(geom, o))(op)

j_dinv = jax.jit(lambda D: inv_bl(D))
timeit("GJ inverse (nu,nu,nc)", j_dinv, op_D)

from incompressibleeulerhdg.ops import structured as st

b0, b1 = geom.fcol_bounds[0], geom.fcol_bounds[1]
l, lu, i0, j0, ni, nj, off = geom.shift[4][0]
rect = (i0, j0, ni, nj)


def schur_color(D, Dinv, Bx, Cx):
    Dup = st.grid_halves(geom, D)[1]
    Dinv_lo = st.grid_halves(geom, Dinv)[0]
    D1 = st.rect_flat(st.roll2(geom, Dup, off), rect)
    Dinv0_k = st.rect_flat(Dinv_lo, rect)
    Sc = D1 - P._bmm(Cx[:, :, b0:b1], P._bmm(Dinv0_k, Bx[:, :, b0:b1]))
    return inv_bl(Sc)


j_schur = jax.jit(schur_color)
timeit("one color Schur+inv", j_schur, op_D, op.Dinv, op_Bx, op_Cx)

j_bmm = jax.jit(lambda A, B: P._bmm(A, B))
timeit("one _bmm (nu,nu,nf/3)", j_bmm, op_Bx[:, :, b0:b1], op_Cx[:, :, b0:b1])
