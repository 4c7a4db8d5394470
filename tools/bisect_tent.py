"""One-compile probe of tentative-solve iteration counts.

Prints iterations + preconditioned and TRUE relative residuals for a single
tentative solve at a chosen size — the cheap way to validate preconditioner
changes at scale (small-mesh CPU checks pass even for changes that diverge
at nx >= 128; see the bf16 note in linalg/preconditioners.py).  Not part of
the test suite.

Usage: BIS_NX=128 BIS_SWEEPS=2 BIS_RTOL=1e-10 python tools/bisect_tent.py
"""

import os
import sys

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
from incompressibleeulerhdg.ops import fields as F
from incompressibleeulerhdg.linalg.preconditioners import (
    build_tentative_operator,
    tentative_operator_matvec,
)
from incompressibleeulerhdg.linalg.tentative import tentative_solve

nx = int(os.environ.get("BIS_NX", "128"))
sweeps = int(os.environ.get("BIS_SWEEPS", "1"))
rtol = float(os.environ.get("BIS_RTOL", "1e-10"))
# match the production stepper's restart (IEHDG_TENT_RESTART default in
# hdg_imex.py) — tentative_solve's own default (40) would validate a
# longer-restart solver than the timestep runs
restart = int(os.environ.get("IEHDG_TENT_RESTART", "28"))
dtype = jnp.float32

from incompressibleeulerhdg.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332,
)

disc = HDGDiscretisation(unit_square_mesh(nx), 2, dtype=dtype)
geom = disc.geom
dt = 1.0 / nx
c = 0.5 * dt  # ~a_ii dt
stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
problem = TaylorGreen(disc)
Q0 = jax.jit(lambda: disc.interpolate_velocity(problem.initial_condition()[0]))()
star = jax.jit(lambda Q: star_fields(geom, project_bdm(geom, stepper._proj, Q)))(Q0)
op = jax.jit(lambda s: build_tentative_operator(geom, s, c, 1.0, True))(star)
b = jax.jit(lambda Q: F.mass_apply(geom, geom.m1, Q))(Q0)

sol = jax.jit(
    lambda s, b, op: tentative_solve(
        geom, s, b, c, alpha=1.0, upwind=True, rtol=rtol, op=op,
        sweeps=sweeps, restart=restart,
    )
)
u, its, rr = sol(star, b, op)
# true residual check against the f32 weak-form matvec
r = b - jax.jit(lambda op, u: tentative_operator_matvec(geom, op, u))(op, u)
tr = float(jnp.linalg.norm(r.ravel()) / jnp.linalg.norm(b.ravel()))
print(
    f"nx={nx} sweeps={sweeps} rtol={rtol}"
    f" -> iters={int(its)} relres={float(rr):.2e} true_relres={tr:.2e}"
)
