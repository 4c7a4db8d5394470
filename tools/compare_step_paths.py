"""Measure the fused vs the composite IMEX step at one mesh size.

Prints, per path, the cold warm-up (compile + 1 step), the warm wall-clock
per step and the device's ``peak_bytes_in_use`` so
``IncompressibleEulerHDGIMEX.COMPOSITE_STEP_CELLS`` can be set from data.
Each path's final state is validated as ``bench.py`` validates its runs
(finite, velocity/pressure L2 errors under bench's bounds, every Krylov
solve > 0 iterations); a path that fails exits non-zero.
The peak is per process: run one path per process (``PROF_PATHS``) to read
each path's own peak.  Not part of the test suite.

Usage: PROF_NX=256 PROF_PATHS=fused python tools/compare_step_paths.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from incompressibleeulerhdg.utils.compile_cache import enable_compile_cache
from incompressibleeulerhdg.mesh.generators import unit_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.models.problems import TaylorGreen
from incompressibleeulerhdg.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332,
)
from bench import ERROR_PRESSURE_MAX, ERROR_VELOCITY_MAX

def run(kind, nx, degree, n_steps):
    dt = 1.0 / nx
    disc = HDGDiscretisation(unit_square_mesh(nx), degree, dtype=jnp.float32)
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
    # force the path: a threshold below/above n_cells selects composite/fused
    stepper.composite_step_cells = 1 if kind == "composite" else 10**9
    problem = TaylorGreen(disc)
    Q0 = jax.jit(
        lambda: disc.interpolate_velocity(problem.initial_condition()[0])
    )()
    p0 = jax.jit(
        lambda: stepper.shift_pressure(
            disc.interpolate_pressure(problem.initial_condition()[1])
        )
    )()
    lam0 = jax.jit(stepper._reconstruct_trace)(Q0, p0)
    s = stepper.nstages
    sQ = [Q0] + [jnp.zeros_like(Q0)] * (s - 1)
    sp = [p0] + [jnp.zeros_like(p0)] * (s - 1)
    sl = [lam0] + [jnp.zeros_like(lam0)] * (s - 1)
    dummy_q = jnp.zeros_like(p0)
    step = stepper._get_step(problem.f_rhs(), False)
    op_args = (disc.geom, stepper._proj, stepper._cs, stepper._gtmg)

    t0 = time.perf_counter()
    out = step(*op_args, sQ, sp, sl, jnp.asarray(0.0, jnp.float32), dummy_q, None)
    jax.block_until_ready(out[0][0])
    warmup_s = time.perf_counter() - t0
    sQ, sp, sl = out[0], out[1], out[2]
    times = []
    for k in range(n_steps):
        t0 = time.perf_counter()
        out = step(
            *op_args, sQ, sp, sl, jnp.asarray((k + 1) * dt, jnp.float32),
            dummy_q, None,
        )
        sQ, sp, sl = out[0], out[1], out[2]
        jax.block_until_ready(sQ[0])
        times.append(time.perf_counter() - t0)
    tent = np.asarray(out[4]["tentative"]).ravel()
    pres = np.asarray(out[4]["pressure"]).ravel()
    stats = jax.devices()[0].memory_stats() or {}
    finite = bool(jnp.isfinite(sQ[0]).all()) and bool(jnp.isfinite(sp[0]).all())
    Q_exact, p_exact = problem.solution((1 + n_steps) * dt)
    err_vel = float(stepper.velocity_error_norm(sQ[0], Q_exact))
    err_p = float(stepper.pressure_error_norm(sp[0], p_exact))
    ok = (finite and err_vel < ERROR_VELOCITY_MAX and err_p < ERROR_PRESSURE_MAX
          and bool((tent > 0).all()) and bool((pres > 0).all()))
    print(
        f"{kind:>10s}: warmup(compile+1 step) {warmup_s:7.1f} s, "
        f"{np.median(times):7.4f} s/step (median of {n_steps}: "
        f"{' '.join(f'{t:.4f}' for t in times)}), "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}, "
        f"tentative its {tent.tolist()}, pressure its {pres.tolist()}; "
        f"finite {finite}, err_vel {err_vel:.3e}, err_p {err_p:.3e}, ok {ok}",
        flush=True,
    )
    return ok


def main():
    enable_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    nx = int(os.environ.get("PROF_NX", 256))
    degree = int(os.environ.get("PROF_DEGREE", 2))
    n_steps = int(os.environ.get("PROF_STEPS", 3))
    paths = os.environ.get("PROF_PATHS", "composite,fused").split(",")
    dev = jax.devices()[0]
    print(f"nx={nx} k={degree} steps={n_steps} on {dev.device_kind} "
          f"({dev.platform})")
    results = [run(kind, nx, degree, n_steps) for kind in paths]
    if not all(results):
        sys.exit(f"validation failed: {dict(zip(paths, results))}")


if __name__ == "__main__":
    main()
