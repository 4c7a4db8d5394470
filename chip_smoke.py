"""Smoke test of the HDG IMEX solver on NVIDIA GPUs.

    python chip_smoke.py              # one card: phases 0-3
    python chip_smoke.py --devices 4  # four cards: phase 4 only

Phases (each prints its findings; any failure raises and exits non-zero):

0. device gate: the first JAX device must be a GPU; prints the card's name
   and power limit (nvidia-smi, read by a child process that stays off
   JAX), the JAX version and the compile-cache directory.
1. batched block inverse at real widths: the own-cell blocks
   ``build_tentative_operator`` assembles for the 512^2 k=2 mesh, and the
   k=3 blocks of the 256^2 mesh, inverted by the kept route (the batched LU
   of ``smallinv.inv_bl``) and by the elementwise Gauss-Jordan sweep it
   replaced; both timed, the kept one checked.
2. float64 verification path, GPU against CPU: the small Taylor-Green run
   through ``cli.driver.main`` on both devices of this process.
3. the flagship configuration at benchmark width through the driver: HDG
   IMEX SSP2(3,3,2), Richardson + projection, Taylor-Green, 256^2, k=2,
   float32, 5 steps.  Runs right after the gate, so the peak device memory
   it reports is its own.
4. (``--devices N``) the slab-decomposed ``shard_map`` step at 512^2 k=2
   f32 against the single-card step from the same state, and the GSPMD
   fallback on the Kelvin-Helmholtz disk mesh (k=1, f64) against one card;
   the two 512^2 steps compile on worker threads meanwhile.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import subprocess
import tempfile
import time

if __name__ == "__main__":
    # phase 2 compares against the CPU device of this same process (JAX
    # reads the platform list when it is imported)
    _plats = os.environ.get("JAX_PLATFORMS")
    if _plats and "cpu" not in _plats.split(","):
        os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import numpy as np

import jax
import jax.numpy as jnp

# flagship bounds (bench.py): velocity / pressure L2 error after the steps
ERROR_VELOCITY_MAX = 1.0e-4
ERROR_PRESSURE_MAX = 1.0e-2
# phase 1: per block, max|A X - I| <= n * eps_f32 * kappa_inf(A), the f32
# round-off of an n-step elimination amplified by the block's condition
# number.  kappa grows like nx (penalty ~ alpha/h against mass ~ h^2):
# ~600 at 64^2, ~1200 at 128^2 (float64 numpy), so at 512^2 a fixed bound
# like 1e-4 is below the round-off of any f32 inverse.  Measured residuals
# sit at ~0.02 of this bound.
INVERSE_RESIDUAL_RATIO_MAX = 1.0
# phase 2: the same float64 program on two devices; reduction orders differ,
# so the error norms (~1e-3) agree to round-off amplified by the solves
F64_RELATIVE_MAX = 1.0e-8
# phase 4: two f32 Krylov solves whose dot products are reduced in another
# order (psum over slabs); 2 steps of f32 round-off through GMRES
SLAB_RELATIVE_MAX = 1.0e-4
GSPMD_RELATIVE_MAX = 1.0e-8

# sizes: the flagship (bench.py) configuration, 5 steps of dt = 1/256
FLAGSHIP_ARGV = ["--nx", "256", "--degree", "2", "--dtype", "float32",
                 "--dt", "0.00390625", "--tfinal", "0.01953125",
                 "--timestepper", "imex_ssp2_332", "--use_projection_method"]
VERIFY_ARGV = ["--nx", "8", "--degree", "1", "--dt", "0.1", "--tfinal", "0.5",
               "--timestepper", "imex_ssp2_332", "--use_projection_method"]
INVERSE_MESHES = ((512, 2), (256, 3))  # (nx, degree): n = 20 and n = 30
SLAB_NX = 512
DISK_REFINEMENT = 3


def require_gpu(devices):
    """Phase 0 gate: refuse to run (SystemExit, non-zero) unless the first
    device is a GPU — nothing here may time or validate a CPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found platform {platform!r}")
    return devices[0]


def _timed(fn, *args, reps=3):
    """(result, cold seconds, best warm seconds) of a jitted call."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        out = None
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, cold, best


def phase0(devices):
    dev = require_gpu(devices)
    from incompressibleeulerhdg.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"phase 0: nvidia-smi: {smi}")
    print(f"phase 0: jax {jax.__version__}, {len(devices)} x {dev.device_kind} "
          f"({dev.platform}), compile cache {cache}", flush=True)
    return dev


def _driver(argv, workdir):
    """cli.driver.main in ``workdir`` (it writes its VTU into the cwd)."""
    from incompressibleeulerhdg.cli.driver import main
    from incompressibleeulerhdg.utils.logging import PerformanceLog

    PerformanceLog.reset()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


def phase3(dev, workdir):
    res = _driver(FLAGSHIP_ARGV, workdir)
    from incompressibleeulerhdg.utils.logging import PerformanceLog

    steps = PerformanceLog.data["timestep"]
    ts = res["timestepper"]
    its = {
        "tentative": ts.niter_tentative,
        "pressure": ts.niter_pressure,
        "final_pressure": ts.niter_final_pressure,
        "reconstruction": ts.niter_pressure_reconstruction,
    }
    finite = bool(jnp.isfinite(res["Q"]).all()) and bool(jnp.isfinite(res["p"]).all())
    peak = dev.memory_stats()["peak_bytes_in_use"]
    print(f"phase 3: {' '.join(FLAGSHIP_ARGV)}: {len(steps)} steps, "
          f"cold (compile + 1 step) {steps[0]:.3f} s, "
          f"warm {np.mean(steps[1:]):.4f} s/step (min {min(steps[1:]):.4f}), "
          f"peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB)")
    print("phase 3: iterations (mean/min): " + ", ".join(
        f"{k} {a.value:.2f}/{a.min}" for k, a in its.items()))
    print(f"phase 3: velocity error {res['velocity_error']:.6e}, "
          f"pressure error {res['pressure_error']:.6e}, finite {finite}",
          flush=True)
    if not finite:
        raise RuntimeError("phase 3: non-finite state")
    if not res["velocity_error"] < ERROR_VELOCITY_MAX:
        raise RuntimeError(f"phase 3: velocity error {res['velocity_error']}")
    if not res["pressure_error"] < ERROR_PRESSURE_MAX:
        raise RuntimeError(f"phase 3: pressure error {res['pressure_error']}")
    if any(a.min is None or a.min <= 0 for a in its.values()):
        raise RuntimeError(f"phase 3: a Krylov solve took no iteration: {its}")


def _own_cell_blocks(nx, degree):
    """The (nu, nu, nc) own-cell blocks and the first colour's size of the
    stage-1 tentative operator of the Taylor-Green vortex at nx^2."""
    from incompressibleeulerhdg.mesh.generators import unit_square_mesh
    from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg.models.problems import TaylorGreen
    from incompressibleeulerhdg.ops.forms import star_fields
    from incompressibleeulerhdg.ops.projection import build_bdm_projection, project_bdm
    from incompressibleeulerhdg.linalg.preconditioners import (
        build_tentative_operator,
        dense_blocks,
    )

    disc = HDGDiscretisation(unit_square_mesh(nx), degree, dtype=jnp.float32)
    geom = disc.geom
    proj = build_bdm_projection(disc)
    problem = TaylorGreen(disc)
    c = 0.25 / nx  # SSP2(3,3,2) a_11 * dt at dt = 1/nx

    Q0 = jax.jit(lambda: disc.interpolate_velocity(problem.initial_condition()[0]))()

    @jax.jit
    def blocks(geom, proj, Q0):
        star = star_fields(geom, project_bdm(geom, proj, Q0))
        return dense_blocks(geom, build_tentative_operator(geom, star, c))[0]

    ncol0 = geom.fcol_bounds[1] - geom.fcol_bounds[0]
    return jax.block_until_ready(blocks(geom, proj, Q0)), ncol0


def _gauss_jordan_bl(A):
    """The replaced candidate: Gauss-Jordan without pivoting, one
    elementwise pass over the whole batch-last (n, n, m) array per pivot."""
    A = jax.lax.optimization_barrier(A)
    m = A.shape[2]

    def body(k, A):
        pivot = jax.lax.dynamic_index_in_dim(A, k, axis=0, keepdims=False)
        inv_p = 1.0 / jax.lax.dynamic_index_in_dim(pivot, k, axis=0, keepdims=False)
        row_k = jax.lax.dynamic_update_index_in_dim(
            pivot * inv_p[None, :], inv_p, k, axis=0)
        col = jax.lax.dynamic_slice_in_dim(A, k, 1, axis=1)[:, 0, :]
        f = jax.lax.dynamic_update_index_in_dim(
            col, jnp.zeros((m,), A.dtype), k, axis=0)
        A = A - f[:, None, :] * row_k[None, :, :]
        A = jax.lax.dynamic_update_slice_in_dim(
            A, (-f * inv_p[None, :])[:, None, :], k, axis=1)
        return jax.lax.dynamic_update_index_in_dim(A, row_k, k, axis=0)

    return jax.lax.fori_loop(0, A.shape[0], body, A)


@jax.jit
def _inverse_check(A, X):
    """(max|AX - I|, max kappa_inf, max ratio to n eps kappa) over blocks."""
    n = A.shape[0]
    R = jnp.max(jnp.abs(
        jnp.einsum("ijm,jkm->ikm", A, X, precision="highest")
        - jnp.eye(n, dtype=A.dtype)[:, :, None]), axis=(0, 1))
    norm_inf = lambda M: jnp.max(jnp.sum(jnp.abs(M), axis=1), axis=0)
    kappa = norm_inf(A) * norm_inf(X)
    ratio = R / (n * jnp.finfo(A.dtype).eps * kappa)
    return jnp.max(R), jnp.max(kappa), jnp.max(ratio)


def phase1():
    from incompressibleeulerhdg.linalg.smallinv import inv_bl

    kept = jax.jit(inv_bl)
    gj = jax.jit(_gauss_jordan_bl)
    failed = []
    for nx, degree in INVERSE_MESHES:
        D, ncol0 = _own_cell_blocks(nx, degree)
        for A in (D, D[:, :, :ncol0]):
            n, _, m = A.shape
            X, cold_k, warm_k = _timed(kept, A)
            r_k, kappa, ratio = (float(v) for v in _inverse_check(A, X))
            X = None
            X, cold_g, warm_g = _timed(gj, A)
            r_g = float(_inverse_check(A, X)[0])
            X = None
            print(f"phase 1: ({n},{n},{m}) f32 from {nx}^2 k={degree}: "
                  f"batched LU (kept) {warm_k * 1e3:.3f} ms (cold {cold_k:.2f} s) "
                  f"max|AX-I| {r_k:.3e}, max kappa {kappa:.3e}, residual / "
                  f"(n eps kappa) {ratio:.3e}; Gauss-Jordan {warm_g * 1e3:.3f} ms "
                  f"(cold {cold_g:.2f} s) max|AX-I| {r_g:.3e}", flush=True)
            if not ratio <= INVERSE_RESIDUAL_RATIO_MAX:
                failed.append((n, m, ratio))
        D = None
    if failed:
        raise RuntimeError(f"phase 1: inverse residual above n eps kappa: {failed}")


def phase2(workdir):
    try:
        gpu = _driver(VERIFY_ARGV, workdir)
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = _driver(VERIFY_ARGV, workdir)
    finally:
        jax.config.update("jax_enable_x64", False)
    for name in ("velocity_error", "pressure_error"):
        rel = abs(gpu[name] - cpu[name]) / abs(cpu[name])
        print(f"phase 2: f64 {name}: gpu {gpu[name]:.15e} cpu {cpu[name]:.15e} "
              f"relative difference {rel:.3e}", flush=True)
        if not rel <= F64_RELATIVE_MAX:
            raise RuntimeError(f"phase 2: {name} differs by {rel:.3e}")


def _initial_state(disc, stepper, problem):
    Q0 = disc.interpolate_velocity(problem.initial_condition()[0])
    p0 = stepper.shift_pressure(
        disc.interpolate_pressure(problem.initial_condition()[1])
    )
    lam0 = stepper._reconstruct_trace(Q0, p0)
    s = stepper.nstages
    zeros = lambda a: [jnp.zeros_like(a)] * (s - 1)
    return [Q0] + zeros(Q0), [p0] + zeros(p0), [lam0] + zeros(lam0)


def disk_solve(n_devices):
    """3 float64 SSP2 steps of Kelvin-Helmholtz on the unit disk (k=1) over
    ``n_devices`` (GSPMD cell/facet sharding for n > 1): final (Q, p)."""
    from incompressibleeulerhdg.mesh.generators import unit_disk_mesh
    from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg.models.problems import KelvinHelmholtz
    from incompressibleeulerhdg.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )

    disc = HDGDiscretisation(unit_disk_mesh(refinement_level=DISK_REFINEMENT), 1,
                             dtype=jnp.float64)
    st = IncompressibleEulerHDGIMEXSSP2_332(disc, 0.01, n_devices=n_devices)
    problem = KelvinHelmholtz(disc)
    Q0, p0 = problem.initial_condition()
    Q, p = st.solve(Q0, p0, None, problem.f_rhs(), 0.03)
    return np.asarray(Q), np.asarray(p)


def _compile(jitted, *args):
    """(compiled executable, seconds) of ``jitted`` lowered for ``args``."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _two_steps(step, state, t_of, extra=()):
    """Two steps from ``state`` = (sQ, sp, sl): final state, last outputs,
    seconds."""
    t0 = time.perf_counter()
    for k in range(2):
        out = step(*state, t_of(k), *extra)
        state = tuple(list(a) for a in out[:3])
        jax.block_until_ready(state[0][0])
    return state, out, time.perf_counter() - t0


def phase4(n_devices):
    from concurrent.futures import ThreadPoolExecutor

    from incompressibleeulerhdg.mesh.generators import unit_square_mesh
    from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg.models.problems import TaylorGreen
    from incompressibleeulerhdg.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )
    from incompressibleeulerhdg.parallel.slab import (
        build_slab_decomposition,
        make_distributed_step,
        scatter_state,
    )

    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"phase 4: {n_devices} devices asked, "
                           f"{len(jax.devices())} present")
    nx = SLAB_NX
    disc = HDGDiscretisation(unit_square_mesh(nx), 2, dtype=jnp.float32)
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, 1.0 / nx)
    problem = TaylorGreen(disc)
    state0 = jax.jit(lambda: _initial_state(disc, stepper, problem))()
    dt = stepper._dt
    t_of = lambda k: jnp.asarray(k * dt, jnp.float32)

    # the fused step the slab path wraps (the one _get_step returns below
    # COMPOSITE_STEP_CELLS), on one card
    step = jax.jit(stepper._make_step(problem.f_rhs(), False))
    op_args = (disc.geom, stepper._proj, stepper._cs, stepper._gtmg)
    extra = (jnp.zeros_like(state0[1][0]), None)
    dec = build_slab_decomposition(disc, stepper, n_slabs=n_devices)
    dstep = make_distributed_step(dec, stepper, problem.f_rhs())
    dstate0 = scatter_state(dec, *state0)

    # the two cold compiles take minutes each: run them on worker threads
    # (XLA compiles without the GIL) while this thread runs the GSPMD
    # comparison; every execution on several cards stays on this thread
    with ThreadPoolExecutor(2) as pool:
        single_c = pool.submit(
            _compile, step, *op_args, *state0, t_of(0), *extra)
        slab_c = pool.submit(_compile, dstep, *dstate0, t_of(0))

        with jax.enable_x64(True):
            Q1, p1 = disk_solve(1)
            Qn, pn = disk_solve(n_devices)
        relQ = float(np.abs(Qn - Q1).max() / np.abs(Q1).max())
        relp = float(np.abs(pn - p1).max() / np.abs(p1).max())
        print(f"phase 4: GSPMD {n_devices} cards vs 1, Kelvin-Helmholtz disk "
              f"(refinement {DISK_REFINEMENT}, k=1, f64, 3 steps): max relative "
              f"difference velocity {relQ:.3e}, pressure {relp:.3e}", flush=True)

        single, t_cs = single_c.result()
        slab, t_cd = slab_c.result()

    (rQ, _, _), out, t_single = _two_steps(
        lambda *a: single(*op_args, *a), state0, t_of, extra)
    ref_tent = np.asarray(out[4]["tentative"], np.int64)
    (dQ, _, _), dout, t_slab = _two_steps(slab, dstate0, t_of)
    Q_ref = np.asarray(rQ[0])
    Q_d = dec.gather_cell_field(np.asarray(dQ[0]), Q_ref.shape)
    rel = float(np.abs(Q_d - Q_ref).max() / np.abs(Q_ref).max())
    tent = np.asarray(dout[3]["tentative"], np.int64)
    print(f"phase 4: slab {n_devices} x {nx}^2 k=2 f32, 2 steps: compile "
          f"single card {t_cs:.1f} s, slab {t_cd:.1f} s (concurrent); 2 steps "
          f"single card {t_single:.3f} s, slab {t_slab:.3f} s; max relative "
          f"velocity difference {rel:.3e}; tentative its single "
          f"{ref_tent.tolist()} slab {tent.tolist()}", flush=True)

    failed = []
    if not max(relQ, relp) <= GSPMD_RELATIVE_MAX:
        failed.append(f"GSPMD differs from one card by {max(relQ, relp):.3e}")
    if not rel <= SLAB_RELATIVE_MAX:
        failed.append(f"slab velocity differs by {rel:.3e}")
    if np.abs(tent - ref_tent).max() > 1:
        failed.append("slab iteration counts differ by more than 1")
    if failed:
        raise RuntimeError("phase 4: " + "; ".join(failed))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--devices", type=int, default=1,
                        help="N > 1 runs only the N-card phase 4")
    args = parser.parse_args()

    jax.config.update("jax_default_matmul_precision", "highest")
    devices = jax.devices()
    dev = phase0(devices)
    if args.devices > 1:
        phase4(args.devices)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            phase3(dev, workdir)
            phase1()
            phase2(workdir)
    # the number of cards the chosen mode ran on
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": args.devices,
    }}))


if __name__ == "__main__":
    main()
