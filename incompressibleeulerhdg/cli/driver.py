"""Command-line driver mirroring the reference's 17-flag argparse surface.

Rebuild of reference src/driver.py: problem/mesh construction
(driver.py:180-185), timestepper dispatch (driver.py:189-282), run banner
(driver.py:284-306), the standalone pressure-solver benchmark with a *working*
signature (driver.py:308-324; the reference's is stale, SURVEY.md section
3.2), the solve, divergence diagnostic + error norms (driver.py:351-381), and
VTK output (driver.py:384-385).

Run:  python -m incompressibleeulerhdg.cli.driver --help
"""

import argparse
import time

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser("Mesh specifications and polynomial degree")
    parser.add_argument(
        "--problem",
        choices=["taylorgreen", "kelvinhelmholtz", "shear"],
        default="taylorgreen",
        help="model problem to solve",
    )
    parser.add_argument("--nx", type=int, default=8, help="number of grid cells in x-direction")
    parser.add_argument(
        "--refinement", type=int, default=2, help="refinement level for unit disk mesh"
    )
    parser.add_argument("--degree", type=int, default=1, help="polynomial degree")
    parser.add_argument("--tfinal", type=float, default=1.0, help="final time")
    parser.add_argument("--kappa", type=float, default=0.5, help="exponential decay factor")
    parser.add_argument("--dt", type=float, default=0.04, help="timestep size")
    parser.add_argument(
        "--discretisation",
        choices=["conforming", "dg", "hdg"],
        default="hdg",
        help="discretisation method",
    )
    parser.add_argument(
        "--use_projection_method",
        action="store_true",
        default=False,
        help="use projection method for timestepping",
    )
    parser.add_argument(
        "--richardson", type=int, default=2, help="number of Richardson iterations"
    )
    parser.add_argument(
        "--flux", choices=["upwind", "centered"], default="upwind", help="numerical flux"
    )
    parser.add_argument(
        "--timestepper",
        choices=[
            "implicit",
            "imex_implicit",
            "imex_ars2_232",
            "imex_ars3_443",
            "imex_ssp2_332",
            "imex_ssp3_433",
        ],
        default="imex_ssp2_332",
        help="timestepper",
    )
    parser.add_argument(
        "--forcing", choices=["exponential", "constant"], default="exponential", help="forcing"
    )
    parser.add_argument(
        "--test_pressure_solver",
        action="store_true",
        default=False,
        help="carry out a single solve with the pressure solver for testing",
    )
    parser.add_argument(
        "--warmup", action="store_true", default=False, help="only perform one timestep"
    )
    parser.add_argument(
        "--animation",
        action="store_true",
        default=False,
        help="save velocity and pressure fields at the end of each timestep as an animation",
    )
    parser.add_argument(
        "--tracer_advection", action="store_true", default=False, help="advect tracer field"
    )
    # extensions (not in the reference)
    parser.add_argument(
        "--dtype",
        choices=["float32", "float64"],
        default="float64",
        help="runtime floating-point precision (float32 for the fast path)",
    )
    parser.add_argument(
        "--n_devices",
        type=int,
        default=1,
        help="distribute the solve over N devices (the analogue of the "
        "reference's mpiexec -n): slab-decomposed shard_map for HDG IMEX "
        "on structured meshes, GSPMD cell/facet sharding otherwise",
    )
    parser.add_argument(
        "--checkpoint_every",
        type=int,
        default=0,
        help="save the solver state every N timesteps (0 = off)",
    )
    parser.add_argument(
        "--checkpoint_file",
        type=str,
        default="checkpoint.npz",
        help="checkpoint file path",
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        default=False,
        help="resume from --checkpoint_file (validated against this config)",
    )
    return parser


def main(argv=None):
    """Run the driver; returns a dict with the final state ``Q``/``p``, the
    ``timestepper`` and the ``velocity_error``/``pressure_error`` norms
    against the exact solution (None where there is none or on --warmup)."""
    args = build_parser().parse_args(argv)

    import jax

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # float32 matmuls may otherwise run in TF32 on the GPU
    jax.config.update("jax_default_matmul_precision", "highest")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32

    from ..mesh.generators import unit_square_mesh, periodic_square_mesh, unit_disk_mesh
    from ..fem.discretisation import HDGDiscretisation
    from ..models.problems import TaylorGreen, KelvinHelmholtz, DoubleLayerShearFlow
    from ..timesteppers.hdg_implicit import IncompressibleEulerHDGImplicit
    from ..timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXImplicit,
        IncompressibleEulerHDGIMEXARS2_232,
        IncompressibleEulerHDGIMEXARS3_443,
        IncompressibleEulerHDGIMEXSSP2_332,
        IncompressibleEulerHDGIMEXSSP3_433,
    )
    from ..timesteppers.dg_implicit import IncompressibleEulerDGImplicit
    from ..timesteppers.conforming_implicit import IncompressibleEulerConformingImplicit
    from ..ops import fields as F
    from ..utils.logging import log_summary
    from ..utils.callbacks import AnimationCallback
    from ..utils.vtk import write_vtu, sample_dg_at_corners

    # mesh (driver.py:180-185)
    if args.problem == "taylorgreen":
        mesh = unit_square_mesh(args.nx)
    elif args.problem == "shear":
        mesh = periodic_square_mesh(args.nx, L=2 * np.pi)
    elif args.problem == "kelvinhelmholtz":
        mesh = unit_disk_mesh(refinement_level=args.refinement)

    if args.discretisation == "conforming":
        print("Warning: ignoring degree for conforming method")
        disc = HDGDiscretisation(mesh, 0, dtype=dtype)
    else:
        disc = HDGDiscretisation(mesh, args.degree, dtype=dtype)

    callbacks = [AnimationCallback(disc, "evolution.pvd")] if args.animation else None

    # timestepper dispatch (driver.py:189-282)
    if args.discretisation == "conforming":
        if args.timestepper != "implicit":
            raise RuntimeError(
                f"Invalid timestepping method for conforming discretisation: '{args.timestepper}'"
            )
        timestepper = IncompressibleEulerConformingImplicit(
            disc, args.dt, args.flux, args.use_projection_method,
            callbacks=callbacks, n_devices=args.n_devices,
        )
    elif args.discretisation == "dg":
        assert (
            not args.use_projection_method
        ), "Can not use projection method with DG discretsation"
        if args.timestepper != "implicit":
            raise RuntimeError(
                f"Invalid timestepping method for DG discretisation: '{args.timestepper}'"
            )
        timestepper = IncompressibleEulerDGImplicit(
            disc, args.dt, flux=args.flux, callbacks=callbacks,
            n_devices=args.n_devices,
        )
    elif args.discretisation == "hdg":
        imex_classes = {
            "imex_implicit": IncompressibleEulerHDGIMEXImplicit,
            "imex_ars2_232": IncompressibleEulerHDGIMEXARS2_232,
            "imex_ars3_443": IncompressibleEulerHDGIMEXARS3_443,
            "imex_ssp2_332": IncompressibleEulerHDGIMEXSSP2_332,
            "imex_ssp3_433": IncompressibleEulerHDGIMEXSSP3_433,
        }
        if args.timestepper == "implicit":
            timestepper = IncompressibleEulerHDGImplicit(
                disc,
                args.dt,
                flux=args.flux,
                use_projection_method=args.use_projection_method,
                callbacks=callbacks,
                n_devices=args.n_devices,
            )
        elif args.timestepper in imex_classes:
            timestepper = imex_classes[args.timestepper](
                disc,
                args.dt,
                flux=args.flux,
                use_projection_method=args.use_projection_method,
                n_richardson=args.richardson,
                callbacks=callbacks,
                n_devices=args.n_devices,
            )
        else:
            raise RuntimeError(
                f"Invalid timestepping method for HDG discretisation: '{args.timestepper}'"
            )

    # banner (driver.py:284-306)
    print("+-------------------------------------------------+")
    print("! timesteppers for incompressible Euler equations !")
    print("! (JAX rebuild)                                   !")
    print("+-------------------------------------------------+")
    print()
    print(f"model problem = {args.problem}")
    if args.problem == "taylorgreen":
        print(f"mesh size = {args.nx} x {args.nx}")
        print(f"forcing = {args.forcing}")
        print(f"kappa = {args.kappa}")
    elif args.problem == "shear":
        print(f"mesh size = {args.nx} x {args.nx}")
    elif args.problem == "kelvinhelmholtz":
        print(f"mesh refinement = {args.refinement}")
    print(f"polynomial degree = {args.degree}")
    print(f"final time = {args.tfinal}")
    print(f"timestep size = {args.dt}")
    print(f"discretisation = {args.discretisation}")
    print(f"numerical flux = {args.flux}")
    print(f"number of Richardson iterations = {args.richardson}")
    print(f"use projection method = {args.use_projection_method}")
    print(f"advect tracer = {args.tracer_advection}")
    print(f"timestepping method = {timestepper.label}")
    print(f"dtype = {args.dtype}")
    if args.n_devices > 1:
        print(f"distributed over {args.n_devices} devices")
    print(f"jax devices = {jax.devices()}")
    print()

    # pressure-solver micro-benchmark (driver.py:308-324) with a working
    # signature: seeded random velocity rhs, warm-up solve, timed solve
    if args.test_pressure_solver:
        if not hasattr(timestepper, "test_pressure_solver"):
            raise RuntimeError("selected timestepper has no pressure solver to test")
        print("=== Testing pressure solver")
        print()
        t_solve, its = timestepper.test_pressure_solver(seed=123456789)
        print(f"    solve time           = {t_solve:12.4f} s")
        print(f"    number of iterations = {its}")
        return {"timestepper": timestepper, "solve_time": t_solve,
                "iterations": its}

    if args.warmup:
        print("WARNING: performing a single timestep only!")
        print()

    # model problem (driver.py:330-337)
    if args.problem == "taylorgreen":
        model_problem = TaylorGreen(disc, args.forcing, args.kappa)
    elif args.problem == "shear":
        model_problem = DoubleLayerShearFlow(disc)
    elif args.problem == "kelvinhelmholtz":
        model_problem = KelvinHelmholtz(disc)

    Q_0, p_0 = model_problem.initial_condition()
    if args.tracer_advection:
        q_0 = lambda x, y: jnp.sin(2 * jnp.pi * x) * jnp.sin(2 * jnp.pi * y)
    else:
        q_0 = None

    solve_kwargs = {}
    if args.checkpoint_every or args.resume:
        # all scheme families checkpoint/resume: IMEX saves its full stage
        # state (timesteppers/hdg_imex.py), the others the plain (Q, p,
        # tracer) state via the base-class helpers (timesteppers/common.py)
        solve_kwargs = dict(
            checkpoint_every=args.checkpoint_every,
            checkpoint_path=args.checkpoint_file,
            resume=args.resume,
        )

    Q, p = timestepper.solve(
        Q_0, p_0, q_0, model_problem.f_rhs(), args.tfinal, warmup=args.warmup,
        **solve_kwargs,
    )

    log_summary()

    result = {"timestepper": timestepper, "Q": Q, "p": p,
              "velocity_error": None, "pressure_error": None}
    if not args.warmup:
        geom = disc.geom
        # divergence diagnostic by mass-matrix projection (driver.py:356-362)
        divQ = F.mass_solve(
            geom, geom.m0inv, F.cell_integrate(geom, geom.phi0, F.cell_div(geom, Q))
        )
        fields = {
            "velocity": sample_dg_at_corners(disc, Q),
            "pressure": sample_dg_at_corners(disc, p),
            "divergence": sample_dg_at_corners(disc, divQ),
        }
        exact = model_problem.solution(args.tfinal)
        if exact is not None:
            Q_exact, p_exact = exact
            Q_err_nrm = timestepper.velocity_error_norm(Q, Q_exact)
            p_err_nrm = timestepper.pressure_error_norm(p, p_exact)
            print()
            print(f"velocity error = {Q_err_nrm}")
            print(f"pressure error = {p_err_nrm}")
            print()
            result["velocity_error"] = float(Q_err_nrm)
            result["pressure_error"] = float(p_err_nrm)
            fields["velocity_exact"] = sample_dg_at_corners(disc, Q_exact)
            fields["velocity_error"] = sample_dg_at_corners(disc, Q - Q_exact)
            fields["pressure_exact"] = sample_dg_at_corners(disc, p_exact)
            fields["pressure_error"] = sample_dg_at_corners(disc, p - p_exact)
        write_vtu("solution.vtu", mesh, fields)
        print("wrote solution.vtu")
    return result


if __name__ == "__main__":
    main()
