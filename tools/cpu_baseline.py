"""Measured CPU baseline: the reference's per-timestep solver composition,
executed with assembled sparse matrices + ILU-preconditioned GMRES on this
host's CPU.

The reference (Firedrake/PETSc) is not installable in this image (no network
egress, no pip), and its companion paper's timing tables cannot be fetched
(arXiv:2410.09790, README.md:49).  What CAN be measured is an
equivalent-algorithm CPU implementation: the same global sparse operators
(assembled from this repo's verified element blocks), solved with the same
Krylov composition the reference's solver configs prescribe
(reference src/timesteppers/hdg_imex.py:128-170,223-255):

  per timestep (SSP2, projection, 2 Richardson):   [SURVEY.md section 3.1]
    4 x tentative velocity solves  - GMRES + ILU, rtol 1e-10
    6 x pressure solves            - condensed trace system, GMRES rtol 1e-12
                                     (SCPC condensation; GTMG replaced by ILU
                                      here — scipy has no AMG)

Solve-time only (operator assembly / TSFC kernel time excluded — in the
reference's favor).  Sizes beyond 128^2 are linearly extrapolated by cell
count (per-iteration work is linear and the reference's preconditioners are
designed for mesh-independent iteration counts).

Usage:  JAX_PLATFORMS=cpu python tools/cpu_baseline.py [nx ...]
Prints one table + a JSON line per size.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def build_matrices(nx, degree=2, with_gtmg=False):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from incompressibleeulerhdg.mesh.generators import unit_square_mesh
    from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
    from incompressibleeulerhdg.models.problems import TaylorGreen
    from incompressibleeulerhdg.linalg.condense import build_condensed_system
    from incompressibleeulerhdg.linalg.preconditioners import (
        build_tentative_operator,
    )
    from incompressibleeulerhdg.ops.forms import star_fields
    from incompressibleeulerhdg.ops.projection import build_bdm_projection, project_bdm

    disc = HDGDiscretisation(unit_square_mesh(nx), degree, dtype=jnp.float64)
    geom = disc.geom
    problem = TaylorGreen(disc)
    proj = build_bdm_projection(disc)
    Q0 = disc.interpolate_velocity(problem.initial_condition()[0])
    star = star_fields(geom, project_bdm(geom, proj, Q0))
    c = 0.5 * (1.0 / nx)
    op = build_tentative_operator(geom, star, c, 1.0, True)
    cs = build_condensed_system(disc, tau=1.0)

    nc, nf, n_int = geom.n_cells, geom.n_facets, geom.n_int
    nu = 2 * geom.d1
    nt = cs.nt
    mesh = disc.mesh

    # ---- tentative operator: cell-major dof numbering, dense blocks ----
    from incompressibleeulerhdg.linalg.preconditioners import dense_blocks

    D_bl, Bx_bl, Cx_bl = dense_blocks(geom, op)
    D = np.asarray(D_bl).transpose(2, 0, 1)  # (nc, nu, nu)
    Bx = np.asarray(Bx_bl).transpose(2, 0, 1)[:n_int]
    Cx = np.asarray(Cx_bl).transpose(2, 0, 1)[:n_int]
    fc = mesh.facet_cells[:n_int]

    ii = (np.arange(nc)[:, None, None] * nu + np.arange(nu)[None, :, None])
    jj = (np.arange(nc)[:, None, None] * nu + np.arange(nu)[None, None, :])
    rows = [np.broadcast_to(ii, D.shape).ravel()]
    cols = [np.broadcast_to(jj, D.shape).ravel()]
    vals = [D.ravel()]
    pi = (fc[:, 0][:, None, None] * nu + np.arange(nu)[None, :, None])
    mi = (fc[:, 1][:, None, None] * nu + np.arange(nu)[None, None, :])
    rows += [np.broadcast_to(pi, Bx.shape).ravel()]
    cols += [np.broadcast_to(mi, Bx.shape).ravel()]
    vals += [Bx.ravel()]
    rows += [np.broadcast_to(mi.transpose(0, 2, 1), Cx.shape).ravel()]
    cols += [np.broadcast_to(pi.transpose(0, 2, 1), Cx.shape).ravel()]
    vals += [Cx.ravel()]
    A_t = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nc * nu, nc * nu),
    ).tocsc()

    # ---- condensed trace operator: facet-major dof numbering ----
    S = np.asarray(cs.S).transpose(2, 0, 1)  # (nc, 3nt, 3nt)
    cfac = mesh.cell_facets  # (nc, 3)
    gdof = (cfac[:, :, None] * nt + np.arange(nt)[None, None, :]).reshape(nc, 3 * nt)
    ri = np.repeat(gdof[:, :, None], 3 * nt, axis=2)
    ci = np.repeat(gdof[:, None, :], 3 * nt, axis=1)
    S_g = sp.coo_matrix(
        (S.ravel(), (ri.ravel(), ci.ravel())), shape=(nf * nt, nf * nt)
    ).tocsc()

    gtmg_M = None
    t_gtmg = 0.0
    if with_gtmg:
        # mesh-independent trace preconditioner: the same two-level GTMG
        # composition the reference's PETSc stack applies (GTMGPC +
        # Chebyshev smoothing + coarse P1 solve, hdg_imex.py:128-170),
        # executed with this repo's verified V-cycle on the CPU backend.
        # scipy's ILU degrades superlinearly under refinement (85 -> 816 ->
        # 2355 its, BASELINE.md) and makes the anchor unfairly slow; the
        # GTMG anchor is the defensible measured stand-in.  Layout: scipy's
        # facet-major dof = f*nt + i
        # <-> the repo's trace-major (nt, nf) field via reshape+transpose.
        from incompressibleeulerhdg.linalg.gtmg import build_gtmg, gtmg_apply

        t0 = time.perf_counter()
        pc = build_gtmg(disc, cs)
        vcycle = jax.jit(lambda v: gtmg_apply(geom, cs, pc, v))
        # warm the compile outside the timed solve
        np.asarray(vcycle(jnp.zeros(nt * nf)))
        t_gtmg = time.perf_counter() - t0

        def gtmg_M(v):
            lam = jnp.asarray(v.reshape(nf, nt).T.ravel())
            z = np.asarray(vcycle(lam))
            return z.reshape(nt, nf).T.ravel()

    return A_t, S_g, gtmg_M, t_gtmg


def time_solve(A, rtol, label, maxiter=200, fill_factor=10.0, deflate=False,
               M_apply=None, t_setup=0.0):
    """Preconditioned GMRES on a seeded random RHS; returns (setup time
    once, per-solve time, iterations).

    Default preconditioner: ILU.  ``M_apply`` (a dense-vector callable)
    overrides it — used for the mesh-independent GTMG trace anchor.

    ``deflate=True`` projects out the constant nullspace (the trace system
    is singular exactly as the reference's pressure system is — PETSc
    handles it with an attached nullspace, hdg_imex.py:480-489); the ILU is
    built on a Tikhonov-shifted copy so the factorization is nonsingular.
    """
    n = A.shape[0]
    rng = np.random.default_rng(123456789)
    b = rng.standard_normal(n)
    ones = np.ones(n) / np.sqrt(n)

    def proj(v):
        return v - ones * (ones @ v) if deflate else v

    b = proj(b)
    if M_apply is not None:
        t_fact = t_setup
        M = spla.LinearOperator(A.shape, lambda v: proj(M_apply(proj(v))))
    else:
        t0 = time.perf_counter()
        A_f = A + 1e-8 * sp.identity(n, format="csc") if deflate else A
        ilu = spla.spilu(A_f, drop_tol=1e-5, fill_factor=fill_factor)
        t_fact = time.perf_counter() - t0
        M = spla.LinearOperator(A.shape, lambda v: proj(ilu.solve(proj(v))))
    Aop = spla.LinearOperator(A.shape, lambda v: proj(A @ proj(v)))
    its = {"n": 0}

    def cb(_):
        its["n"] += 1

    t0 = time.perf_counter()
    x, info = spla.gmres(
        Aop, b, rtol=rtol, restart=60, maxiter=maxiter, M=M, callback=cb,
        callback_type="pr_norm",
    )
    t_solve = time.perf_counter() - t0
    res = np.linalg.norm(proj(b - A @ proj(x))) / np.linalg.norm(b)
    print(
        f"  {label:>28s}: factor {t_fact:7.2f}s  solve {t_solve:7.2f}s  "
        f"its {its['n']:4d}  relres {res:.1e}  (n={A.shape[0]})"
    )
    return t_fact, t_solve, its["n"]


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [32, 64, 128]
    # trace ILU is only run at sizes where it is tractable (its iteration
    # count degrades superlinearly: 85/816/2355 at 64/128/256 — the 256 row
    # took 92 min/step in round 3); the GTMG anchor replaces it as the
    # defensible mesh-independent number (CPU_BASELINE_ILU=1 forces it)
    ilu_cap = 128 if os.environ.get("CPU_BASELINE_ILU") != "1" else 10**9
    results = []
    for nx in sizes:
        print(f"== nx={nx} k=2 ==", flush=True)
        t0 = time.perf_counter()
        A_t, S_g, gtmg_M, t_gtmg = build_matrices(nx, with_gtmg=True)
        print(f"  assembly(+element blocks): {time.perf_counter()-t0:.1f}s",
              flush=True)
        # tentative: GMRES+ILU rtol 1e-10 (hdg_imex.py:224-228)
        tf_t, ts_t, it_t = time_solve(A_t, 1e-10, "tentative GMRES+ILU")
        # pressure: condensed trace GMRES rtol 1e-12 (hdg_imex.py:135-137)
        # with the reference's own two-level GTMG composition
        tf_p, ts_p, it_p = time_solve(
            S_g, 1e-12, "trace GMRES+GTMG", deflate=True, M_apply=gtmg_M,
            t_setup=t_gtmg,
        )
        row = {"nx": nx,
               "tentative_s": ts_t, "tentative_factor_s": tf_t,
               "tentative_its": it_t,
               "pressure_s": ts_p, "pressure_its": it_p}
        if nx <= ilu_cap:
            _, ts_pi, it_pi = time_solve(
                S_g, 1e-12, "trace GMRES+ILU", deflate=True,
                maxiter=5000 // 60 + 1,
            )
            row["pressure_ilu_s"] = ts_pi
            row["pressure_ilu_its"] = it_pi
        # reference composition (SURVEY 3.1): 4 tentative + 6 pressure per
        # step; ILU refactorization happens once per stage for the tentative
        # operator (it changes with Q*): 2 stage factorizations per step.
        per_step = 4 * ts_t + 6 * ts_p + 2 * tf_t
        print(f"  per-step (4 tent + 6 press + 2 factor): {per_step:.2f}s",
              flush=True)
        row["per_step_s"] = per_step
        results.append(row)
        print(json.dumps(results[-1]), flush=True)
    if len(results) >= 2:
        # linear-in-cells extrapolation from the largest measured size
        r = results[-1]
        for target in (256, 512):
            scale = (target / r["nx"]) ** 2
            print(json.dumps({"nx": target, "per_step_s_extrapolated":
                              r["per_step_s"] * scale,
                              "from_measured_nx": r["nx"]}))


if __name__ == "__main__":
    main()
