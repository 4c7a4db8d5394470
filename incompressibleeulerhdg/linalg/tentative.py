"""Tentative (advective) velocity solve.

Equivalent of the reference's per-stage tentative velocity solver
(GMRES + ILU, rtol 1e-10; reference src/timesteppers/hdg_imex.py:223-255
and the in-loop solve of hdg_implicit.py:103-129).  The operator is

    a(u, w) = (w, u) - c * f_impl(w, u, Q*),    c = a_ii * dt

which couples neighbouring cells through the advective/penalty/upwind facet
terms.  The production path uses an assembled TentativeOperator (``op=``):
block-SpMV matvec + multiplicative colored facet-pair Schwarz preconditioner
(falling back to the additive sweep when the mesh carries no facet coloring),
both built once per stage.  All fields are batch-last (2, d1, nc).
"""

import os

import jax.numpy as jnp

from ..ops.fields import mass_apply
from ..ops.forms import f_impl_apply
from .krylov import gmres, gmres_right
from .preconditioners import (
    build_tentative_operator,
    _matvec_bl,
    _patch_apply_bl,
    _colored_apply_bl,
    _colored_apply_fused_bl,
)

__all__ = ["tentative_matvec", "tentative_solve"]


def tentative_matvec(geom, star, u, c, alpha=1.0, upwind=True):
    """Apply the tentative-velocity operator M - c * f_impl(., Q*) from the
    weak form (reference path for verifying the assembled operator)."""
    return mass_apply(geom, geom.m1, u) - c * f_impl_apply(geom, star, u, alpha, upwind)


def tentative_solve(
    geom,
    star,
    rhs,
    c,
    *,
    alpha=1.0,
    upwind=True,
    rtol=1.0e-10,
    restart=40,
    maxiter=200,
    op=None,
    colored=True,
    sweeps=1,
    symmetric=True,
    fused=None,
):
    """Solve (M - c f_impl) u = rhs.  Returns (u (2, d1, nc), iters, relres).

    Preconditioner: multiplicative colored facet-pair Schwarz (the analogue
    of the reference's ILU: exact patch solves swept color by color
    resolve the one-sided facet couplings sequentially, keeping iteration
    counts low where block Jacobi degrades like 1/h).

    :arg sweeps: multiplicative sweeps per preconditioner application
    :arg symmetric: sweep the colors forward then backward (block-SSOR-like);
        roughly doubles the per-application cost but cuts GMRES iterations
        by more (the reference's ILU plays this role, hdg_imex.py:224-228)
    :arg restart: GMRES restart length; the full solve should fit inside one
        cycle — restarting loses superlinear convergence
    :arg fused: override the IEHDG_TENT_FUSED env default (0 = the
        left-preconditioned sweep+matvec composition, 1 = fused
        right-preconditioned GMRES with exact A z, 2 = fully fused with the
        free A z = v - r)
    """
    shape = rhs.shape
    nu = shape[0] * shape[1]
    nc = shape[2]
    if op is None:
        op = build_tentative_operator(geom, star, c, alpha, upwind)

    def matvec(v):
        return _matvec_bl(geom, op, v.reshape(nu, nc)).ravel()

    from ..ops.structured import dist_axis

    # fused right-preconditioned path (structured meshes): the sweep's
    # incremental residuals skip the full inter-color matvecs, so each
    # Arnoldi step costs ONE sweep + one matvec (IEHDG_TENT_FUSED=1,
    # default: exact A z) or just one sweep (=2: the free A z = v - r,
    # subject to the f32 cancellation noted in the sweep's docstring) —
    # the dominant per-iteration saving at production sizes (BASELINE.md
    # roofline).  IEHDG_TENT_FUSED=0 falls back to the left-preconditioned
    # composition.
    fused_mode = os.environ.get("IEHDG_TENT_FUSED", "1") if fused is None else str(fused)
    fused = (
        colored
        and geom.fcol_pos is not None
        and geom.shift is not None
        and not geom.fcol_orphans
        and fused_mode in ("1", "2")
    )
    if fused:
        exact_Az = fused_mode == "1"

        def opM(v):
            vb = v.reshape(nu, nc)
            z, Az = _colored_apply_fused_bl(
                geom, op, vb, symmetric=symmetric, exact_Az=exact_Az
            )
            for _ in range(sweeps - 1):
                dz, Adz = _colored_apply_fused_bl(
                    geom, op, vb - Az, symmetric=symmetric, exact_Az=exact_Az
                )
                z = z + dz
                Az = Az + Adz
            return z.ravel(), Az.ravel()

        u, iters, relres = gmres_right(
            opM, matvec, rhs.ravel(), rtol=rtol, restart=restart,
            maxiter=maxiter, axis_name=dist_axis(geom),
        )
        return u.reshape(shape), iters, relres

    if colored and geom.fcol_pos is not None:
        def M(v):
            rb = v.reshape(nu, nc)
            z = _colored_apply_bl(geom, op, rb, symmetric=symmetric)
            for _ in range(sweeps - 1):
                rk = rb - _matvec_bl(geom, op, z)
                z = z + _colored_apply_bl(geom, op, rk, symmetric=symmetric)
            return z.ravel()
    else:
        def M(v):
            return _patch_apply_bl(geom, op, v.reshape(nu, nc)).ravel()

    u, iters, relres = gmres(
        matvec, rhs.ravel(), M=M, rtol=rtol, restart=restart, maxiter=maxiter,
        axis_name=dist_axis(geom),
    )
    return u.reshape(shape), iters, relres
