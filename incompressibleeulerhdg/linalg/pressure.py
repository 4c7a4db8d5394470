"""The HDG mixed-Poisson pressure solve: condense -> Krylov on traces -> recover.

This is the equivalent of the reference's
``pressure_solve`` (reference src/timesteppers/hdg_imex.py:257-272):
SCPC static condensation is the batched Schur-complement pipeline in
``linalg/condense.py``, the condensed-field GMRES (rtol 1e-12,
hdg_imex.py:135-137) is the deflated matrix-free GMRES below, and the
GTMG preconditioner is (round 1) a facet-block-Jacobi / (later) two-level
scheme.  The returned iteration count mirrors
``condensed_ksp.getIterationNumber()`` (hdg_imex.py:265-271).
"""

import jax.numpy as jnp

from .condense import trace_matvec, condense_rhs, back_substitute
from .krylov import gmres, deflate_constant
from .preconditioners import trace_block_jacobi

__all__ = ["pressure_solve"]


def pressure_solve(
    geom,
    cs,
    f_u,
    f_p,
    f_lam,
    *,
    rtol=1.0e-12,
    restart=30,
    maxiter=500,
    precond=None,
):
    """Solve the condensed HDG mixed-Poisson system for (u, p, lam).

    :arg f_u: u-row right-hand side (2, d1, nc)
    :arg f_p: psi-row right-hand side (d0, nc)
    :arg f_lam: mu-row right-hand side (nt, nf)
    :returns: (u, p, lam, iteration count, final preconditioned relative
        residual — a stalled solve is then visible to callers instead of
        silently indistinguishable from a converged one)
    """
    from ..ops.structured import dist_axis

    ax = dist_axis(geom)
    g = condense_rhs(geom, cs, f_u, f_p, f_lam).ravel()
    nt = cs.nt

    def matvec(v):
        return trace_matvec(geom, cs, v.reshape(nt, -1)).ravel()

    M = precond if precond is not None else trace_block_jacobi(cs)
    project = deflate_constant(cs.nullvec.ravel(), axis_name=ax)
    lam_flat, iters, relres = gmres(
        matvec, g, M=M, rtol=rtol, restart=restart, maxiter=maxiter,
        project=project, axis_name=ax,
    )
    lam = lam_flat.reshape(nt, -1)
    u, p = back_substitute(geom, cs, f_u, f_p, lam)
    return u, p, lam, iters, relres
