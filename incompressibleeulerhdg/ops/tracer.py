"""Passive tracer advection: upwind DG transport against a DG mass matrix.

Rebuild of ``IncompressibleEuler._tracer_advection``
(reference src/timesteppers/common.py:110-129) and the per-step tracer
solves of every scheme (e.g. hdg_implicit.py:94-96,193).

The advection form (explicit Euler within a step, explicit tableau in IMEX):

    adv(chi, q, u) = int_dx q div(chi u)
                     - int_dS (chi+ - chi-) (un+ q+ - un- q-)
    un = (u.n + |u.n|) / 2 per side (upwind flux)

The reference projects the advecting velocity onto a continuous CG space
first (common.py:121-122); that projection lives in ops/cg_projection.py and
is applied by the timesteppers before calling :func:`tracer_advection_apply`
when ``project_onto_cg`` is requested.
"""

import jax.numpy as jnp

from . import fields as F

__all__ = ["tracer_advection_apply", "tracer_step"]


def tracer_advection_apply(geom, q, u):
    """Coefficients of adv(chi, q, u) in the DG(k) tracer test space.

    :arg q: tracer (d0, nc)
    :arg u: advecting velocity (2, d1, nc) — assumed (approximately)
        continuous; facet fluxes use each side's own trace as the reference
        does after CG projection
    """
    # volume: q (u . grad chi + chi div u)
    q_q = F.cell_values(geom.phi0, q)  # (nq, nc)
    u_q = F.cell_values(geom.phi1, u)  # (2, nq, nc)
    divu = F.cell_div(geom, u)  # (nq, nc)
    # int q u_a dchi_i/dx_a: per reference-gradient direction b, a static
    # GEMM against (wq-weighted) q * (jinv u) -- the jinv contraction is a
    # 2-term elementwise sum (a batched einsum would transpose)
    jinv = geom.jac_inv
    r = 0.0
    for b in (0, 1):
        ua_b = jinv[b, 0][None, :] * u_q[0] + jinv[b, 1][None, :] * u_q[1]
        r = r + jnp.einsum("q,qi,qc->ic", geom.wq, geom.gphi0[:, :, b], q_q * ua_b)
    r = geom.det_jac * r
    r = r + F.cell_integrate(geom, geom.phi0, q_q * divu)

    # facet: -(chi+ - chi-)(un+ q+ - un- q-), interior only
    q0, q1 = F.facet_traces(geom, geom.tphi0, q)
    u0, u1 = F.facet_traces(geom, geom.tphi1, u)
    n = geom.normal
    un0 = u0[0] * n[0][None, :] + u0[1] * n[1][None, :]
    un1 = -(u1[0] * n[0][None, :] + u1[1] * n[1][None, :])  # minus side outward
    up0 = 0.5 * (un0 + jnp.abs(un0))
    up1 = 0.5 * (un1 + jnp.abs(un1))
    flux = (up0 * q0 - up1 * q1) * F.interior_mask(geom)
    g0 = -flux
    g1 = +flux
    return r + F.scatter_facets(geom, geom.tphi0, g0, g1)


def cg_project_velocity(geom, cg_space, u):
    """Project a DG(k+1) velocity onto vector CG(k+1) and return it in the DG
    nodal layout (2, d1, nc).

    The reference projects the advecting velocity onto CG before the tracer
    flux (common.py:119-122).  The CG(k+1) lattice nodes coincide with the
    DG(k+1) nodes (same equispaced lattice, same ordering), so the projected
    field converts back by a pure gather and all DG machinery applies — its
    facet traces are continuous by construction.
    """
    from ..fem.cg import cg_project_dg, cg_gather

    x, _ = cg_project_dg(geom, cg_space, u)  # (2, n_dofs)
    return cg_gather(cg_space, x)


def tracer_step(geom, q, u, dt, cg_space=None):
    """One explicit tracer step: solve M q_new = M q + dt adv(chi, q, u_cg).

    :arg cg_space: optional CGSpace of degree k+1; when given, the advecting
        velocity is CG-projected first (project_onto_cg=True of the reference)
    """
    if cg_space is not None:
        u = cg_project_velocity(geom, cg_space, u)
    b = F.mass_apply(geom, geom.m0, q) + dt * tracer_advection_apply(geom, q, u)
    return F.mass_solve(geom, geom.m0inv, b)
