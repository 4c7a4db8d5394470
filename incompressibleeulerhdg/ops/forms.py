"""Batched weak-form kernels for the HDG incompressible Euler discretisation.

Each function evaluates one of the reference's composable UFL forms as test
function coefficients, given trial fields as coefficient arrays:

- :func:`f_impl_apply`          <- ``_f_impl`` (hdg_imex.py:313-331)
- :func:`pressure_gradient_apply` <- ``_pressure_gradient`` (hdg_imex.py:333-340)
- :func:`gamma_apply`           <- ``_Gamma`` (hdg_imex.py:342-351)
- :func:`weak_divergence_apply` <- ``_weak_divergence`` (hdg_imex.py:353-365)
- :func:`trace_mass_apply` / :func:`reconstruct_trace_rhs`
                                <- ``_reconstruct_trace`` (hdg_imex.py:450-469)

All fields are batch-last (velocity (2, d1, nc), pressure (d0, nc), trace
(nt, nf) — see fem/discretisation.py).

Facet-sign conventions: the stored facet normal ``n_f`` points out of the plus
cell; all UFL ``dS`` terms above are orientation-invariant, and reduce to the
expressions implemented here (derivations in each docstring).  Terms involving
``Q_star("+")`` use the plus-side trace exactly as the reference does.
"""

import jax.numpy as jnp

from .fields import (
    cell_values,
    cell_grads,
    cell_div,
    facet_traces,
    facet_trace_plus,
    trace_values,
    scatter_facets,
    facet_integrate_trace,
    cell_integrate,
    interior_mask,
)

__all__ = [
    "star_fields",
    "f_impl_apply",
    "pressure_gradient_apply",
    "gamma_apply",
    "weak_divergence_apply",
    "weak_divergence_values",
    "trace_mass_apply",
    "reconstruct_trace_rhs",
]


def _dot_normal(geom, v):
    """v[..., a, q, f] . n[a, f] -> (..., q, f): 2-term elementwise sum (an
    einsum here triggers XLA's batched-dot relayout path)."""
    n = geom.normal
    return v[..., 0, :, :] * n[0][None, :] + v[..., 1, :, :] * n[1][None, :]


def star_fields(geom, Qstar):
    """Precompute the advecting-velocity fields used by ``f_impl``.

    Returns (Q* nodal coefficients (2, d1, nc),
             plus-trace normal component Q*("+").n at facet quadrature
             (nqf, nf)).
    Cell-quadrature values are recomputed on demand by consumers.
    """
    q0 = facet_trace_plus(geom, geom.tphi1, Qstar)  # (2, nqf, nf)
    qn = _dot_normal(geom, q0)
    return Qstar, qn


def _convect(geom, star_q, u):
    """(Q*.grad) u at cell quadrature: (2, nq, nc).

    conv[a] = star_d du_a/dx_d with du_a/dx_d = gphi[q,j,b] jinv[b,d] u[a,j].
    """
    jinv = geom.jac_inv
    R = jnp.stack(
        [
            jinv[b, 0][None, :] * star_q[0] + jinv[b, 1][None, :] * star_q[1]
            for b in (0, 1)
        ]
    )  # (2=b, nq, nc)
    gphi = geom.gphi1  # (nq, d1, 2) static
    GP = sum(gphi[:, :, b].T[:, :, None] * R[b][None, :, :] for b in (0, 1))
    d1 = u.shape[-2]
    return sum(GP[j][None, :, :] * u[..., j, None, :] for j in range(d1))


def f_impl_apply(geom, star, u, alpha=1.0, upwind=True):
    """Coefficients of ``f_impl(w, u, Q*)`` (reference hdg_imex.py:313-331).

    f_impl = + int_dS (Q*+.n+)(u+ - u-).avg(w)
             - int_dx (w otimes Q*) : grad u
             - alpha [ int_dS (1/h_F)((u+-u-).n)((w+-w-).n) + int_ds (1/h)(u.n)(w.n) ]
             - upwind: int_dS |Q*+.n+| (u+-u-).(w+-w-)

    (the 4*avg(1/h)avg(u.n)avg(w.n) form of the penalty equals the jump form
    above because avg(u.n) = (u+ - u-).n_f / 2 and 1/h_F is single-valued).
    """
    star_coeff, star_n = star
    star_q = cell_values(geom.phi1, star_coeff)  # (2, nq, nc)
    # volume: -(w, (Q*.grad) u)
    conv = _convect(geom, star_q, u)
    r = -cell_integrate(geom, geom.phi1, conv)

    u0, u1 = facet_traces(geom, geom.tphi1, u)  # (2, nqf, nf)
    mask = interior_mask(geom, 3)
    jump = (u0 - u1) * mask
    jn = _dot_normal(geom, jump)
    nrm = geom.normal[:, None, :]  # (2, 1, nf)
    hinv = geom.hF_inv[None, :]

    # interior: advective + penalty + upwind (g0/g1 multiply w+ / w- traces)
    g0 = 0.5 * star_n[None] * jump
    g1 = 0.5 * star_n[None] * jump
    pen = (alpha * hinv * jn)[None] * nrm
    g0 = g0 - pen
    g1 = g1 + pen
    if upwind:
        upw = jnp.abs(star_n)[None] * jump
        g0 = g0 - upw
        g1 = g1 + upw
    # boundary: -alpha (1/h)(u.n)(w.n) on the plus side
    u0n = _dot_normal(geom, u0)
    bnd = -(alpha * hinv * u0n)[None] * nrm * (1.0 - mask)
    g0 = g0 + bnd
    return r + scatter_facets(geom, geom.tphi1, g0, g1)


def _div_test_coeffs(geom, scalar_q):
    """Coefficients of int scalar * div(w) dx for vector test functions w.

    (nq, nc) -> (2, d1, nc):  d phi_i/dx_a = gphi[q,i,b] jinv[b,a].
    """
    t = jnp.einsum("q,qib,qc->ibc", geom.wq, geom.gphi1, scalar_q)
    jinv = geom.jac_inv
    return geom.det_jac * jnp.stack(
        [
            t[:, 0, :] * jinv[0, a][None, :] + t[:, 1, :] * jinv[1, a][None, :]
            for a in (0, 1)
        ]
    )


def pressure_gradient_apply(geom, p, lam):
    """Coefficients of ``g(w, p, lambda)`` (reference hdg_imex.py:333-340).

    g = int_dx p div w - int_dS lambda (w+ - w-).n - int_ds lambda w.n
    """
    p_q = cell_values(geom.phi0, p)  # (nq, nc)
    gw = _div_test_coeffs(geom, p_q)
    lam_q = trace_values(geom, lam)  # (nqf, nf)
    nrm = geom.normal[:, None, :]
    g0 = -lam_q[None] * nrm  # interior and boundary have the same plus term
    g1 = +lam_q[None] * nrm
    return gw + scatter_facets(geom, geom.tphi1, g0, g1)


def pressure_gradient_dg_apply(geom, p):
    """u-row coefficients of the *trace-free* DG pressure coupling used by the
    DG scheme (reference src/timesteppers/dg_implicit.py:56-58):

    g_DG(w, p) = int p div w - int_dS (w+ - w-).n avg(p) - int_ds (w.n) p
    """
    p_q = cell_values(geom.phi0, p)
    gw = _div_test_coeffs(geom, p_q)
    p0, p1 = facet_traces(geom, geom.tphi0, p)
    mask = interior_mask(geom)
    pavg = jnp.where(mask > 0, 0.5 * (p0 + p1), p0)
    nrm = geom.normal[:, None, :]
    g0 = -pavg[None] * nrm
    g1 = +pavg[None] * nrm
    return gw + scatter_facets(geom, geom.tphi1, g0, g1)


def gamma_apply(geom, u, p, lam, tau=1.0):
    """Coefficients of ``Gamma(psi, mu, u, p, lambda; tau)`` (hdg_imex.py:342-351).

    psi-rows: int psi div u + sum_sides tau (p_side - lambda) psi_side (dS)
              + tau (p - lambda) psi (ds)
    mu-rows:  int_dS mu [ (u+-u-).n + tau (p+ + p- - 2 lambda) ]
              + int_ds mu [ u.n + tau (p - lambda) ]
    """
    divu = cell_div(geom, u)
    rp = cell_integrate(geom, geom.phi0, divu)

    u0, u1 = facet_traces(geom, geom.tphi1, u)
    p0, p1 = facet_traces(geom, geom.tphi0, p)
    lam_q = trace_values(geom, lam)
    mask = interior_mask(geom)

    # psi-rows on facets: tau (p_side - lambda) for each side
    g0 = tau * (p0 - lam_q)
    g1 = tau * (p1 - lam_q)
    rp = rp + scatter_facets(geom, geom.tphi0, g0, g1)

    # mu-rows
    un0 = _dot_normal(geom, u0)
    un1 = _dot_normal(geom, u1)
    interior = (un0 - un1) + tau * (p0 + p1 - 2.0 * lam_q)
    boundary = un0 + tau * (p0 - lam_q)
    rl = facet_integrate_trace(geom, jnp.where(mask > 0, interior, boundary))
    return rp, rl


def weak_divergence_values(geom, Q_q, Qn0, Qn1):
    """psi-row coefficients of ``_weak_divergence`` from quadrature-point data.

    weak_div(psi, Q) = int psi div Q - int_dS avg(psi) (Q+ - Q-).n
                       - int_ds psi Q.n                      (hdg_imex.py:353-365)

    :arg Q_q: divergence values at cell quadrature (nq, nc)
    :arg Qn0/Qn1: plus/minus normal traces Q_side.n_f at facet quadrature (nqf, nf)
    """
    rp = cell_integrate(geom, geom.phi0, Q_q)
    mask = interior_mask(geom)
    jumpn = (Qn0 - Qn1) * mask
    g0 = -0.5 * jumpn - (1.0 - mask) * Qn0
    g1 = -0.5 * jumpn
    return rp + scatter_facets(geom, geom.tphi0, g0, g1)


def weak_divergence_apply(geom, Q):
    """psi-row coefficients of ``_weak_divergence(psi, Q)`` for a DG velocity Q."""
    divq = cell_div(geom, Q)
    Q0, Q1 = facet_traces(geom, geom.tphi1, Q)
    Qn0 = _dot_normal(geom, Q0)
    Qn1 = _dot_normal(geom, Q1)
    return weak_divergence_values(geom, divq, Qn0, Qn1)


def trace_mass_apply(geom, lam, tau=1.0):
    """Apply the trace 'mass' operator ``2 tau (lam+, mu+) dS + tau (lam, mu) ds``.

    This is the LHS of the trace reconstruction solve (hdg_imex.py:462) —
    block-diagonal per facet: (2 tau | tau) * L_f * M_trace_ref.
    """
    fac = jnp.where(interior_mask(geom, 1) > 0, 2.0 * tau, tau)
    lam_q = trace_values(geom, lam)
    return fac[None, :] * facet_integrate_trace(geom, lam_q)


def reconstruct_trace_rhs(geom, Q, p, tau=1.0):
    """RHS of the t=0 trace reconstruction (hdg_imex.py:463-466): (nt, nf).

    2 avg((Q.n + tau p) mu) dS + (Q.n + tau p) mu ds
      = [ (Q+-Q-).n + tau (p+ + p-) ] mu   (interior)
        [ Q.n + tau p ] mu                 (boundary)
    """
    Q0, Q1 = facet_traces(geom, geom.tphi1, Q)
    p0, p1 = facet_traces(geom, geom.tphi0, p)
    un0 = _dot_normal(geom, Q0)
    un1 = _dot_normal(geom, Q1)
    mask = interior_mask(geom)
    interior = (un0 - un1) + tau * (p0 + p1)
    boundary = un0 + tau * p0
    return facet_integrate_trace(geom, jnp.where(mask > 0, interior, boundary))
