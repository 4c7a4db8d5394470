"""Right-hand side of the IMEX pressure reconstruction solve.

Rebuild of the reference's ``b_rhs_pressure_reconstruction``
(reference src/timesteppers/hdg_imex.py:200-214):

    weak_div(psi, -f + (grad Q) Q) - mu (n . f) ds

where Q is the new velocity and f the forcing at t + dt.  The argument
G = -f + (grad Q) Q is evaluated pointwise: its cell divergence needs second
derivatives of Q (Hessian tabulations) and its facet traces need gradient
traces.  All fields batch-last: Q, f_nodal (2, d1, nc).
"""

import jax.numpy as jnp

from . import fields as F
from .forms import weak_divergence_values

__all__ = ["pressure_reconstruction_rhs", "facet_grad_traces"]


def facet_grad_traces(geom, u):
    """Physical gradient traces of a DG(k+1) field at facet quadrature.

    Returns (g_plus, g_minus), each (..., 2, nqf, nf); the new axis (before
    nqf) is the derivative direction.  Per-facet gradient-trace tables are
    assembled from the 6 static tables by one-hot sums over ``ftab``.
    """
    dtype = geom.wq.dtype
    d1 = geom.d1
    out = []
    for side in (0, 1):
        oh = (geom.ftab[side][None, :] == jnp.arange(6)[:, None]).astype(dtype)
        if geom.shift is not None:
            from .structured import gather_plus, gather_minus

            gp = gather_plus if side == 0 else gather_minus
            ug = gp(geom, u)  # (..., d1, nf)
            jinv = gp(geom, geom.jac_inv)  # (2=b, 2=a, nf)
        else:
            c = geom.fcells[side]
            ug = u[..., c]  # (..., d1, nf)
            jinv = geom.jac_inv[:, :, c]  # (2=b, 2=a, nf)
        # per-b reference-gradient traces, then the 2-term jac_inv
        # contraction — all elementwise FMAs (lane-batched einsums relayout)
        gref = []
        for b in (0, 1):
            Ub = sum(
                oh[t][None, None, :] * geom.tgphi1[t, :, :, b][:, :, None]
                for t in range(6)
            )  # (nqf, d1, nf)
            gref.append(
                sum(Ub[:, i, :] * ug[..., i, None, :] for i in range(d1))
            )
        phys = jnp.stack(
            [
                gref[0] * jinv[0, a][None, :] + gref[1] * jinv[1, a][None, :]
                for a in (0, 1)
            ],
            axis=-3,
        )
        out.append(phys)
    return out[0], out[1]


def convective_term(geom, Q):
    """(grad Q) Q = (Q . grad) Q at cell quadrature points: (2, nq, nc).

    UFL's ``dot(grad(Q), Q)`` (hdg_imex.py:205): (grad Q)_{ab} Q_b with
    (grad Q)_{ab} = d_b Q_a.
    """
    gQ = F.cell_grads(geom, geom.gphi1, Q)  # (2 comp a, 2 deriv d, nq, nc)
    Qq = F.cell_values(geom.phi1, Q)  # (2, nq, nc)
    return jnp.stack([gQ[a, 0] * Qq[0] + gQ[a, 1] * Qq[1] for a in (0, 1)])


def pressure_reconstruction_rhs(geom, Q, f_nodal):
    """(f_p, f_lam) rows of the reconstruction solve.

    :arg Q: new velocity (2, d1, nc)
    :arg f_nodal: forcing at t + dt interpolated into V_Q (2, d1, nc)
    :returns: (psi-rows (d0, nc), mu-rows (nt, nf))
    """
    # --- cell divergence of G = -f + (grad Q) Q ---------------------------
    gQ = F.cell_grads(geom, geom.gphi1, Q)  # (2 a, 2 d, nq, nc)
    Qq = F.cell_values(geom.phi1, Q)  # (2, nq, nc)
    # reference Hessian contraction: d_d d_e Q_a = hphi[q,i,b,f] jinv[b,d] jinv[f,e] Q[a,i]
    href = jnp.einsum("qibf,aic->abfqc", geom.hphi1, Q)  # (a, b, f, nq, nc)
    jinv = geom.jac_inv
    # d_d d_e Q_a = href[a, b, f] jinv[b, d] jinv[f, e]: unrolled 2x2
    # elementwise contractions (batched einsums would transpose);
    # div((grad Q) Q) = (d_a d_b Q_a) Q_b + (d_b Q_a)(d_a Q_b)
    def hp(a, d, e):
        return sum(
            href[a, b, f] * (jinv[b, d] * jinv[f, e])[None, :]
            for b in (0, 1)
            for f in (0, 1)
        )

    term1 = sum(hp(a, a, b) * Qq[b] for a in (0, 1) for b in (0, 1))
    term2 = sum(gQ[a, d] * gQ[d, a] for a in (0, 1) for d in (0, 1))
    divG = -F.cell_div(geom, f_nodal) + term1 + term2

    # --- facet normal traces of G ----------------------------------------
    f0, f1 = F.facet_traces(geom, geom.tphi1, f_nodal)  # (2, nqf, nf)
    Q0, Q1 = F.facet_traces(geom, geom.tphi1, Q)
    g0, g1 = facet_grad_traces(geom, Q)  # (2 a, 2 d, nqf, nf)
    G0 = jnp.stack([g0[a, 0] * Q0[0] + g0[a, 1] * Q0[1] for a in (0, 1)]) - f0
    G1 = jnp.stack([g1[a, 0] * Q1[0] + g1[a, 1] * Q1[1] for a in (0, 1)]) - f1
    n = geom.normal
    Gn0 = G0[0] * n[0][None, :] + G0[1] * n[1][None, :]
    Gn1 = G1[0] * n[0][None, :] + G1[1] * n[1][None, :]

    f_p = weak_divergence_values(geom, divG, Gn0, Gn1)

    # --- boundary mu-row: -mu (n . f) ds ---------------------------------
    fn0 = f0[0] * geom.normal[0][None, :] + f0[1] * geom.normal[1][None, :]
    bnd = 1.0 - F.interior_mask(geom)
    f_lam = -F.facet_integrate_trace(geom, fn0 * bnd)
    return f_p, f_lam
