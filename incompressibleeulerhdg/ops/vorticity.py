"""Vorticity projection for animation output.

Rebuild of the cached vorticity solver in
reference src/auxilliary/callbacks.py:43-69: project the weak curl of
the DG velocity onto CG(k+1),

    (tau, xi)_CG = -int (d_x tau Q_y - d_y tau Q_x) dx
                   + oint tau (n_x Q_y - n_y Q_x) ds
"""

import jax.numpy as jnp

from . import fields as F
from ..fem.cg import cg_scatter, cg_mass_solve

__all__ = ["vorticity_project"]


def vorticity_project(disc, space, Q, gphi_cg, tphi_cg, rtol=1e-12):
    """Project the weak curl of Q onto the CG space.

    :arg gphi_cg: (nq, nloc, 2) reference gradients of the CG basis at cell quad
    :arg tphi_cg: (6, nqf, nloc) facet traces of the CG basis
    :returns: (omega (n_dofs,), iters)
    """
    geom = disc.geom
    Qq = F.cell_values(geom.phi1, Q)  # (2, nq, nc)
    # physical gradients of the CG basis: (2=a, nq, nloc, nc)
    gphys = jnp.einsum("qib,bac->aqic", gphi_cg, geom.jac_inv)
    vol = -jnp.einsum(
        "c,q,qic,qc->ic", geom.det_jac, geom.wq, gphys[0], Qq[1]
    ) + jnp.einsum("c,q,qic,qc->ic", geom.det_jac, geom.wq, gphys[1], Qq[0])
    b = cg_scatter(space, vol)

    # boundary: + tau (n_x Q_y - n_y Q_x) ds (plus side only on boundary facets)
    Q0, _ = F.facet_traces(geom, geom.tphi1, Q)  # (2, nqf, nf)
    integrand = geom.normal[0][None, :] * Q0[1] - geom.normal[1][None, :] * Q0[0]
    bnd = 1.0 - F.interior_mask(geom)
    w = geom.wqf[:, None] * geom.flen[None, :]
    oh0 = (geom.ftab[0][None, :] == jnp.arange(6)[:, None]).astype(Q.dtype)
    T0 = jnp.einsum("tf,tqi->iqf", oh0, tphi_cg)  # (nloc, nqf, nf)
    contrib = jnp.einsum("qf,iqf,qf->if", w, T0, integrand * bnd)
    loc = jnp.zeros((T0.shape[0], geom.n_cells), dtype=Q.dtype)
    loc = loc.at[:, geom.fcells[0]].add(contrib)
    b = b + cg_scatter(space, loc)

    return cg_mass_solve(geom, space, b, rtol=rtol)
