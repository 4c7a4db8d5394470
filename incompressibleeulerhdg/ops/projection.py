"""BDM projection: H(div)-conforming averaging of a DG velocity.

Rebuild of ``IncompressibleEuler.project_bdm``
(reference src/timesteppers/common.py:91-108), which interpolates the DG
velocity into BDM(k+1) with INC (sum) accesses, divides by dof multiplicity
(i.e. *averages* the facet dofs contributed by both neighbouring cells), and
applies a zero-normal boundary condition.

Because BDM_r on a triangle is the *complete* vector polynomial space
[P_r]^2, the projected field lives in the same nodal DG(k+1) layout as the
input; only its dof values change.  The projection is characterised by
(basis-independent, hence Firedrake-parity) moments:

- facet:    (Q*.n)|_e = avg of the two normal traces of Q, for every e
            (exact, since both traces are already in P_r(e)); 0 on boundary
- interior: int_K Q*.v = int_K Q.v   for all v in Nedelec N1_{r-1}(K)

The runtime pipeline is three batched einsums:
  (1) averaged facet normal moments against orthonormal Legendre polynomials,
  (2) interior Nedelec moments,
  (3) per-cell dense reconstruction solve Q* = R_c @ dofs_c.
R_c depends only on the cell's geometry class (Jacobian + facet orientations +
boundary pattern), so on structured meshes only a handful of distinct
matrices exist; they are gathered by a per-cell class index.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..fem.lagrange import shifted_legendre
from .fields import cell_values, facet_traces, interior_mask

__all__ = ["BDMProjection", "build_bdm_projection", "project_bdm"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["leg", "vhat", "recon", "class_id"],
    meta_fields=["n_moments", "n_interior_dofs"],
)
@dataclass
class BDMProjection:
    """Device tables for the BDM(k+1) projection pipeline."""

    leg: jnp.ndarray  # (nqf, r+1) orthonormal Legendre at facet quadrature
    vhat: jnp.ndarray  # (nj, nq, 2) Nedelec span on reference cell (nj may be 0)
    recon: jnp.ndarray  # (n_classes, 2*d1, 2*d1) reconstruction matrices
    class_id: jnp.ndarray  # (nc,) int32
    n_moments: int = 0  # r+1
    n_interior_dofs: int = 0  # (r-1)(r+1)


def _nedelec_span(m, qp):
    """Spanning set of the 2-D first-kind Nedelec space N1_m at points qp.

    N1_m = [P_{m-1}]^2  (+)  { h(x,y) (-y, x) : h homogeneous of degree m-1 }.
    Returns (dim, npts, 2) with dim = m (m + 2); m = 0 gives an empty set.
    """
    if m == 0:
        return np.zeros((0, qp.shape[0], 2))
    x, y = qp[:, 0], qp[:, 1]
    vs = []
    for tot in range(m):
        for i in range(tot + 1):
            mono = x**i * y ** (tot - i)
            vs.append(np.stack([mono, np.zeros_like(mono)], -1))
            vs.append(np.stack([np.zeros_like(mono), mono], -1))
    for i in range(m):
        h = x**i * y ** (m - 1 - i)
        vs.append(np.stack([-y * h, x * h], -1))
    return np.stack(vs)


def _amajor_perm(d1):
    """Permutation taking an i-major (i*2+a) local u-dof vector to the
    component-major (a*d1+i) convention of the batch-last field layout."""
    return np.array([i * 2 + a for a in range(2) for i in range(d1)])


def cell_geometry_classes(mesh, extra=None):
    """Deduplicate cells by geometry signature.

    Two cells share a class iff they have the same Jacobian, facet orientation
    flips, facet normal signs, and boundary-facet pattern — then all their
    dense element matrices coincide.  Returns (class_id (nc,), representative
    cell indices (n_classes,)).
    """
    flips = mesh.facet_flip[mesh.cell_facets, mesh.cell_facet_side]
    bnd = (mesh.cell_facets >= mesh.n_interior_facets).astype(np.int64)
    sig = np.concatenate(
        [
            np.round(mesh.jac.reshape(-1, 4), 12),
            flips.astype(np.float64),
            mesh.cell_facet_side.astype(np.float64),
            bnd.astype(np.float64),
        ]
        + ([extra] if extra is not None else []),
        axis=1,
    )
    uniq, class_id, reps = _unique_rows(sig)
    return class_id.astype(np.int32), reps


def _unique_rows(a):
    view = np.ascontiguousarray(a).view([("", a.dtype)] * a.shape[1]).ravel()
    uniq, reps, inverse = np.unique(view, return_index=True, return_inverse=True)
    return uniq, inverse, reps


def build_bdm_projection(disc):
    """Build the BDMProjection tables for an HDGDiscretisation (setup, numpy)."""
    mesh = disc.mesh
    k = disc.degree
    r = k + 1
    V1, Vt = disc.V1, disc.Vt
    d1 = V1.ndof
    n = 2 * d1
    nm = r + 1
    nj = (r - 1) * (r + 1)

    leg = shifted_legendre(r, Vt.sq)  # (nqf, r+1)
    vhat = _nedelec_span(r - 1, V1.qp)  # (nj, nq, 2)

    class_id, reps = cell_geometry_classes(mesh)

    # build D_rep for representative cells only
    nc_r = reps.shape[0]
    D = np.zeros((nc_r, n, n))
    jac_inv = mesh.jac_inv[reps]
    det = mesh.det_jac[reps]
    normals = mesh.normals
    for l in range(3):
        f = mesh.cell_facets[reps, l]
        side = mesh.cell_facet_side[reps, l]
        flip = mesh.facet_flip[f, side]
        tab = V1.tphi[2 * l + flip]  # (nc_r, nqf, d1)
        sign = np.where(side == 0, 1.0, -1.0)
        n_out = sign[:, None] * normals[f]  # (nc_r, 2)
        L = mesh.facet_lengths[f]
        rows = np.einsum("c,q,qm,cqi,ca->cmia", L, Vt.wq, leg, tab, n_out)
        D[:, l * nm : (l + 1) * nm, :] = rows.reshape(nc_r, nm, n)
    if nj > 0:
        # interior: int_K phi_i e_a . (jac_inv^T vhat_j) dx
        rows = np.einsum("c,q,qi,cba,jqb->cjia", det, V1.qw, V1.phi, jac_inv, vhat)
        D[:, 3 * nm :, :] = rows.reshape(nc_r, nj, n)

    # rows permuted to the component-major (a*d1+i) batch-last dof layout
    recon = np.linalg.inv(D)[:, _amajor_perm(d1), :]

    f = lambda a: jnp.asarray(a, dtype=disc.dtype)
    return BDMProjection(
        leg=f(leg),
        vhat=f(vhat),
        recon=f(recon),
        class_id=jnp.asarray(class_id),
        n_moments=nm,
        n_interior_dofs=nj,
    )


def project_bdm(geom, proj, Q):
    """Apply the BDM projection: (2, d1, nc) -> (2, d1, nc), jittable.

    Mirrors reference common.py:91-108 (interpolate-with-averaging + zero
    normal boundary condition).
    """
    d1 = geom.d1
    # (1) averaged facet normal moments (zero on boundary facets = the
    #     DirichletBC((0,0), "on_boundary") of the reference)
    Q0, Q1 = facet_traces(geom, geom.tphi1, Q)  # (2, nqf, nf)
    mask = interior_mask(geom, 1)
    n = geom.normal
    qsum = Q0 + Q1
    avg_n = 0.5 * (qsum[0] * n[0][None, :] + qsum[1] * n[1][None, :]) * mask[None, :]
    w = geom.wqf[:, None] * geom.flen[None, :]
    m_f = jnp.einsum("qf,qm,qf->mf", w, proj.leg, avg_n)  # (nm, nf)

    # (2) interior Nedelec moments: im[j, c] = det wq Q_a jinv[b, a] vhat[j, b]
    if proj.n_interior_dofs > 0:
        Qq = cell_values(geom.phi1, Q)  # (2, nq, nc)
        jinv = geom.jac_inv
        im = 0.0
        for b in (0, 1):
            Vb = jinv[b, 0][None, :] * Qq[0] + jinv[b, 1][None, :] * Qq[1]
            im = im + jnp.einsum("q,jq,qc->jc", geom.wq, proj.vhat[:, :, b], Vb)
        im = geom.det_jac * im
    else:
        im = jnp.zeros((0, geom.n_cells), dtype=Q.dtype)

    # (3) gather per-cell dofs (sign-corrected to the cell's outward normal)
    #     and reconstruct
    if geom.shift is not None:
        from .structured import slot_gather

        mf_cell = [
            s * geom.cfsign[l][None, :] for l, s in enumerate(slot_gather(geom, m_f))
        ]
    else:
        mf_cell = [
            m_f[:, geom.cell_facets[l]] * geom.cfsign[l][None, :] for l in range(3)
        ]
    dofs = jnp.concatenate(mf_cell + [im], axis=0)  # (nu, nc)
    # apply the per-class reconstruction matrices as one GEMM per class
    # (instead of gathering batch-major (nc, n, n) blocks)
    ncls = proj.recon.shape[0]
    if ncls > 16:
        sol = jnp.einsum("cij,jc->ic", proj.recon[proj.class_id], dofs)
    else:
        sol = jnp.zeros_like(dofs)
        for k in range(ncls):
            yk = proj.recon[k] @ dofs
            sol = jnp.where((proj.class_id == k)[None, :], yk, sol)
    return sol.reshape(2, d1, geom.n_cells)
