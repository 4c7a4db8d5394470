"""Lowest-order Raviart-Thomas (RT1 in Firedrake numbering) element operations.

Element layer for the conforming scheme
(reference src/timesteppers/conforming_implicit.py:33): the velocity
lives in the H(div)-conforming RT space with ONE global dof per facet — the
integrated normal flux g_f = int_f v . n_f ds (n_f the stored global facet
normal).  On a cell c with area A and opposite vertex P_l, the local basis

    W_l(x) = (x - P_l) / (2 A),   v|_c = sum_l sign_{c,l} g_{f(c,l)} W_l

has unit outward flux through facet l and zero through the others, so normal
continuity is automatic.  Because W_l is affine, every evaluation reduces to
v(x) = a_c x - b_c with per-cell scalars/vectors a_c, b_c — all operations
below are tiny batched einsums.

Layouts are batch-last throughout (fem/discretisation.py): RT dof vectors are
flat (nf,); quadrature-point fields are (2, nq, nc) / (2, nqf, nf).

DG1-representability: RT1 subset [P1]^2, so an RT field converts exactly to
the k=0 velocity space DG(1); outputs/tracer/error-norm machinery is reused
through that conversion.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["RTTables", "build_rt_tables"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "P_opp",
        "area",
        "mass_elem",
        "mass_diag_inv",
        "xqf",
        "bnd_mask",
        "int_dof_mask",
    ],
    meta_fields=[],
)
@dataclass
class RTTables:
    P_opp: jnp.ndarray  # (3, 2, nc) opposite-vertex coordinates per local facet
    area: jnp.ndarray  # (nc,)
    mass_elem: jnp.ndarray  # (3, 3, nc) signed element mass matrices
    mass_diag_inv: jnp.ndarray  # (nf,) inverse of assembled mass diagonal
    xqf: jnp.ndarray  # (2 side, 2 comp, nqf, nf) facet quad coords (unwrapped)
    bnd_mask: jnp.ndarray  # (nf,) 1.0 on boundary facets
    int_dof_mask: jnp.ndarray  # (nf,) 1.0 on interior facets (BC projector)


def build_rt_tables(disc):
    """Build RT tables; requires disc.degree == 0 (V1 = DG1)."""
    assert disc.degree == 0, "conforming RT solver uses the degree-0 discretisation"
    mesh = disc.mesh
    area = mesh.det_jac / 2.0
    # opposite vertex of local facet l is local vertex l
    P_opp = mesh.cell_coords  # (nc, 3, 2): vertex l is opposite facet l

    # signed element mass: M[l,m] = s_l s_m / (4A^2) int (x-P_l).(x-P_m) dx
    qp = disc.V1.qp
    lam = np.stack([1.0 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]], axis=-1)
    xq = np.einsum("ql,cld->cqd", lam, mesh.cell_coords)  # (nc, nq, 2)
    w = disc.V1.qw
    diff = xq[:, :, None, :] - P_opp[:, None, :, :]  # (nc, nq, 3, 2)
    M = np.einsum("c,q,cqld,cqmd->clm", mesh.det_jac, w, diff, diff)
    sgn = np.where(mesh.cell_facet_side == 0, 1.0, -1.0)
    M = M * sgn[:, :, None] * sgn[:, None, :] / (4.0 * area**2)[:, None, None]

    nf = mesh.n_facets
    Mdiag = np.zeros(nf)
    np.add.at(Mdiag, mesh.cell_facets, np.einsum("cll->cl", M))

    # facet quadrature coords per side, in each cell's unwrapped frame
    sq = disc.Vt.sq
    from ..fem.spaces import facet_ref_points

    xqf = np.zeros((nf, 2, sq.shape[0], 2))
    for side in (0, 1):
        c = mesh.facet_cells[:, side].copy()
        c[c < 0] = 0
        l = mesh.facet_local[:, side]
        flip = mesh.facet_flip[:, side]
        for li in range(3):
            for fl in range(2):
                sel = (l == li) & (flip == fl)
                if not np.any(sel):
                    continue
                ref = facet_ref_points(li, fl, sq)  # (nqf, 2)
                lamf = np.stack(
                    [1.0 - ref[:, 0] - ref[:, 1], ref[:, 0], ref[:, 1]], axis=-1
                )
                xqf[sel, side] = np.einsum("ql,cld->cqd", lamf, mesh.cell_coords[c[sel]])

    bnd = np.zeros(nf)
    bnd[mesh.n_interior_facets :] = 1.0

    f = lambda a: jnp.asarray(a, dtype=disc.dtype)
    return RTTables(
        P_opp=f(P_opp.transpose(1, 2, 0)),
        area=f(area),
        mass_elem=f(M.transpose(1, 2, 0)),
        mass_diag_inv=f(1.0 / Mdiag),
        xqf=f(xqf.transpose(1, 3, 2, 0)),
        bnd_mask=f(bnd),
        int_dof_mask=f(1.0 - bnd),
    )


def _signed_local(geom, gdofs):
    """Signed local dofs per cell: (3, nc)."""
    return gdofs[geom.cell_facets] * geom.cfsign


def rt_cell_coeffs(geom, rt, gdofs):
    """Per-cell affine representation v(x) = a_c x - b_c.

    Returns (a (nc,), b (2, nc)).
    """
    gl = _signed_local(geom, gdofs)  # (3, nc)
    a = jnp.sum(gl, axis=0) / (2.0 * rt.area)
    b = jnp.einsum("lc,ldc->dc", gl, rt.P_opp) / (2.0 * rt.area)[None, :]
    return a, b


def rt_eval(geom, rt, gdofs, x):
    """Evaluate the RT field at per-cell points x (2, npts, nc)."""
    a, b = rt_cell_coeffs(geom, rt, gdofs)
    return a[None, None, :] * x - b[:, None, :]


def rt_eval_cellq(geom, rt, gdofs):
    """Values at the cell quadrature points (2, nq, nc)."""
    return rt_eval(geom, rt, gdofs, geom.xq)


def rt_facet_values(geom, rt, gdofs):
    """Both-side values at facet quadrature: (v_plus, v_minus), (2, nqf, nf)."""
    a, b = rt_cell_coeffs(geom, rt, gdofs)
    out = []
    for side in (0, 1):
        c = geom.fcells[side]
        out.append(a[c][None, None, :] * rt.xqf[side] - b[:, c][:, None, :])
    return out[0], out[1]


def rt_divergence(geom, rt, gdofs):
    """Cellwise-constant divergence: (nc,) = sum_l s_l g_l / A."""
    gl = _signed_local(geom, gdofs)
    return jnp.sum(gl, axis=0) / rt.area


def _scatter_cell_dofs(geom, coeff):
    """Accumulate per-cell local-facet coefficients (3, nc) into (nf,)."""
    out = jnp.zeros(geom.n_facets, dtype=coeff.dtype)
    return out.at[geom.cell_facets].add(coeff)


def rt_div_adjoint(geom, rt, q):
    """Adjoint of (cell values q) -> int q div(w): dof coefficients (nf,).

    int_K q div W_l = q_c  (unit flux), so coeff(c, l) = s_l q_c.
    """
    return _scatter_cell_dofs(geom, geom.cfsign * q[None, :])


def rt_mass_apply(geom, rt, gdofs):
    """Global RT mass matrix action (nf,) -> (nf,)."""
    gl = gdofs[geom.cell_facets]  # (3, nc)
    y = jnp.einsum("lmc,mc->lc", rt.mass_elem, gl)
    out = jnp.zeros_like(gdofs)
    return out.at[geom.cell_facets].add(y)


def rt_volume_adjoint(geom, rt, G):
    """Test coefficients of int_K G(x) . w dx for a quadrature-point field G.

    :arg G: (2, nq, nc) integrand values at cell quadrature
    coeff(c, l) = s_l / (2A) * int_K [G.x - G.P_l] dx
    """
    xq = geom.xq  # (2, nq, nc)
    wdet = geom.det_jac[None, :] * geom.wq[:, None]  # (nq, nc)
    S1 = jnp.einsum("qc,dqc,dqc->c", wdet, G, xq)  # int G.x
    S0 = jnp.einsum("qc,dqc->dc", wdet, G)  # int G
    coeff = (S1[None, :] - jnp.einsum("ldc,dc->lc", rt.P_opp, S0)) * geom.cfsign
    coeff = coeff / (2.0 * rt.area)[None, :]
    return _scatter_cell_dofs(geom, coeff)


def rt_facet_adjoint(geom, rt, G0, G1):
    """Test coefficients of facet integrals sum_f int_f G_side . w_side ds.

    :arg G0/G1: (2, nqf, nf) weights multiplying the plus/minus side trace of
        the RT test function (G1 must already be masked to interior facets)
    """
    w = geom.wqf[:, None] * geom.flen[None, :]  # (nqf, nf)
    dtype = G0.dtype
    Scell1 = jnp.zeros(geom.n_cells, dtype=dtype)
    Scell0 = jnp.zeros((2, geom.n_cells), dtype=dtype)
    for side, G in ((0, G0), (1, G1)):
        c = geom.fcells[side]
        A1 = jnp.einsum("qf,dqf,dqf->f", w, G, rt.xqf[side])
        A0 = jnp.einsum("qf,dqf->df", w, G)
        Scell1 = Scell1.at[c].add(A1)
        Scell0 = Scell0.at[:, c].add(A0)
    coeff = (Scell1[None, :] - jnp.einsum("ldc,dc->lc", rt.P_opp, Scell0)) * geom.cfsign
    coeff = coeff / (2.0 * rt.area)[None, :]
    return _scatter_cell_dofs(geom, coeff)


def rt_to_dg1(geom, rt, gdofs):
    """Convert an RT field to the (k=0) DG1 nodal velocity layout (2, 3, nc)."""
    # DG1 nodes of the k=0 discretisation are the cell vertices
    return rt_eval(geom, rt, gdofs, geom.xnodes1)


def rt_interpolate(disc, rt, fn):
    """RT interpolation of an expression: g_f = int_f fn . n_f ds."""
    geom = disc.geom
    x = rt.xqf[0]  # plus-side coords (2, nqf, nf)
    fx, fy = fn(x[0], x[1])
    vals = jnp.stack(jnp.broadcast_arrays(fx, fy), axis=0)  # (2, nqf, nf)
    w = geom.wqf[:, None] * geom.flen[None, :]
    return jnp.einsum("qf,dqf,df->f", w, vals, geom.normal).astype(disc.dtype)
