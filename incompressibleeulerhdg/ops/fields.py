"""Batched field evaluation primitives shared by all weak-form kernels.

Every operation maps DG coefficient arrays to quadrature-point values (or the
adjoint scatter back to test-function coefficients) as dense einsums — the
replacement for the per-element C kernels TSFC generates for the
reference's UFL forms.

All arrays are BATCH-LAST (see fem/discretisation.py): scalar fields are
``(d, nc)``, vector fields ``(2, d, nc)``, trace fields ``(nt, nf)``,
quadrature values ``([2,] nq, nc)`` / ``([2,] nqf, nf)``.  Leading ellipsis
dims in the helpers carry the vector component (or nothing, for scalars).

Facet trace evaluation uses per-facet trace tables assembled on the fly from
the 6 static reference tables by one-hot sums over the ``ftab`` orientation
index — never batch-major (nf, nqf, d) table gathers.
Facet->cell accumulation is expressed as three column gathers over the
side-concatenated contribution array (``cfassemble`` index) instead of a
scatter-add.

Contractions between two lane-batched (non-static) operands are written as
UNROLLED elementwise FMA sums over the small dimension, never einsum: XLA
lowers such einsums to dot_general with the batch in the minor dim and
relayouts the operands to 14-17x padded batch-major temporaries (the 512^2
OOM and a large fraction of the 256^2 step time).  Elementwise ops preserve
the lane-minor layout and fuse.
"""

import jax.numpy as jnp

__all__ = [
    "cell_values",
    "cell_grads",
    "cell_div",
    "facet_eval_tables",
    "facet_traces",
    "facet_trace_plus",
    "trace_values",
    "gather_facet_contribs",
    "scatter_facets",
    "facet_integrate_trace",
    "cell_integrate",
    "integral",
    "mass_apply",
    "mass_solve",
    "l2_norm_sq",
    "interior_mask",
]


def cell_values(phi, u):
    """Evaluate DG field at cell quadrature points: (..., nd, nc) -> (..., nq, nc)."""
    return jnp.einsum("qi,...ic->...qc", phi, u)


def cell_grads(geom, gphi, u):
    """Physical gradients at cell quadrature points.

    Returns (..., 2, nq, nc) with the new axis (before nq) the spatial
    derivative direction: d/dx_a = gradref[..., b] jac_inv[b, a].
    The jac_inv contraction is a 2-term elementwise sum (einsum between two
    lane-batched operands triggers XLA's batched-dot relayout path).
    """
    gref = jnp.einsum("qib,...ic->...bqc", gphi, u)
    jinv = geom.jac_inv
    return jnp.stack(
        [
            gref[..., 0, :, :] * jinv[0, a][None, :]
            + gref[..., 1, :, :] * jinv[1, a][None, :]
            for a in (0, 1)
        ],
        axis=-3,
    )


def cell_div(geom, u):
    """Divergence of a velocity field at cell quadrature points: (nq, nc)."""
    g = cell_grads(geom, geom.gphi1, u)  # (2 comp, 2 deriv, nq, nc)
    return g[0, 0] + g[1, 1]


def _side_onehot(geom, side):
    """(6, nf) one-hot of the trace-table index (2*local + flip) per facet."""
    dtype = geom.wq.dtype
    return (geom.ftab[side][None, :] == jnp.arange(6)[:, None]).astype(dtype)


def facet_eval_tables(geom, tphi):
    """Per-facet trace tables (nqf, nd, nf) for each side, via one-hot sums
    over the 6 static orientation tables (tphi indexed 2*local + flip).

    Built by elementwise broadcasts only — consumers contract them with
    unrolled FMA loops so the lane-minor layout survives.
    """
    oh0 = _side_onehot(geom, 0)
    oh1 = _side_onehot(geom, 1)
    U0 = sum(oh0[t][None, None, :] * tphi[t][:, :, None] for t in range(6))
    U1 = sum(oh1[t][None, None, :] * tphi[t][:, :, None] for t in range(6))
    return U0, U1


def _eval_side(geom, tphi, u, side):
    """Trace of a DG field on one facet side: (..., nqf, nf), FMA-unrolled."""
    oh = _side_onehot(geom, side)
    if geom.shift is not None:
        from .structured import gather_plus, gather_minus

        ug = gather_plus(geom, u) if side == 0 else gather_minus(geom, u)
    else:
        ug = u[..., geom.fcells[side]]  # (..., nd, nf)
    nd = tphi.shape[2]
    U = sum(oh[t][None, None, :] * tphi[t][:, :, None] for t in range(6))
    return sum(
        U[:, i, :] * ug[..., i, None, :] for i in range(nd)
    )


def facet_traces(geom, tphi, u):
    """Both-side traces of a DG field at facet quadrature points.

    Returns (u_plus, u_minus), each (..., nqf, nf).  For boundary facets the
    minus trace is garbage (clamped gather) — callers must mask it out with
    :func:`interior_mask`.
    """
    return _eval_side(geom, tphi, u, 0), _eval_side(geom, tphi, u, 1)


def facet_trace_plus(geom, tphi, u):
    """Plus-side trace only: (..., nqf, nf)."""
    return _eval_side(geom, tphi, u, 0)


def trace_values(geom, lam):
    """Evaluate the DGT trace field at facet quadrature points: (nqf, nf)."""
    return jnp.einsum("qj,jf->qf", geom.tr, lam)


def interior_mask(geom, ndim=2):
    """(..., nf) float mask (1 on interior facets) with ndim-1 leading axes.

    Uses the stored per-facet mask when present (slab-local layouts
    interleave boundary facets inside the color families, so a
    "first n_int facets" threshold cannot express them); global layouts
    derive it from the interior-first facet ordering.
    """
    if getattr(geom, "fint", None) is not None:
        m = geom.fint
    else:
        m = (jnp.arange(geom.n_facets) < geom.n_int).astype(geom.wq.dtype)
    return m.reshape((1,) * (ndim - 1) + (-1,))


def gather_facet_contribs(geom, c0, c1):
    """Accumulate per-facet-side contributions into cells WITHOUT scatters.

    Each cell has exactly three facets, so the facet->cell scatter-add is
    re-expressed as three lane gathers over the side-concatenated array.

    :arg c0/c1: (..., nf) contributions targeting the plus / minus cell
    :returns: (..., nc) summed per cell
    """
    if geom.shift is not None:
        from .structured import scatter_sides_sum

        return scatter_sides_sum(geom, c0, c1)
    zcat = jnp.concatenate([c0, c1], axis=-1)  # (..., 2 nf)
    out = 0.0
    for l in range(3):
        out = out + zcat[..., geom.cfassemble[l]]
    return out


def _adjoint_side(geom, tphi, g, side):
    """Integrate an integrand against one side's trace basis: (..., nd, nf)."""
    oh = _side_onehot(geom, side)
    nd = tphi.shape[2]
    w = geom.wqf[:, None] * geom.flen[None, :]  # (nqf, nf)
    U = sum(oh[t][None, None, :] * tphi[t][:, :, None] for t in range(6))
    wg = w * g  # (..., nqf, nf)
    return jnp.stack(
        [jnp.sum(U[:, i, :] * wg, axis=-2) for i in range(nd)], axis=-2
    )


def scatter_facets(geom, tphi, g0, g1):
    """Adjoint of facet trace evaluation: accumulate facet integrands into cells.

    r[..., i, c] += sum_{facets of c} L_f sum_q wqf[q] T_side[i,q,f] g_side[...,q,f]

    :arg g0/g1: integrand multiplying the test function's plus/minus trace,
        shape (..., nqf, nf).  g1 is masked to interior facets internally.
    """
    c0 = _adjoint_side(geom, tphi, g0, 0)
    g1 = g1 * interior_mask(geom, g1.ndim)
    c1 = _adjoint_side(geom, tphi, g1, 1)
    return gather_facet_contribs(geom, c0, c1)


def facet_integrate_trace(geom, integrand):
    """Integrate against the DGT test basis: (nqf, nf) -> (nt, nf)."""
    w = geom.wqf[:, None] * geom.flen[None, :]
    return jnp.einsum("qf,qj,qf->jf", w, geom.tr, integrand)


def cell_integrate(geom, phi, integrand):
    """Integrate a quadrature-point integrand against a cell test basis.

    (..., nq, nc) -> (..., nd, nc):  r = detJ * sum_q wq phi[q,i] g[..., q, c]
    """
    return jnp.einsum("c,q,qi,...qc->...ic", geom.det_jac, geom.wq, phi, integrand)


def integral(geom, phi, u):
    """Scalar integral of a DG field over the domain (summed over components);
    a psum over the slab axis when the geometry is slab-decomposed (the
    ``assemble(p*dx)`` analogue of the reference's MPI reduction)."""
    vals = cell_values(phi, u)
    out = jnp.einsum("c,q,...qc->...", geom.det_jac, geom.wq, vals)
    from .structured import dist_axis

    ax = dist_axis(geom)
    if ax is not None:
        import jax

        out = jax.lax.psum(out, ax)
    return out


def mass_apply(geom, mref, u):
    """Apply the block-diagonal DG mass matrix (affine cells: detJ * M_ref)."""
    return geom.det_jac * jnp.einsum("ij,...jc->...ic", mref, u)


def mass_solve(geom, minv, r):
    """Solve M u = r for the block-diagonal DG mass matrix."""
    return jnp.einsum("ij,...jc->...ic", minv, r) / geom.det_jac


def l2_norm_sq(geom, phi, u):
    """Squared L2 norm of a DG field (scalar (d, nc) or vector (2, d, nc));
    globally reduced when slab-decomposed."""
    vals = cell_values(phi, u)
    sq = vals**2 if vals.ndim == 2 else jnp.sum(vals**2, axis=0)
    out = jnp.einsum("c,q,qc->", geom.det_jac, geom.wq, sq)
    from .structured import dist_axis

    ax = dist_axis(geom)
    if ax is not None:
        import jax

        out = jax.lax.psum(out, ax)
    return out
