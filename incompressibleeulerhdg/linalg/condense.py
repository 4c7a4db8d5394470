"""Batched static condensation of the HDG mixed-Poisson operator.

Replacement for Slate/SCPC static condensation
(``"pc_python_type": "firedrake.SCPC"``, ``"pc_sc_eliminate_fields": "0, 1"``
at reference src/timesteppers/hdg_imex.py:128-133) applied to the
bilinear form

    a((u,p,lam),(w,psi,mu)) = (w,u) - g(w,p,lam) + Gamma(psi,mu,u,p,lam)
    (hdg_imex.py:123-127)

which is *constant in time*, so all element blocks are formed once at setup.

Per cell, local unknowns x = [u (2*d1), p (d0)] couple to the traces of the
cell's three facets.  The element system

    [A_c  B_c] [x_c  ]   [f_c    ]
    [C_c  D_c] [lam_c] = [f_lam_c]

is condensed to per-cell trace Schur blocks S_c = D_c - C_c A_c^{-1} B_c; the
global trace operator is their facet-scatter sum.  Cells are deduplicated by
geometry class (see ops/projection.py): A^{-1}, A^{-1}B, CA^{-1} are stored
per class; S is materialised per cell because it is read on every Krylov
iteration (the gather is then a pure streaming load).

Local dof layout: u dofs flattened as i*2 + component; then p dofs.
Trace layout per cell: local facet l * nt + trace node.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.projection import cell_geometry_classes

__all__ = ["CondensedSystem", "build_condensed_system", "trace_matvec", "condense_rhs", "back_substitute"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["S", "Ainv", "AinvB", "CAinv", "class_id", "Sdiag_inv", "nullvec"],
    meta_fields=["tau", "nt"],
)
@dataclass
class CondensedSystem:
    S: jnp.ndarray  # (3nt, 3nt, nc) per-cell trace Schur blocks, BATCH-LAST
    # (batch-last: the matvec is an elementwise multiply-reduce over
    # contiguous cells)
    Ainv: jnp.ndarray  # (ncls, nloc, nloc); u-dofs component-major (a*d1+i)
    AinvB: jnp.ndarray  # (ncls, nloc, 3nt)
    CAinv: jnp.ndarray  # (ncls, 3nt, nloc)
    class_id: jnp.ndarray  # (nc,)
    Sdiag_inv: jnp.ndarray  # (nt, nt, nf) inverse facet-diagonal blocks, batch-last
    nullvec: jnp.ndarray  # (nt, nf) normalised constant-trace nullspace of S
    tau: float = 1.0
    nt: int = 1


def build_element_blocks(disc, reps, tau):
    """Dense element blocks (A, B, C, D) for the representative cells (numpy)."""
    mesh, V1, V0, Vt = disc.mesh, disc.V1, disc.V0, disc.Vt
    d1, d0, nt = V1.ndof, V0.ndof, Vt.ndof
    nu = 2 * d1
    nloc = nu + d0
    ncr = reps.shape[0]
    det = mesh.det_jac[reps]
    jinv = mesh.jac_inv[reps]

    # physical gradients of DG(k+1) at cell quadrature: (ncr, nq, d1, 2)
    gphys = np.einsum("qib,cba->cqia", V1.gphi, jinv)

    A = np.zeros((ncr, nloc, nloc))
    B = np.zeros((ncr, nloc, 3 * nt))
    C = np.zeros((ncr, 3 * nt, nloc))
    D = np.zeros((ncr, 3 * nt, 3 * nt))

    # A_uu: vector mass  (w, u)
    Muu = np.einsum("c,q,qi,qj->cij", det, V1.qw, V1.phi, V1.phi)
    for a in range(2):
        A[:, a:nu:2, a:nu:2] = Muu

    # A_up = -int p div w ;  A_pu = +int psi div u   (Gamma volume)
    div_blk = np.einsum("c,q,qp,cqia->cpia", det, V1.qw, V0.phi, gphys)  # (ncr,d0,d1,2)
    A[:, :nu, nu:] = -div_blk.reshape(ncr, d0, nu).transpose(0, 2, 1)
    A[:, nu:, :nu] = div_blk.reshape(ncr, d0, nu)

    # facet terms
    for l in range(3):
        f = mesh.cell_facets[reps, l]
        side = mesh.cell_facet_side[reps, l]
        flip = mesh.facet_flip[f, side]
        T1 = V1.tphi[2 * l + flip]  # (ncr, nqf, d1)
        T0 = V0.tphi[2 * l + flip]  # (ncr, nqf, d0)
        sgn = np.where(side == 0, 1.0, -1.0)
        n_out = sgn[:, None] * mesh.normals[f]
        L = mesh.facet_lengths[f]
        w = L[:, None] * Vt.wq[None, :]  # (ncr, nqf)

        # A_pp += tau * facet mass of p traces (own side)
        A[:, nu:, nu:] += tau * np.einsum("cq,cqa,cqb->cab", w, T0, T0)

        sl = slice(l * nt, (l + 1) * nt)
        # B_u,lam = + int tr_m phi_i n_out_a   (from -g)
        Bu = np.einsum("cq,qm,cqi,ca->cima", w, Vt.tr, T1, n_out)
        Bu_cols = Bu.transpose(0, 1, 3, 2).reshape(ncr, nu, nt)  # rows (i*2+a)
        B[:, :nu, sl] = Bu_cols
        # B_p,lam = - tau int tr_m psi_a      (Gamma psi-row)
        Bp = np.einsum("cq,qm,cqa->cma", w, Vt.tr, T0)
        B[:, nu:, sl] = -tau * Bp.transpose(0, 2, 1)
        # C_lam,u = + int tr_m phi_j n_out_b  (Gamma mu-row)
        C[:, sl, :nu] = Bu_cols.transpose(0, 2, 1)
        # C_lam,p = + tau int tr_m psi_b
        C[:, sl, nu:] = tau * Bp
        # D_lam,lam = - tau facet trace mass (one contribution per side)
        D[:, sl, sl] = -tau * np.einsum("cq,qm,qn->cmn", w, Vt.tr, Vt.tr)

    return A, B, C, D


def build_condensed_system(disc, tau=1.0):
    """Condense the mixed-Poisson HDG operator; all numpy at setup."""
    mesh = disc.mesh
    nt = disc.Vt.ndof
    class_id, reps = cell_geometry_classes(mesh)
    A, B, C, D = build_element_blocks(disc, reps, tau)

    Ainv = np.linalg.inv(A)
    AinvB = Ainv @ B
    CAinv = C @ Ainv
    S_cls = D - C @ AinvB  # (ncls, 3nt, 3nt)
    S = S_cls[class_id]  # materialised per cell (hot path)

    # permute the u-dof block of the local index to the component-major
    # (a*d1+i) convention of the batch-last field layout
    from ..ops.projection import _amajor_perm

    d1 = disc.V1.ndof
    perm = np.concatenate([_amajor_perm(d1), 2 * d1 + np.arange(disc.V0.ndof)])
    Ainv = Ainv[:, perm][:, :, perm]
    AinvB = AinvB[:, perm, :]
    CAinv = CAinv[:, :, perm]

    # facet-block diagonal of the assembled trace operator
    nf = mesh.n_facets
    Sdiag = np.zeros((nf, nt, nt))
    for l in range(3):
        f = mesh.cell_facets[:, l]
        sl = slice(l * nt, (l + 1) * nt)
        np.add.at(Sdiag, f, S[:, sl, sl])
    Sdiag_inv = np.linalg.inv(Sdiag)

    nullvec = np.ones((nt, nf))
    nullvec /= np.linalg.norm(nullvec)

    # stash host copies of the large tables for downstream setup consumers
    # (build_gtmg's spectral estimates) instead of pulling them back off
    # the device
    disc._cs_host = {"S": S, "Sdiag_inv": Sdiag_inv}

    f = lambda a: jnp.asarray(a, dtype=disc.dtype)
    return CondensedSystem(
        S=f(S.transpose(1, 2, 0)),
        Ainv=f(Ainv),
        AinvB=f(AinvB),
        CAinv=f(CAinv),
        class_id=jnp.asarray(class_id),
        Sdiag_inv=f(Sdiag_inv.transpose(1, 2, 0)),
        nullvec=f(nullvec),
        tau=float(tau),
        nt=int(nt),
    )


def _facets_from_cells(geom, y_c):
    """Gather-based facet assembly of per-cell (3nt, nc) contributions.

    Equivalent to scatter-add over cell_facets, but expressed as masked lane
    gathers per local-facet index (each facet has at most two cells)
    instead of a scatter-add.  Returns (nt, nf).
    """
    nt = y_c.shape[0] // 3
    if geom.shift is not None:
        from ..ops.structured import slot_scatter

        return slot_scatter(geom, [y_c[l * nt : (l + 1) * nt] for l in range(3)])
    fl = geom.ftab // 2  # (2, nf) local facet index per side
    from ..ops.fields import interior_mask

    msk = interior_mask(geom, 2).astype(y_c.dtype)
    out = 0.0
    for l in range(3):
        sel0 = (fl[0] == l).astype(y_c.dtype)[None, :]
        sel1 = (fl[1] == l).astype(y_c.dtype)[None, :] * msk
        blk = y_c[l * nt : (l + 1) * nt]
        out = out + sel0 * blk[:, geom.fcells[0]] + sel1 * blk[:, geom.fcells[1]]
    return out


def _cells_from_facets(geom, lam):
    """Gather per-cell trace dofs: (nt, nf) -> (3nt, nc) (local facet major)."""
    if geom.shift is not None:
        from ..ops.structured import slot_gather

        return jnp.concatenate(slot_gather(geom, lam), axis=0)
    return jnp.concatenate(
        [lam[:, geom.cell_facets[l]] for l in range(3)], axis=0
    )


def trace_matvec(geom, cs, lam):
    """Condensed trace operator: (nt, nf) -> (nt, nf), batch-last blocks."""
    lam_c = _cells_from_facets(geom, lam)  # (3nt, nc)
    # einsum, NOT an unrolled FMA loop: measured head-to-head at 512^2
    # (tools/microbench_bm.py, round 5) the einsum form runs 0.90 ms vs
    # 2.03 ms unrolled on (9, 9, nc) — XLA's multiply-reduce fusion wins
    # for small batch-last blocks
    y_c = jnp.einsum("ijc,jc->ic", cs.S, lam_c)
    return _facets_from_cells(geom, y_c)


def _flatten_local(f_u, f_p):
    """(2, d1, nc) u-rows + (d0, nc) p-rows -> (nloc, nc)."""
    nc = f_u.shape[-1]
    return jnp.concatenate([f_u.reshape(-1, nc), f_p], axis=0)


def _apply_class_blocks(tables, class_id, x):
    """y[:, c] = tables[class_id[c]] @ x[:, c] without per-cell blocks.

    One (m, n) x (n, nc) GEMM per geometry class, selected by class id —
    ncls is O(10) on generated meshes.  Falls back to a gather path for
    large class counts (unstructured meshes).
    """
    ncls = tables.shape[0]
    if ncls > 16:
        return jnp.einsum("cij,jc->ic", tables[class_id], x)
    out = jnp.zeros((tables.shape[1], x.shape[1]), dtype=x.dtype)
    for k in range(ncls):
        yk = tables[k] @ x
        out = jnp.where((class_id == k)[None, :], yk, out)
    return out


def condense_rhs(geom, cs, f_u, f_p, f_lam):
    """Condensed right-hand side g = f_lam - C A^{-1} f_loc: (nt, nf)."""
    f_loc = _flatten_local(f_u, f_p)
    contrib = _apply_class_blocks(cs.CAinv, cs.class_id, f_loc)  # (3nt, nc)
    return f_lam - _facets_from_cells(geom, contrib)


def back_substitute(geom, cs, f_u, f_p, lam):
    """Recover (u, p) from the trace solution: x = A^{-1}(f_loc - B lam)."""
    f_loc = _flatten_local(f_u, f_p)
    lam_c = _cells_from_facets(geom, lam)
    x = _apply_class_blocks(cs.Ainv, cs.class_id, f_loc) - _apply_class_blocks(
        cs.AinvB, cs.class_id, lam_c
    )
    d1 = geom.d1
    u = x[: 2 * d1].reshape(2, d1, -1)
    p = x[2 * d1 :]
    return u, p
