"""Preconditioners and assembled operators for the matrix-free Krylov solvers.

- TentativeOperator: the per-stage tentative velocity operator M - c f_impl
  assembled into batch-last dense blocks (own-cell D + facet cross blocks),
  applied as a block SpMV and preconditioned by multiplicative colored
  facet-pair Schwarz sweeps — the replacement for the GMRES+ILU tentative
  solver of the reference (hdg_imex.py:224-228)
- facet-block Jacobi for the condensed trace system (the default when the
  GTMG two-level scheme of linalg/gtmg.py is not supplied)

All fields are batch-last with component-major local dofs (dof = a * d1 + i,
so a (2, d1, nc) field reshapes to (nu, nc) for free); all block tables are
(nu, nu, n) batch-last: structure-of-arrays, so consecutive cells are
consecutive in memory and every elementwise block FMA reads coalesced rows.
"""

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.fields import interior_mask
from .smallinv import inv_bl


def _fact_wanted():
    """Whether uniform meshes should store FACTORED tentative tables.

    ``IEHDG_FACT=1/0`` overrides; default ON.  The factored tables carry
    ~4x fewer bytes per matvec than the dense ones, with identical
    in-timestep iteration counts and velocity error.  The H100 comparison
    of the two (same call, 512^2 k=2 f32) is recorded in PERF.md.
    """
    flag = os.environ.get("IEHDG_FACT")
    if flag is not None:
        return flag == "1"
    return True

_register_tentative_op = partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "D",
        "Bx",
        "Cx",
        "Dinv",
        "Sinv",
        "Dinv0",
        "Sown",
        "Pcell",
        "Ks01",
        "Ks10",
        "Bp",
        "Cp",
    ],
    meta_fields=[],
)


def _register_tentative_op_wrap(cls):
    return _register_tentative_op(dataclass(cls))


__all__ = [
    "trace_block_jacobi",
    "TentativeOperator",
    "build_tentative_operator",
    "tentative_operator_matvec",
    "tentative_patch_apply",
    "tentative_colored_apply",
    "dense_blocks",
]


def dense_blocks(geom, op):
    """Reconstruct the dense (D, Bx, Cx) block tables of a TentativeOperator.

    Identity on dense-table operators; expands the Kronecker factors of the
    factored (uniform structured mesh) representation.  Diagnostic/test
    helper — the hot paths never materialise these.
    """
    if op.Sown is None:
        return op.D, op.Bx, op.Cx
    Sown, Ks01, Ks10 = op.Sown, op.Ks01, op.Ks10
    d1 = Sown.shape[0]
    nu = 2 * d1
    nc = Sown.shape[2]
    nf = geom.n_facets
    if Ks01.shape[2] < nf:
        pad = ((0, 0), (0, 0), (0, nf - Ks01.shape[2]))
        Ks01 = jnp.pad(Ks01, pad)
        Ks10 = jnp.pad(Ks10, pad)
    eye2 = jnp.eye(2, dtype=Sown.dtype)
    nch = geom.shift[0] * geom.shift[1]
    D = jnp.einsum("ab,ijc->aibjc", eye2, Sown).reshape(nu, nu, nc)
    D = D + jnp.concatenate(
        [
            jnp.broadcast_to(op.Pcell[0][:, :, None], (nu, nu, nch)),
            jnp.broadcast_to(op.Pcell[1][:, :, None], (nu, nu, nc - nch)),
        ],
        axis=2,
    )
    b = geom.fcol_bounds
    msk = interior_mask(geom, 1)

    def expand(Ks, Pk):
        X = jnp.einsum("ab,ijf->aibjf", eye2, Ks).reshape(nu, nu, nf)
        pen = jnp.zeros((nu, nu, nf), Sown.dtype)
        for k in range(len(b) - 1):
            pen = pen.at[:, :, b[k] : b[k + 1]].set(Pk[k][:, :, None])
        return X + pen * msk[None, None, :]

    return D, expand(Ks01, op.Bp), expand(Ks10, op.Cp)


def trace_block_jacobi(cs):
    """Return a flat-vector preconditioner applying per-facet inverse diagonal
    blocks (batch-last storage, (nt, nf) trace layout)."""
    nt = cs.nt

    def M(v):
        lam = v.reshape(nt, -1)
        return jnp.einsum("ijf,jf->if", cs.Sdiag_inv, lam).ravel()

    return M


@_register_tentative_op_wrap
class TentativeOperator:
    """Assembled per-stage tentative operator M - c f_impl + its patch factors.

    The Krylov matvec uses the SAME blocks as the Schwarz patches: assembling
    once per stage and applying dense blocks replaces re-deriving the weak
    form from tabulations per application.
    """

    D: jnp.ndarray  # (nu, nu, nc) own-cell blocks (None on the factored path)
    Bx: jnp.ndarray  # (nu, nu, nf) -c K01: plus-test rows, minus-side trial
    Cx: jnp.ndarray  # (nu, nu, nf) -c K10: minus-test rows, plus-side trial
    Dinv: jnp.ndarray  # (nu, nu, nc)
    Sinv: jnp.ndarray  # (nu, nu, nf) patch Schur inverses
    Dinv0: jnp.ndarray  # (nu, nu, nf) Dinv gathered to each facet's plus cell
    # (stored once per build instead of gathered per application)
    #
    # FACTORED tables (uniform structured meshes, geom.uniform is not None;
    # the above dense D/Bx/Cx are None then).  The 2x2-component structure
    #     D  = eye2 (x) Sown + Pcell[half]          (Pcell constant per half)
    #     Bx = eye2 (x) Ks01 + Bp[color]            (Bp constant per color)
    #     Cx = eye2 (x) Ks10 + Cp[color]
    # cuts the matvec's HBM table traffic ~4x: the varying factors are
    # (d1, d1, .) scalar blocks instead of (nu, nu, .) = (2 d1, 2 d1, .)
    # vector blocks, and the penalty parts collapse to (nu, nu) constants
    # applied as small GEMMs.  A preconditioned GMRES iteration streams the
    # tables about 5 times (1 Krylov matvec + the colored sweep), so table
    # bytes set the cost of the tentative solve.
    Sown: jnp.ndarray = None  # (d1, d1, nc) scalar own-cell blocks
    Pcell: jnp.ndarray = None  # (2, nu, nu) per-half constant penalty block
    Ks01: jnp.ndarray = None  # (d1, d1, nf) scalar cross blocks, plus rows
    Ks10: jnp.ndarray = None  # (d1, d1, nf) scalar cross blocks, minus rows
    Bp: jnp.ndarray = None  # (ncol, nu, nu) per-color constant cross penalty
    Cp: jnp.ndarray = None  # (ncol, nu, nu)
    #
    # NOTE: bf16 table copies for the preconditioner were tried TWICE and are
    # a dead end — both the patch Schur factors (iterations 20 -> 60-210 at
    # 384^2) and the sweep's residual-update matvec tables (GMRES stalled at
    # maxiter from 128^2 up).  The sweep computes r - A z with z ~ A^{-1} r,
    # so table rounding is amplified by cond(A) ~ alpha * nx (the
    # penalty/mass entry ratio): eps_bf16 * cond crosses O(1) around
    # nx ~ 128.  Small-mesh CPU checks pass and prove nothing.


def _bm(A, x):
    """Batch-last block matvec: (nu, nu, n) x (nu, n) -> (nu, n).

    einsum form: XLA fuses the multiply-reduce without materialising the
    table-sized (nu, nu, n) product temporary of the broadcast form.
    """
    return jnp.einsum("ijn,jn->in", A, x)


def _bmm(A, B):
    """Batch-last block matmul: (n, n, m) x (n, n, m) -> (n, n, m).

    Unrolled over the contraction index as elementwise FMAs over the
    batch axis: einsum / dot_general with the batch in the minor dim
    transposes the operands to batch-major first.
    """
    out = 0.0
    for k in range(A.shape[1]):
        out = out + A[:, k, None, :] * B[None, k, :, :]
    return out


def build_tentative_operator(geom, star, c, alpha=1.0, upwind=True, pc_dtype=None,
                             reuse_factors=None):
    """Assemble blocks + facet-pair Schwarz factors per stage, batch-last.

    :arg reuse_factors: a previously built :class:`TentativeOperator` whose
        PRECONDITIONER factors (Dinv/Dinv0/Sinv) are reused instead of
        refactorised — the lagged-preconditioner mode (IEHDG_LAG_PC): the
        MATVEC tables are always rebuilt fresh from ``star`` (they define
        the operator, hence the converged solutions), so lagging can only
        move iteration counts, never results.  The factorisation is the
        compute-bound part of the build.  CAVEAT: reuse is only effective
        between builds with the SAME implicit coefficient ``c`` — the
        dominant penalty block scales with c, so factors for a different c
        precondition poorly (SSP2(3,3,2) has a_ii = 1/4, 1/4, 1/3: lagging
        stage-1 factors into stage 2 ballooned tentative iterations
        16 -> 112 at 512^2 f32).  The composite step therefore only reuses
        between stages whose a_ii match.

    The 2x2 cell-block patch  [[D_plus, -c K01], [-c K10, D_minus]]  is
    factorised in block-Schur form: per-cell D^{-1} (shared by the patches
    containing each cell) + per-facet nu x nu Schur inverse.  This resolves
    the O(alpha/h) normal-jump penalty couplings that make block Jacobi
    degrade under mesh refinement — the analogue of the reference's ILU
    preconditioner (hdg_imex.py:224-228).

    Assembly strategy (everything batch-last; no batch-major transients):
    every facet integrand separates into STATIC reference-table factors and
    per-entity coefficients, so blocks are sums of
       (static (d1, d1, nqf) tables) x (per-entity (nqf, n) coefficients)
    GEMMs plus rank-one n (x) n penalty terms with per-entity scalars.  The
    6 facet trace tables enter via one-hot masks on the per-entity
    coefficients, never via batch-major (n, nqf, d1) table gathers.
    """
    star_bl, snq = star  # (2, d1, nc), (nqf, nf)
    d1 = geom.d1
    nu = 2 * d1
    nc = geom.n_cells
    nf = geom.n_facets
    nqf = geom.wqf.shape[0]
    dtype = star_bl.dtype
    eye2 = jnp.eye(2, dtype=dtype)
    upw = 1.0 if upwind else 0.0
    # factored (Kronecker-structured) tables on uniform structured meshes:
    # see the TentativeOperator docstring
    factored = (
        geom.uniform is not None
        and geom.shift is not None
        and _fact_wanted()
    )

    # ------------------------------------------------------------------
    # own-cell blocks D = mass - c * f_impl_own
    # ------------------------------------------------------------------
    # volume convection  +c * int phi_i (Q*.grad) phi_j  (= -c * vol_f_impl)
    star_q = jnp.einsum("qi,aic->aqc", geom.phi1, star_bl)  # (2, nq, nc)
    jinv = geom.jac_inv
    # 2-term elementwise contraction (a batched einsum would transpose)
    R = jnp.stack(
        [
            jinv[b, 0][None, :] * star_q[0] + jinv[b, 1][None, :] * star_q[1]
            for b in (0, 1)
        ]
    )  # (2=b, nq, nc)
    Gvol = jnp.einsum("q,qi,qjb->ijbq", geom.wq, geom.phi1, geom.gphi1)
    S_own = c * geom.det_jac[None, None, :] * jnp.einsum("ijbq,bqc->ijc", Gvol, R)
    # mass
    S_own = S_own + geom.det_jac[None, None, :] * geom.m1[:, :, None]

    # facet terms accumulated per trace table t via one-hot masks:
    #   scalar (delta_ab):  -c * (0.5 sgn sn - upw |sn|) , interior only
    #   penalty (n (x) n):  +c * alpha / h_F              , all facets
    Gt = jnp.einsum("tqi,tqj->tijq", geom.tphi1, geom.tphi1)  # (6, d1, d1, nqf)
    Pt = jnp.einsum("q,tqi,tqj->tij", geom.wqf, geom.tphi1, geom.tphi1)  # (6, d1, d1)
    Ct = jnp.zeros((6, nqf, nc), dtype)
    NNt = jnp.zeros((6, 2, 2, nc), dtype)
    if geom.shift is not None:
        # facet values per cell slot as slices/rolls — keeps the per-stage
        # build gather-free AND slab-local (cross-slab slot values arrive
        # through the distributed shift in ops/structured.py)
        from ..ops.structured import slot_gather

        sn_slots = slot_gather(geom, snq)
        flen_slots = slot_gather(geom, geom.flen)
        hfi_slots = slot_gather(geom, geom.hF_inv)
        nrm_slots = slot_gather(geom, geom.normal)
    for l in range(3):
        if geom.shift is not None:
            sn_l, flen_l = sn_slots[l], flen_slots[l]
            hfi_l, n_l = hfi_slots[l], nrm_slots[l]
        else:
            fl = geom.cell_facets[l]
            sn_l = snq[:, fl]  # (nqf, nc)
            flen_l = geom.flen[fl]
            hfi_l = geom.hF_inv[fl]
            n_l = geom.normal[:, fl]  # (2, nc)
        int_l = 1.0 - geom.cf_bnd[l].astype(dtype)  # (nc,)
        w_l = geom.wqf[:, None] * flen_l[None, :]  # (nqf, nc)
        coeff = (-c) * (
            0.5 * geom.cfsign[l][None, :] * sn_l - upw * jnp.abs(sn_l)
        ) * w_l * int_l[None, :]
        onehot = (geom.cf_tab[l][None, :] == jnp.arange(6)[:, None]).astype(dtype)
        Ct = Ct + onehot[:, None, :] * coeff[None, :, :]
        if not factored:
            pen_l = c * alpha * hfi_l * flen_l  # (nc,)
            nn_l = n_l[:, None, :] * n_l[None, :, :]  # (2, 2, nc)
            NNt = NNt + onehot[:, None, None, :] * (pen_l[None, None, :] * nn_l)[None]
    S_own = S_own + jnp.einsum("tijq,tqc->ijc", Gt, Ct)
    if factored:
        # consumed by D_bl below AND stored: materialise once
        S_own = jax.lax.optimization_barrier(S_own)
        # penalty blocks collapse to per-half CONSTANTS: every cell of a
        # half has congruent facets (slots with fixed trace table, length,
        # normal direction — mesh/triangle_mesh.py:_attach_uniform_structure)
        halves_u = geom.uniform[1]
        Pcell_parts = []
        for h in (0, 1):
            Ph = jnp.zeros((2, d1, 2, d1), dtype)
            for (t, ln, nx_, ny_) in halves_u[h]:
                pen = c * alpha  # = c * alpha * hF_inv * flen, hF_inv = 1/flen
                nvec = jnp.asarray([nx_, ny_], dtype)
                nn = nvec[:, None] * nvec[None, :]
                Ph = Ph + pen * nn[:, None, :, None] * Pt[t][None, :, None, :]
            Pcell_parts.append(Ph.reshape(nu, nu))
        Pcell = jnp.stack(Pcell_parts)  # (2, nu, nu)
        nch = geom.shift[0] * geom.shift[1]
        if reuse_factors is not None:
            D_bl = None  # factored matvec never reads D; factors reused
        else:
            pen_cells = jnp.concatenate(
                [
                    jnp.broadcast_to(Pcell[0][:, :, None], (nu, nu, nch)),
                    jnp.broadcast_to(Pcell[1][:, :, None], (nu, nu, nc - nch)),
                ],
                axis=2,
            )
            D_bl = (
                jnp.einsum("ab,ijc->aibjc", eye2, S_own).reshape(nu, nu, nc)
                + pen_cells
            )
    else:
        pen5 = sum(
            Pt[t][None, :, None, :, None] * NNt[t][:, None, :, None, :]
            for t in range(6)
        )
        D5 = jnp.einsum("ab,ijc->aibjc", eye2, S_own) + pen5
        D_bl = D5.reshape(nu, nu, nc)
    if reuse_factors is not None:
        Dinv_bl = None  # reused from reuse_factors (early return below)
    else:
        Dinv_bl = inv_bl(D_bl)

    # ------------------------------------------------------------------
    # cross blocks Bx = -c K01 (plus rows, minus cols), Cx = -c K10
    # ------------------------------------------------------------------
    # per-facet trace tables selected by one-hot sums (static per mesh):
    onehot0 = (geom.ftab[0][None, :] == jnp.arange(6)[:, None]).astype(dtype)
    onehot1 = (geom.ftab[1][None, :] == jnp.arange(6)[:, None]).astype(dtype)
    # (nqf, d1, nf) per-facet trace tables, elementwise-built and consumed
    # only by unrolled FMA loops (the batch axis stays minor)
    U0 = sum(onehot0[t][None, None, :] * geom.tphi1[t][:, :, None] for t in range(6))
    U1 = sum(onehot1[t][None, None, :] * geom.tphi1[t][:, :, None] for t in range(6))
    msk = interior_mask(geom, 1)  # (nf,)
    wf = geom.wqf[:, None] * geom.flen[None, :]  # (nqf, nf)
    s01 = (-c) * (-0.5 * snq + upw * jnp.abs(snq)) * wf * msk[None, :]
    s10 = (-c) * (+0.5 * snq + upw * jnp.abs(snq)) * wf * msk[None, :]
    penf = (-c) * alpha * geom.hF_inv * msk  # (nf,)
    nnf = geom.normal[:, None, :] * geom.normal[None, :, :]  # (2, 2, nf)

    K01s = sum(
        U0[q, :, None, :] * (U1[q] * s01[q][None, :])[None, :, :]
        for q in range(nqf)
    )
    K10s = sum(
        U1[q, :, None, :] * (U0[q] * s10[q][None, :])[None, :, :]
        for q in range(nqf)
    )
    if factored:
        # cross penalty blocks are per-color CONSTANTS (congruent facets):
        #   Bp_k = penf_k * (sum_q wqf U0 (x) U1 * flen_k) (x) (n_k (x) n_k)
        # with penf_k * flen_k = -c * alpha exactly (hF_inv = 1/flen)
        colors_u = geom.uniform[0]
        Bp_parts, Cp_parts = [], []
        for (t0, t1, ln, nx_, ny_) in colors_u:
            PM = jnp.einsum(
                "q,qi,qj->ij", geom.wqf, geom.tphi1[t0], geom.tphi1[t1]
            )
            nvec = jnp.asarray([nx_, ny_], dtype)
            nn = nvec[:, None] * nvec[None, :]
            coef = (-c) * alpha
            Bp_parts.append(
                coef * (nn[:, None, :, None] * PM[None, :, None, :]).reshape(nu, nu)
            )
            Cp_parts.append(
                coef * (nn[:, None, :, None] * PM.T[None, :, None, :]).reshape(nu, nu)
            )
        Bp = jnp.stack(Bp_parts)  # (ncol, nu, nu)
        Cp = jnp.stack(Cp_parts)
        Bx = Cx = None
        # multi-consumer tables: materialise so XLA does not refuse
        # (= recompute) their producer chains into every consumer
        K01s, K10s = jax.lax.optimization_barrier((K01s, K10s))
    else:
        K01p = sum(
            U0[q, :, None, :] * (U1[q] * wf[q][None, :])[None, :, :]
            for q in range(nqf)
        ) * penf[None, None, :]
        Bx = (
            jnp.einsum("ab,ijf->aibjf", eye2, K01s)
            + K01p[None, :, None, :, :] * nnf[:, None, :, None, :]
        ).reshape(nu, nu, nf)
        K10p = sum(
            U1[q, :, None, :] * (U0[q] * wf[q][None, :])[None, :, :]
            for q in range(nqf)
        ) * penf[None, None, :]
        Cx = (
            jnp.einsum("ab,ijf->aibjf", eye2, K10s)
            + K10p[None, :, None, :, :] * nnf[:, None, :, None, :]
        ).reshape(nu, nu, nf)
        # multi-consumer tables: materialise so XLA does not refuse
        # (= recompute) their producer chains into every consumer
        Bx, Cx = jax.lax.optimization_barrier((Bx, Cx))

    if reuse_factors is not None:
        # lagged preconditioner: fresh matvec tables + reused factors
        rf = reuse_factors
        if factored:
            return TentativeOperator(
                D=None, Bx=None, Cx=None,
                Dinv=rf.Dinv, Sinv=rf.Sinv, Dinv0=rf.Dinv0,
                Sown=S_own, Pcell=Pcell, Ks01=K01s, Ks10=K10s,
                Bp=Bp, Cp=Cp,
            )
        return TentativeOperator(
            D=D_bl, Bx=Bx, Cx=Cx,
            Dinv=rf.Dinv, Sinv=rf.Sinv, Dinv0=rf.Dinv0,
        )

    # ------------------------------------------------------------------
    # patch Schur factors  S = D_minus - Cx Dinv_plus Bx
    # ------------------------------------------------------------------
    eye = jnp.eye(nu, dtype=dtype)
    store = pc_dtype or dtype
    if geom.shift is not None:
        # structured: per-color D gathers are rect slices/rolls at BUILD
        # time; the color-sorted Dinv0 slices are STORED contiguously (like
        # Sinv), so each patch solve streams one contiguous slice instead of
        # re-slicing the strided color rects of op.Dinv.  Costs nu*nu*nf
        # floats of device memory, already computed here for the Schur build.
        from ..ops import structured as st

        Dup = st.grid_halves(geom, D_bl)[1]
        Dinv_lo = st.grid_halves(geom, Dinv_bl)[0]
        Sinv_parts, Dinv0_parts = [], []
        for k, (l, lu, i0, j0, ni, nj, off) in enumerate(geom.shift[4]):
            rect = (i0, j0, ni, nj)
            b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
            D1 = st.rect_flat(st.roll2(geom, Dup, off), rect)
            Dinv0_k = st.rect_flat(Dinv_lo, rect)
            Dinv0_parts.append(Dinv0_k.astype(store))
            if factored:
                # reconstruct the dense color-slice cross blocks as
                # transients (the stored tables stay factored)
                Bx_k = (
                    jnp.einsum("ab,ijf->aibjf", eye2, K01s[:, :, b0:b1])
                ).reshape(nu, nu, b1 - b0) + Bp[k][:, :, None]
                Cx_k = (
                    jnp.einsum("ab,ijf->aibjf", eye2, K10s[:, :, b0:b1])
                ).reshape(nu, nu, b1 - b0) + Cp[k][:, :, None]
            else:
                Bx_k = Bx[:, :, b0:b1]
                Cx_k = Cx[:, :, b0:b1]
            Sc = D1 - _bmm(Cx_k, _bmm(Dinv0_k, Bx_k))
            if geom.fint is not None:
                # slab-local layout: color rects include boundary/dummy
                # positions — give them an identity Schur block (the patch
                # solve masks their corrections out)
                Sc = jnp.where(
                    geom.fint[b0:b1][None, None, :] > 0, Sc, eye[:, :, None]
                )
            Sinv_parts.append(inv_bl(Sc).astype(store))
        nbnd = nf - geom.n_int
        if nbnd:
            Sinv_parts.append(
                jnp.broadcast_to(eye[:, :, None], (nu, nu, nbnd)).astype(store)
            )
            # plus-cell blocks for the boundary tail, matching the
            # unstructured build's Dinv0 (one build-time gather of ~4 nx
            # facets).  Slab-local layouts carry fcells == 0 (gather path
            # unused there): the tail is then cell-0 blocks, never read —
            # the colored sweep masks every non-interior position by
            # geom.fint, exactly like Sinv's identity tail.
            Dinv0_parts.append(
                Dinv_bl[:, :, geom.fcells[0, geom.n_int :]].astype(store)
            )
        Dinv0_full = jnp.concatenate(Dinv0_parts, axis=2)
        if factored:
            return TentativeOperator(
                D=None,
                Bx=None,
                Cx=None,
                Dinv=Dinv_bl,
                Sinv=jnp.concatenate(Sinv_parts, axis=2),
                Dinv0=Dinv0_full,
                Sown=S_own,
                Pcell=Pcell,
                Ks01=K01s,
                Ks10=K10s,
                Bp=Bp,
                Cp=Cp,
            )
        return TentativeOperator(
            D=D_bl,
            Bx=Bx,
            Cx=Cx,
            Dinv=Dinv_bl,
            Sinv=jnp.concatenate(Sinv_parts, axis=2),
            Dinv0=Dinv0_full,
        )

    # chunked over facets: the unchunked chain holds D1, two _bmm
    # temporaries, Sc and Sinv live simultaneously; per-chunk temporaries
    # are freed eagerly.
    # pc_dtype (bf16 on the f32 fast path) halves the STORED factors — they
    # only steer the preconditioner, convergence is judged on the f32 matvec.
    n_chunks = 4 if nf > 200000 else 1
    bounds = [round(i * nf / n_chunks) for i in range(n_chunks + 1)]
    Sinv_chunks, Dinv0_chunks = [], []
    for f0, f1 in zip(bounds[:-1], bounds[1:]):
        fsl = slice(f0, f1)
        Dinv0_c = jax.lax.optimization_barrier(
            Dinv_bl[:, :, geom.fcells[0, fsl]]
        )
        D1_c = D_bl[:, :, geom.fcells[1, fsl]]
        Sc = D1_c - _bmm(Cx[:, :, fsl], _bmm(Dinv0_c, Bx[:, :, fsl]))
        Sc = jnp.where(msk[fsl][None, None, :] > 0, Sc, eye[:, :, None])
        Sinv_chunks.append(inv_bl(Sc).astype(store))
        Dinv0_chunks.append(Dinv0_c.astype(store))
    Sinv = jnp.concatenate(Sinv_chunks, axis=2)
    Dinv0 = jnp.concatenate(Dinv0_chunks, axis=2)

    return TentativeOperator(
        D=D_bl, Bx=Bx, Cx=Cx, Dinv=Dinv_bl, Sinv=Sinv, Dinv0=Dinv0
    )


def _gather_sides_bl(geom, ub):
    """Plus/minus cell columns of a (nu, nc) field: two (nu, nf) moves.

    Structured meshes: slices/rolls (ops/structured.py); otherwise column
    gathers."""
    if geom.shift is not None:
        from ..ops.structured import gather_plus, gather_minus

        return gather_plus(geom, ub), gather_minus(geom, ub)
    msk = interior_mask(geom, 1)[None, :]
    u0 = ub[:, geom.fcells[0]]
    u1 = ub[:, geom.fcells[1]] * msk
    return u0, u1


def _assemble_cells_bl(geom, z0, z1):
    """Facet->cell assembly: (nu, nf) sides -> (nu, nc) sum.

    One column gather per local facet from the side-concatenated array
    (a gather instead of a scatter-add: every cell has exactly three
    facets); slices/rolls on structured meshes.
    """
    if geom.shift is not None:
        from ..ops.structured import scatter_sides_sum

        return scatter_sides_sum(geom, z0, z1)
    zcat = jnp.concatenate([z0, z1], axis=1)  # (nu, 2 nf)
    out = 0.0
    for l in range(3):
        out = out + zcat[:, geom.cfassemble[l]]
    return out


def _bm2(A, x):
    """Scalar block applied to both components: (d1, d1, n) x (nu, n) -> (nu, n).

    Unrolled over the contraction index as elementwise FMAs reading the A
    table ONCE for both components (the einsum form of this contraction —
    unlike _bm's — lowers through a batch-dim dot_general that transposes
    the operands batch-major).
    """
    d1 = A.shape[0]
    x2 = x.reshape(2, d1, -1)
    out = 0.0
    for j in range(d1):
        out = out + x2[:, None, j, :] * A[None, :, j, :]
    return out.reshape(x.shape)


def _fact_apply(geom, A, P, x, per="color"):
    """(eye2 (x) A + P-constant) x over the full batch axis.

    :arg P: (ncol, nu, nu) per-color constants (``per="color"``, facet
        fields: boundary facets beyond the colors get ZERO penalty) or
        (2, nu, nu) per-half constants (``per="half"``, cell fields)
    """
    nu, m = x.shape
    z = _bm2(A, x)
    if per == "half":
        nch = geom.shift[0] * geom.shift[1]
        return z + jnp.concatenate(
            [P[0] @ x[:, :nch], P[1] @ x[:, nch:]], axis=1
        )
    b = geom.fcol_bounds
    parts = [P[k] @ x[:, b[k] : b[k + 1]] for k in range(len(b) - 1)]
    nbnd = m - b[-1]
    if nbnd:
        parts.append(jnp.zeros((nu, nbnd), x.dtype))
    return z + jnp.concatenate(parts, axis=1)


def _fact_color_apply(geom, A, Pk, x, k):
    """Single-color factored cross apply on color ``k``'s facet values:
    (eye2 (x) A[color k] + Pk) x."""
    b0 = geom.fcol_bounds[k]
    return _bm2(A[:, :, b0 : b0 + x.shape[1]], x) + Pk @ x


def _matvec_bl(geom, op, ub):
    """Assembled-block application on a component-major (nu, nc) field."""
    msk = interior_mask(geom, 1)[None, :]
    u0, u1 = _gather_sides_bl(geom, ub)
    if op.Sown is not None:  # factored tables (uniform structured mesh)
        r = _fact_apply(geom, op.Sown, op.Pcell, ub, per="half")
        z0 = _fact_apply(geom, op.Ks01, op.Bp, u1)
        z1 = _fact_apply(geom, op.Ks10, op.Cp, u0)
        # boundary positions inside slab-local color rects carry real plus
        # values in u0 but no cross coupling: mask the minus rows
        z1 = z1 * msk
    else:
        r = _bm(op.D, ub)
        z0 = _bm(op.Bx, u1)  # contribution to plus-cell rows
        z1 = _bm(op.Cx, u0) * msk  # minus-cell rows (zero on boundary)
    return r + _assemble_cells_bl(geom, z0, z1)


def tentative_operator_matvec(geom, op, u):
    """Assembled-block application of M - c f_impl: (2, d1, nc) -> same."""
    _, d1, nc = u.shape
    return _matvec_bl(geom, op, u.reshape(2 * d1, nc)).reshape(2, d1, nc)


def _patch_apply_bl(geom, op, rb):
    """Additive Schwarz on a component-major (nu, nc) residual."""
    msk = interior_mask(geom, 1)[None, :]
    r0, r1 = _gather_sides_bl(geom, rb)
    Dinv0, Sinv = op.Dinv0, op.Sinv
    if op.Sown is not None:  # factored cross blocks
        t = r1 - _fact_apply(geom, op.Ks10, op.Cp, _bm(Dinv0, r0)) * msk
        y1 = _bm(Sinv, t) * msk
        y0 = _bm(Dinv0, r0 - _fact_apply(geom, op.Ks01, op.Bp, y1))
    else:
        t = r1 - _bm(op.Cx, _bm(Dinv0, r0))
        y1 = _bm(Sinv, t) * msk
        y0 = _bm(Dinv0, r0 - _bm(op.Bx, y1))
    return _assemble_cells_bl(geom, y0, y1) / 3.0


def tentative_patch_apply(geom, op, r):
    """Additive-Schwarz facet-patch preconditioner (batch-last tables).

    Per interior facet:  y1 = Sinv (r1 - C D0inv r0);  y0 = D0inv (r0 - B y1);
    partition-of-unity weight 1/3 (every cell sits in exactly 3 patches).
    """
    _, d1, nc = r.shape
    return _patch_apply_bl(geom, op, r.reshape(2 * d1, nc)).reshape(2, d1, nc)


def _patch_color(geom, op, k, rb):
    """Exact solves of the disjoint facet-pair patches of one color.

    :arg rb: residual (nu, nc) component-major; returns (nu, nc), zero on
        cells without a color-k facet (those are untouched by this sweep).
    """
    b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
    r0 = rb[:, geom.fcells[0, b0:b1]]  # (nu, nfk)
    r1 = rb[:, geom.fcells[1, b0:b1]]
    Dinv0 = op.Dinv0[:, :, b0:b1]
    t = r1 - _bm(op.Cx[:, :, b0:b1], _bm(Dinv0, r0))
    y1 = _bm(op.Sinv[:, :, b0:b1], t)
    y0 = _bm(Dinv0, r0 - _bm(op.Bx[:, :, b0:b1], y1))
    ycat = jnp.concatenate([y0, y1], axis=1)  # (nu, 2 nfk)
    idx = geom.fcol_pos[k] + geom.fcol_side[k] * (b1 - b0)
    return ycat[:, idx] * geom.fcol_mask[k][None, :]


def _patch_color_structured(geom, op, k, rb):
    """Structured-mesh variant of :func:`_patch_color`: the per-color
    facet<->cell moves are rect slices/rolls on the [lowers; uppers] grid
    (ops/structured.py) and the plus-cell block inverses stream from the
    stored color-sorted ``op.Dinv0`` instead of strided color rects of
    ``op.Dinv``."""
    from ..ops import structured as st

    l, lu, i0, j0, ni, nj, off = geom.shift[4][k]
    rect = (i0, j0, ni, nj)
    b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
    lo, up = st.grid_halves(geom, rb)
    r0 = st.rect_flat(lo, rect)
    r1 = st.rect_flat(st.roll2(geom, up, off), rect)
    if op.Sown is not None:  # factored cross blocks (single color slice)
        Dinv0 = op.Dinv0[:, :, b0:b1]
        w = _bm(Dinv0, r0)
        t = r1 - _fact_color_apply(geom, op.Ks10, op.Cp[k], w, k)
        y1 = _bm(op.Sinv[:, :, b0:b1], t)
        y0 = _bm(Dinv0, r0 - _fact_color_apply(geom, op.Ks01, op.Bp[k], y1, k))
    else:
        Dinv0 = op.Dinv0[:, :, b0:b1]
        t = r1 - _bm(op.Cx[:, :, b0:b1], _bm(Dinv0, r0))
        y1 = _bm(op.Sinv[:, :, b0:b1], t)
        y0 = _bm(Dinv0, r0 - _bm(op.Bx[:, :, b0:b1], y1))
    if geom.fint is not None:
        # slab-local layout: no patch correction at the boundary/dummy
        # positions inside the full rects (matches the global layout, whose
        # colors contain interior facets only)
        m = geom.fint[b0:b1][None, :]
        y0 = y0 * m
        y1 = y1 * m
    z_lo = st.rect_pad(geom, y0, rect)
    z_up = st.roll2(geom, st.rect_pad(geom, y1, rect), (-off[0], -off[1]))
    return st.grid_join(geom, z_lo, z_up)


def _colored_apply_bl(geom, op, rb, symmetric=False):
    """Multiplicative colored sweep on a component-major (nu, nc) residual.

    ``symmetric=True`` continues the sweep back through the colors in
    reverse order (block-SSOR-like): stronger per application at the cost of
    ncol-1 extra patch solves + matvecs.
    """
    ncol = len(geom.fcol_bounds) - 1
    patch = _patch_color_structured if geom.shift is not None else _patch_color
    z = patch(geom, op, 0, rb)
    if geom.fcol_orphans:
        orphan = (jnp.sum(geom.fcol_mask, axis=0) == 0.0).astype(rb.dtype)
        z = z + _bm(op.Dinv, rb) * orphan[None, :]
    order = list(range(1, ncol))
    if symmetric:
        order += list(range(ncol - 2, -1, -1))
    for k in order:
        rk = rb - _matvec_bl(geom, op, z)
        z = z + patch(geom, op, k, rk)
    return z


def _color_cov(geom, k):
    """(nc,) mask of cells whose color-k patch is actually solved.

    Lower cells at the color rect + upper cells at rect+off, restricted to
    interior facet positions (``geom.fint`` on slab-local layouts; the
    global structured layouts color interior facets only).  Static data —
    XLA folds it to a constant inside a jitted sweep.
    """
    from ..ops import structured as st

    l, lu, i0, j0, ni, nj, off = geom.shift[4][k]
    rect = (i0, j0, ni, nj)
    b0, b1 = geom.fcol_bounds[k], geom.fcol_bounds[k + 1]
    if geom.fint is not None:
        fk = geom.fint[b0:b1]
    else:
        fk = jnp.ones(b1 - b0, geom.wq.dtype)
    lo = st.rect_pad(geom, fk, rect)
    up = st.roll2(geom, lo, (-off[0], -off[1]))
    return st.grid_join(geom, lo, up)


def _cross_offcolor(geom, op, k, dz):
    """Cross-coupling part of ``A dz`` via facets of colors != k.

    After an EXACT color-k pair solve, this is the only nonzero part of
    ``A dz`` on the patch cells (the own-cell + within-pair part cancels the
    residual there by construction) — the incremental-residual identity that
    lets the multiplicative sweep skip its full inter-color matvecs.
    """
    from ..ops import structured as st

    ncol = len(geom.fcol_bounds) - 1
    lo_dz, up_dz = st.grid_halves(geom, dz)
    acc_lo = 0.0
    acc_up = 0.0
    for j in range(ncol):
        if j == k:
            continue
        l, lu, i0, j0, ni, nj, off = geom.shift[4][j]
        rect = (i0, j0, ni, nj)
        b0, b1 = geom.fcol_bounds[j], geom.fcol_bounds[j + 1]
        z0 = st.rect_flat(lo_dz, rect)  # plus-side (lower-cell) values
        z1 = st.rect_flat(st.roll2(geom, up_dz, off), rect)  # minus side
        if op.Sown is not None:
            y0 = _fact_color_apply(geom, op.Ks01, op.Bp[j], z1, j)
            y1 = _fact_color_apply(geom, op.Ks10, op.Cp[j], z0, j)
        else:
            y0 = _bm(op.Bx[:, :, b0:b1], z1)
            y1 = _bm(op.Cx[:, :, b0:b1], z0)
        if geom.fint is not None:
            m = geom.fint[b0:b1][None, :]
            y0 = y0 * m
            y1 = y1 * m
        acc_lo = acc_lo + st.rect_pad(geom, y0, rect)
        acc_up = acc_up + st.roll2(
            geom, st.rect_pad(geom, y1, rect), (-off[0], -off[1])
        )
    return st.grid_join(geom, acc_lo, acc_up)


def _colored_apply_fused_bl(geom, op, vb, symmetric=False, exact_Az=True):
    """Multiplicative colored sweep returning BOTH ``z = M v`` and ``A z``.

    Mathematically identical to :func:`_colored_apply_bl` + an explicit
    matvec, but tracks the residual ``r = v - A z`` INCREMENTALLY: because
    each color's pair solves are exact and each cell has at most one facet
    per color, the post-patch residual is ``-(off-color cross)(dz)`` on
    patch cells and ``r - (off-color cross)(dz)`` on uncovered ones — no
    own-cell table read, no full matvec between colors.  Consumed by the
    right-preconditioned fused GMRES (linalg/krylov.py:gmres_right) where it
    replaces the per-iteration (sweep + matvec) pair of the tentative
    solves.

    :arg exact_Az: compute the returned ``A z`` with one explicit matvec
        (default — still saves the sweep's 4 internal matvecs).  ``False``
        returns the free ``A z = v - r`` instead: exact in exact arithmetic,
        but the incremental cancellations amplify f32 patch-factor rounding
        by cond(pair block) ~ alpha/h (the factored-vs-dense f32 sweeps
        already differ by ~0.7% at 256^2 for this reason), which perturbs
        the Arnoldi relation near the f32 tolerance floor.

    Structured meshes only (``geom.shift``); requires every cell to carry an
    interior facet (no ``fcol_orphans``), which holds on the structured
    square/periodic layouts (every cell's hypotenuse is interior).
    """
    ncol = len(geom.fcol_bounds) - 1
    order = list(range(ncol))
    if symmetric:
        order += list(range(ncol - 2, -1, -1))
    z = None
    r = vb
    for i, k in enumerate(order):
        dz = _patch_color_structured(geom, op, k, r)
        z = dz if z is None else z + dz
        if exact_Az and i == len(order) - 1:
            return z, _matvec_bl(geom, op, z)
        r = r * (1.0 - _color_cov(geom, k))[None, :] - _cross_offcolor(
            geom, op, k, dz
        )
    return z, vb - r


def tentative_colored_apply(geom, op, r, symmetric=False):
    """Multiplicative colored facet-pair Schwarz sweep.

    Block Gauss-Seidel over the conflict-free facet colors (interior facets
    are color-sorted in the mesh; on structured triangulations each color is
    a perfect matching of cells).  Solving the patches of one color exactly,
    updating the residual, and moving to the next color resolves the
    O(alpha/h) normal-jump penalty couplings *sequentially* — the analogue
    of the reference's ILU sweep (hdg_imex.py:224-228), and a much
    stronger preconditioner than the additive facet-pair variant (which
    averages conflicting patch corrections with weight 1/3).
    """
    _, d1, nc = r.shape
    return _colored_apply_bl(
        geom, op, r.reshape(2 * d1, nc), symmetric=symmetric
    ).reshape(2, d1, nc)
