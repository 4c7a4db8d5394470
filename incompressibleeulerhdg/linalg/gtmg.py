"""Two-level (GTMG-equivalent) preconditioner for the condensed trace system.

Replacement for ``firedrake.GTMGPC`` + ASMStar smoothing + gamg
coarse solve (reference src/timesteppers/hdg_imex.py:128-170 and the
appctx coarse-space callbacks at hdg_imex.py:97-118):

- fine level: the DGT trace system S (per-cell Schur blocks); smoother =
  Chebyshev over facet-block Jacobi on structured meshes, and Chebyshev
  over additive VERTEX-STAR patches (exact dense solves of S restricted to
  each vertex's facet star — the ASMStarPC analogue, hdg_imex.py:142-152)
  on unstructured meshes
- coarse level: the P1 conforming Laplacian (hdg_imex.py:101-106) —
  EXACT inverses where affordable: FFT-diagonalised on structured grids,
  dense pseudo-inverse for small unstructured meshes (<= 8k vertices), and
  Chebyshev over Jacobi beyond (replacing gamg, hdg_imex.py:153-167)
- transfer: linear interpolation of vertex values along each facet
  (the analogue of the facet-mass-inverse x P1-projection interpolation
  matrix of hdg_imex.py:491-503; for straight facets and nodal trace bases
  the two coincide up to the trace-basis change)

All pieces are linear with static iteration counts, so the preconditioner is
a fixed linear operator — safe for (left-preconditioned) GMRES.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .condense import trace_matvec

__all__ = ["TwoLevelTracePC", "build_gtmg", "gtmg_apply"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "Sdiag_inv",
        "facet_verts",
        "trace_nodes",
        "K_elem",
        "cells",
        "K_diag_inv",
        "sign",
        "vf",
        "vf_end",
        "vf_mask",
        "vc",
        "vc_pos",
        "vc_mask",
        "coarse_eig_inv",
        "coarse_scale",
        "star_inv",
        "star_pos",
        "coarse_dense_inv",
    ],
    meta_fields=[
        "n_vertices",
        "cheb_fine",
        "cheb_coarse",
        "lmax_fine",
        "lmax_coarse",
        "coarse_kind",
        "grid_shape",
        "vshift",
        "dist",
    ],
)
@dataclass
class TwoLevelTracePC:
    Sdiag_inv: jnp.ndarray  # (nt, nt, nf) batch-last
    facet_verts: jnp.ndarray  # (2, nf) endpoint vertex ids, lo -> hi
    trace_nodes: jnp.ndarray  # (nt,) nodal positions on [0, 1]
    K_elem: jnp.ndarray  # (3, 3, nc) P1 stiffness element matrices, batch-last
    cells: jnp.ndarray  # (3, nc)
    K_diag_inv: jnp.ndarray  # (nv,)
    sign: jnp.ndarray  # scalar: sign making sign*S positive semidefinite
    # padded vertex adjacency (gather-based assembly instead of scatter-adds)
    vf: jnp.ndarray  # (nv, Dv) facet ids touching each vertex
    vf_end: jnp.ndarray  # (nv, Dv) 0 = vertex is the facet's lo end, 1 = hi
    vf_mask: jnp.ndarray  # (nv, Dv) 1.0 valid
    vc: jnp.ndarray  # (nv, Dc) cell ids touching each vertex
    vc_pos: jnp.ndarray  # (nv, Dc) local vertex index within the cell
    vc_mask: jnp.ndarray  # (nv, Dc)
    coarse_eig_inv: jnp.ndarray = None  # spectral inverse (structured meshes)
    coarse_scale: jnp.ndarray = None  # (nv,) D^{-1} boundary-row scaling
    # vertex-star additive-Schwarz smoother tables (unstructured meshes —
    # the ASMStarPC analogue, reference src/timesteppers/hdg_imex.py:142-152):
    # per vertex, the dense inverse of S restricted to the trace dofs of all
    # facets meeting that vertex; each facet belongs to exactly its two
    # endpoint stars, so scatter-back weight 1/2 is an exact partition
    star_inv: jnp.ndarray = None  # (Dv*nt, Dv*nt, nv) batch-last
    star_pos: jnp.ndarray = None  # (2, nf) position of facet in its
    # endpoint-vertex patch (paired with facet_verts)
    # exact coarse solve for small unstructured meshes: dense pseudo-inverse
    # of the singular P1 Laplacian (a (nv, nv) dense matvec per V-cycle,
    # cheap up to a few thousand vertices; gamg's exactness analogue)
    coarse_dense_inv: jnp.ndarray = None
    # static vertex-shift spec (Mx, My, wrap, groups) mapping every facet
    # group's endpoint vertices to constant vertex-grid offsets — turns
    # restrict/prolong into slices/rolls (None: padded-adjacency gathers)
    vshift: tuple = None
    # slab-decomposed transfers (parallel/slab.py):
    # (axis_name, n_slabs, Mx, My, canvas_rows, local_groups) — restrict
    # accumulates into a local (canvas_rows, My) vertex canvas, embeds it at
    # the slab's row offset and psums to a replicated global residual; the
    # coarse FFT solve then runs replicated and prolong slices it back
    dist: tuple = None
    n_vertices: int = 0
    coarse_kind: str = "cheb"  # "cheb" | "fft_neumann" | "fft_periodic"
    grid_shape: tuple = None
    cheb_fine: int = 2
    cheb_coarse: int = 25
    lmax_fine: float = 1.0
    lmax_coarse: float = 1.0


def _facet_endpoints(mesh):
    """Global endpoint vertex ids of every facet in CANONICAL order.

    Canonical = the orientation the flip bits encode (geometric
    coordinate-lexicographic, mesh/triangle_mesh.py) — NOT ascending gid,
    which reverses on periodic wrap seams."""
    from ..mesh.triangle_mesh import LOCAL_FACET_VERTS

    cp = mesh.facet_cells[:, 0]
    lp = mesh.facet_local[:, 0]
    va = mesh.cells[cp, LOCAL_FACET_VERTS[lp, 0]]
    vb = mesh.cells[cp, LOCAL_FACET_VERTS[lp, 1]]
    fl = mesh.facet_flip[:, 0].astype(bool)
    lo = np.where(fl, vb, va)
    hi = np.where(fl, va, vb)
    return np.stack([lo, hi], axis=1).astype(np.int32)


def _vertex_shift_groups(mesh):
    """Constant vertex-grid offsets of every facet group's endpoints.

    For each facet group of the shift spec (colors + boundary groups, in
    facet order) verify that the lo/hi endpoint vertices sit at a constant
    vertex-grid offset from the facet's grid position; returns
    ``(Mx, My, wrap, groups)`` with groups entries
    ``(f0, f1, i0, j0, ni, nj, (dlo_i, dlo_j), (dhi_i, dhi_j))``,
    or None (fall back to the padded-adjacency gathers).
    """
    spec = getattr(mesh, "shift_spec", None)
    sg = getattr(mesh, "structured_grid", None)
    if spec is None or sg is None:
        return None
    kind, Mx, My = sg[0], sg[1], sg[2]
    wrap = kind == "periodic"
    fv = _facet_endpoints(mesh)
    bounds = mesh.facet_color_bounds
    items = [
        (bounds[k], bounds[k + 1], col[2], col[3], col[4], col[5])
        for k, col in enumerate(spec[4])
    ]
    items += [(f0, f0 + ni * nj, i0, j0, ni, nj) for (h, l, i0, j0, ni, nj, f0) in spec[5]]
    groups = []
    expect_f0 = 0
    for (f0, f1, i0, j0, ni, nj) in items:
        if f0 != expect_f0:
            return None
        expect_f0 = f1
        pi = i0 + np.repeat(np.arange(ni), nj)
        pj = j0 + np.tile(np.arange(nj), ni)
        offs = []
        for e in range(2):
            v = fv[f0:f1, e]
            vi, vj = v // My, v % My
            di, dj = vi - pi, vj - pj
            if wrap:
                di = (di + Mx // 2) % Mx - Mx // 2
                dj = (dj + My // 2) % My - My // 2
            if v.size == 0 or not (np.all(di == di[0]) and np.all(dj == dj[0])):
                return None
            offs.append((int(di[0]), int(dj[0])))
        groups.append((f0, f1, i0, j0, ni, nj, offs[0], offs[1]))
    if expect_f0 != mesh.n_facets:
        return None
    return (int(Mx), int(My), wrap, tuple(groups))


def build_gtmg(disc, cs, cheb_fine=2, cheb_coarse=25, power_iters=25):
    """Build the two-level preconditioner (setup; a few device matvecs for
    eigenvalue estimates)."""
    mesh = disc.mesh
    geom = disc.geom
    nv = mesh.n_vertices

    facet_verts = _facet_endpoints(mesh)
    trace_nodes = disc.Vt.nodes

    # P1 stiffness: K_ab = area * g_a . g_b with physical gradients of the
    # barycentric basis; area = detJ / 2
    ghat = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    gphys = np.einsum("ab,cbd->cad", ghat, mesh.jac_inv)  # (nc, 3, 2)
    K_elem = 0.5 * mesh.det_jac[:, None, None] * np.einsum(
        "cad,cbd->cab", gphys, gphys
    )
    K_diag = np.zeros(nv)
    np.add.at(K_diag, mesh.cells, np.einsum("caa->ca", K_elem))

    # sign and eigenvalue estimates: host-side numpy power iteration (one
    # eager device dispatch per iteration would dominate setup time).  Use
    # the host copies stashed by build_condensed_system instead of pulling
    # the device tables back.
    rng = np.random.default_rng(7)
    host = getattr(disc, "_cs_host", None)
    if host is not None:
        S_np = np.asarray(host["S"], dtype=np.float64)
        Sdiag_inv_np = np.asarray(host["Sdiag_inv"], dtype=np.float64)
    else:
        S_np = np.asarray(cs.S, dtype=np.float64).transpose(2, 0, 1)
        Sdiag_inv_np = np.asarray(cs.Sdiag_inv, dtype=np.float64).transpose(2, 0, 1)
    cf = mesh.cell_facets
    nt = S_np.shape[-1] // 3
    nf = mesh.n_facets

    def trace_mv_np(lam):
        lam_c = lam[cf].reshape(mesh.n_cells, -1)
        y_c = np.einsum("cij,cj->ci", S_np, lam_c)
        out = np.zeros_like(lam)
        np.add.at(out, cf, y_c.reshape(mesh.n_cells, 3, nt))
        return out

    x = rng.standard_normal((nf, nt))
    sign = float(np.sign(np.vdot(x, trace_mv_np(x))))

    def fine_op(v):
        # D(S)^{-1} S == D(A)^{-1} A for A = sign*S (signs cancel); its
        # spectrum is positive either way
        return np.einsum("fij,fj->fi", Sdiag_inv_np, trace_mv_np(v))

    v = rng.standard_normal((nf, nt))
    for _ in range(power_iters):
        v = fine_op(v)
        v = v / np.linalg.norm(v)
    lmax_fine = float(np.vdot(v, fine_op(v)))

    Kdi_np = 1.0 / np.maximum(K_diag, 1e-300)

    def coarse_mv_np(z):
        loc = np.einsum("cab,cb->ca", K_elem, z[mesh.cells])
        out = np.zeros_like(z)
        np.add.at(out, mesh.cells, loc)
        return out

    w = rng.standard_normal(nv)
    for _ in range(power_iters):
        w = Kdi_np * coarse_mv_np(w)
        w = w / np.linalg.norm(w)
    lmax_coarse = float(np.vdot(w, Kdi_np * coarse_mv_np(w)))

    cells_j = jnp.asarray(mesh.cells.T.astype(np.int32))
    K_elem_j = jnp.asarray(K_elem.transpose(1, 2, 0), dtype=disc.dtype)
    Kdi = jnp.asarray(Kdi_np, dtype=disc.dtype)

    def padded_adjacency(pairs_v, payload_cols):
        """pairs_v: (N,) vertex of each incidence; payloads: list of (N,) arrays.
        Returns padded (nv, D) tables + mask."""
        order = np.argsort(pairs_v, kind="stable")
        sv = pairs_v[order]
        deg = np.bincount(pairs_v, minlength=nv)
        D = int(deg.max())
        start = np.concatenate([[0], np.cumsum(deg)])
        pos = np.arange(sv.shape[0]) - start[sv]
        tables = []
        for col in payload_cols:
            t = np.zeros((nv, D), dtype=col.dtype)
            t[sv, pos] = col[order]
            tables.append(t)
        mask = np.zeros((nv, D))
        mask[sv, pos] = 1.0
        return tables, mask

    # spectral coarse solve on structured square grids: the P1 stiffness on a
    # uniform right-triangulated grid is the 5-point graph Laplacian with
    # weights (hy/hx, hx/hy), diagonalised by DCT-I (Neumann) / DFT (periodic)
    coarse_kind = "cheb"
    grid_shape = None
    eig_inv = jnp.zeros((1, 1), dtype=disc.dtype)
    coarse_scale = jnp.ones((nv,), dtype=disc.dtype)
    sg = getattr(mesh, "structured_grid", None)
    if sg is not None:
        kind = sg[0]
        if kind == "neumann":
            Mx, My = sg[1], sg[2]
            xs = mesh.vertices[:, 0].reshape(Mx, My)
            ys = mesh.vertices[:, 1].reshape(Mx, My)
            hx = float(xs[1, 0] - xs[0, 0])
            hy = float(ys[0, 1] - ys[0, 0])
            kx = np.arange(Mx)
            ky = np.arange(My)
            lx = (hy / hx) * (2.0 - 2.0 * np.cos(np.pi * kx / (Mx - 1)))
            ly = (hx / hy) * (2.0 - 2.0 * np.cos(np.pi * ky / (My - 1)))
            lam2 = lx[:, None] + ly[None, :]
            lam2[0, 0] = 1.0
            inv = 1.0 / lam2
            inv[0, 0] = 0.0  # constant mode: deflated
            coarse_kind = "fft_neumann"
            grid_shape = (Mx, My)
            eig_inv = jnp.asarray(inv, dtype=disc.dtype)
            # FEM boundary rows are half/quarter stencils: K = D * A_mirror
            # with D = diag(1, 1/2 edge, 1/4 corner); the spectral solve
            # inverts A_mirror, so pre-scale the residual by D^{-1} — this
            # makes the coarse solve EXACT for the structured FEM Laplacian
            wgt = np.ones((Mx, My))
            wgt[0, :] *= 0.5
            wgt[-1, :] *= 0.5
            wgt[:, 0] *= 0.5
            wgt[:, -1] *= 0.5
            coarse_scale = jnp.asarray(1.0 / wgt, dtype=disc.dtype).ravel()
        elif kind == "periodic":
            nx_, ny_ = sg[1], sg[2]
            hx = 1.0  # uniform square cells: weights are ratio-only
            kx = np.arange(nx_)
            ky = np.arange(ny_)
            lx = 2.0 - 2.0 * np.cos(2.0 * np.pi * kx / nx_)
            ly = 2.0 - 2.0 * np.cos(2.0 * np.pi * ky / ny_)
            lam2 = lx[:, None] + ly[None, :]
            lam2[0, 0] = 1.0
            inv = 1.0 / lam2
            inv[0, 0] = 0.0
            coarse_kind = "fft_periodic"
            grid_shape = (nx_, ny_)
            eig_inv = jnp.asarray(inv, dtype=disc.dtype)

    fv_flat = facet_verts.ravel()  # incidence (facet, end)
    fid = np.repeat(np.arange(mesh.n_facets, dtype=np.int32), 2)
    fend = np.tile(np.array([0, 1], dtype=np.int32), mesh.n_facets)
    (vf_t, vf_end_t), vf_mask = padded_adjacency(fv_flat, [fid, fend])

    cv_flat = mesh.cells.ravel()
    cid = np.repeat(np.arange(mesh.n_cells, dtype=np.int32), 3)
    cpos = np.tile(np.array([0, 1, 2], dtype=np.int32), mesh.n_cells)
    (vc_t, vc_pos_t), vc_mask = padded_adjacency(cv_flat, [cid, cpos])

    # ---- vertex-star smoother (unstructured meshes; ASMStarPC analogue,
    # hdg_imex.py:142-152): exact dense solves of S restricted to each
    # vertex's facet star, applied additively with weight 1/2 (every facet
    # has exactly two endpoint stars).  Structured meshes keep the
    # facet-block Jacobi smoother — the FFT coarse solve already gives
    # mesh-independent counts there, and the block Jacobi is cheaper.
    star_inv_j = None
    star_pos_j = None
    star_np = None
    coarse_dense_inv_j = None
    # the star setup is an O(nv) host loop (sparse patch extraction + dense
    # inverse per vertex) plus an (Dv nt, Dv nt, nv) device table — gate it
    # so very large unstructured meshes degrade to the Chebyshev-Jacobi
    # smoother instead of hitting a multi-minute setup cliff
    _STAR_MAX_VERTICES = 65536
    if coarse_kind == "cheb" and nv > _STAR_MAX_VERTICES:
        import warnings

        warnings.warn(
            f"GTMG vertex-star smoother disabled: {nv} vertices exceeds "
            f"the setup gate ({_STAR_MAX_VERTICES}); using Chebyshev-Jacobi "
            "smoothing (expect higher iteration counts)",
            RuntimeWarning,
        )
    if coarse_kind == "cheb" and nv <= _STAR_MAX_VERTICES:
        import scipy.sparse as _sp

        S_cells = S_np  # (nc, 3nt, 3nt) float64 host copy from above
        cfac = mesh.cell_facets
        gdof = (cfac[:, :, None] * nt + np.arange(nt)[None, None, :]).reshape(
            mesh.n_cells, 3 * nt
        )
        ri = np.repeat(gdof[:, :, None], 3 * nt, axis=2)
        ci = np.repeat(gdof[:, None, :], 3 * nt, axis=1)
        S_glob = _sp.coo_matrix(
            (S_cells.ravel(), (ri.ravel(), ci.ravel())),
            shape=(nf * nt, nf * nt),
        ).tocsr()
        Dv = vf_t.shape[1]
        mdim = Dv * nt
        Pinv = np.zeros((nv, mdim, mdim))
        for v in range(nv):
            deg = int(vf_mask[v].sum())
            fs = vf_t[v, :deg]
            idx = (fs[:, None] * nt + np.arange(nt)[None, :]).ravel()
            blk = sign * S_glob[idx][:, idx].toarray()
            Pv = np.eye(mdim)
            Pv[: deg * nt, : deg * nt] = blk
            Pinv[v] = np.linalg.inv(Pv)
        # facet -> (position within endpoint patch) lookup
        star_pos = np.zeros((2, mesh.n_facets), np.int32)
        for v in range(nv):
            deg = int(vf_mask[v].sum())
            for p in range(deg):
                star_pos[vf_end_t[v, p], vf_t[v, p]] = p

        def star_np_apply(r):
            """(nf, nt) -> (nf, nt) numpy vertex-star apply (for lmax)."""
            rv = np.zeros((nv, mdim))
            for p in range(Dv):
                rv[:, p * nt : (p + 1) * nt] = (
                    r[vf_t[:, p]] * vf_mask[:, [p]]
                )
            y = np.einsum("vij,vj->vi", Pinv, rv)
            z = np.zeros_like(r)
            for e in range(2):
                cols = star_pos[e][:, None] * nt + np.arange(nt)[None, :]
                z += 0.5 * np.take_along_axis(
                    y[facet_verts[:, e]], cols, axis=1
                )
            return z

        star_np = star_np_apply
        star_inv_j = jnp.asarray(Pinv.transpose(1, 2, 0), dtype=disc.dtype)
        star_pos_j = jnp.asarray(star_pos)

        # exact coarse solve: dense pseudo-inverse of the (singular) P1
        # Laplacian for small unstructured meshes — one (nv, nv) dense matvec
        # per V-cycle; the Chebyshev-Jacobi coarse approximation was the
        # remaining source of h-dependent iteration growth
        if nv <= 8192:
            K_dense = np.zeros((nv, nv))
            for a in range(3):
                for b in range(3):
                    np.add.at(
                        K_dense,
                        (mesh.cells[:, a], mesh.cells[:, b]),
                        K_elem[:, a, b],
                    )
            coarse_dense_inv_j = jnp.asarray(
                np.linalg.pinv(K_dense, rcond=1e-10), dtype=disc.dtype
            )
        else:
            coarse_dense_inv_j = None

        # the Chebyshev bounds target the STAR-preconditioned spectrum
        def fine_op_star(vv):
            return star_np(sign * trace_mv_np(vv))

        v = rng.standard_normal((nf, nt))
        for _ in range(power_iters):
            v = fine_op_star(v)
            v = v / np.linalg.norm(v)
        lmax_fine = float(np.vdot(v, fine_op_star(v)))

    return TwoLevelTracePC(
        Sdiag_inv=cs.Sdiag_inv,
        facet_verts=jnp.asarray(facet_verts.T),
        trace_nodes=jnp.asarray(trace_nodes, dtype=disc.dtype),
        K_elem=K_elem_j,
        cells=cells_j,
        K_diag_inv=Kdi,
        sign=jnp.asarray(sign, dtype=disc.dtype),
        vf=jnp.asarray(vf_t),
        vf_end=jnp.asarray(vf_end_t),
        vf_mask=jnp.asarray(vf_mask, dtype=disc.dtype),
        vc=jnp.asarray(vc_t),
        vc_pos=jnp.asarray(vc_pos_t),
        vc_mask=jnp.asarray(vc_mask, dtype=disc.dtype),
        coarse_eig_inv=eig_inv,
        coarse_scale=coarse_scale,
        star_inv=star_inv_j,
        star_pos=star_pos_j,
        coarse_dense_inv=coarse_dense_inv_j,
        vshift=_vertex_shift_groups(mesh),
        n_vertices=nv,
        coarse_kind=coarse_kind,
        grid_shape=grid_shape,
        cheb_fine=cheb_fine,
        cheb_coarse=cheb_coarse,
        lmax_fine=abs(lmax_fine),
        lmax_coarse=abs(lmax_coarse),
    )


def _chebyshev(apply_A, apply_Minv, r, niter, lmax):
    """Chebyshev iteration for A z = r targeting [0.1 lmax, 1.1 lmax]."""
    lmin = 0.1 * lmax
    lmax = 1.1 * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    z = apply_Minv(r) / theta
    if niter == 1:
        return z
    d = z
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(niter - 1):
        res = apply_Minv(r - apply_A(z))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * res
        rho = rho_new
        z = z + d
    return z


def _dct1_2d(u):
    """2-D DCT-I via FFT of the even extension; involutive up to 4 Nx Ny."""
    v = jnp.concatenate([u, u[-2:0:-1, :]], axis=0)
    v = jnp.concatenate([v, v[:, -2:0:-1]], axis=1)
    return jnp.fft.fft2(v).real[: u.shape[0], : u.shape[1]]


def _coarse_solve(pc, rc):
    """Approximately invert the P1 coarse Laplacian.

    Structured meshes: exact spectral inverse of the 5-point stencil in a
    handful of FFT kernels (a 25-iteration Chebyshev chain is a long
    sequence of tiny launch-bound kernels).
    Unstructured meshes: Chebyshev over Jacobi with the gathered stencil.
    """
    # the spectral solve runs in the working dtype and is exact
    if pc.coarse_kind == "fft_neumann":
        Mx, My = pc.grid_shape
        u = (rc * pc.coarse_scale).reshape(Mx, My)
        c = _dct1_2d(u) * pc.coarse_eig_inv
        z = _dct1_2d(c) / (4.0 * (Mx - 1) * (My - 1))
        return z.reshape(-1).astype(rc.dtype)
    if pc.coarse_kind == "fft_periodic":
        nx_, ny_ = pc.grid_shape
        u = rc.reshape(nx_, ny_)
        c = jnp.fft.fft2(u) * pc.coarse_eig_inv
        return jnp.fft.ifft2(c).real.reshape(-1).astype(rc.dtype)

    if pc.coarse_dense_inv is not None:
        return pc.coarse_dense_inv @ rc  # exact (pseudo-)inverse

    def Ac(v):
        vg = v[pc.cells]  # (3, nc)
        loc = jnp.einsum("abc,bc->ac", pc.K_elem, vg)  # (3, nc)
        # vertex assembly: one flat 1-D gather per adjacency column
        locf = loc.ravel()
        nc_ = loc.shape[1]
        out = 0.0
        for d in range(pc.vc.shape[1]):
            out = out + pc.vc_mask[:, d] * locf[pc.vc_pos[:, d] * nc_ + pc.vc[:, d]]
        return out

    def Dc(v):
        return pc.K_diag_inv * v

    return _chebyshev(Ac, Dc, rc, pc.cheb_coarse, pc.lmax_coarse)


def prolong(pc, zc):
    """P1 vertex values -> trace dofs: linear interpolation along each facet.

    (nv,) -> (nt, nf).  Structured meshes read the endpoint values as
    slices/rolls of the vertex grid (vshift); otherwise two (nf,) gathers.
    Slab-decomposed runs slice the slab's rows out of the replicated global
    coarse solution first.
    """
    if pc.dist is not None:
        from ..ops.structured import _shift_axis, rect_flat

        axis_name, n_slabs, Mx, My, crows, groups, wrap = pc.dist
        zg = zc.reshape(Mx, My)  # replicated global coarse solution
        if wrap:
            # periodic i seam: the last slab's interface row is row 0 —
            # extend the canvas so the dynamic row slice never wraps
            zg = jnp.concatenate([zg, zg[:1]], axis=0)
        # uneven decompositions (nx % n_slabs != 0) pad the grid with dummy
        # trailing columns on the last slab: extend the canvas with zero
        # rows so its row slice never clamps/shifts (the dummy-vertex values
        # are masked downstream by geom.fvalid)
        rows_needed = n_slabs * (crows - 1) + 1
        if rows_needed > zg.shape[0]:
            zg = jnp.concatenate(
                [zg, jnp.zeros((rows_needed - zg.shape[0], My), zg.dtype)]
            )
        row0 = jax.lax.axis_index(axis_name) * (crows - 1)
        local = jax.lax.dynamic_slice(zg, (row0, jnp.int32(0)), (crows, My))

        def shv(a, d):
            # i offsets stay inside the local (crows, My) canvas; j offsets
            # wrap on periodic meshes (the H family's j = ny-1 seam)
            return _shift_axis(_shift_axis(a, d[0], -2, False), d[1], -1, wrap)

        lo_parts, hi_parts = [], []
        for (f0, f1, i0, j0, ni, nj, dlo, dhi) in groups:
            rect = (i0, j0, ni, nj)
            lo_parts.append(rect_flat(shv(local, dlo), rect))
            hi_parts.append(rect_flat(shv(local, dhi), rect))
        lo = jnp.concatenate(lo_parts)
        hi = jnp.concatenate(hi_parts)
        s = pc.trace_nodes[:, None]
        return lo[None, :] * (1.0 - s) + hi[None, :] * s
    if pc.vshift is not None:
        from ..ops.structured import shift2, rect_flat

        Mx, My, wrap, groups = pc.vshift
        zg = zc.reshape(Mx, My)
        lo_parts, hi_parts = [], []
        for (f0, f1, i0, j0, ni, nj, dlo, dhi) in groups:
            rect = (i0, j0, ni, nj)
            lo_parts.append(rect_flat(shift2(zg, dlo, wrap), rect))
            hi_parts.append(rect_flat(shift2(zg, dhi, wrap), rect))
        lo = jnp.concatenate(lo_parts)
        hi = jnp.concatenate(hi_parts)
    else:
        lo = zc[pc.facet_verts[0]]  # (nf,)
        hi = zc[pc.facet_verts[1]]
    s = pc.trace_nodes[:, None]
    return lo[None, :] * (1.0 - s) + hi[None, :] * s


def restrict(pc, lam):
    """Adjoint of prolong: (nt, nf) -> (nv,).

    Structured meshes scatter the two endpoint accumulants by grid
    pads/rolls; otherwise padded vertex-facet adjacency gathers.
    """
    s = pc.trace_nodes[:, None]
    a_lo = jnp.sum(lam * (1.0 - s), axis=0)  # (nf,)
    a_hi = jnp.sum(lam * s, axis=0)
    if pc.dist is not None:
        from ..ops.structured import _shift_axis

        axis_name, n_slabs, Mx, My, crows, groups, wrap = pc.dist
        canvas = jnp.zeros((crows, My), lam.dtype)
        for (f0, f1, i0, j0, ni, nj, dlo, dhi) in groups:
            for arr, d in ((a_lo, dlo), (a_hi, dhi)):
                seg = arr[f0:f1].reshape(ni, nj)
                pad = jnp.pad(seg, ((i0, crows - i0 - ni), (j0, My - j0 - nj)))
                # facet p contributes to canvas vertex p + d: adjoint shift
                # by -d (i stays inside the local canvas; j wraps on
                # periodic meshes)
                canvas = canvas + _shift_axis(
                    _shift_axis(pad, -d[0], -2, False), -d[1], -1, wrap
                )
        row0 = jax.lax.axis_index(axis_name) * (crows - 1)
        # periodic: extended canvas, fold below; uneven decompositions:
        # extra dummy rows so the last slab's embedding never clamps (their
        # contributions are zero — dummy-facet lam is fvalid-masked)
        rows = max(Mx + 1 if wrap else Mx, n_slabs * (crows - 1) + 1)
        glob = jax.lax.dynamic_update_slice(
            jnp.zeros((rows, My), lam.dtype), canvas, (row0, jnp.int32(0))
        )
        if wrap:
            glob = glob[:Mx].at[0].add(glob[Mx])
        else:
            glob = glob[:Mx]
        # shared slab-interface vertex rows are resolved by the sum; the
        # result is the REPLICATED global coarse residual (1 MB at 512^2)
        return jax.lax.psum(glob, axis_name).ravel()
    if pc.vshift is not None:
        from ..ops.structured import shift2

        Mx, My, wrap, groups = pc.vshift
        acc = jnp.zeros((Mx, My), lam.dtype)
        for (f0, f1, i0, j0, ni, nj, dlo, dhi) in groups:
            for arr, d in ((a_lo, dlo), (a_hi, dhi)):
                seg = arr[f0:f1].reshape(ni, nj)
                pad = jnp.pad(seg, ((i0, Mx - i0 - ni), (j0, My - j0 - nj)))
                # facet p contributes to vertex p + d: adjoint shift by -d
                acc = acc + shift2(pad, (-d[0], -d[1]), wrap)
        return acc.ravel()
    # side-concatenated flat gather per adjacency column
    acat = jnp.concatenate([a_lo, a_hi])
    nf_ = a_lo.shape[0]
    out = 0.0
    for d in range(pc.vf.shape[1]):
        idx = pc.vf[:, d] + pc.vf_end[:, d] * nf_
        out = out + pc.vf_mask[:, d] * acat[idx]
    return out


def _star_apply(pc, r):
    """Additive vertex-star smoother: (nt, nf) -> (nt, nf).

    Exact dense patch solves per vertex, scatter-back weight 1/2 (each
    facet's dofs appear in exactly its two endpoint stars).
    """
    nt = r.shape[0]
    rg = r[:, pc.vf] * pc.vf_mask[None]  # (nt, nv, Dv)
    rv = jnp.transpose(rg, (2, 0, 1)).reshape(pc.star_inv.shape[0], -1)
    y = jnp.einsum("ijv,jv->iv", pc.star_inv, rv)
    z = 0.0
    for e in range(2):
        ycol = y[:, pc.facet_verts[e]]  # (Dv*nt, nf)
        idx = pc.star_pos[e][None, :] * nt + jnp.arange(nt)[:, None]
        z = z + 0.5 * jnp.take_along_axis(ycol, idx, axis=0)
    return z


def gtmg_apply(geom, cs, pc, r_flat):
    """Multiplicative two-level V-cycle approximating S^{-1} r.

    Flat vectors are the (nt, nf) batch-last trace layout ravelled.
    """
    nt = cs.nt
    r = (pc.sign * r_flat).reshape(nt, -1)  # work with A = sign * S (positive)

    def A(v):
        return pc.sign * trace_matvec(geom, cs, v)

    def Dinv(v):
        if pc.star_inv is not None:
            return _star_apply(pc, v)  # built from sign*S: A^{-1}-approx already
        # einsum, not an unrolled loop: measured tie at (3,3,nf) and a 2x
        # einsum win at (9,9,nc) — tools/microbench_bm.py, round 5
        return pc.sign * jnp.einsum("ijf,jf->if", cs.Sdiag_inv, v)

    # pre-smooth
    z = _chebyshev(A, Dinv, r, pc.cheb_fine, pc.lmax_fine)
    # coarse correction
    rc = restrict(pc, r - A(z))

    zc = _coarse_solve(pc, rc)
    pr = prolong(pc, zc)
    if getattr(geom, "fvalid", None) is not None:
        pr = pr * geom.fvalid  # dummy facet positions of slab-local layouts
    z = z + pr
    # post-smooth
    z = z + _chebyshev(A, Dinv, r - A(z), pc.cheb_fine, pc.lmax_fine)
    return (pc.sign * z).ravel()
