"""Slab-decomposed distributed execution: shard_map + single-row ppermute halos.

This is the analogue of the reference's PETSc-MPI domain
decomposition (SURVEY.md sections 2.4, 5.8): the structured [lowers; uppers]
mesh is cut into ``n_slabs`` contiguous i-slabs, one per device.  Each device
holds ONLY its slab's cells, facets, and operator tables (per-device memory
is 1/n_slabs of the global problem), and the entire step runs inside one
``shard_map``:

- every facet<->cell move is a slice/roll (ops/structured.py); the only
  i-direction offsets are +-1, so the halo is exactly one grid row exchanged
  by ``lax.ppermute`` (see ``_dist_shift_i``) — NO cell-array all-gathers
  anywhere (asserted by tests/test_slab.py's collective audit);
- Krylov inner products / integrals are psum reductions (linalg/krylov.py);
- the GTMG coarse residual (the P1 vertex field, ~1 MB at 512^2) is the one
  globally shared object: accumulated into a local vertex canvas, embedded
  at the slab's row offset and psum'd to a replicated global vector; the
  exact FFT coarse solve then runs replicated (linalg/gtmg.py).

Local facet layout (uniform across slabs, required by SPMD):

    [V (nxl, ny); D (nxl, ny); H (nxl, ny); T (nxl,); L (ny,)]

indexed by the facet's plus cell: V = vertical (lower slot 0; the
i = nx-1 column is the global right boundary), D = diagonal, H = horizontal
(the j = 0 row is the bottom boundary), T = top boundary (upper slot 0),
L = left boundary (upper slot 1) — REAL only on slab 0, a zero-masked DUMMY
family elsewhere (``geom.fvalid``); interface values travel through the
rolls, never through dummies.

Numerical contract: the distributed solve is IDENTICAL to the single-device
solve (same operators, same preconditioners, same reduction order up to
float associativity) — pinned by tests/test_slab.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..fem.discretisation import Geom
from ..linalg.condense import CondensedSystem
from ..linalg.gtmg import TwoLevelTracePC, _facet_endpoints
from ..ops.projection import BDMProjection

__all__ = [
    "SlabDecomposition",
    "slab_supported",
    "build_slab_decomposition",
    "scatter_state",
    "make_distributed_step",
    "make_distributed_simple_step",
]

AXIS = "slab"


def slab_supported(mesh, n_slabs):
    """Whether the slab decomposition covers this (mesh, n_slabs) pair.

    Mirrors the :class:`SlabDecomposition` constructor checks WITHOUT
    raising, so callers (hdg_imex.solve, common.slab_context) can fall back
    to the GSPMD sharding instead of erroring — the reference's MPI
    decomposition covers every mesh uniformly
    (reference src/timesteppers/conforming_implicit.py:86), so an
    ``--n_devices`` split the slab layout cannot represent (periodic mesh
    with ``nx % n_devices != 0``, whose wrap halo needs the last local grid
    row to be physical) must still run, just on the fallback path.
    """
    spec = getattr(mesh, "shift_spec", None)
    if spec is None or n_slabs <= 1:
        return False
    nx, periodic = spec[0], spec[2]
    nxl = -(-nx // n_slabs)
    if periodic and n_slabs * nxl != nx:
        return False
    if nxl * (n_slabs - 1) >= nx:  # an empty trailing slab
        return False
    return True


class SlabDecomposition:
    """Stacked per-slab Geom/operator pytrees + index maps (host object)."""

    def __init__(self, disc, stepper, n_slabs):
        mesh = disc.mesh
        spec = mesh.shift_spec
        # user-facing (--n_devices) validation: real errors, not asserts
        # (asserts vanish under python -O and a truncating nx // n_slabs
        # would silently drop grid rows)
        if spec is None:
            raise RuntimeError("slab decomposition needs a structured mesh")
        nx, ny, periodic = spec[0], spec[1], spec[2]
        # nx % n_slabs != 0: pad the grid to n_slabs * ceil(nx / n_slabs)
        # columns; the trailing dummy columns all live on the LAST slab
        # (zero-masked cells/facets — geom.cvalid/fvalid), so the halo
        # exchange between real slabs is untouched.  Periodic meshes need
        # the last local row to be the physical wrap neighbor of slab 0, so
        # they still require divisibility.
        nxl = -(-nx // n_slabs)
        pad = n_slabs * nxl - nx
        if pad and periodic:
            raise RuntimeError(
                f"n_devices={n_slabs} must divide nx={nx} on periodic meshes "
                "(the wrap halo needs the last local grid row to be physical)"
            )
        if nxl * (n_slabs - 1) >= nx:
            raise RuntimeError(
                f"n_devices={n_slabs} leaves an empty slab at nx={nx}: use "
                f"n_devices <= {max(1, nx // max(1, nxl))}"
            )
        self.disc = disc
        self.n_slabs = n_slabs
        self.nx, self.ny, self.nxl = nx, ny, nxl
        self.pad = pad
        self.periodic = periodic
        nch = nx * ny
        gh = disc._geom_host
        cf = mesh.cell_facets  # (nc, 3) global
        A = nxl * ny
        # periodic meshes have no boundary facets: the local layout is the
        # three full interior colors; Neumann appends the T/L boundary groups
        self.nf_loc = 3 * A if periodic else 3 * A + nxl + ny
        self.nc_loc = 2 * A

        # ---- local -> global index maps per slab --------------------------
        cell_maps, facet_maps, facet_valid, cell_valid = [], [], [], []
        for d in range(n_slabs):
            r0 = d * nxl
            ii = r0 + np.arange(nxl)  # global grid column per local column
            cv_col = ii < nx  # real columns (False only on the last slab)
            ii_c = np.where(cv_col, ii, 0)  # clamp dummies to column 0
            low = (ii_c[:, None] * ny + np.arange(ny)).ravel().astype(np.int64)
            cells = np.concatenate([low, nch + low])
            cval = np.tile(np.repeat(cv_col.astype(np.float64), ny), 2)
            vcol = np.repeat(cv_col.astype(np.float64), ny)  # per facet rect
            fV = np.where(vcol > 0, cf[low, 0], 0)
            fD = np.where(vcol > 0, cf[low, 1], 0)
            fH = np.where(vcol > 0, cf[low, 2], 0)
            if periodic:
                fmap = np.concatenate([fV, fD, fH])
                valid = np.ones(3 * A)
            else:
                up_top = nch + ii_c * ny + (ny - 1)
                fT = np.where(cv_col, cf[up_top, 0], 0)
                vT = cv_col.astype(np.float64)
                if d == 0:
                    upL = nch + np.arange(ny)
                    fL = cf[upL, 1]
                    vL = np.ones(ny)
                else:
                    fL = np.zeros(ny, dtype=cf.dtype)
                    vL = np.zeros(ny)
                fmap = np.concatenate([fV, fD, fH, fT, fL])
                valid = np.concatenate([vcol, vcol, vcol, vT, vL])
            cell_maps.append(cells)
            facet_maps.append(fmap)
            facet_valid.append(valid)
            cell_valid.append(cval)
        self.cell_maps = cell_maps
        self.facet_maps = facet_maps
        self.facet_valid = facet_valid
        self.cell_valid = cell_valid

        # ---- local static spec (identical across slabs) -------------------
        colors = (
            (0, 1, 0, 0, nxl, ny, (1, 0)),   # V
            (1, 2, 0, 0, nxl, ny, (0, 0)),   # D
            (2, 0, 0, 0, nxl, ny, (0, -1)),  # H
        )
        if periodic:
            bnd = ()
        else:
            bnd = (
                (1, 0, 0, ny - 1, nxl, 1, 3 * A),  # T
                (1, 1, 0, 0, 1, ny, 3 * A + nxl),  # L
            )
        self.local_spec = (
            nxl, ny, periodic, spec[3], colors, bnd, (AXIS, n_slabs),
        )
        self.fcol_bounds = (0, A, 2 * A, 3 * A)

        # uniform-geometry constants reordered to the LOCAL color order
        # (local color k has plus slot k; global color order may differ)
        uspec = getattr(mesh, "uniform_spec", None)
        if uspec is not None:
            by_slot = {entry[0] // 2: entry for entry in uspec[0]}
            self.local_uniform = (
                tuple(by_slot[l] for l in range(3)),
                uspec[1],
            )
        else:
            self.local_uniform = None

        # ---- stacked local Geoms ------------------------------------------
        geoms = [self._local_geom(gh, mesh, d) for d in range(n_slabs)]
        self.geom = jax.device_put(_stack(geoms))

        cs = stepper._cs
        cs_host = disc._cs_host
        css = [self._local_cs(cs, cs_host, mesh, d) for d in range(n_slabs)]
        self.cs = jax.device_put(_stack(css))

        proj = stepper._proj
        projs = [
            dataclasses.replace(
                proj, class_id=jnp.asarray(np.asarray(proj.class_id)[self.cell_maps[d]])
            )
            for d in range(n_slabs)
        ]
        self.proj = jax.device_put(_stack(projs))

        pcs = [self._local_pc(stepper._gtmg, mesh, d) for d in range(n_slabs)]
        self.pc = jax.device_put(_stack(pcs))

        self.mesh_devices = jax.sharding.Mesh(
            np.asarray(jax.devices()[:n_slabs]), (AXIS,)
        )

    # ----------------------------------------------------------------------

    def local_cg(self, stepper):
        """Stacked slab-local tracer CGSpace: the dofmap keeps GLOBAL dof
        ids restricted to each slab's cells (the CG dof vector stays
        replicated; slab-interface dofs are psum-assembled, fem/cg.py)."""
        if getattr(self, "_local_cg_cache", None) is None:
            space = stepper.tracer_cg_space()
            dofmap = np.asarray(space.dofmap)  # (nloc, nc) global ids
            spaces = [
                dataclasses.replace(
                    space, dofmap=jnp.asarray(dofmap[:, self.cell_maps[d]])
                )
                for d in range(self.n_slabs)
            ]
            self._local_cg_cache = jax.device_put(_stack(spaces))
        return self._local_cg_cache

    def _take_facets(self, arr, d, fill=0.0, axis=-1):
        """Local facet values from a global per-facet array (dummy -> fill)."""
        a = np.take(np.asarray(arr), self.facet_maps[d], axis=axis)
        v = self.facet_valid[d]
        shape = [1] * a.ndim
        shape[axis] = v.shape[0]
        vv = v.reshape(shape)
        return (a * vv + fill * (1.0 - vv)).astype(np.asarray(arr).dtype)

    def _local_geom(self, gh, mesh, d):
        cm = self.cell_maps[d]
        tf = lambda a: np.asarray(a)[..., cm]  # cell arrays (batch-last)
        ncol = 3
        dtype = np.asarray(gh.wq).dtype
        fint = (self.facet_maps[d] < mesh.n_interior_facets).astype(dtype)
        fint = fint * self.facet_valid[d].astype(dtype)
        fcells_loc = np.zeros((2, self.nf_loc), np.int32)  # gather path unused
        return dataclasses.replace(
            gh,
            det_jac=tf(gh.det_jac),
            jac_inv=tf(gh.jac_inv),
            normal=self._take_facets(gh.normal, d),
            flen=self._take_facets(gh.flen, d, fill=1.0),
            hF_inv=self._take_facets(gh.hF_inv, d),
            fcells=fcells_loc,
            ftab=np.asarray(gh.ftab)[:, self.facet_maps[d]] * self.facet_valid[
                d
            ].astype(np.int32),
            cell_facets=np.zeros((3, self.nc_loc), np.int32),
            cfside=tf(gh.cfside),
            cfsign=tf(gh.cfsign),
            cfassemble=np.zeros((3, self.nc_loc), np.int32),
            cf_tab=tf(gh.cf_tab),
            cf_bnd=tf(gh.cf_bnd),
            xq=tf(gh.xq),
            xnodes1=tf(gh.xnodes1),
            xnodes0=tf(gh.xnodes0),
            fcol_pos=np.zeros((ncol, self.nc_loc), np.int32),
            fcol_side=np.zeros((ncol, self.nc_loc), np.int32),
            fcol_mask=np.zeros((ncol, self.nc_loc), dtype),
            fint=fint,
            fvalid=self.facet_valid[d].astype(dtype),
            # None on even decompositions: the stacked pytree must keep one
            # treedef across slabs, so it is all-or-nothing per decomposition
            cvalid=self.cell_valid[d].astype(dtype) if self.pad else None,
            # meta must be IDENTICAL across slabs (the stacked pytree is one
            # SPMD program); interiorness comes from the fint DATA array
            n_int=3 * self.nxl * self.ny,
            fcol_bounds=self.fcol_bounds,
            fcol_orphans=False,
            shift=self.local_spec,
            uniform=self.local_uniform,
        )

    def _local_cs(self, cs, cs_host, mesh, d):
        cm = self.cell_maps[d]
        nt = cs.nt
        S_loc = np.asarray(cs_host["S"])[cm].transpose(1, 2, 0)
        eye = np.eye(nt)
        Sdiag_loc = self._take_facets(
            np.asarray(cs_host["Sdiag_inv"]).transpose(1, 2, 0), d
        )
        # dummy facets: identity diagonal block (applied to zero values)
        v = self.facet_valid[d]
        Sdiag_loc = Sdiag_loc * v + eye[:, :, None] * (1.0 - v)
        nullvec = self._take_facets(np.asarray(cs.nullvec), d)
        # the host copies are float64 for setup accuracy; the DEVICE tables
        # must follow the discretisation dtype like cs itself (a float64
        # slab cs silently promoted the whole f32 distributed step under
        # jax_enable_x64)
        dtype = np.asarray(cs.nullvec).dtype
        return dataclasses.replace(
            cs,
            S=jnp.asarray(S_loc, dtype),
            class_id=jnp.asarray(np.asarray(cs.class_id)[cm]),
            Sdiag_inv=jnp.asarray(Sdiag_loc, dtype),
            nullvec=jnp.asarray(nullvec, dtype),
        )

    def _local_pc(self, pc, mesh, d):
        nxl, ny = self.nxl, self.ny
        Mx, My = pc.grid_shape
        assert pc.coarse_kind in ("fft_neumann", "fft_periodic"), (
            "distributed GTMG v1 needs the structured FFT coarse solve"
        )
        # local vertex-canvas offsets of each facet family's endpoints,
        # verified numerically from the global facet endpoints
        fv = _facet_endpoints(mesh)
        groups = []
        r0 = d * nxl
        fam_rects = [
            (0, 0, nxl, ny),
            (0, 0, nxl, ny),
            (0, 0, nxl, ny),
        ]
        if not self.periodic:
            fam_rects += [
                (0, ny - 1, nxl, 1),
                (0, 0, 1, ny),
            ]
        f0 = 0
        for fam, rect in enumerate(fam_rects):
            i0, j0, ni, nj = rect
            n = ni * nj
            fm = self.facet_maps[d][f0 : f0 + n]
            vmask = self.facet_valid[d][f0 : f0 + n]
            pi = i0 + np.repeat(np.arange(ni), nj)
            pj = j0 + np.tile(np.arange(nj), ni)
            offs = []
            for e in range(2):
                vids = fv[fm, e]
                vi, vj = vids // My - r0, vids % My
                di, dj = vi - pi, vj - pj
                if self.periodic:
                    # wrap seams: canonicalize to the smallest offset — the
                    # facet endpoints sit at p + {0, 1} on the torus
                    di = (di + Mx) % Mx
                    dj = (dj + My) % My
                use = vmask > 0
                if not use.any():
                    # dummy-only family on this slab: offsets come from the
                    # slab that owns the real facets (slab 0's L family)
                    offs.append(None)
                    continue
                assert np.all(di[use] == di[use][0]) and np.all(
                    dj[use] == dj[use][0]
                ), ("non-constant vertex offset", fam, d)
                offs.append((int(di[use][0]), int(dj[use][0])))
            groups.append((f0, f0 + n, i0, j0, ni, nj, offs[0], offs[1]))
            f0 += n
        self._vgroups_per_slab = getattr(self, "_vgroups_per_slab", {})
        self._vgroups_per_slab[d] = groups
        # fill dummy-family offsets from slab 0 (the owner) so the static
        # spec is identical on every device
        g0 = self._vgroups_per_slab.get(0, groups)
        merged = []
        for ga, gb in zip(groups, g0):
            dlo = ga[6] if ga[6] is not None else gb[6]
            dhi = ga[7] if ga[7] is not None else gb[7]
            assert dlo is not None and dhi is not None
            merged.append(ga[:6] + (dlo, dhi))
        dist = (
            AXIS, self.n_slabs, int(Mx), int(My), nxl + 1, tuple(merged),
            self.periodic,
        )
        dtype = np.asarray(pc.trace_nodes).dtype
        small = jnp.zeros((1, 1), dtype)
        return dataclasses.replace(
            pc,
            # the smoother reads cs.Sdiag_inv (localized in _local_cs);
            # pc.Sdiag_inv is only consumed by setup-time host eigenvalue
            # estimates — ship a dummy, not a per-slab copy
            Sdiag_inv=small,
            facet_verts=jnp.zeros((2, self.nf_loc), jnp.int32),
            K_elem=small,
            cells=jnp.zeros((1, 1), jnp.int32),
            K_diag_inv=small,
            vf=jnp.zeros((1, 1), jnp.int32),
            vf_end=jnp.zeros((1, 1), jnp.int32),
            vf_mask=small,
            vc=jnp.zeros((1, 1), jnp.int32),
            vc_pos=jnp.zeros((1, 1), jnp.int32),
            vc_mask=small,
            vshift=None,
            dist=dist,
        )

    # ------------------------------------------------------------------
    # state movement
    # ------------------------------------------------------------------

    def scatter_cell_field(self, u):
        """Global (..., nc) -> stacked (n_slabs, ..., nc_loc).

        Dummy cells of an uneven decomposition read clamped (real) indices;
        mask them to ZERO — the whole-step invariant that keeps them
        decoupled and invisible to global reductions."""
        u = np.asarray(u)
        return jnp.asarray(
            np.stack(
                [
                    u[..., cm] * cv.astype(u.dtype)
                    for cm, cv in zip(self.cell_maps, self.cell_valid)
                ]
            )
        )

    def scatter_facet_field(self, lam):
        lam = np.asarray(lam)
        return jnp.asarray(
            np.stack(
                [
                    # keep the field dtype: the float64 validity mask would
                    # silently promote a float32 state (and then the whole
                    # distributed step) under jax_enable_x64
                    lam[..., fm] * fv.astype(lam.dtype)
                    for fm, fv in zip(self.facet_maps, self.facet_valid)
                ]
            )
        )

    def gather_cell_field(self, u_s, global_shape):
        out = np.zeros(global_shape, dtype=np.asarray(u_s).dtype)
        for d, (cm, cv) in enumerate(zip(self.cell_maps, self.cell_valid)):
            # dummy cells alias real index 0 — write only the real ones
            sel = cv > 0
            out[..., cm[sel]] = np.asarray(u_s)[d][..., sel]
        return out

    def gather_facet_field(self, lam_s, global_shape):
        out = np.zeros(global_shape, dtype=np.asarray(lam_s).dtype)
        for d, (fm, fv) in enumerate(zip(self.facet_maps, self.facet_valid)):
            sel = fv > 0
            out[..., fm[sel]] = np.asarray(lam_s)[d][..., sel]
        return out


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)


def build_slab_decomposition(disc, stepper, n_slabs):
    return SlabDecomposition(disc, stepper, n_slabs)


def scatter_state(dec, stage_Q, stage_p, stage_lam):
    sQ = [dec.scatter_cell_field(Q) for Q in stage_Q]
    sp = [dec.scatter_cell_field(p) for p in stage_p]
    sl = [dec.scatter_facet_field(l) for l in stage_lam]
    return sQ, sp, sl


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def make_distributed_simple_step(dec, stepper, f_rhs_fn):
    """Slab-decomposed wrapper for the single-state schemes (hdg_implicit,
    dg_implicit — step signature (geom, proj, cs, pc, Q, p, f_nodal)).

    The same jitted step body runs per slab inside one shard_map (the
    operator kernels dispatch on the slab-local ``geom.shift`` spec, so
    facet<->cell moves ride the ppermute halos and Krylov dots psum —
    identical machinery to the IMEX :func:`make_distributed_step`); the
    forcing is interpolated on the LOCAL velocity nodes inside the map.

    Returns ``dstep(Q_s, p_s, tn) -> (Q_s, p_s, *extras)`` on stacked
    (n_slabs, ...) fields; extras (iteration counts) are de-stacked scalars.
    """
    from jax.sharding import PartitionSpec as P

    step = stepper._make_step()
    mesh = dec.mesh_devices
    dtype = dec.disc.dtype

    def body(geom, proj, cs, pc, Q, p, tn):
        geom0, proj0, cs0, pc0, Q0, p0 = jax.tree_util.tree_map(
            lambda a: a[0], (geom, proj, cs, pc, Q, p)
        )
        x = geom0.xnodes1
        fx, fy = f_rhs_fn(tn)(x[0], x[1])
        f_nodal = jnp.stack(jnp.broadcast_arrays(fx, fy), axis=0).astype(dtype)
        if geom0.cvalid is not None:  # uneven slabs: zero the dummy cells
            f_nodal = f_nodal * geom0.cvalid
        out = step(geom0, proj0, cs0, pc0, Q0, p0, f_nodal)
        return jax.tree_util.tree_map(lambda a: a[None], tuple(out))

    sharded = _shard_map(
        body,
        mesh,
        in_specs=(P(AXIS),) * 6 + (P(),),
        out_specs=P(AXIS),
    )

    @jax.jit
    def dstep(Q, p, tn):
        out = sharded(dec.geom, dec.proj, dec.cs, dec.pc, Q, p, tn)
        extras = tuple(jax.tree_util.tree_map(lambda a: a[0], e) for e in out[2:])
        return (out[0], out[1]) + extras

    return dstep


def make_distributed_step(dec, stepper, f_rhs_fn, with_tracer=False):
    """Wrap the (shared-phase) fused IMEX step in a shard_map over slabs.

    Returns step(sQ_stacked, sp_stacked, sl_stacked, tn[, q_stacked]) ->
    (sQ, sp, sl, [q_new,] counts); states are stacked (n_slabs, ...)
    pytrees.  With ``with_tracer`` the tracer advects distributed: cell
    fields are slab-local, the CG-projection dof vector stays replicated
    (psum-assembled, see fem/cg.py:cg_scatter).
    """
    from jax.sharding import PartitionSpec as P

    step = stepper._make_step(f_rhs_fn, with_tracer=with_tracer)
    mesh = dec.mesh_devices
    s = stepper.nstages
    cg_stacked = dec.local_cg(stepper) if with_tracer else None

    def body(geom, proj, cs, pc, sQ, sp, sl, tn, q, cg):
        sq = jax.tree_util.tree_map(
            lambda a: a[0], (geom, proj, cs, pc, sQ, sp, sl, q, cg)
        )
        geom0, proj0, cs0, pc0, sQ0, sp0, sl0, q0, cg0 = sq
        dummy_q = q0 if with_tracer else jnp.zeros_like(sp0[0])
        out_Q, out_p, out_l, q_new, counts = step(
            geom0, proj0, cs0, pc0, list(sQ0), list(sp0), list(sl0), tn,
            dummy_q, cg0,
        )
        pack = (tuple(out_Q), tuple(out_p), tuple(out_l))
        qp = q_new if with_tracer else jnp.zeros((1,), sp0[0].dtype)
        return (
            jax.tree_util.tree_map(lambda a: a[None], pack),
            qp[None],
            jax.tree_util.tree_map(lambda a: a[None], counts),
        )

    sharded = _shard_map(
        body,
        mesh,
        in_specs=(P(AXIS),) * 7 + (P(), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
    )

    @jax.jit
    def dstep(sQ, sp, sl, tn, q=None):
        if with_tracer:
            qs = q
        else:
            qs = jnp.zeros((dec.n_slabs, 1), sp[0].dtype)
        (oQ, op_, ol), q_new, counts = sharded(
            dec.geom, dec.proj, dec.cs, dec.pc, tuple(sQ), tuple(sp),
            tuple(sl), tn, qs, cg_stacked,
        )
        counts = jax.tree_util.tree_map(lambda a: a[0], counts)
        if with_tracer:
            return list(oQ), list(op_), list(ol), q_new, counts
        return list(oQ), list(op_), list(ol), counts

    return dstep
