"""Central discretisation object: device-resident geometry + tabulation tables.

Bundles everything the batched weak-form kernels in ``ops/`` and the solvers in
``linalg/`` need at runtime into a single JAX pytree (``Geom``) so that every
hot function is ``jit(f)(geom, state...)`` with purely static shapes.

Field layouts (runtime arrays) are BATCH-LAST: the huge entity axis is the
minor (contiguous) one, so every per-entity kernel is an elementwise
contraction whose loads are coalesced across consecutive entities:

    velocity   Q      (2, d1, n_cells)   nodal DG(k+1), component-major
    pressure   p      (d0, n_cells)      nodal DG(k)
    trace      lam    (nt, n_facets)     nodal DGT(k), single-valued per facet
    tracer     q      (d0, n_cells)      nodal DG(k)

Per-entity geometry and index tables follow the same rule: (3, n_cells)
cell->facet maps, (2, n_facets) facet->cell maps, (2, 2, n_cells) inverse
Jacobians, (2, nq, n_cells) quadrature coordinates.

The geometry-class machinery (``cell_class``) deduplicates per-cell dense
operator blocks: cells with identical (Jacobian, facet orientation, boundary
pattern) share precomputed element matrices, so on structured meshes the
static-condensation tables are O(1) instead of O(n_cells).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .spaces import tabulate_cell_space, tabulate_trace_space

__all__ = ["Geom", "HDGDiscretisation"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "wq",
        "phi1",
        "gphi1",
        "hphi1",
        "tgphi1",
        "phi0",
        "gphi0",
        "wqf",
        "sqf",
        "tr",
        "tphi1",
        "tphi0",
        "det_jac",
        "jac_inv",
        "normal",
        "flen",
        "hF_inv",
        "fcells",
        "ftab",
        "cell_facets",
        "cfside",
        "cfsign",
        "cfassemble",
        "cf_tab",
        "cf_bnd",
        "xq",
        "xnodes1",
        "xnodes0",
        "m1",
        "m0",
        "m1inv",
        "m0inv",
        "mtinv",
        "fcol_pos",
        "fcol_side",
        "fcol_mask",
        "fint",
        "fvalid",
        "cvalid",
    ],
    meta_fields=[
        "n_int",
        "degree",
        "fcol_bounds",
        "fcol_orphans",
        "shift",
        "uniform",
    ],
)
@dataclass
class Geom:
    """Device-resident geometry/tabulation pytree (see module docstring)."""

    # quadrature + reference tabulations
    wq: jnp.ndarray  # (nq,) cell quadrature weights (reference triangle)
    phi1: jnp.ndarray  # (nq, d1) DG(k+1) values
    gphi1: jnp.ndarray  # (nq, d1, 2) DG(k+1) reference gradients
    hphi1: jnp.ndarray  # (nq, d1, 2, 2) DG(k+1) reference second derivatives
    tgphi1: jnp.ndarray  # (6, nqf, d1, 2) facet traces of DG(k+1) ref gradients
    phi0: jnp.ndarray  # (nq, d0) DG(k)
    gphi0: jnp.ndarray  # (nq, d0, 2)
    wqf: jnp.ndarray  # (nqf,) facet quadrature weights on [0,1]
    sqf: jnp.ndarray  # (nqf,) facet quadrature points
    tr: jnp.ndarray  # (nqf, nt) DGT(k) basis at facet quadrature
    tphi1: jnp.ndarray  # (6, nqf, d1) facet traces of DG(k+1), index 2*l+flip
    tphi0: jnp.ndarray  # (6, nqf, d0)

    # per-cell geometry
    det_jac: jnp.ndarray  # (nc,)
    jac_inv: jnp.ndarray  # (2, 2, nc): d/dx_a phi = gphi[..., b] jac_inv[b, a]

    # per-facet data (interior facets first)
    normal: jnp.ndarray  # (2, nf) outward from plus cell
    flen: jnp.ndarray  # (nf,)
    hF_inv: jnp.ndarray  # (nf,) = 1/flen  (reference common.py:36-57)
    fcells: jnp.ndarray  # (2, nf) int32; [1] == clamp for boundary
    ftab: jnp.ndarray  # (2, nf) int32 trace-tab index 2*local+flip per side

    # cell -> facet maps
    cell_facets: jnp.ndarray  # (3, nc) int32
    cfside: jnp.ndarray  # (3, nc) int32 0 plus / 1 minus
    cfsign: jnp.ndarray  # (3, nc) +1 if facet normal is outward for this cell
    cfassemble: jnp.ndarray  # (3, nc) int32 = cell_facets + cfside * nf
    cf_tab: jnp.ndarray  # (3, nc) int32 trace-tab index for this cell's side
    cf_bnd: jnp.ndarray  # (3, nc) bool: facet is on the boundary

    # physical coordinates
    xq: jnp.ndarray  # (2, nq, nc) cell quadrature points
    xnodes1: jnp.ndarray  # (2, d1, nc) DG(k+1) nodes
    xnodes0: jnp.ndarray  # (2, d0, nc) DG(k) nodes

    # reference mass matrices and inverses (affine cells: M_cell = det_jac * M_ref)
    m1: jnp.ndarray  # (d1, d1)
    m0: jnp.ndarray  # (d0, d0)
    m1inv: jnp.ndarray  # (d1, d1)
    m0inv: jnp.ndarray  # (d0, d0)
    mtinv: jnp.ndarray  # (nt, nt)

    # facet-color patch maps (interior facets are color-sorted in the mesh):
    # for each color k and cell c, the within-color position of c's color-k
    # facet, which side c is on, and whether c has a color-k facet at all.
    # Drives the multiplicative colored Schwarz tentative preconditioner.
    fcol_pos: jnp.ndarray = None  # (ncol, nc) int32
    fcol_side: jnp.ndarray = None  # (ncol, nc) int32
    fcol_mask: jnp.ndarray = None  # (ncol, nc) float

    # optional explicit interior-facet mask (nf,); None means "the first
    # n_int facets are interior" (the global layouts).  Slab-local layouts
    # (parallel/slab.py) store it explicitly.
    fint: jnp.ndarray = None
    # optional validity mask (nf,) zeroing DUMMY facet positions of the
    # uniform slab-local layout (positions that exist for shape uniformity
    # across shard_map devices but correspond to no physical facet)
    fvalid: jnp.ndarray = None
    # optional cell-validity mask (nc,): zero on the trailing DUMMY grid
    # columns an uneven slab decomposition pads the last slab with
    # (nx % n_devices != 0, parallel/slab.py).  Consumed by the forcing
    # interpolation (dummy cells must carry zero data so they stay decoupled
    # and invisible to global reductions); None on even decompositions and
    # single-device runs.
    cvalid: jnp.ndarray = None

    # static metadata
    n_int: int = 0
    degree: int = 1
    fcol_bounds: tuple = ()  # color slice offsets into the facet axis
    fcol_orphans: bool = False  # any cell with no interior facet?
    # shift topology (nx, ny, periodic, slot_off, colors, bnd) of a
    # [lowers; uppers] structured mesh, or None — enables the slice/roll
    # facet<->cell fast path (ops/structured.py)
    shift: tuple = None
    # per-family geometric constants (colors_u, halves_u) of a UNIFORM
    # structured mesh (mesh/triangle_mesh.py:_attach_uniform_structure), or
    # None — enables the factored tentative-operator tables
    # (linalg/preconditioners.py)
    uniform: tuple = None

    @property
    def n_cells(self):
        return self.det_jac.shape[0]

    @property
    def n_facets(self):
        return self.normal.shape[1]

    @property
    def d1(self):
        return self.phi1.shape[1]

    @property
    def d0(self):
        return self.phi0.shape[1]

    @property
    def nt(self):
        return self.tr.shape[1]


class HDGDiscretisation:
    """Host-side bundle: mesh + tabulations + the device Geom pytree.

    :arg mesh: a ``TriangleMesh``
    :arg degree: polynomial degree k of the pressure space (velocity is k+1)
    :arg dtype: runtime floating dtype (float64 for convergence verification,
        float32 for the performance path) — the dtype config axis
        called for by SURVEY.md section 7
    """

    def __init__(self, mesh, degree, dtype=jnp.float64):
        self.mesh = mesh
        self.degree = int(degree)
        self.dtype = dtype
        k = self.degree

        cell_qdeg = 3 * k + 5
        facet_qdeg = 3 * k + 6
        self.Vt = tabulate_trace_space(k, facet_qdeg)
        sq = self.Vt.sq
        self.V1 = tabulate_cell_space(k + 1, cell_qdeg, sq)
        self.V0 = tabulate_cell_space(k, cell_qdeg, sq)

        m = mesh
        # host-side conversions only: the finished Geom is shipped in ONE
        # device_put below instead of ~40 eager per-array transfers
        f = lambda a: np.asarray(a, dtype=dtype)
        i32 = lambda a: np.asarray(a, dtype=np.int32)

        # clamp missing minus cells to 0 so gathers are in-bounds; interior mask
        # n_int keeps results correct (boundary facets never read side 1)
        fcells = m.facet_cells.copy()
        fcells[fcells < 0] = 0
        ftab = 2 * m.facet_local + m.facet_flip

        cfsign = np.where(m.cell_facet_side == 0, 1.0, -1.0)
        cf_tab = ftab[m.cell_facets, m.cell_facet_side]
        cf_bnd = m.cell_facets >= m.n_interior_facets

        xq = m.map_to_physical(self.V1.qp)
        xnodes1 = m.map_to_physical(self.V1.nodes)
        xnodes0 = m.map_to_physical(self.V0.nodes)

        # per-color cell maps for the multiplicative facet-patch Schwarz
        bounds = m.facet_color_bounds
        ncol = len(bounds) - 1
        nc = m.n_cells
        fcol_pos = np.zeros((ncol, nc), dtype=np.int32)
        fcol_side = np.zeros((ncol, nc), dtype=np.int32)
        fcol_mask = np.zeros((ncol, nc))
        for kc in range(ncol):  # NOT `k`: that still holds the degree
            fk = np.arange(bounds[kc], bounds[kc + 1])
            for s in (0, 1):
                cks = m.facet_cells[fk, s]
                fcol_pos[kc, cks] = fk - bounds[kc]
                fcol_side[kc, cks] = s
                fcol_mask[kc, cks] = 1.0
        fcol_orphans = bool(np.any(fcol_mask.sum(axis=0) == 0.0))

        cfassemble = m.cell_facets + m.cell_facet_side * m.n_facets

        geom_host = Geom(
            wq=f(self.V1.qw),
            phi1=f(self.V1.phi),
            gphi1=f(self.V1.gphi),
            hphi1=f(self.V1.hphi),
            tgphi1=f(self.V1.tgphi),
            phi0=f(self.V0.phi),
            gphi0=f(self.V0.gphi),
            wqf=f(self.Vt.wq),
            sqf=f(self.Vt.sq),
            tr=f(self.Vt.tr),
            tphi1=f(self.V1.tphi),
            tphi0=f(self.V0.tphi),
            det_jac=f(m.det_jac),
            jac_inv=f(m.jac_inv.transpose(1, 2, 0)),
            normal=f(m.normals.T),
            flen=f(m.facet_lengths),
            hF_inv=f(1.0 / m.facet_lengths),
            fcells=i32(fcells.T),
            ftab=i32(ftab.T),
            cell_facets=i32(m.cell_facets.T),
            cfside=i32(m.cell_facet_side.T),
            cfsign=f(cfsign.T),
            cfassemble=i32(cfassemble.T),
            cf_tab=i32(cf_tab.T),
            cf_bnd=np.asarray(cf_bnd.T),
            xq=f(xq.transpose(2, 1, 0)),
            xnodes1=f(xnodes1.transpose(2, 1, 0)),
            xnodes0=f(xnodes0.transpose(2, 1, 0)),
            m1=f(self.V1.mass_ref),
            m0=f(self.V0.mass_ref),
            m1inv=f(self.V1.mass_ref_inv),
            m0inv=f(self.V0.mass_ref_inv),
            mtinv=f(self.Vt.mass_ref_inv),
            fcol_pos=i32(fcol_pos),
            fcol_side=i32(fcol_side),
            fcol_mask=f(fcol_mask),
            n_int=int(m.n_interior_facets),
            degree=k,
            fcol_bounds=tuple(int(b) for b in bounds),
            fcol_orphans=fcol_orphans,
            shift=getattr(m, "shift_spec", None),
            uniform=getattr(m, "uniform_spec", None),
        )
        self.geom = jax.device_put(geom_host)
        # host (numpy) copy retained for setup-time consumers — the slab
        # decomposition reindexes it without device round trips
        self._geom_host = geom_host

        self.domain_volume = m.domain_volume

    # ------------------------------------------------------------------
    # interpolation (the analogue of Function(V).interpolate(expr))
    # ------------------------------------------------------------------

    def interpolate_velocity(self, fn):
        """Nodal interpolation of ``fn(x, y) -> (2,)`` into V_Q: (2, d1, nc)."""
        x = self.geom.xnodes1
        return jnp.stack(
            jnp.broadcast_arrays(*_as_pair(fn(x[0], x[1]))), axis=0
        ).astype(self.dtype)

    def interpolate_pressure(self, fn):
        """Nodal interpolation of scalar ``fn(x, y)`` into V_p: (d0, nc)."""
        x = self.geom.xnodes0
        return jnp.broadcast_to(
            jnp.asarray(fn(x[0], x[1])), x.shape[1:]
        ).astype(self.dtype)


def _as_pair(v):
    """Normalize a vector-expression result to a pair of arrays."""
    if isinstance(v, (tuple, list)):
        return v[0], v[1]
    return v[..., 0], v[..., 1]
