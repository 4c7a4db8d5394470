"""Continuous (CG) Lagrange spaces: global numbering + matrix-free operators.

The reference uses CG spaces in three places, all rebuilt on top of this
module:
- tracer-advection velocity projection onto vector CG(k+1)
  (reference src/timesteppers/common.py:119-122)
- vorticity output projection onto CG(k+1)
  (reference src/auxilliary/callbacks.py:53-69)
- the P1 coarse space of the GTMG preconditioner (hdg_imex.py:97-106)

A CG field is a flat vector over global dofs; cell-local views are obtained
by gathering with the (n_cells, n_local) dof map, operators are batched dense
element kernels + scatter-add, and mass/stiffness solves are matrix-free CG
iterations with Jacobi preconditioning.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .lagrange import triangle_basis, tri_dim

__all__ = ["CGSpace", "build_cg_space", "cg_mass_solve", "cg_project_dg"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["dofmap", "phi_at_q1", "mass_diag", "node_coords"],
    meta_fields=["degree", "n_dofs"],
)
@dataclass
class CGSpace:
    """Device tables for a scalar CG(degree) space on the mesh."""

    dofmap: jnp.ndarray  # (nloc, nc) int32 global dof ids (batch-last)
    phi_at_q1: jnp.ndarray  # (nq, nloc) CG basis at the V1 cell quadrature
    mass_diag: jnp.ndarray  # (n_dofs,) assembled (lumped row-sum) diagonal
    node_coords: jnp.ndarray  # (n_dofs, 2)
    degree: int = 1
    n_dofs: int = 0


def _local_node_classification(m):
    """Classify lattice nodes of degree m: returns list of (kind, data).

    kind 'v': data = local vertex id
    kind 'e': data = (local_edge, position 1..m-1 along canonical direction)
    kind 'i': data = interior counter
    Lattice order matches fem.lagrange.triangle_nodes (i outer, j inner).
    """
    out = []
    n_int = 0
    for i in range(m + 1):
        for j in range(m + 1 - i):
            k = m - i - j
            # barycentric indices: (k, i, j) for vertices (v0, v1, v2)
            if i == m:
                out.append(("v", 1))
            elif j == m:
                out.append(("v", 2))
            elif k == m:
                out.append(("v", 0))
            elif k == 0:  # edge v1-v2 = local facet 0; position runs v1->v2
                out.append(("e", (0, j)))
            elif j == 0:  # edge v0-v1 = local facet 2; position runs v0->v1
                out.append(("e", (2, i)))
            elif i == 0:  # edge v2-v0 = local facet 1; position runs v2->v0
                out.append(("e", (1, m - j)))
            else:
                n_int += 1
                out.append(("i", n_int - 1))
    return out


def build_cg_space(disc, degree):
    """Build a CGSpace of the given degree for disc's mesh (numpy setup)."""
    mesh = disc.mesh
    m = degree
    nc = mesh.n_cells
    nv = mesh.n_vertices
    nf = mesh.n_facets
    n_edge = m - 1
    n_int = tri_dim(m - 3) if m >= 3 else 0
    nloc = tri_dim(m)
    n_dofs = nv + nf * n_edge + nc * n_int

    basis = triangle_basis(m)
    cls = _local_node_classification(m)
    assert len(cls) == nloc

    dofmap = np.zeros((nc, nloc), dtype=np.int64)
    for loc, (kind, data) in enumerate(cls):
        if kind == "v":
            dofmap[:, loc] = mesh.cells[:, data]
        elif kind == "e":
            le, pos = data
            f = mesh.cell_facets[:, le]
            side = mesh.cell_facet_side[:, le]
            flip = mesh.facet_flip[f, side]
            # position along the *global* (lo->hi) direction of the facet
            gpos = np.where(flip == 1, m - pos, pos)
            dofmap[:, loc] = nv + f * n_edge + (gpos - 1)
        else:
            dofmap[:, loc] = nv + nf * n_edge + np.arange(nc) * n_int + data

    # basis at the discretisation's cell quadrature points
    phi = basis.tabulate(disc.V1.qp)
    # assembled diagonal of the consistent mass matrix
    Mloc = np.einsum("q,qi,qj->ij", disc.V1.qw, phi, phi)
    diag_loc = np.einsum("c,i->ci", mesh.det_jac, np.diag(Mloc))
    mass_diag = np.zeros(n_dofs)
    np.add.at(mass_diag, dofmap, diag_loc)

    # representative node coordinates (last writer wins — identical for CG)
    lam = np.stack(
        [1.0 - basis.nodes[:, 0] - basis.nodes[:, 1], basis.nodes[:, 0], basis.nodes[:, 1]],
        axis=-1,
    )
    cell_nodes = np.einsum("pl,cld->cpd", lam, mesh.cell_coords)
    node_coords = np.zeros((n_dofs, 2))
    node_coords[dofmap.ravel()] = cell_nodes.reshape(-1, 2)

    f = lambda a: jnp.asarray(a, dtype=disc.dtype)
    return CGSpace(
        dofmap=jnp.asarray(dofmap.T.astype(np.int32)),
        phi_at_q1=f(phi),
        mass_diag=f(mass_diag),
        node_coords=f(node_coords),
        degree=m,
        n_dofs=int(n_dofs),
    )


def cg_gather(space, v):
    """Global CG vector(s) (..., n_dofs) -> cell-local (..., nloc, nc)."""
    return v[..., space.dofmap]


def cg_scatter(space, local, axis_name=None):
    """Adjoint gather: accumulate (..., nloc, nc) into (..., n_dofs).

    Under a slab-decomposed ``shard_map`` (``axis_name`` set) each device
    accumulates its own cells' contributions into the REPLICATED global dof
    vector and a psum resolves the slab-interface dofs — the CG dof vector
    is small (~19 MB at 512^2 k=3) and stays replicated, exactly like the
    GTMG coarse canvas (parallel/slab.py)."""
    out = jnp.zeros(local.shape[:-2] + (space.n_dofs,), dtype=local.dtype)
    out = out.at[..., space.dofmap].add(local)
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


def cg_mass_matvec(geom, space, v):
    """Consistent CG mass matrix action on (..., n_dofs) vectors."""
    from ..ops.structured import dist_axis

    loc = cg_gather(space, v)  # (..., nloc, nc)
    Mloc = jnp.einsum("q,qi,qj->ij", geom.wq, space.phi_at_q1, space.phi_at_q1)
    out = geom.det_jac * jnp.einsum("ij,...jc->...ic", Mloc, loc)
    return cg_scatter(space, out, axis_name=dist_axis(geom))


def cg_mass_solve(geom, space, b, rtol=1e-12, maxiter=200):
    """Solve the CG mass system M x = b with Jacobi-preconditioned CG.

    Works on (n_dofs,) or (k, n_dofs) right-hand sides (components solved
    together with a shared iteration).  Returns (x, iters).
    """
    from ..linalg.krylov import cg as cg_solve

    shape = b.shape

    def mv(v):
        return cg_mass_matvec(geom, space, v.reshape(shape)).ravel()

    dinv = 1.0 / space.mass_diag

    def M(v):
        return (dinv * v.reshape(shape)).ravel()

    x, iters, _ = cg_solve(mv, b.ravel(), M=M, rtol=rtol, maxiter=maxiter)
    return x.reshape(shape), iters


def cg_project_dg(geom, space, u, rtol=1e-12):
    """L2-project a DG(k+1) field ([2,] d1, nc) onto CG(degree) global dofs.

    The reference's ``Function(V_CG).project(u)`` (common.py:121-122).
    Returns (x ([2,] n_dofs), iters).
    """
    from ..ops.structured import dist_axis

    uq = jnp.einsum("qi,...ic->...qc", geom.phi1, u)
    loc = jnp.einsum("c,q,qi,...qc->...ic", geom.det_jac, geom.wq, space.phi_at_q1, uq)
    b = cg_scatter(space, loc, axis_name=dist_axis(geom))
    return cg_mass_solve(geom, space, b, rtol=rtol)


def cg_eval_at_q(geom, space, x):
    """Evaluate a CG field at the cell quadrature points: (..., nq, nc)."""
    return jnp.einsum("qi,...ic->...qc", space.phi_at_q1, cg_gather(space, x))
