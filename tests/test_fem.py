"""Unit tests: quadrature exactness, Lagrange bases, mesh connectivity.

Covers the rebuild's equivalents of FIAT tabulation and DMPlex connectivity
(SURVEY.md section 4 'unit tests for reference-element tabulations, mesh
connectivity').
"""

import numpy as np
import pytest

from incompressibleeulerhdg.fem.quadrature import triangle_quadrature, edge_quadrature
from incompressibleeulerhdg.fem.lagrange import (
    triangle_basis,
    edge_basis,
    shifted_legendre,
)
from incompressibleeulerhdg.mesh.generators import (
    unit_square_mesh,
    periodic_square_mesh,
    unit_disk_mesh,
)


@pytest.mark.parametrize("deg", [1, 2, 3, 5, 8, 11])
def test_triangle_quadrature_exactness(deg):
    """int_T x^i y^j = i! j! / (i + j + 2)! for the reference triangle."""
    from math import factorial

    pts, w = triangle_quadrature(deg)
    for i in range(deg + 1):
        for j in range(deg + 1 - i):
            exact = factorial(i) * factorial(j) / factorial(i + j + 2)
            got = np.sum(w * pts[:, 0] ** i * pts[:, 1] ** j)
            assert abs(got - exact) < 1e-14, (i, j)


@pytest.mark.parametrize("deg", [1, 3, 7])
def test_edge_quadrature_exactness(deg):
    s, w = edge_quadrature(deg)
    for i in range(deg + 1):
        assert abs(np.sum(w * s**i) - 1.0 / (i + 1)) < 1e-14


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_triangle_basis_nodal(k):
    b = triangle_basis(k)
    V = b.tabulate(b.nodes)
    assert np.allclose(V, np.eye(b.ndof), atol=1e-10)
    # partition of unity
    pts, _ = triangle_quadrature(5)
    assert np.allclose(b.tabulate(pts).sum(axis=1), 1.0, atol=1e-12)
    assert np.allclose(b.tabulate_grad(pts).sum(axis=1), 0.0, atol=1e-10)


def test_triangle_basis_gradient_consistency():
    b = triangle_basis(3)
    pts = np.array([[0.2, 0.3], [0.1, 0.6]])
    eps = 1e-6
    g = b.tabulate_grad(pts)
    for d in range(2):
        dp = pts.copy()
        dp[:, d] += eps
        dm = pts.copy()
        dm[:, d] -= eps
        fd = (b.tabulate(dp) - b.tabulate(dm)) / (2 * eps)
        assert np.allclose(fd, g[:, :, d], atol=1e-8)


def test_triangle_basis_hessian_consistency():
    b = triangle_basis(4)
    pts = np.array([[0.25, 0.35]])
    eps = 1e-5
    h = b.tabulate_hess(pts)
    for d in range(2):
        dp = pts.copy()
        dp[:, d] += eps
        dm = pts.copy()
        dm[:, d] -= eps
        fd = (b.tabulate_grad(dp) - b.tabulate_grad(dm)) / (2 * eps)
        assert np.allclose(fd, h[:, :, :, d], atol=1e-6)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_edge_basis_nodal(k):
    b = edge_basis(k)
    assert np.allclose(b.tabulate(b.nodes), np.eye(k + 1), atol=1e-12)


def test_shifted_legendre_orthonormal():
    s, w = edge_quadrature(13)
    L = shifted_legendre(5, s)
    gram = np.einsum("q,qi,qj->ij", w, L, L)
    assert np.allclose(gram, np.eye(6), atol=1e-12)


# ---------------------------------------------------------------------------
# mesh connectivity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mesh,expect_bnd",
    [
        (unit_square_mesh(4), True),
        (periodic_square_mesh(4), False),
        (unit_disk_mesh(2), True),
    ],
    ids=["square", "periodic", "disk"],
)
def test_mesh_connectivity(mesh, expect_bnd):
    m = mesh
    assert np.all(m.det_jac > 0)
    # Euler-ish counts
    assert m.n_facets == m.n_interior_facets + m.n_boundary_facets
    assert (m.n_boundary_facets > 0) == expect_bnd
    # each cell's facet list is consistent with the facet tables
    for c in range(m.n_cells):
        for l in range(3):
            f = m.cell_facets[c, l]
            s = m.cell_facet_side[c, l]
            assert m.facet_cells[f, s] == c
            assert m.facet_local[f, s] == l
    # interior facets have two distinct cells
    fi = m.facet_cells[: m.n_interior_facets]
    assert np.all(fi[:, 0] != fi[:, 1])
    assert np.all(fi >= 0)
    # boundary facets have no minus cell
    assert np.all(m.facet_cells[m.n_interior_facets :, 1] == -1)


def test_mesh_normals_outward():
    """Facet normals point out of the plus cell (checked via centroids)."""
    m = unit_square_mesh(3)
    centroids = m.cell_coords.mean(axis=1)
    for f in range(m.n_facets):
        cp = m.facet_cells[f, 0]
        lp = m.facet_local[f, 0]
        # midpoint of the facet
        locv = [[1, 2], [2, 0], [0, 1]][lp]
        mid = 0.5 * (m.cell_coords[cp, locv[0]] + m.cell_coords[cp, locv[1]])
        assert np.dot(m.normals[f], mid - centroids[cp]) > 0


def test_domain_volumes():
    assert abs(unit_square_mesh(5).domain_volume - 1.0) < 1e-13
    L = 2 * np.pi
    assert abs(periodic_square_mesh(4).domain_volume - L * L) < 1e-10
    # disk area converges to pi under refinement
    a2 = unit_disk_mesh(2).domain_volume
    a4 = unit_disk_mesh(4).domain_volume
    assert abs(a4 - np.pi) < abs(a2 - np.pi) / 4
