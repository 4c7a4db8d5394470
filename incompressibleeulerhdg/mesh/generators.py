"""Mesh generators: unit square, periodic square, unit disk.

Replacements for the Firedrake constructors used by the reference
driver (reference src/driver.py:181-185):
``UnitSquareMesh(nx, nx)``, ``PeriodicSquareMesh(nx, nx, L=2*pi)``,
``UnitDiskMesh(refinement_level)``.
"""

import numpy as np

from .triangle_mesh import build_mesh, attach_shift_structure

__all__ = ["unit_square_mesh", "periodic_square_mesh", "unit_disk_mesh"]


def unit_square_mesh(nx, ny=None, L=1.0):
    """Structured triangulation of [0, L]^2 with 2*nx*ny cells.

    Each grid square is split along the (i, j) -> (i+1, j+1) diagonal
    (diagonal "right"), matching the default triangle pattern of the
    reference's ``UnitSquareMesh`` up to reflection; convergence behaviour is
    identical.

    Cells are ordered [all lower triangles (i-major); all upper triangles]:
    every lower cell's neighbors are upper cells at fixed grid offsets (and
    vice versa), which turns all facet<->cell data movement into static
    slices/rolls (see :func:`attach_shift_structure`).
    """
    if ny is None:
        ny = nx
    xs = np.linspace(0.0, L, nx + 1)
    ys = np.linspace(0.0, L, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return i * (ny + 1) + j

    lowers, uppers = [], []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            lowers.append([v00, v10, v11])
            uppers.append([v00, v11, v01])
    m = build_mesh(vertices, np.asarray(lowers + uppers, dtype=np.int32))
    m.structured_grid = ("neumann", nx + 1, ny + 1)
    attach_shift_structure(m, nx, ny, periodic=False)
    return m


def periodic_square_mesh(nx, ny=None, L=2.0 * np.pi):
    """Doubly-periodic structured triangulation of [0, L]^2.

    Vertices are identified modulo nx/ny; per-cell coordinates are stored
    unwrapped so every cell remains affine.  Requires nx, ny >= 3 so that no
    two distinct facets share the same vertex pair.
    """
    if ny is None:
        ny = nx
    assert nx >= 3 and ny >= 3, "periodic mesh requires nx, ny >= 3"
    xs = np.arange(nx) * (L / nx)
    ys = np.arange(ny) * (L / ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return (i % nx) * ny + (j % ny)

    def coord(i, j):
        return np.array([i * (L / nx), j * (L / ny)])

    lowers, lcoords, uppers, ucoords = [], [], [], []
    for i in range(nx):
        for j in range(ny):
            lowers.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            lcoords.append([coord(i, j), coord(i + 1, j), coord(i + 1, j + 1)])
            uppers.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
            ucoords.append([coord(i, j), coord(i + 1, j + 1), coord(i, j + 1)])
    m = build_mesh(
        vertices,
        np.asarray(lowers + uppers, dtype=np.int32),
        cell_coords=np.asarray(lcoords + ucoords, dtype=np.float64),
        periodic=True,
    )
    m.structured_grid = ("periodic", nx, ny)
    attach_shift_structure(m, nx, ny, periodic=True)
    return m


def unit_disk_mesh(refinement_level=2):
    """Triangulation of the unit disk by uniform refinement of a hexagonal core.

    Analogue of Firedrake's ``UnitDiskMesh``: a coarse hexagon (6 triangles
    around the origin) is refined ``refinement_level`` times by 4-way edge
    midpoint splitting; newly created *boundary* vertices are projected onto
    the unit circle, and all vertices are smoothly graded so the boundary is a
    good polygonal approximation of the circle.
    """
    # coarse hexagon
    angles = np.arange(6) * (np.pi / 3.0)
    ring = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    vertices = np.concatenate([[[0.0, 0.0]], ring], axis=0)
    cells = np.array([[0, 1 + i, 1 + (i + 1) % 6] for i in range(6)], dtype=np.int32)
    boundary = np.zeros(7, dtype=bool)
    boundary[1:] = True

    for _ in range(refinement_level):
        verts = list(vertices)
        bnd = list(boundary)
        edge_mid = {}
        new_cells = []

        # mark boundary edges: edges used by only one cell
        from collections import Counter

        edge_count = Counter()
        for c in cells:
            for a, b in ((c[0], c[1]), (c[1], c[2]), (c[2], c[0])):
                edge_count[(min(a, b), max(a, b))] += 1

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                pm = 0.5 * (vertices[a] + vertices[b])
                on_bnd = edge_count[key] == 1
                if on_bnd:
                    pm = pm / np.linalg.norm(pm)
                edge_mid[key] = len(verts)
                verts.append(pm)
                bnd.append(on_bnd)
            return edge_mid[key]

        for c in cells:
            m01 = midpoint(c[0], c[1])
            m12 = midpoint(c[1], c[2])
            m20 = midpoint(c[2], c[0])
            new_cells += [
                [c[0], m01, m20],
                [c[1], m12, m01],
                [c[2], m20, m12],
                [m01, m12, m20],
            ]
        vertices = np.asarray(verts)
        cells = np.asarray(new_cells, dtype=np.int32)
        boundary = np.asarray(bnd, dtype=bool)

    return build_mesh(vertices, cells)
