"""Shift-structured facet<->cell data movement for [lowers; uppers] grid meshes.

The generic facet<->cell column gathers (``u[:, fcells[side]]`` etc.) read
memory at index-driven addresses in every Krylov matvec.  On the structured
square meshes all of these maps are
*shift maps*: with cells ordered [all lower triangles; all upper triangles]
(mesh/generators.py) every lower cell's neighbors are upper cells at a fixed
grid offset and each facet color is a row-major rectangle of the lower-cell
grid (mesh/triangle_mesh.py:attach_shift_structure).  Every facet<->cell move
then decomposes into reshapes, static slices, zero-pads, and 2-D rolls —
pure streaming ops.

Primitives (all dispatch on ``geom.shift``, the static spec tuple
``(nx, ny, periodic, slot_off, colors, bnd)``):

- :func:`gather_plus` / :func:`gather_minus` — plus/minus-cell values of a
  cell field at every facet (minus is zero on boundary facets)
- :func:`scatter_sides_sum` — adjoint: accumulate per-facet-side
  contributions into cells (each cell has exactly three facets)
- :func:`slot_gather` / :func:`slot_scatter` — facet values per local cell
  slot (the cell-major trace layout of linalg/condense.py) and its adjoint

Geometry conventions (see attach_shift_structure): ``roll2(a, off)[p] =
a[p + off]`` with zero fill (Neumann) or wraparound (periodic); a color-k
facet sits at lower cell p and couples to upper cell ``p + off_k``.
"""

import jax.numpy as jnp

__all__ = [
    "grid_halves",
    "grid_join",
    "shift2",
    "roll2",
    "rect_slice",
    "rect_flat",
    "rect_pad",
    "gather_plus",
    "gather_minus",
    "scatter_sides_sum",
    "slot_gather",
    "slot_scatter",
]


def grid_halves(geom, u):
    """Split a cell field (..., nc) into lower/upper (..., nx, ny) grids."""
    nx, ny = geom.shift[0], geom.shift[1]
    nch = nx * ny
    shape = u.shape[:-1] + (nx, ny)
    return u[..., :nch].reshape(shape), u[..., nch:].reshape(shape)


def grid_join(geom, lo, up):
    """Inverse of :func:`grid_halves`: two (..., nx, ny) -> (..., nc)."""
    shape = lo.shape[:-2] + (-1,)
    return jnp.concatenate([lo.reshape(shape), up.reshape(shape)], axis=-1)


def _shift_axis(a, d, axis, wrap):
    """out[..., i, ...] = a[..., i + d, ...]; zero fill unless ``wrap``."""
    if d == 0:
        return a
    n = a.shape[axis]

    def sl(s, e):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(s, e)
        return a[tuple(idx)]

    if wrap:
        d = d % n
        return jnp.concatenate([sl(d, n), sl(0, d)], axis=axis)
    zshape = list(a.shape)
    zshape[axis] = min(abs(d), n)
    z = jnp.zeros(zshape, a.dtype)
    if d >= n or d <= -n:
        return jnp.zeros_like(a)
    if d > 0:
        return jnp.concatenate([sl(d, n), z], axis=axis)
    return jnp.concatenate([z, sl(0, n + d)], axis=axis)


def shift2(a, off, wrap):
    """Neighbor lookup on (..., nx, ny): out[p] = a[p + off]."""
    a = _shift_axis(a, off[0], -2, wrap)
    return _shift_axis(a, off[1], -1, wrap)


def dist_axis(geom):
    """shard_map axis name of a slab-decomposed spec, or None.

    A distributed spec (parallel/slab.py) appends ``(axis_name, n_slabs)``
    as a 7th element to the shift tuple.
    """
    s = geom.shift
    if s is not None and len(s) > 6 and s[6] is not None:
        return s[6][0]
    return None


def _dist_shift_i(a, d, wrap, axis_name, n_slabs):
    """Distributed i-axis shift: local shift + single-row ppermute halo.

    The slab decomposition cuts the i axis across devices; the only i
    offsets in any spec are +-1, so the halo is exactly one grid row
    (ny * leading-dims values).  Slabs that receive from nobody (the global
    Neumann boundary) get zeros — ppermute's fill — which is exactly the
    zero-fill semantics of the local shift.
    """
    assert d in (1, -1), d
    import jax

    if d == 1:
        # out[i] = a[i+1]: my row 0 goes to the left neighbor's last row
        row = a[..., :1, :]
        perm = [(s + 1, s) for s in range(n_slabs - 1)]
        if wrap:
            perm.append((0, n_slabs - 1))
        recv = jax.lax.ppermute(row, axis_name, perm)
        return jnp.concatenate([a[..., 1:, :], recv], axis=-2)
    row = a[..., -1:, :]
    perm = [(s, s + 1) for s in range(n_slabs - 1)]
    if wrap:
        perm.append((n_slabs - 1, 0))
    recv = jax.lax.ppermute(row, axis_name, perm)
    return jnp.concatenate([recv, a[..., :-1, :]], axis=-2)


def roll2(geom, a, off):
    """:func:`shift2` with the mesh's wrap mode; slab-decomposed specs route
    i shifts through the ppermute halo exchange."""
    spec = geom.shift
    wrap = spec[2]
    if len(spec) > 6 and spec[6] is not None and off[0] != 0:
        axis_name, n_slabs = spec[6]
        a = _dist_shift_i(a, off[0], wrap, axis_name, n_slabs)
    else:
        a = _shift_axis(a, off[0], -2, wrap)
    return _shift_axis(a, off[1], -1, wrap)


def _neg(off):
    return (-off[0], -off[1])


def rect_slice(a, rect):
    """(..., nx, ny) -> (..., ni, nj) at rect = (i0, j0, ni, nj)."""
    i0, j0, ni, nj = rect
    return a[..., i0 : i0 + ni, j0 : j0 + nj]


def rect_flat(a, rect):
    """rect_slice flattened to the facet axis: (..., ni * nj)."""
    s = rect_slice(a, rect)
    return s.reshape(s.shape[:-2] + (-1,))


def rect_pad(geom, a, rect):
    """(..., nfk) or (..., ni, nj) -> zero-padded (..., nx, ny) at rect."""
    nx, ny = geom.shift[0], geom.shift[1]
    i0, j0, ni, nj = rect
    if a.shape[-1] == ni * nj and (a.ndim < 2 or a.shape[-2:] != (ni, nj)):
        a = a.reshape(a.shape[:-1] + (ni, nj))
    pad = [(0, 0)] * (a.ndim - 2) + [(i0, nx - i0 - ni), (j0, ny - j0 - nj)]
    return jnp.pad(a, pad)


def _fvalid(geom, x):
    """Zero out dummy facet positions (slab-local layouts only)."""
    fv = getattr(geom, "fvalid", None)
    return x if fv is None else x * fv


def _cvalid(geom, x):
    """Zero out dummy CELL positions (uneven slab decompositions only).

    The seam facet between the last real grid column and the first dummy
    column is a global BOUNDARY facet: globally its minus-side value is
    dropped by the zero-fill roll off the grid edge, but locally the dummy
    cell exists at that offset and would catch it — and, once nonzero, feed
    spurious contributions back into the real seam facet through the
    adjoint scatter.  Masking every cell-field-producing move keeps the
    dummy cells exactly zero for the whole step (the decoupling invariant
    of parallel/slab.py's padding scheme)."""
    cv = getattr(geom, "cvalid", None)
    return x if cv is None else x * cv


def gather_plus(geom, u):
    """Plus-cell values of a cell field at every facet: (..., nc) -> (..., nf)."""
    colors, bnd = geom.shift[4], geom.shift[5]
    lo, up = grid_halves(geom, u)
    parts = [rect_flat(lo, col[2:6]) for col in colors]
    parts += [rect_flat(lo if h == 0 else up, (i0, j0, ni, nj))
              for (h, l, i0, j0, ni, nj, f0) in bnd]
    return _fvalid(geom, jnp.concatenate(parts, axis=-1))


def gather_minus(geom, u):
    """Minus-cell values at every facet; ZERO on boundary facets (the gather
    path returns clamped garbage there instead — both are always masked)."""
    colors, bnd = geom.shift[4], geom.shift[5]
    _, up = grid_halves(geom, u)
    parts = [rect_flat(roll2(geom, up, col[6]), col[2:6]) for col in colors]
    if bnd:
        nbnd = sum(ni * nj for (_, _, _, _, ni, nj, _) in bnd)
        parts.append(jnp.zeros(up.shape[:-2] + (nbnd,), u.dtype))
    return _fvalid(geom, jnp.concatenate(parts, axis=-1))


def scatter_sides_sum(geom, c0, c1):
    """Accumulate per-facet contributions into cells: 2 x (..., nf) -> (..., nc).

    c0 targets each facet's plus cell, c1 its minus cell (interior only;
    boundary entries of c1 are ignored, matching the gather path where no
    cell ever reads them).
    """
    colors, bnd = geom.shift[4], geom.shift[5]
    c0 = _fvalid(geom, c0)
    c1 = _fvalid(geom, c1)
    b = geom.fcol_bounds
    acc_lo = 0.0
    acc_up = 0.0
    for k, (l, lu, i0, j0, ni, nj, off) in enumerate(colors):
        rect = (i0, j0, ni, nj)
        acc_lo = acc_lo + rect_pad(geom, c0[..., b[k] : b[k + 1]], rect)
        acc_up = acc_up + roll2(
            geom, rect_pad(geom, c1[..., b[k] : b[k + 1]], rect), _neg(off)
        )
    for (h, l, i0, j0, ni, nj, f0) in bnd:
        pad = rect_pad(geom, c0[..., f0 : f0 + ni * nj], (i0, j0, ni, nj))
        if h == 0:
            acc_lo = acc_lo + pad
        else:
            acc_up = acc_up + pad
    return _cvalid(geom, grid_join(geom, acc_lo, acc_up))


def slot_gather(geom, gf):
    """Facet values per local cell slot: (..., nf) -> 3-list of (..., nc).

    slot l of cell c holds ``gf[..., cell_facets[l, c]]`` — the cell-major
    layout of the condensed trace system (linalg/condense.py).
    """
    colors, bnd = geom.shift[4], geom.shift[5]
    gf = _fvalid(geom, gf)
    b = geom.fcol_bounds
    zeros = 0.0
    lo_blocks = [zeros] * 3
    up_blocks = [zeros] * 3
    for k, (l, lu, i0, j0, ni, nj, off) in enumerate(colors):
        pad = rect_pad(geom, gf[..., b[k] : b[k + 1]], (i0, j0, ni, nj))
        lo_blocks[l] = lo_blocks[l] + pad
        up_blocks[lu] = up_blocks[lu] + roll2(geom, pad, _neg(off))
    for (h, l, i0, j0, ni, nj, f0) in bnd:
        pad = rect_pad(geom, gf[..., f0 : f0 + ni * nj], (i0, j0, ni, nj))
        if h == 0:
            lo_blocks[l] = lo_blocks[l] + pad
        else:
            up_blocks[l] = up_blocks[l] + pad
    return [
        _cvalid(geom, grid_join(geom, lo_blocks[l], up_blocks[l]))
        for l in range(3)
    ]


def slot_scatter(geom, y_slots):
    """Adjoint of :func:`slot_gather`: 3-list of (..., nc) -> (..., nf).

    out[..., f] = sum over the (cell, slot) pairs mapping to facet f.
    """
    colors, bnd = geom.shift[4], geom.shift[5]
    b = geom.fcol_bounds
    halves = [grid_halves(geom, y) for y in y_slots]
    n_int_parts = [None] * len(colors)
    for k, (l, lu, i0, j0, ni, nj, off) in enumerate(colors):
        rect = (i0, j0, ni, nj)
        n_int_parts[k] = rect_flat(halves[l][0], rect) + rect_flat(
            roll2(geom, halves[lu][1], off), rect
        )
    parts = n_int_parts
    parts += [rect_flat(halves[l][h], (i0, j0, ni, nj))
              for (h, l, i0, j0, ni, nj, f0) in bnd]
    return _fvalid(geom, jnp.concatenate(parts, axis=-1))
