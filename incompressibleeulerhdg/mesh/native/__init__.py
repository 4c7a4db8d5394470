"""ctypes loader for the native mesh kernel.

Compiles meshkernel.cpp with g++ on first use (cached as a shared object next
to the source, built for the host it runs on and never committed); falls back
transparently to the pure-numpy implementation in mesh/triangle_mesh.py if no
compiler is available.
"""

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["get_lib", "native_connectivity", "native_color_cells"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "meshkernel.cpp")
_SO = os.path.join(_HERE, "libmeshkernel.so")
_LIB = None
_TRIED = False


def get_lib():
    """Return the loaded shared library, compiling it if needed, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            # build under a per-process name and rename into place, so
            # concurrent first uses never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.build_connectivity.restype = ctypes.c_int64
        lib.build_connectivity.argtypes = [
            ctypes.c_int64,
            ctypes.c_int64,
            i32p,
            i32p,
            i32p,
            i32p,
            i32p,
            i32p,
            i64p,
        ]
        lib.color_cells.restype = ctypes.c_int32
        lib.color_cells.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_connectivity(n_vertices, cells):
    """Run the C++ connectivity build.  Returns None if unavailable.

    :returns: (facet_cells, facet_local, facet_flip, cell_facets,
               cell_facet_side, n_interior) or None
    """
    lib = get_lib()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc = cells.shape[0]
    cap = 3 * nc
    facet_cells = np.empty((cap, 2), dtype=np.int32)
    facet_local = np.zeros((cap, 2), dtype=np.int32)
    facet_flip = np.zeros((cap, 2), dtype=np.int32)
    cell_facets = np.empty((nc, 3), dtype=np.int32)
    cell_side = np.empty((nc, 3), dtype=np.int32)
    n_int = np.zeros(1, dtype=np.int64)
    nf = lib.build_connectivity(
        int(n_vertices),
        int(nc),
        _ptr(cells),
        _ptr(facet_cells),
        _ptr(facet_local),
        _ptr(facet_flip),
        _ptr(cell_facets),
        _ptr(cell_side),
        n_int.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    nf = int(nf)
    return (
        facet_cells[:nf].copy(),
        facet_local[:nf].copy(),
        facet_flip[:nf].copy(),
        cell_facets,
        cell_side,
        int(n_int[0]),
    )


def native_color_cells(n_cells, n_interior_facets, facet_cells):
    """Run the C++ greedy coloring.  Returns (colors, n_colors) or None."""
    lib = get_lib()
    if lib is None:
        return None
    fc = np.ascontiguousarray(facet_cells, dtype=np.int32)
    colors = np.empty(int(n_cells), dtype=np.int32)
    ncol = lib.color_cells(int(n_cells), int(n_interior_facets), _ptr(fc), _ptr(colors))
    return colors, int(ncol)
