"""Mesh utility functions.

``gridspacing`` rebuilds reference src/auxilliary/utils.py:49-79 (min and
max edge length of the mesh) — trivially, since facet lengths are first-class
arrays here instead of a loopy par_loop over DGT coordinate fields.
"""

import numpy as np

__all__ = ["gridspacing"]


def gridspacing(mesh):
    """Smallest and largest edge length of a 2-D mesh (utils.py:49-79)."""
    return float(np.min(mesh.facet_lengths)), float(np.max(mesh.facet_lengths))
