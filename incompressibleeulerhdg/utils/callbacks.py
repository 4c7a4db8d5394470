"""Per-timestep callbacks: animation output with derived vorticity.

Rebuild of reference src/auxilliary/callbacks.py: the ``Callback`` ABC
(callbacks.py:11-25) and ``AnimationCallback`` (callbacks.py:28-85), which
writes [velocity, pressure, vorticity, (tracer)] to a VTK time series after
every step.  The vorticity solver (CG weak-curl projection) is built lazily
and cached, mirroring the reference's ``functools.cache``.
"""

from abc import ABC, abstractmethod

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["Callback", "AnimationCallback"]


class Callback(ABC):
    """Abstract base class (callbacks.py:11-25)."""

    @abstractmethod
    def __call__(self, Q, p, t, q_tracer=None):
        """Invoke the callback for fields at a given time."""

    @abstractmethod
    def reset(self):
        """Reset callback."""


class AnimationCallback(Callback):
    """Save fields (+ derived vorticity) to a VTK time series (callbacks.py:28-85).

    :arg disc: HDGDiscretisation
    :arg filename: .pvd output path
    """

    def __init__(self, disc, filename):
        self.disc = disc
        self.filename = filename
        self._vort = None
        self.reset()

    def reset(self):
        from .vtk import VTKTimeSeries

        self.outfile = VTKTimeSeries(self.filename)

    def _vorticity_solver(self):
        """Lazily build & cache the CG vorticity projection (callbacks.py:43-69)."""
        if self._vort is None:
            from ..fem.cg import build_cg_space
            from ..fem.lagrange import triangle_basis
            from ..fem.spaces import facet_ref_points
            from ..ops.vorticity import vorticity_project

            disc = self.disc
            degree = disc.degree + 1  # CG(degree of V_Q)
            space = build_cg_space(disc, degree)
            basis = triangle_basis(degree)
            gphi = jnp.asarray(basis.tabulate_grad(disc.V1.qp), dtype=disc.dtype)
            tphi = jnp.asarray(
                np.stack(
                    [
                        basis.tabulate(facet_ref_points(l, flip, disc.Vt.sq))
                        for l in range(3)
                        for flip in (0, 1)
                    ]
                ),
                dtype=disc.dtype,
            )
            project = jax.jit(
                lambda Q: vorticity_project(disc, space, Q, gphi, tphi)[0]
            )
            self._vort = (space, project)
        return self._vort

    def __call__(self, Q, p, t, q_tracer=None):
        from .vtk import sample_dg_at_corners

        disc = self.disc
        space, project = self._vorticity_solver()
        omega = project(Q)
        # evaluate CG vorticity at cell corners: gather local dofs, tabulate
        from ..fem.lagrange import triangle_basis

        basis = triangle_basis(space.degree)
        corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        tab = basis.tabulate(corners)  # (3, nloc)
        loc = np.asarray(omega)[np.asarray(space.dofmap)]  # (nloc, nc)
        omega_corners = np.einsum("pi,ic->cp", tab, loc)

        fields = {
            "velocity": sample_dg_at_corners(disc, Q),
            "pressure": sample_dg_at_corners(disc, p),
            "vorticity": omega_corners,
        }
        if q_tracer is not None:
            fields["tracer"] = sample_dg_at_corners(disc, q_tracer)
        self.outfile.write(disc.mesh, fields, time=float(t))
