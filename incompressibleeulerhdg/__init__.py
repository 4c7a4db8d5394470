"""incompressibleeulerhdg — HDG solver framework for the 2-D
incompressible Euler equations.

A ground-up JAX/XLA rebuild of the capabilities of
eikehmueller/IncompressibleEulerHDG (hybridisable discontinuous Galerkin
spatial discretisations + implicit/IMEX timestepping for
``dQ/dt + grad p + (Q.grad)Q = f``, ``div Q = 0``).

Architecture (accelerator-first, not a port):

- ``mesh``          triangle meshes as flat index arrays (replaces Firedrake/DMPlex)
- ``fem``           reference-element tabulations: quadrature, Lagrange/DGT/BDM
                    bases, geometry factors (replaces UFL/TSFC/FIAT)
- ``ops``           batched weak-form kernels: every bilinear/linear form of the
                    reference becomes a dense tensor contraction over
                    ``(n_cells, n_dof, ...)`` arrays (replaces generated C kernels)
- ``linalg``        batched static condensation, matrix-free Krylov with
                    iteration-count observables, preconditioners
                    (replaces PETSc/Slate/SCPC/GTMG/MUMPS)
- ``timesteppers``  the five scheme families of the reference
- ``models``        model problems (Taylor-Green, Kelvin-Helmholtz, shear flow)
- ``parallel``      mesh-sharded SPMD over a ``jax.sharding.Mesh``
- ``utils``         performance logging, callbacks, VTK output
- ``cli``           argparse driver mirroring the reference's 17-flag surface
"""

__version__ = "0.1.0"
