"""Abstract timestepper base: shared FEM operations and the ``solve`` contract.

Rebuild of ``IncompressibleEuler``
(reference src/timesteppers/common.py:15-144):

- the ``1/h_F`` facet field (common.py:36-57) is ``geom.hF_inv`` (exact edge
  lengths instead of a loopy par_loop)
- BDM projection with multiplicity averaging + zero-normal BC
  (common.py:91-108) is the batched moment pipeline in ops/projection.py
- ``get_timesteps`` mirrors common.py:75-84 including the divisibility assert
- the upwind DG tracer advection form (common.py:110-129) is implemented in
  ops/tracer.py and shared by all concrete schemes
"""

from abc import ABC, abstractmethod

import numpy as np
import jax.numpy as jnp

from ..ops import fields as F
from ..ops.projection import build_bdm_projection, project_bdm

__all__ = ["IncompressibleEuler"]


class IncompressibleEuler(ABC):
    """Abstract base class for timesteppers of the incompressible Euler equation.

    :arg disc: HDGDiscretisation (mesh + degree + dtype)
    :arg dt: timestep size
    :arg label: name of the timestepping method
    """

    def __init__(self, disc, dt, label=None):
        self.disc = disc
        self.geom = disc.geom
        self.degree = disc.degree
        self._dt = float(dt)
        self._label = label
        self.domain_volume = disc.domain_volume
        self._proj = build_bdm_projection(disc)
        self._cg_space = None

    def shard_ops_and_state(self, state, *extra_ops):
        """GSPMD-shard ``(geom, *extra_ops)`` and the state pytree when
        ``self.n_devices > 1``; identity otherwise.

        The n_devices analogue of the reference's transparent ``mpiexec -n``
        for the non-IMEX schemes (IMEX has the stronger slab-decomposed
        path, timesteppers/hdg_imex.py): operator pytrees get cell/facet
        shardings, the same jitted step runs under GSPMD.
        """
        n = getattr(self, "n_devices", 1)
        if n <= 1:
            return (self.geom, *extra_ops), state
        import jax

        if len(jax.devices()) < n:
            raise RuntimeError(
                f"n_devices={n} but only {len(jax.devices())} jax devices "
                "are visible"
            )
        from ..parallel.sharding import (
            make_device_mesh,
            shard_discretisation,
            shard_state,
        )

        mesh = make_device_mesh(n)
        ops = shard_discretisation(self.disc, mesh, *extra_ops)
        st = shard_state(
            state, mesh, self.geom.n_cells, self.geom.n_facets
        )
        return ops, st

    def slab_context(self, f_rhs, with_tracer=False):
        """Build ``(dec, dist_step)`` when the scalable slab path applies to
        this stepper — structured mesh, ``n_devices > 1``, no tracer, and a
        simple ``step(geom, proj, cs, pc, Q, p, f_nodal)`` body — else None
        (callers fall back to the GSPMD sharding of
        :meth:`shard_ops_and_state`).

        This extends the halo-exchange domain decomposition beyond IMEX to
        the dg/hdg implicit families (the reference's MPI decomposition
        covers every scheme uniformly, SURVEY.md section 2.4); the
        conforming RT scheme keeps the GSPMD fallback — its RT assembly
        uses index-table gathers the slab-local layout does not carry.
        """
        n = getattr(self, "n_devices", 1)
        if n <= 1 or with_tracer:
            return None
        from ..parallel.slab import slab_supported

        if not slab_supported(self.disc.mesh, n):
            # unstructured mesh OR a split the slab layout cannot represent
            # (periodic with nx % n != 0): GSPMD fallback
            return None
        import jax

        if len(jax.devices()) < n:
            raise RuntimeError(
                f"n_devices={n} but only {len(jax.devices())} jax devices "
                "are visible"
            )
        from ..parallel import slab as _slab

        dec = _slab.build_slab_decomposition(self.disc, self, n)
        return dec, _slab.make_distributed_simple_step(dec, self, f_rhs)

    def tracer_cg_space(self):
        """Vector CG(k+1) space for the tracer advecting-velocity projection.

        The reference projects the advecting velocity onto CG before every
        tracer flux (``project_onto_cg=True`` at all call sites,
        common.py:110-129); built lazily since most runs carry no tracer.
        """
        if self._cg_space is None:
            from ..fem.cg import build_cg_space

            self._cg_space = build_cg_space(self.disc, self.degree + 1)
        return self._cg_space

    @property
    def label(self):
        """Label of method (reference common.py:86-89)."""
        return self._label

    def get_timesteps(self, t_final, warmup):
        """Number of timesteps; asserts dt divides t_final (common.py:75-84)."""
        nt = 1 if warmup else int(np.round(t_final / self._dt))
        assert warmup or (abs(nt * self._dt - t_final) < 1.0e-12)
        return nt

    def project_bdm(self, Q):
        """H(div)-conforming averaging projection (common.py:91-108)."""
        return project_bdm(self.geom, self._proj, Q)

    def pressure_mean(self, p):
        """Integral mean of a DG(k) pressure field."""
        return F.integral(self.geom, self.geom.phi0, p) / self.domain_volume

    def shift_pressure(self, p):
        """Shift pressure to zero mean."""
        return p - self.pressure_mean(p)

    # ------------------------------------------------------------------
    # checkpoint / resume of plain (Q, p, tracer) state — shared by the
    # non-IMEX schemes (IMEX checkpoints its full stage state instead,
    # timesteppers/hdg_imex.py).  Exceeds reference parity: the reference
    # has no checkpointing at all (SURVEY.md section 5.4).
    # ------------------------------------------------------------------

    def _checkpoint_config(self):
        """Run-defining config validated on resume (mesh/scheme/dt guard)."""
        return {
            "scheme": type(self).__name__,
            "n_cells": int(self.geom.n_cells),
            "degree": int(self.degree),
            "dt": float(self._dt),
        }

    def save_state(self, checkpoint_path, k, Q, p, q_tracer=None):
        """Atomically save the plain solver state after step ``k``."""
        from ..utils.checkpoint import save_checkpoint

        save_checkpoint(
            checkpoint_path,
            {
                "Q": np.asarray(Q),
                "p": np.asarray(p),
                "q_tracer": None if q_tracer is None else np.asarray(q_tracer),
            },
            t=k * self._dt,
            config=self._checkpoint_config(),
        )

    def resume_state(self, checkpoint_path, q_tracer=None):
        """Load ``(Q, p, q_tracer, k_start)`` saved by :meth:`save_state`.

        The stored config must match this run's mesh/scheme/dt; the stored
        tracer is used only when this run carries one too.
        """
        from ..utils.checkpoint import load_checkpoint

        state, t_ck, _ = load_checkpoint(
            checkpoint_path, expect_config=self._checkpoint_config()
        )
        dtype = self.disc.dtype
        Q = jnp.asarray(state["Q"], dtype)
        p = jnp.asarray(state["p"], dtype)
        if state.get("q_tracer") is not None and q_tracer is not None:
            q_tracer = jnp.asarray(state["q_tracer"], dtype)
        k_start = int(round(t_ck / self._dt))
        print(f"resumed from {checkpoint_path} at t = {t_ck} (step {k_start})")
        return Q, p, q_tracer, k_start

    def velocity_error_norm(self, Q, Q_exact):
        """L2 norm of the velocity error (driver.py:376-379 analogue)."""
        return float(jnp.sqrt(F.l2_norm_sq(self.geom, self.geom.phi1, Q - Q_exact)))

    def pressure_error_norm(self, p, p_exact):
        """L2 norm of the pressure error (driver.py:377-380 analogue)."""
        return float(jnp.sqrt(F.l2_norm_sq(self.geom, self.geom.phi0, p - p_exact)))


    @property
    def rtol_pressure(self):
        """Condensed-field GMRES tolerance (1e-12 in the reference,
        hdg_imex.py:137); loosened in float32 where 1e-12 is unreachable."""
        import jax.numpy as jnp

        return 1.0e-12 if self.disc.dtype == jnp.float64 else 2.0e-6

    @property
    def rtol_tentative(self):
        """Tentative-velocity GMRES tolerance (1e-10, hdg_imex.py:226)."""
        import jax.numpy as jnp

        return 1.0e-10 if self.disc.dtype == jnp.float64 else 1.0e-6

    @abstractmethod
    def solve(self, Q_initial, p_initial, q_initial, f_rhs, T_final, warmup=False):
        """Propagate (Q, p) from the initial state to T_final.

        :arg Q_initial: initial velocity expression ``(x, y) -> (u, v)``
        :arg p_initial: initial pressure expression ``(x, y) -> p``
        :arg q_initial: initial tracer expression or None
        :arg f_rhs: ``t -> ((x, y) -> (fx, fy))`` forcing factory
        :arg T_final: final time
        :arg warmup: perform a single timestep only
        :returns: (Q, p) final coefficient arrays
        """
