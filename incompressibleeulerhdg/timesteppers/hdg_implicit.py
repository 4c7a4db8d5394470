"""First-order HDG solver: Chorin projection method (and monolithic variant).

Rebuild of ``IncompressibleEulerHDGImplicit``
(reference src/timesteppers/hdg_implicit.py).  This class is the
readable specification of the HDG scheme (SURVEY.md section 3.3); the IMEX
framework generalises it.

Per timestep (projection branch, hdg_implicit.py:97-150):
  1. Q* = project_bdm(Q)
  2a. tentative velocity: (M - dt f_impl(., Q*)) Q~ = M Q + dt M f
  2b. HDG mixed-Poisson pressure correction with rhs
      -(1/dt) (psi, div Q~)_dx  (volume term only, hdg_implicit.py:145)
  2c. Q <- Q~ + dt u'
  3. p <- phi, shifted to zero mean

The whole timestep is one jitted function; the host loop only runs callbacks
and progress reporting.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .common import IncompressibleEuler
from ..ops import fields as F
from ..ops.forms import star_fields
from ..ops.projection import project_bdm
from ..ops.tracer import tracer_step
from ..linalg.condense import build_condensed_system
from ..linalg.gtmg import build_gtmg, gtmg_apply
from ..linalg.pressure import pressure_solve
from ..linalg.tentative import tentative_solve
from ..linalg.preconditioners import build_tentative_operator
from ..linalg.monolithic import monolithic_stage_solve
from ..utils.logging import PerformanceLog, progress

__all__ = ["IncompressibleEulerHDGImplicit"]


class IncompressibleEulerHDGImplicit(IncompressibleEuler):
    """First-order-in-time HDG solver (projection or monolithic).

    :arg disc: HDGDiscretisation
    :arg dt: timestep size
    :arg flux: "upwind" or "centered"
    :arg use_projection_method: Chorin projection instead of monolithic solve
    :arg callbacks: per-timestep callbacks
    """

    def __init__(
        self,
        disc,
        dt,
        flux="upwind",
        use_projection_method=True,
        callbacks=None,
        n_devices=1,
    ):
        super().__init__(disc, dt, label="HDG Implicit")
        self.flux = flux
        assert self.flux in ["upwind", "centered"]
        self.use_projection_method = use_projection_method
        self.callbacks = [] if callbacks is None else callbacks
        self.n_devices = n_devices
        # penalty / stabilisation parameters (hdg_implicit.py:41-43)
        self.alpha = 1.0
        self.tau = 1.0
        self._cs = build_condensed_system(disc, tau=self.tau)
        self._gtmg = build_gtmg(disc, self._cs)
        self._step = jax.jit(self._make_step())

    def _make_step(self):
        dt = self._dt
        alpha = self.alpha
        upwind = self.flux == "upwind"
        vol = self.domain_volume
        projection = self.use_projection_method
        rtol_p = self.rtol_pressure
        rtol_t = self.rtol_tentative

        def step(geom, proj, cs, pc, Q, p, f_nodal):
            precond = lambda v: gtmg_apply(geom, cs, pc, v)
            Qstar = project_bdm(geom, proj, Q)
            star = star_fields(geom, Qstar)
            if projection:
                # 2a: tentative velocity
                t_op = build_tentative_operator(geom, star, dt, alpha, upwind)
                b = F.mass_apply(geom, geom.m1, Q + dt * f_nodal)
                Qt, it_tent, rr_t = tentative_solve(
                    geom, star, b, dt, alpha=alpha, upwind=upwind, rtol=rtol_t,
                    op=t_op,
                )
                # 2b: pressure correction (volume-divergence rhs)
                f_p = (-1.0 / dt) * F.cell_integrate(geom, geom.phi0, F.cell_div(geom, Qt))
                zero_u = jnp.zeros_like(Q)
                zero_lam = jnp.zeros((cs.nt, geom.n_facets), dtype=Q.dtype)
                du, phi, lam, it_p, rr_p = pressure_solve(
                    geom, cs, zero_u, f_p, zero_lam, rtol=rtol_p, precond=precond
                )
                # 2c: velocity update
                Q_new = Qt + dt * du
                p_new = phi
            else:
                b = F.mass_apply(geom, geom.m1, Q + dt * f_nodal)
                Q_new, p_new, lam, it_tent, it_p = monolithic_stage_solve(
                    geom, cs, star, b, dt, alpha=alpha, upwind=upwind,
                    rtol=rtol_p, precond=precond,
                )
            # step 3: zero-mean pressure (dummy cells of an uneven slab
            # decomposition must stay zero — see Geom.cvalid)
            m = F.integral(geom, geom.phi0, p_new) / vol
            p_new = p_new - (m * geom.cvalid if geom.cvalid is not None else m)
            return Q_new, p_new, it_tent, it_p

        return step

    def solve(
        self,
        Q_initial,
        p_initial,
        q_initial,
        f_rhs,
        T_final,
        warmup=False,
        checkpoint_every=0,
        checkpoint_path="checkpoint.npz",
        resume=False,
    ):
        """Timestepping loop (reference hdg_implicit.py:52-197)."""
        geom = self.geom
        nt = self.get_timesteps(T_final, warmup)
        Q = self.disc.interpolate_velocity(Q_initial)
        p = self.disc.interpolate_pressure(p_initial)
        p = self.shift_pressure(p)
        q_tracer = (
            self.disc.interpolate_pressure(q_initial) if q_initial is not None else None
        )
        k_start = 0
        if resume:
            Q, p, q_tracer, k_start = self.resume_state(checkpoint_path, q_tracer)

        for callback in self.callbacks:
            callback.reset()
            callback(Q, p, k_start * self._dt, q_tracer=q_tracer)

        ctx = self.slab_context(f_rhs, with_tracer=q_tracer is not None)
        if ctx is not None:
            dec, dist_step = ctx
            Q_shape, p_shape = Q.shape, p.shape
            Q, p = dec.scatter_cell_field(Q), dec.scatter_cell_field(p)
            gather = lambda: (
                jnp.asarray(dec.gather_cell_field(np.asarray(Q), Q_shape)),
                jnp.asarray(dec.gather_cell_field(np.asarray(p), p_shape)),
            )
        else:
            ops, (Q, p) = self.shard_ops_and_state(
                (Q, p), self._proj, self._cs, self._gtmg
            )
            gather = lambda: (Q, p)
        for k in progress(range(k_start, nt)):
            with PerformanceLog("timestep"):
                if q_tracer is not None:
                    q_tracer = tracer_step(
                        geom, q_tracer, Q, self._dt, cg_space=self.tracer_cg_space()
                    )
                if ctx is not None:
                    tn = jnp.asarray(k * self._dt, dtype=self.disc.dtype)
                    Q, p, it_tent, it_p = dist_step(Q, p, tn)
                else:
                    f_nodal = self.disc.interpolate_velocity(f_rhs(k * self._dt))
                    Q, p, it_tent, it_p = self._step(*ops, Q, p, f_nodal)
            if checkpoint_every and (k + 1) % checkpoint_every == 0:
                self.save_state(checkpoint_path, k + 1, *gather(), q_tracer)
            for callback in self.callbacks:
                callback(*gather(), (k + 1) * self._dt, q_tracer=q_tracer)

        return gather()
