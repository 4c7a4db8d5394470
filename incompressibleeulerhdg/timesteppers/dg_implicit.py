"""DG implicit solver: [DG(k+1)]^2 x DG(k) monolithic velocity-pressure system.

Rebuild of ``IncompressibleEulerDGImplicit``
(reference src/timesteppers/dg_implicit.py).  The reference solves the
saddle-point system per step with GMRES + MUMPS LU (dg_implicit.py:77-82); a
sparse direct factorisation is the wrong tool on an accelerator, so we iterate the
projection preconditioner (tentative solve + HDG mixed-Poisson correction) to
the same tolerance — the momentum block is *identical* to the tentative
operator M - dt f_impl, and the DG continuity form equals the reference's
``_weak_divergence``.

Per step (dg_implicit.py:116-134): Q* = project_bdm(Q); assemble rhs
(Q + dt f, w); monolithic solve; pressure mean shift; optional tracer.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .common import IncompressibleEuler
from ..ops import fields as F
from ..ops.forms import star_fields, pressure_gradient_dg_apply, weak_divergence_apply
from ..ops.projection import project_bdm
from ..ops.tracer import tracer_step
from ..linalg.condense import build_condensed_system
from ..linalg.gtmg import build_gtmg, gtmg_apply
from ..linalg.pressure import pressure_solve
from ..linalg.tentative import tentative_solve
from ..linalg.preconditioners import build_tentative_operator, tentative_operator_matvec
from ..linalg.krylov import fgmres
from ..utils.logging import PerformanceLog, progress

__all__ = ["IncompressibleEulerDGImplicit"]


class IncompressibleEulerDGImplicit(IncompressibleEuler):
    """Implicit DG scheme (Guzman et al. 2016, section 2.2)."""

    def __init__(self, disc, dt, flux="upwind", callbacks=None, n_devices=1):
        super().__init__(disc, dt, label="DG Implicit")
        assert flux in ["upwind", "centered"]
        self.flux = flux
        self.alpha = 1.0  # penalty parameter (dg_implicit.py:29)
        self.callbacks = [] if callbacks is None else callbacks
        self.n_devices = n_devices
        self._cs = build_condensed_system(disc, tau=1.0)
        self._gtmg = build_gtmg(disc, self._cs)
        self._step = jax.jit(self._make_step())

    def _make_step(self):
        dt = self._dt
        alpha = self.alpha
        upwind = self.flux == "upwind"
        vol = self.domain_volume
        rtol_p = self.rtol_pressure
        rtol_t = self.rtol_tentative

        def dg_matvec(geom, t_op, Q, p):
            """Monolithic DG operator (dg_implicit.py:48-71); momentum block
            applied via the assembled per-stage blocks."""
            r_u = tentative_operator_matvec(geom, t_op, Q) - (
                dt * pressure_gradient_dg_apply(geom, p)
            )
            r_p = dt * weak_divergence_apply(geom, Q)
            return r_u, r_p

        def solve_monolithic(geom, cs, precond, star, t_op, b_u, Q0, p0):
            """FGMRES on the coupled (u, p) system, preconditioned by one
            projection cycle (replacing GMRES+MUMPS, dg_implicit.py:77-82).
            Inner products are global reductions when slab-distributed."""
            from ..ops.structured import dist_axis
            from ..linalg.krylov import _pdot, _pnorm

            ax = dist_axis(geom)
            nc, d1, d0 = geom.n_cells, geom.d1, geom.d0
            nu = nc * d1 * 2

            def flat(u, p):
                return jnp.concatenate([u.ravel(), p.ravel()])

            def unflat(v):
                return v[:nu].reshape(2, d1, nc), v[nu:].reshape(d0, nc)

            def matvec(v):
                return flat(*dg_matvec(geom, t_op, *unflat(v)))

            def M(v):
                r_u, r_p = unflat(v)
                dQt, _, _ = tentative_solve(
                    geom, star, r_u, dt, alpha=alpha, upwind=upwind,
                    rtol=1e-6, maxiter=60, op=t_op,
                )
                f_p = (-1.0 / dt) * weak_divergence_apply(geom, dQt) + (1.0 / dt) * r_p
                du, dp, _, _, _ = pressure_solve(
                    geom, cs, jnp.zeros_like(r_u), f_p,
                    jnp.zeros((cs.nt, geom.n_facets), r_u.dtype), rtol=1e-6,
                    maxiter=60, precond=precond,
                )
                return flat(dQt + dt * du, dp)

            ones_p = jnp.ones((d0, nc), b_u.dtype)
            if geom.cvalid is not None:  # skip dummy cells of uneven slabs
                ones_p = ones_p * geom.cvalid
            nullv = flat(jnp.zeros((2, d1, nc), b_u.dtype), ones_p)
            nullv = nullv / _pnorm(nullv, ax)
            project = lambda v: v - nullv * _pdot(nullv, v, ax)

            b = flat(b_u, jnp.zeros((d0, nc), b_u.dtype))
            x, _, _ = fgmres(
                matvec, b, M=M, x0=flat(Q0, p0), rtol=10 * rtol_p,
                restart=20, maxiter=100, project=project, axis_name=ax,
            )
            return unflat(x)

        def step(geom, proj, cs, pc, Q, p, f_nodal):
            precond = lambda v: gtmg_apply(geom, cs, pc, v)
            Qstar = project_bdm(geom, proj, Q)
            star = star_fields(geom, Qstar)
            b_u = F.mass_apply(geom, geom.m1, Q + dt * f_nodal)
            t_op = build_tentative_operator(geom, star, dt, alpha, upwind)
            Q_new, p_new = solve_monolithic(geom, cs, precond, star, t_op, b_u, Q, p)
            m = F.integral(geom, geom.phi0, p_new) / vol
            p_new = p_new - (m * geom.cvalid if geom.cvalid is not None else m)
            return Q_new, p_new

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
        """Timestepping loop (dg_implicit.py:84-136)."""
        nt = self.get_timesteps(T_final, warmup)
        Q = self.disc.interpolate_velocity(Q_initial)
        p = self.shift_pressure(self.disc.interpolate_pressure(p_initial))
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
                        self.geom, q_tracer, Q, self._dt, cg_space=self.tracer_cg_space()
                    )
                if ctx is not None:
                    tn = jnp.asarray(k * self._dt, dtype=self.disc.dtype)
                    Q, p = dist_step(Q, p, tn)
                else:
                    f_nodal = self.disc.interpolate_velocity(f_rhs(k * self._dt))
                    Q, p = self._step(*ops, Q, p, f_nodal)
                jax.block_until_ready(Q)
            if checkpoint_every and (k + 1) % checkpoint_every == 0:
                self.save_state(checkpoint_path, k + 1, *gather(), q_tracer)
            for callback in self.callbacks:
                callback(*gather(), (k + 1) * self._dt, q_tracer=q_tracer)
        return gather()
