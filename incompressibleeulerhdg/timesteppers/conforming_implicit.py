"""Conforming RT1 x DG0 implicit solver.

Rebuild of ``IncompressibleEulerConformingImplicit``
(reference src/timesteppers/conforming_implicit.py) — scheme 1 of the
reference README (Guzman et al. 2016, section 2.1).

Velocity: global H(div)-conforming RT dofs (one normal flux per facet,
ops/rt.py); pressure: DG0 (one value per cell).  Per timestep (projection
branch, conforming_implicit.py:163-178):

  1. mass solve  M Qhat = (Q,w) + dt [ (f,w) + p div w - (w, (Q.grad)Q)
                                        + advective facet flux ]
     with zero-normal-flux boundary conditions (the DirichletBC of
     conforming_implicit.py:70)
  2. mixed Darcy solve [[M, B^T], [B, 0]] (dQ, dphi) = (0, (1/dt) div Qhat)
     via a Schur-complement CG (outer CG on B M^{-1} B^T with constant
     deflation, inner diagonally-preconditioned CG mass solves) — replacing
     the PETSc nullspace-projected Krylov of conforming_implicit.py:82-94
  3. Q <- Qhat - dt dQ ;  p <- p + dphi ; zero-mean shift

The monolithic branch iterates the same mass + Darcy preconditioner on the
coupled residual (replacing the direct solve of conforming_implicit.py:96-125)
to solver tolerance.
"""

import jax
import jax.numpy as jnp
from jax import lax

from .common import IncompressibleEuler
from ..ops import fields as F
from ..ops import rt as RT
from ..ops.tracer import tracer_step
from ..linalg.krylov import cg as cg_solve, fgmres
from ..utils.logging import PerformanceLog, progress

__all__ = ["IncompressibleEulerConformingImplicit"]


class IncompressibleEulerConformingImplicit(IncompressibleEuler):
    """Conforming implicit scheme (RT1 velocity, DG0 pressure)."""

    def __init__(self, disc, dt, flux="upwind", use_projection_method=True,
                 callbacks=None, n_devices=1):
        assert disc.degree == 0, "conforming scheme uses degree 0 (RT1 x DG0)"
        super().__init__(disc, dt, label="Conforming Implicit")
        self.flux = flux
        assert self.flux in ["upwind", "centered"]
        self._use_projection_method = use_projection_method
        self.callbacks = [] if callbacks is None else callbacks
        self.n_devices = n_devices
        self._rt = RT.build_rt_tables(disc)
        self._step = jax.jit(self._make_step())

    # ------------------------------------------------------------------

    def _make_step(self):
        dt = self._dt
        upwind = self.flux == "upwind"
        vol = self.domain_volume
        projection = self._use_projection_method
        rtol = self.rtol_pressure

        def step(geom, rt, Q, p, f_dofs):
            Z = rt.int_dof_mask  # zero-normal-flux BC projector

            def mass_solve(b):
                """CG solve of Z M Z g = Z b (boundary dofs pinned to zero)."""
                b = Z * b

                def mv(v):
                    return Z * RT.rt_mass_apply(geom, rt, Z * v) + (1.0 - Z) * v

                x, iters, _ = cg_solve(
                    mv, b, M=lambda v: rt.mass_diag_inv * v, rtol=1e-14, maxiter=200
                )
                return x, iters

            def apply_BT(phi):
                """B^T phi: dof coefficients of int phi div w."""
                return Z * RT.rt_div_adjoint(geom, rt, phi)

            def apply_B(g):
                """B g: cell values int div(v) psi = sum_l s_l g_l."""
                gl = (Z * g)[geom.cell_facets] * geom.cfsign  # (3, nc)
                return jnp.sum(gl, axis=0)

            def mixed_solve(b_p):
                """Schur-complement solve of the Darcy system with rhs (0, b_p).

                Returns (dQ (nf,), dphi (nc,), outer iterations).
                """
                nrm = jnp.sqrt(jnp.asarray(geom.n_cells, b_p.dtype))

                def project(q):
                    return q - jnp.mean(q)

                def schur(phi):
                    y, _ = mass_solve(apply_BT(phi))
                    return apply_B(y)

                rhs = project(-b_p)
                phi, iters, _ = cg_solve(
                    schur, rhs, M=lambda v: v * rt.area, rtol=rtol, maxiter=300,
                    project=project,
                )
                y, _ = mass_solve(apply_BT(phi))
                return -y, phi, iters

            def advective_rhs(Q):
                """dt * [ -(w, (Q.grad)Q) + advective facet flux ] coefficients."""
                a, b = RT.rt_cell_coeffs(geom, rt, Q)
                # (Q.grad)Q = a_c * Q(x)  (grad of an RT1 field is a_c * Identity)
                Qq = RT.rt_eval_cellq(geom, rt, Q)  # (2, nq, nc)
                Gvol = -dt * a[None, None, :] * Qq
                r = RT.rt_volume_adjoint(geom, rt, Gvol)

                v0, v1 = RT.rt_facet_values(geom, rt, Q)  # (2, nqf, nf)
                mask = F.interior_mask(geom, 3)
                jump = (v0 - v1) * mask
                qn = jnp.einsum("dqf,df->qf", v0, geom.normal)
                if upwind:
                    # (Q+.n)(jump Q).avg(w) - 1/2 |Q+.n| (jump Q).(jump w)
                    # (conforming_implicit.py:48-58)
                    G0 = dt * (0.5 * qn[None] * jump - 0.5 * jnp.abs(qn)[None] * jump)
                    G1 = dt * (0.5 * qn[None] * jump + 0.5 * jnp.abs(qn)[None] * jump)
                else:
                    # centered: 2 avg((Q.n) Q).avg(w) = (Q+.n)(jump Q).avg(w) for RT
                    # (conforming_implicit.py:59-62)
                    G0 = dt * 0.5 * qn[None] * jump
                    G1 = dt * 0.5 * qn[None] * jump
                return r + RT.rt_facet_adjoint(geom, rt, G0, G1 * mask)

            def monolithic_matvec(Qlin, v, phi):
                """a_monolithic action (conforming_implicit.py:96-125)."""
                aQ, _ = RT.rt_cell_coeffs(geom, rt, Qlin)
                vq = RT.rt_eval_cellq(geom, rt, Z * v)
                # inner(grad Q, outer(v, w)) = a_Q * v . w for RT1
                r_v = RT.rt_mass_apply(geom, rt, Z * v) + dt * RT.rt_volume_adjoint(
                    geom, rt, aQ[None, None, :] * vq
                )
                # - advective_facet_flux(v) with Q as advecting field
                q0, q1 = RT.rt_facet_values(geom, rt, Qlin)
                w0, w1 = RT.rt_facet_values(geom, rt, Z * v)
                mask = F.interior_mask(geom, 3)
                jmp = (w0 - w1) * mask
                qn = jnp.einsum("dqf,df->qf", q0, geom.normal)
                G0 = -dt * 0.5 * qn[None] * jmp
                G1 = -dt * 0.5 * qn[None] * jmp
                if upwind:
                    G0 = G0 + dt * jnp.abs(qn)[None] * jmp
                    G1 = G1 - dt * jnp.abs(qn)[None] * jmp
                r_v = r_v + RT.rt_facet_adjoint(geom, rt, G0, G1 * mask)
                # - dt phi div w ; psi div v
                r_v = r_v - dt * apply_BT(phi)
                r_p = apply_B(v)
                return Z * r_v + (1.0 - Z) * v, r_p

            def monolithic_solve(Q, p, b_v):
                """FGMRES on the coupled (v, phi) system, preconditioned by one
                mass-solve + Darcy-correction cycle (replacing the direct solve
                of conforming_implicit.py:96-125)."""
                b_v = Z * b_v
                nf, nc = geom.n_facets, geom.n_cells

                def flat(v, phi):
                    return jnp.concatenate([v, phi])

                def unflat(x):
                    return x[:nf], x[nf:]

                def matvec(x):
                    return flat(*monolithic_matvec(Q, *unflat(x)))

                def M(x):
                    r_v, r_p = unflat(x)
                    vt, _ = mass_solve(r_v)
                    # continuity: B(vt - dt dv) = r_p => B dv = (B vt - r_p)/dt
                    b_p = (1.0 / dt) * (apply_B(vt) - r_p)
                    dv, dphi, _ = mixed_solve(b_p)
                    return flat(vt - dt * dv, dphi)

                nullv = flat(jnp.zeros(nf, b_v.dtype), jnp.ones(nc, b_v.dtype))
                nullv = nullv / jnp.linalg.norm(nullv)
                project = lambda x: x - nullv * jnp.dot(nullv, x)

                b = flat(b_v, jnp.zeros(nc, b_v.dtype))
                x, _, _ = fgmres(
                    matvec, b, M=M, x0=flat(Q, p), rtol=10 * rtol,
                    restart=20, maxiter=100, project=project,
                )
                return unflat(x)

            def _advance(Q, p, f_dofs):
                b_v = (
                    RT.rt_mass_apply(geom, rt, Q)
                    + dt * RT.rt_mass_apply(geom, rt, f_dofs)
                    + dt * RT.rt_div_adjoint(geom, rt, p)
                    + advective_rhs(Q)
                )
                if projection:
                    Qhat, _ = mass_solve(b_v)
                    b_p = (1.0 / dt) * apply_B(Qhat)
                    dQ, dphi, iters = mixed_solve(b_p)
                    Q_new = Qhat - dt * dQ  # conforming_implicit.py:172-178
                    p_new = p + dphi
                else:
                    b_vm = (
                        RT.rt_mass_apply(geom, rt, Q)
                        + dt * RT.rt_mass_apply(geom, rt, f_dofs)
                    )
                    Q_new, p_new = monolithic_solve(Q, p, b_vm)
                # zero-mean pressure (DG0: area-weighted mean)
                p_new = p_new - jnp.sum(p_new * rt.area) / vol
                return Q_new, p_new


            return _advance(Q, p, f_dofs)

        return step

    # ------------------------------------------------------------------

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
        """Timestepping loop (conforming_implicit.py:127-190)."""
        geom = self.geom
        rt = self._rt
        nt = self.get_timesteps(T_final, warmup)
        Q = RT.rt_interpolate(self.disc, rt, Q_initial) * rt.int_dof_mask
        # DG0 pressure: value at centroids
        xc = jnp.mean(geom.xnodes1, axis=1)  # (2, nc)
        p = jnp.broadcast_to(
            jnp.asarray(p_initial(xc[0], xc[1])), (geom.n_cells,)
        ).astype(self.disc.dtype)
        p = p - jnp.sum(p * rt.area) / self.domain_volume
        q_tracer = (
            self.disc.interpolate_pressure(q_initial) if q_initial is not None else None
        )
        k_start = 0
        if resume:
            # checkpointed state is the RT dof vector + DG0 pressure
            Q, p, q_tracer, k_start = self.resume_state(checkpoint_path, q_tracer)

        for callback in self.callbacks:
            callback.reset()
            callback(
                self.velocity_dg(Q), p[None, :], k_start * self._dt, q_tracer=q_tracer
            )

        (geom_s, rt_s), (Q, p) = self.shard_ops_and_state((Q, p), self._rt)
        for k in progress(range(k_start, nt)):
            with PerformanceLog("timestep"):
                if q_tracer is not None:
                    q_tracer = tracer_step(
                        geom, q_tracer, self.velocity_dg(Q), self._dt,
                        cg_space=self.tracer_cg_space(),
                    )
                f_dofs = RT.rt_interpolate(self.disc, rt, f_rhs(k * self._dt))
                Q, p = self._step(geom_s, rt_s, Q, p, f_dofs)
                jax.block_until_ready(Q)
            if checkpoint_every and (k + 1) % checkpoint_every == 0:
                self.save_state(checkpoint_path, k + 1, Q, p, q_tracer)
            for callback in self.callbacks:
                callback(
                    self.velocity_dg(Q), p[None, :], (k + 1) * self._dt, q_tracer=q_tracer
                )

        return self.velocity_dg(Q), p[None, :]

    def velocity_dg(self, Q):
        """RT velocity as a DG1 nodal field (2, 3, nc) for outputs/errors."""
        return RT.rt_to_dg1(self.geom, self._rt, Q)
