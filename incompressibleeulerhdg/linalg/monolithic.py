"""Monolithic coupled (u, p, lambda) stage solve.

The reference solves the unsplit stage system with GMRES + MUMPS LU
(reference src/timesteppers/hdg_imex.py:600-620 and the monolithic
branches of hdg_implicit/dg_implicit).  A sparse direct factorisation is the
wrong tool on an accelerator; instead we run FGMRES on the coupled system with the
*projection method as preconditioner* — one approximate cycle of

    tentative solve   (M - c f_impl) dQ~ = r_u
    mixed-Poisson     rhs (-1/c) weak_div(psi, dQ~) + r_p rows, r_lam rows
    delta = (dQ~ + c du, dp, dlam)

per preconditioner application (the same cycle the reference's Richardson
iteration applies, hdg_imex.py:568-599, but wrapped in a flexible Krylov
method so it converges for any timestep size).  The constant-pressure
nullspace (0, 1, 1) is deflated exactly as in the split path.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import fields as F
from ..ops.forms import f_impl_apply, pressure_gradient_apply, gamma_apply, weak_divergence_apply
from .pressure import pressure_solve
from .tentative import tentative_solve
from .preconditioners import build_tentative_operator, tentative_operator_matvec
from .krylov import fgmres

__all__ = [
    "monolithic_stage_solve",
    "coupled_matvec",
    "build_monolithic_phases",
    "host_fgmres",
]


def coupled_matvec(geom, star, Q, p, lam, c, alpha=1.0, upwind=True, tau=1.0):
    """Apply the monolithic stage operator (reference a_implicit,
    hdg_imex.py:602-609):

    r_u   = M Q - c f_impl(Q, Q*) - c g(p, lam)
    (r_p, r_lam) = Gamma(Q, p, lam)
    """
    r_u = (
        F.mass_apply(geom, geom.m1, Q)
        - c * f_impl_apply(geom, star, Q, alpha, upwind)
        - c * pressure_gradient_apply(geom, p, lam)
    )
    r_p, r_lam = gamma_apply(geom, Q, p, lam, tau)
    return r_u, r_p, r_lam


def monolithic_stage_solve(
    geom,
    cs,
    star,
    b_u,
    c,
    *,
    alpha=1.0,
    upwind=True,
    rtol=1.0e-11,
    inner_rtol=1.0e-6,
    x0=None,
    precond=None,
    restart=20,
    maxiter=100,
):
    """Solve the coupled stage system with b on the u-rows and 0 on Gamma rows.

    :returns: (Q, p, lam, fgmres iters, fgmres iters)
    """
    dtype = b_u.dtype
    nc, d1 = geom.n_cells, geom.d1
    d0, nf, nt = geom.d0, geom.n_facets, cs.nt
    nu = nc * d1 * 2
    np_ = nc * d0

    def flat(u, p, lam):
        return jnp.concatenate([u.ravel(), p.ravel(), lam.ravel()])

    def unflat(v):
        u = v[:nu].reshape(2, d1, nc)
        p = v[nu : nu + np_].reshape(d0, nc)
        lam = v[nu + np_ :].reshape(nt, nf)
        return u, p, lam

    t_op = build_tentative_operator(geom, star, c, alpha, upwind)

    from ..ops.structured import dist_axis
    from .krylov import _pdot, _pnorm

    ax = dist_axis(geom)
    fval = getattr(geom, "fvalid", None)

    def matvec(v):
        u, p, lam = unflat(v)
        # u-rows via the assembled blocks (same operator, far cheaper than
        # re-deriving the weak form per Krylov iteration)
        r_u = tentative_operator_matvec(geom, t_op, u) - c * pressure_gradient_apply(
            geom, p, lam
        )
        r_p, r_lam = gamma_apply(geom, u, p, lam, cs.tau)
        if fval is not None:
            # slab-local layouts: gamma_apply's mu-rows treat the zero-masked
            # DUMMY facet slots as boundary facets and fill them with aliased
            # trace data — nonzero dummy components would corrupt every
            # psum'd Krylov dot (the cell rows are already protected by the
            # slot machinery's fvalid masks).  Keep the all-zeros dummy
            # invariant of parallel/slab.py on every operator output.
            r_lam = r_lam * fval
        if geom.cvalid is not None:
            r_u = r_u * geom.cvalid
            r_p = r_p * geom.cvalid
        return flat(r_u, r_p, r_lam)

    def M(v):
        r_u, r_p, r_lam = unflat(v)
        dQt, _, _ = tentative_solve(
            geom, star, r_u, c, alpha=alpha, upwind=upwind,
            rtol=inner_rtol, maxiter=60, op=t_op,
        )
        f_p = (-1.0 / c) * weak_divergence_apply(geom, dQt) + r_p
        du, dp, dlam, _, _ = pressure_solve(
            geom, cs, jnp.zeros_like(r_u), f_p, r_lam,
            rtol=inner_rtol, maxiter=60, precond=precond,
        )
        return flat(dQt + c * du, dp, dlam)

    # deflate the (0, 1_p, 1_lam) nullspace; norms/dots are GLOBAL reductions
    # when slab-distributed (the nullvec's cell/facet rows skip dummy slots)
    fval = getattr(geom, "fvalid", None)
    lam1 = (
        jnp.ones((nt, nf), dtype)
        if fval is None
        else jnp.broadcast_to(fval[None, :], (nt, nf)).astype(dtype)
    )
    p1 = jnp.ones((d0, nc), dtype)
    if geom.cvalid is not None:
        p1 = p1 * geom.cvalid
    nullv = flat(
        jnp.zeros((2, d1, nc), dtype),
        p1,
        lam1,
    )
    nullv = nullv / _pnorm(nullv, ax)

    def project(v):
        return v - nullv * _pdot(nullv, v, ax)

    b = flat(b_u, jnp.zeros((d0, nc), dtype), jnp.zeros((nt, nf), dtype))
    x0flat = None if x0 is None else flat(*x0)
    x, iters, _ = fgmres(
        matvec, b, M=M, x0=x0flat, rtol=rtol, restart=restart, maxiter=maxiter,
        project=project, axis_name=ax,
    )
    Q, p, lam = unflat(x)
    return Q, p, lam, iters, iters


# ---------------------------------------------------------------------------
#  host-composed monolithic solve (large meshes)
# ---------------------------------------------------------------------------
#
# Above the composite-step cell threshold (hdg_imex COMPOSITE_STEP_CELLS) the
# step runs as host-composed phases, so peak device memory is bounded by the
# largest phase; a whole-stage jitted FGMRES would instead put the Krylov
# bases AND every phase's workspace into one XLA buffer assignment.
# The reference has no such restriction — MUMPS LU factorises at any size
# (reference src/timesteppers/hdg_imex.py:613-618) — so the monolithic
# path must compose the same way the projection step does: jitted PHASES
# (matvec, preconditioner cycle, basis updates) driven by a host loop, with
# the Givens scalar recurrences in numpy.  Peak device memory = the bases
# (2m+2 vectors) + one preconditioner application.


def _flat3(u, p, lam):
    return jnp.concatenate([u.ravel(), p.ravel(), lam.ravel()])


def _unflat3(geom, nt, v):
    nc, d1, d0, nf = geom.n_cells, geom.d1, geom.d0, geom.n_facets
    nu = nc * d1 * 2
    np_ = nc * d0
    return (
        v[:nu].reshape(2, d1, nc),
        v[nu : nu + np_].reshape(d0, nc),
        v[nu + np_ :].reshape(nt, nf),
    )


def _nullproj(geom, nt, v):
    """Project out the (0, 1_p, 1_lam) constant-pressure nullspace."""
    nc, d1, d0, nf = geom.n_cells, geom.d1, geom.d0, geom.n_facets
    nullv = _flat3(
        jnp.zeros((2, d1, nc), v.dtype),
        jnp.ones((d0, nc), v.dtype),
        jnp.ones((nt, nf), v.dtype),
    )
    nullv = nullv / jnp.linalg.norm(nullv)
    return v - nullv * jnp.dot(nullv, v)


def build_monolithic_phases(alpha, upwind, tau, inner_rtol=1.0e-6):
    """Jitted phases for the host-composed coupled (u, p, lambda) solve.

    Returns (mono_matvec, mono_precond, mono_rhs) — each takes the operator
    pytrees as ARGUMENTS (not closures) so the tables stay device buffers.
    Build ONCE per step function (jit caches by callable identity).
    """

    @jax.jit
    def mono_rhs(geom, cs, b_u, x0_Q, x0_p, x0_lam):
        return (
            _nullproj(
                geom,
                cs.nt,
                _flat3(
                    b_u,
                    jnp.zeros((geom.d0, geom.n_cells), b_u.dtype),
                    jnp.zeros((cs.nt, geom.n_facets), b_u.dtype),
                ),
            ),
            _flat3(x0_Q, x0_p, x0_lam),
        )

    @jax.jit
    def mono_matvec(geom, cs, t_op, c, v):
        u, p, lam = _unflat3(geom, cs.nt, v)
        r_u = tentative_operator_matvec(geom, t_op, u) - c * pressure_gradient_apply(
            geom, p, lam
        )
        r_p, r_lam = gamma_apply(geom, u, p, lam, tau)
        return _nullproj(geom, cs.nt, _flat3(r_u, r_p, r_lam))

    @jax.jit
    def mono_precond(geom, cs, pc, star, t_op, c, v):
        from ..linalg.gtmg import gtmg_apply

        r_u, r_p, r_lam = _unflat3(geom, cs.nt, v)
        dQt, _, _ = tentative_solve(
            geom, star, r_u, c, alpha=alpha, upwind=upwind,
            rtol=inner_rtol, maxiter=60, op=t_op,
        )
        f_p = (-1.0 / c) * weak_divergence_apply(geom, dQt) + r_p
        du, dp, dlam, _, _ = pressure_solve(
            geom, cs, jnp.zeros_like(r_u), f_p, r_lam,
            rtol=inner_rtol, maxiter=60,
            precond=lambda w: gtmg_apply(geom, cs, pc, w),
        )
        return _flat3(dQt + c * du, dp, dlam)

    return mono_matvec, mono_precond, mono_rhs


@partial(jax.jit, donate_argnums=(0,))
def _arnoldi_update(V, w, j):
    """Orthogonalise w against V[:j+1] and store the new basis vector at
    j+1 IN PLACE (donated buffer — no (m+1, n) copy per iteration).
    Returns (V, h (m+1,), hnext)."""
    dtype = V.dtype
    tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)
    mask = (jnp.arange(V.shape[0]) <= j).astype(dtype)
    h = (V @ w) * mask
    w = w - V.T @ h
    hnext = jnp.linalg.norm(w)
    V = jax.lax.dynamic_update_index_in_dim(
        V, w / jnp.maximum(hnext, tiny), j + 1, 0
    )
    return V, h, hnext


@partial(jax.jit, donate_argnums=(0,))
def _store_row(Z, z, j):
    return jax.lax.dynamic_update_index_in_dim(Z, z, j, 0)


@jax.jit
def _combine(x, Z, y):
    return x + Z.T @ y


def host_fgmres(matvec, M, b, x0, *, rtol, restart=20, maxiter=100):
    """Host-driven flexible GMRES: device math through jitted callables,
    scalar Givens recurrences in numpy.

    Same algorithm as :func:`krylov.fgmres` (true-residual convergence,
    stored Z directions, 0.95-stagnation guard per restart cycle) but the
    loop lives on the host so device memory never holds more than the bases
    plus one preconditioner application — the large-mesh analogue of the
    projection path's composite step.

    :returns: (x, iters, relres)
    """
    n = b.shape[0]
    m = restart
    dtype = b.dtype
    bnorm = float(jnp.linalg.norm(b))
    target = max(rtol * bnorm, 0.0)
    x = x0
    iters = 0
    res_prev = np.inf
    relres = np.inf
    while True:
        r = b - matvec(x)
        beta = float(jnp.linalg.norm(r))
        if beta <= target or iters >= maxiter:
            relres = beta / max(bnorm, 1e-300)
            break
        V = jnp.zeros((m + 1, n), dtype)
        V = _store_row(V, r / max(beta, 1e-300), jnp.int32(0))
        Z = jnp.zeros((m, n), dtype)
        H = np.zeros((m + 1, m))
        cs_ = np.zeros(m)
        sn_ = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        j_end = 0
        res = beta
        for j in range(m):
            z = M(V[j])
            Z = _store_row(Z, z, jnp.int32(j))
            w = matvec(z)
            V, h_dev, hnext = _arnoldi_update(V, w, jnp.int32(j))
            # np.asarray of a CPU jax array is a READ-ONLY zero-copy view
            h = np.array(h_dev, dtype=np.float64)
            h[j + 1] = float(hnext)
            for i in range(j):
                hi = cs_[i] * h[i] + sn_[i] * h[i + 1]
                h[i + 1] = -sn_[i] * h[i] + cs_[i] * h[i + 1]
                h[i] = hi
            denom = np.hypot(h[j], h[j + 1])
            cs_[j] = h[j] / denom if denom > 0 else 1.0
            sn_[j] = h[j + 1] / denom if denom > 0 else 0.0
            h[j] = denom
            h[j + 1] = 0.0
            H[: m + 1, j] = h[: m + 1]
            g[j + 1] = -sn_[j] * g[j]
            g[j] = cs_[j] * g[j]
            j_end = j + 1
            res = abs(g[j + 1])
            if not np.isfinite(res) or res <= target or iters + j_end >= maxiter:
                break
        y = np.zeros(m)
        k = j_end
        if k > 0 and np.all(np.isfinite(g[:k])):
            y[:k] = np.linalg.solve(H[:k, :k], g[:k])
        x = _combine(x, Z, jnp.asarray(y, dtype))
        iters += j_end
        relres = res / max(bnorm, 1e-300)
        # stagnation guard across cycles (matches krylov.fgmres)
        if not (res < 0.95 * res_prev) or j_end == 0:
            r = b - matvec(x)
            relres = float(jnp.linalg.norm(r)) / max(bnorm, 1e-300)
            break
        res_prev = res
    return x, iters, relres
