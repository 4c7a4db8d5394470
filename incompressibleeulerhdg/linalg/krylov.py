"""Matrix-free Krylov solvers with iteration-count observables.

Replacement for the PETSc KSP layer of the reference (GMRES on the
condensed trace system, hdg_imex.py:135-137; GMRES+ILU tentative velocity
solves, hdg_imex.py:224-228; iteration counts harvested at
hdg_imex.py:265-271,281).  Everything is jittable: ``lax.while_loop`` drives
the iteration, shapes are static, and the iteration count is returned as an
array output so the caller can feed the reference's ``Averager`` analogue.

Vectors are flat 1-D arrays; callers flatten/unflatten their field layouts.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["gmres", "gmres_right", "fgmres", "cg", "deflate_constant"]


def _pdot(a, b, axis_name):
    """Inner product, psum-reduced over a shard_map axis when given.

    Vectors inside the slab-decomposed distributed solve are the LOCAL
    shards; every Krylov inner product must be a global reduction
    (the ``assemble(p*dx)``/VecDot analogue of the reference's PETSc-MPI
    layer, SURVEY.md section 5.8).
    """
    d = jnp.dot(a, b)
    return lax.psum(d, axis_name) if axis_name is not None else d


def _pnorm(a, axis_name):
    if axis_name is None:
        return jnp.linalg.norm(a)
    return jnp.sqrt(lax.psum(jnp.dot(a, a), axis_name))


def deflate_constant(nullvec, axis_name=None):
    """Return a projector v -> v - (nullvec . v) nullvec for a unit nullvec
    (unit in the GLOBAL norm when distributed)."""

    def proj(v):
        return v - nullvec * _pdot(nullvec, v, axis_name)

    return proj


def _identity(v):
    return v


# rows per chunk of the chunked-conditional Gram-Schmidt products below; 8
# keeps the lax.cond count small while skipping ~2/3 of the basis traffic at
# the observed iteration counts
_GS_CHUNK = 8


def _masked_basis_dot(V, w, j, mask, axis_name):
    """h = (V @ w) * mask without streaming INACTIVE basis rows.

    The masked dense product reads all (m+1, n) rows of V every Arnoldi
    step although only rows 0..j are live — at 512^2 k=2 that is ~1.2 GB
    per read at restart 28 versus an average ~9 live rows.  Chunks of
    ``_GS_CHUNK`` rows are computed under ``lax.cond`` (a real branch
    inside the while_loop, unlike ``where`` which executes both sides), so
    chunks beyond j are skipped entirely; their h entries are the exact
    zeros the mask would have produced (V rows > j+1 are zero-initialised
    and never read).
    """
    m1 = V.shape[0]
    dtype = V.dtype
    parts = []
    for lo in range(0, m1, _GS_CHUNK):
        hi = min(lo + _GS_CHUNK, m1)
        Vc = V[lo:hi]
        parts.append(
            lax.cond(
                j >= lo,
                lambda Vc=Vc: Vc @ w,
                lambda hi=hi, lo=lo: jnp.zeros((hi - lo,), dtype),
            )
        )
    h = jnp.concatenate(parts)
    if axis_name is not None:
        h = lax.psum(h, axis_name)
    return h * mask


def _masked_basis_axpy(V, h, j, w):
    """w - V.T @ h, skipping chunks whose h entries are (exact) zeros."""
    m1 = V.shape[0]
    acc = w
    for lo in range(0, m1, _GS_CHUNK):
        hi = min(lo + _GS_CHUNK, m1)
        Vc = V[lo:hi]
        acc = lax.cond(
            j >= lo,
            lambda acc=acc, Vc=Vc, lo=lo, hi=hi: acc - Vc.T @ h[lo:hi],
            lambda acc=acc: acc,
        )
    return acc


def gmres(
    matvec,
    b,
    *,
    M=None,
    x0=None,
    rtol=1e-12,
    atol=0.0,
    restart=30,
    maxiter=200,
    project=None,
    axis_name=None,
):
    """Left-preconditioned restarted GMRES.

    Solves ``M A x = M b``; convergence is declared when the preconditioned
    residual norm drops below ``max(rtol * ||M b||, atol)`` (PETSc's default
    convergence test for left preconditioning, matching the reference's
    iteration-count observables).

    :arg project: optional projector applied to b and to every operator
        output — used for nullspace deflation of singular systems (the
        analogue of the PETSc nullspace handling at
        hdg_imex.py:480-489).
    :returns: (x, iters, relres)
    """
    M = M or _identity
    project = project or _identity
    n = b.shape[0]
    m = restart
    dtype = b.dtype

    b = project(b)
    Mb = M(b)
    target = jnp.maximum(rtol * _pnorm(Mb, axis_name), atol).astype(dtype)
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def op(v):
        return M(project(matvec(v)))

    tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)

    def cycle(x):
        """One GMRES(m) cycle; returns (x_new, res_norm, inner_iters)."""
        r = M(project(b - matvec(x)))
        beta = _pnorm(r, axis_name)
        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(r / jnp.maximum(beta, tiny))
        R = jnp.zeros((m, m), dtype)  # triangularised Hessenberg columns
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def arnoldi_step(state):
            V, R, cs, sn, g, j, res = state
            w = op(V[j])
            # modified Gram-Schmidt as masked dense products (the V @ w
            # basis dots are global reductions when distributed)
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h = _masked_basis_dot(V, w, j, mask, axis_name)
            w = _masked_basis_axpy(V, h, j, w)
            hnext = _pnorm(w, axis_name)
            V = V.at[j + 1].set(w / jnp.maximum(hnext, tiny))
            h = h.at[j + 1].set(hnext)

            # apply stored Givens rotations 0..j-1
            def rot(i, h):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                use = i < j
                h = h.at[i].set(jnp.where(use, hi, h[i]))
                return h.at[i + 1].set(jnp.where(use, hi1, h[i + 1]))

            h = lax.fori_loop(0, m, rot, h)

            # new rotation annihilating h[j+1]
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c_new = jnp.where(denom > tiny, h[j] / jnp.maximum(denom, tiny), 1.0)
            s_new = jnp.where(denom > tiny, h[j + 1] / jnp.maximum(denom, tiny), 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            h = h.at[j].set(denom).at[j + 1].set(0.0)
            R = R.at[:, j].set(h[:m])
            g = g.at[j + 1].set(-s_new * g[j])
            g = g.at[j].set(c_new * g[j])
            res = jnp.abs(g[j + 1])
            return V, R, cs, sn, g, j + 1, res

        def arnoldi_cond(state):
            *_, j, res = state
            return jnp.logical_and(j < m, res > target)

        init = (V, R, cs, sn, g, jnp.int32(0), beta)
        V, R, cs, sn, g, j_end, res = lax.while_loop(arnoldi_cond, arnoldi_step, init)

        # solve the (masked) triangular system R[:j_end,:j_end] y = g[:j_end]
        active = jnp.arange(m) < j_end
        Rm = jnp.where(
            jnp.logical_and(active[None, :], active[:, None]),
            R,
            jnp.eye(m, dtype=dtype),
        )
        gm = jnp.where(active, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        x_new = x + V[:m].T @ y
        return x_new, res, j_end

    def outer_step(state):
        x, res_prev, iters, _ = state
        x, res, j = cycle(x)
        # stagnation guard: a full restart cycle that barely reduced the
        # residual (common at the float32 attainable-accuracy floor) ends the
        # iteration instead of burning maxiter
        go = jnp.logical_and(j > 0, res < 0.95 * res_prev)
        return x, res, iters + j, go.astype(jnp.int32)

    def outer_cond(state):
        _, res, iters, go = state
        return jnp.logical_and(res > target, jnp.logical_and(iters < maxiter, go > 0))

    x, res, iters, _ = lax.while_loop(
        outer_cond,
        outer_step,
        (x0, jnp.asarray(jnp.inf, dtype), jnp.int32(0), jnp.int32(1)),
    )
    relres = res / jnp.maximum(_pnorm(Mb, axis_name), tiny)
    return x, iters, relres


def gmres_right(
    opM,
    matvec,
    b,
    *,
    x0=None,
    rtol=1e-12,
    atol=0.0,
    restart=30,
    maxiter=200,
    axis_name=None,
):
    """Right-preconditioned FLEXIBLE GMRES with a FUSED preconditioner+operator.

    ``opM(v) -> (M v, A M v)`` supplies both the preconditioned direction and
    its operator image in one application — built for the colored-Schwarz
    sweep whose incremental residuals yield ``A z`` as a by-product
    (preconditioners.py:_colored_apply_fused_bl), replacing the
    (sweep + matvec) pair of the left-preconditioned loop with a single
    sweep per Arnoldi step.  ``matvec`` (plain ``A``) is used once per
    restart cycle for the exact starting residual, so incremental-residual
    rounding cannot accumulate across cycles.

    The preconditioned directions ``z_j = M v_j`` are STORED (flexible-GMRES
    style) and the solution reconstructed as ``x = x0 + Z y``.  An earlier
    version re-applied M once at the end instead ("M is a fixed linear
    operator") — that assumption fails in float32 at scale: the fused
    sweep's incremental-residual rounding makes successive M applications
    inconsistent by O(eps * cond) (measured: 5.7e-3 at 256^2 k=2 f32,
    ~4x per mesh doubling), and a right-preconditioned reconstruction
    through an inconsistent M floors the attainable residual at that level
    — the 512^2 f32 NaN regression of round 3 (VERDICT).  Storing Z makes
    the reconstruction exact for whatever directions were actually used, so
    sweep drift can only cost iterations, never correctness.

    Solves ``A (M y) = b`` with ``x = M y``; convergence on the TRUE
    residual ``||b - A x|| <= max(rtol ||b||, atol)`` (the standard
    right-preconditioned test; the left-preconditioned :func:`gmres` tests
    ``||M r||`` instead, so iteration counts differ slightly).  The returned
    relres is RECOMPUTED from an exact final residual (one extra matvec) —
    never the Givens estimate, which drifts from the truth in f32.

    :returns: (x, iters, relres)
    """
    n = b.shape[0]
    m = restart
    dtype = b.dtype
    bnorm = _pnorm(b, axis_name)
    target = jnp.maximum(rtol * bnorm, atol).astype(dtype)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)

    def cycle(x):
        r = b - matvec(x)
        beta = _pnorm(r, axis_name)
        V = jnp.zeros((m + 1, n), dtype).at[0].set(r / jnp.maximum(beta, tiny))
        Zb = jnp.zeros((m, n), dtype)
        R = jnp.zeros((m, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def step(state):
            V, Zb, R, cs, sn, g, j, res = state
            z, w = opM(V[j])
            Zb = Zb.at[j].set(z)
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h = _masked_basis_dot(V, w, j, mask, axis_name)
            w = _masked_basis_axpy(V, h, j, w)
            hnext = _pnorm(w, axis_name)
            V = V.at[j + 1].set(w / jnp.maximum(hnext, tiny))
            h = h.at[j + 1].set(hnext)

            def rot(i, h):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                use = i < j
                h = h.at[i].set(jnp.where(use, hi, h[i]))
                return h.at[i + 1].set(jnp.where(use, hi1, h[i + 1]))

            h = lax.fori_loop(0, m, rot, h)
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c_new = jnp.where(denom > tiny, h[j] / jnp.maximum(denom, tiny), 1.0)
            s_new = jnp.where(denom > tiny, h[j + 1] / jnp.maximum(denom, tiny), 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            h = h.at[j].set(denom).at[j + 1].set(0.0)
            R = R.at[:, j].set(h[:m])
            g = g.at[j + 1].set(-s_new * g[j])
            g = g.at[j].set(c_new * g[j])
            return V, Zb, R, cs, sn, g, j + 1, jnp.abs(g[j + 1])

        def cond(state):
            *_, j, res = state
            # a non-finite Givens residual (overflow/NaN inside the Arnoldi
            # body) must STOP the iteration, not satisfy it: NaN > target is
            # False, which would exit the loop and reconstruct a garbage x.
            # Guarding here keeps j_end at the last finite step so the
            # masked triangular solve below uses only healthy columns.
            return jnp.logical_and(
                jnp.logical_and(j < m, res > target), jnp.isfinite(res)
            )

        init = (V, Zb, R, cs, sn, g, jnp.int32(0), beta)
        V, Zb, R, cs, sn, g, j_end, res = lax.while_loop(cond, step, init)
        # drop a trailing non-finite column: its rotation already poisoned g
        n_ok = jnp.where(jnp.isfinite(res), j_end, jnp.maximum(j_end - 1, 0))
        active = jnp.arange(m) < n_ok
        Rm = jnp.where(
            jnp.logical_and(active[None, :], active[:, None]),
            R,
            jnp.eye(m, dtype=dtype),
        )
        gm = jnp.where(active, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        # flexible reconstruction from the STORED directions (see docstring)
        x_new = x + Zb.T @ y
        # belt and braces: never return a non-finite iterate — fall back to
        # the cycle's starting point (the caller's stagnation guard then
        # terminates, and the exact relres below reports the truth)
        ok = jnp.isfinite(x_new).all()
        return jnp.where(ok, x_new, x), jnp.where(ok, res, jnp.inf), j_end

    def outer_step(state):
        x, res_prev, iters, _ = state
        x, res, j = cycle(x)
        go = jnp.logical_and(j > 0, res < 0.95 * res_prev)
        return x, res, iters + j, go.astype(jnp.int32)

    def outer_cond(state):
        _, res, iters, go = state
        return jnp.logical_and(res > target, jnp.logical_and(iters < maxiter, go > 0))

    x, res, iters, _ = lax.while_loop(
        outer_cond,
        outer_step,
        (x0, jnp.asarray(jnp.inf, dtype), jnp.int32(0), jnp.int32(1)),
    )
    relres = _pnorm(b - matvec(x), axis_name) / jnp.maximum(bnorm, tiny)
    return x, iters, relres


def fgmres(
    matvec,
    b,
    *,
    M=None,
    x0=None,
    rtol=1e-12,
    atol=0.0,
    restart=30,
    maxiter=200,
    project=None,
    axis_name=None,
):
    """Flexible (right-preconditioned) restarted GMRES.

    The preconditioner may itself be an inner iteration (e.g. a projection
    cycle with nested Krylov solves) — FGMRES stores the preconditioned
    directions Z so a nonstationary M is admissible.  Convergence is on the
    TRUE residual norm: ||b - A x|| <= max(rtol ||b||, atol).

    Used for the monolithic coupled solves where the reference uses direct
    LU/MUMPS (hdg_imex.py:613-618, dg_implicit.py:77-82,
    conforming_implicit.py:96-125).
    :returns: (x, iters, relres)
    """
    M = M or _identity
    project = project or _identity
    n = b.shape[0]
    m = restart
    dtype = b.dtype
    b = project(b)
    bnorm = _pnorm(b, axis_name)
    target = jnp.maximum(rtol * bnorm, atol).astype(dtype)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)

    def cycle(x):
        r = project(b - matvec(x))
        beta = _pnorm(r, axis_name)
        V = jnp.zeros((m + 1, n), dtype).at[0].set(r / jnp.maximum(beta, tiny))
        Zb = jnp.zeros((m, n), dtype)
        R = jnp.zeros((m, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def step(state):
            V, Zb, R, cs, sn, g, j, res = state
            z = M(V[j])
            w = project(matvec(z))
            Zb = Zb.at[j].set(z)
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h = _masked_basis_dot(V, w, j, mask, axis_name)
            w = _masked_basis_axpy(V, h, j, w)
            hnext = _pnorm(w, axis_name)
            V = V.at[j + 1].set(w / jnp.maximum(hnext, tiny))
            h = h.at[j + 1].set(hnext)

            def rot(i, h):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                use = i < j
                h = h.at[i].set(jnp.where(use, hi, h[i]))
                return h.at[i + 1].set(jnp.where(use, hi1, h[i + 1]))

            h = lax.fori_loop(0, m, rot, h)
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c_new = jnp.where(denom > tiny, h[j] / jnp.maximum(denom, tiny), 1.0)
            s_new = jnp.where(denom > tiny, h[j + 1] / jnp.maximum(denom, tiny), 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            h = h.at[j].set(denom).at[j + 1].set(0.0)
            R = R.at[:, j].set(h[:m])
            g = g.at[j + 1].set(-s_new * g[j])
            g = g.at[j].set(c_new * g[j])
            return V, Zb, R, cs, sn, g, j + 1, jnp.abs(g[j + 1])

        def cond(state):
            *_, j, res = state
            return jnp.logical_and(j < m, res > target)

        init = (V, Zb, R, cs, sn, g, jnp.int32(0), beta)
        V, Zb, R, cs, sn, g, j_end, res = lax.while_loop(cond, step, init)
        active = jnp.arange(m) < j_end
        Rm = jnp.where(
            jnp.logical_and(active[None, :], active[:, None]), R, jnp.eye(m, dtype=dtype)
        )
        gm = jnp.where(active, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        return x + Zb.T @ y, res, j_end

    def outer_step(state):
        x, res_prev, iters, _ = state
        x, res, j = cycle(x)
        go = jnp.logical_and(j > 0, res < 0.95 * res_prev)
        return x, res, iters + j, go.astype(jnp.int32)

    def outer_cond(state):
        _, res, iters, go = state
        return jnp.logical_and(res > target, jnp.logical_and(iters < maxiter, go > 0))

    x, res, iters, _ = lax.while_loop(
        outer_cond,
        outer_step,
        (x0, jnp.asarray(jnp.inf, dtype), jnp.int32(0), jnp.int32(1)),
    )
    return x, iters, res / jnp.maximum(bnorm, tiny)


def cg(matvec, b, *, M=None, x0=None, rtol=1e-12, atol=0.0, maxiter=500, project=None, axis_name=None):
    """Preconditioned conjugate gradients with iteration count.

    Convergence on the unpreconditioned residual 2-norm.
    :returns: (x, iters, relres)
    """
    M = M or _identity
    project = project or _identity
    b = project(b)
    bnorm = _pnorm(b, axis_name)
    target = jnp.maximum(rtol * bnorm, atol)
    x0 = jnp.zeros_like(b) if x0 is None else x0

    r = project(b - matvec(x0))
    z = project(M(r))
    p = z
    rz = _pdot(r, z, axis_name)

    def body(state):
        x, r, z, p, rz, it, _ = state
        Ap = project(matvec(p))
        alpha = rz / _pdot(p, Ap, axis_name)
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(M(r))
        rz_new = _pdot(r, z, axis_name)
        beta = rz_new / rz
        p = z + beta * p
        return x, r, z, p, rz_new, it + 1, _pnorm(r, axis_name)

    def cond(state):
        *_, it, res = state
        return jnp.logical_and(res > target, it < maxiter)

    state = (x0, r, z, p, rz, jnp.int32(0), _pnorm(r, axis_name))
    x, r, *_, iters, res = lax.while_loop(cond, body, state)
    return x, iters, res / jnp.maximum(bnorm, 1e-300)
