"""Unit tests for the Krylov solvers, small-matrix inverses, and IMEX tableaus."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from incompressibleeulerhdg.linalg.krylov import gmres, fgmres, cg, deflate_constant
from incompressibleeulerhdg.linalg.smallinv import inv_bl
from incompressibleeulerhdg.timesteppers.tableaus import (
    TABLEAUS,
    unroll_residual_coefficients,
)


def random_spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return jnp.asarray(A @ A.T + n * np.eye(n))


def test_cg_solves_spd():
    A = random_spd(40)
    x_true = jnp.asarray(np.random.default_rng(1).standard_normal(40))
    b = A @ x_true
    x, iters, relres = cg(lambda v: A @ v, b, rtol=1e-12)
    assert float(jnp.abs(x - x_true).max()) < 1e-8
    assert 0 < int(iters) <= 40


@pytest.mark.parametrize("solver", [gmres, fgmres], ids=["gmres", "fgmres"])
def test_gmres_solves_nonsymmetric(solver):
    rng = np.random.default_rng(2)
    A = jnp.asarray(rng.standard_normal((50, 50)) + 8 * np.eye(50))
    x_true = jnp.asarray(rng.standard_normal(50))
    b = A @ x_true
    x, iters, relres = solver(lambda v: A @ v, b, rtol=1e-12, restart=20, maxiter=200)
    assert float(jnp.abs(x - x_true).max()) < 1e-8


def test_gmres_preconditioned_converges_faster():
    A = random_spd(60, seed=3)
    Ainv_diag = 1.0 / jnp.diag(A)
    b = jnp.asarray(np.random.default_rng(4).standard_normal(60))
    _, it_plain, _ = gmres(lambda v: A @ v, b, rtol=1e-10, maxiter=300)
    _, it_pc, _ = gmres(
        lambda v: A @ v, b, M=lambda v: Ainv_diag * v, rtol=1e-10, maxiter=300
    )
    assert int(it_pc) <= int(it_plain)


def test_gmres_deflation_singular_system():
    """Solve a singular consistent system (A = SPD + rank deficiency) with
    constant nullspace deflation (the pressure-system pattern)."""
    n = 30
    A = np.asarray(random_spd(n, seed=5))
    # make constants a nullspace: A <- P A P with P = I - ones ones^T / n
    P = np.eye(n) - np.ones((n, n)) / n
    A = jnp.asarray(P @ A @ P)
    nullvec = jnp.ones(n) / np.sqrt(n)
    x_true = jnp.asarray(np.random.default_rng(6).standard_normal(n))
    x_true = x_true - nullvec * jnp.dot(nullvec, x_true)
    b = A @ x_true
    project = deflate_constant(nullvec)
    x, iters, _ = gmres(lambda v: A @ v, b, rtol=1e-12, project=project)
    x = x - nullvec * jnp.dot(nullvec, x)
    assert float(jnp.abs(x - x_true).max()) < 1e-8


def test_fgmres_with_nonlinear_preconditioner():
    """FGMRES tolerates an iteration-dependent preconditioner."""
    A = random_spd(40, seed=7)
    b = jnp.asarray(np.random.default_rng(8).standard_normal(40))
    state = {"k": 0}

    def M(v):
        # deliberately nonstationary
        state["k"] += 1
        return v / (jnp.diag(A) * (1.0 + 0.01 * (state["k"] % 3)))

    x, iters, relres = fgmres(lambda v: A @ v, b, M=M, rtol=1e-10)
    assert float(jnp.linalg.norm(A @ x - b) / jnp.linalg.norm(b)) < 1e-9


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [8, 20, 30])
def test_batched_inverse_matches_numpy(dtype, n):
    """The batch-last block inverse matches numpy.linalg.inv on diagonally
    dominant blocks (the preconditioner blocks' class) at the block sizes
    of degrees k=1..3 (n = 2 * d1(k+1): 12, 20, 30)."""
    rng = np.random.default_rng(n)
    m = 37
    A = rng.standard_normal((m, n, n)) * 0.3 + 2.0 * n ** 0.5 * np.eye(n)
    ref = np.linalg.inv(A).transpose(1, 2, 0)  # batch-last
    got = np.asarray(inv_bl(jnp.asarray(A.transpose(1, 2, 0), dtype)))
    assert got.dtype == dtype and got.shape == (n, n, m)
    # f32 round-off grows ~n * cond (cond < 2 for these blocks)
    tol = 1e-13 if dtype == np.float64 else 50 * n * np.finfo(np.float32).eps
    assert np.abs(got - ref).max() < tol * np.abs(ref).max()


# ---------------------------------------------------------------------------
# IMEX tableaus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TABLEAUS))
def test_tableau_consistency(name):
    """Row sums of a_expl equal c_expl (consistency); b sums to 1 for the
    non-trivial schemes."""
    tab = TABLEAUS[name]
    if name != "imex_ssp2_332":
        # the reference's SSP2(3,3,2) has c_expl = [0, 1, 1/2] while its
        # a_expl row sums are [0, 1/2, 1] (hdg_imex.py:921-949) — replicated
        # faithfully, so exclude it from the row-sum consistency check
        assert np.allclose(tab.a_expl.sum(axis=1), tab.c_expl, atol=1e-12)
    assert abs(tab.b_expl.sum() - 1.0) < 1e-12
    assert abs(tab.b_impl.sum() - 1.0) < 1e-12
    # lower-triangular explicit part; implicit diagonal non-negative
    assert np.allclose(np.triu(tab.a_expl), 0.0)


def test_ars3_b_impl_corrected():
    """The rebuild uses the standard ARS3(4,4,3) final weights, not the
    reference's length-6 typo (hdg_imex.py:874; SURVEY.md C7)."""
    tab = TABLEAUS["imex_ars3_443"]
    assert tab.b_impl.shape == (5,)
    assert np.allclose(tab.b_impl, [0, 1.5, -1.5, 0.5, 0.5])


@pytest.mark.parametrize("name", list(TABLEAUS))
def test_unrolled_residuals_match_recursion(name):
    """The compile-time unrolled coefficients reproduce the reference's
    recursive residual definition (hdg_imex.py:367-413) on scalar data."""
    tab = TABLEAUS[name]
    s = tab.nstages
    rng = np.random.default_rng(10)
    Q = rng.standard_normal(s)  # scalar stand-ins for (Q_j, w) inner products
    bfield = rng.standard_normal(s)  # stand-ins for (b_j, w)
    dt = 0.37

    def residual(i):
        r = Q[0]
        for j in range(1, i):
            if tab.a_impl[i, j] != 0:
                r += tab.a_impl[i, j] / tab.a_impl[j, j] * (Q[j] - residual(j))
        for j in range(i):
            if tab.a_expl[i, j] != 0:
                r += dt * tab.a_expl[i, j] * bfield[j]
        return r

    def final_residual():
        r = Q[0]
        for i in range(1, s):
            if tab.b_impl[i] != 0:
                r += tab.b_impl[i] / tab.a_impl[i, i] * (Q[i] - residual(i))
        for i in range(s):
            if tab.b_expl[i] != 0:
                r += dt * tab.b_expl[i] * bfield[i]
        return r

    alpha, beta, alpha_f, beta_f = unroll_residual_coefficients(tab)
    for i in range(1, s):
        unrolled = alpha[i] @ Q + dt * beta[i] @ bfield
        assert abs(unrolled - residual(i)) < 1e-12, (name, i)
    assert abs(alpha_f @ Q + dt * beta_f @ bfield - final_residual()) < 1e-12
