"""Tests of static condensation + the deflated trace GMRES pressure solve.

Cross-validates two independent implementations of the mixed-Poisson HDG
operator: the batched element blocks (linalg/condense.py) against the
matrix-free weak-form kernels (ops/forms.py), then checks the full solver on
a manufactured Neumann-Poisson problem (SURVEY.md section 4c).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from incompressibleeulerhdg.mesh.generators import unit_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.ops import fields as F
from incompressibleeulerhdg.ops import forms
from incompressibleeulerhdg.linalg.condense import (
    build_condensed_system,
    trace_matvec,
    condense_rhs,
    back_substitute,
)
from incompressibleeulerhdg.linalg.pressure import pressure_solve


def mixed_matvec(disc, Q, p, lam):
    """Matrix-free application of (w,u) - g(w,p,lam) + Gamma via ops kernels."""
    g = disc.geom
    r_u = F.mass_apply(g, g.m1, Q) - forms.pressure_gradient_apply(g, p, lam)
    r_p, r_lam = forms.gamma_apply(g, Q, p, lam, tau=1.0)
    return r_u, r_p, r_lam


def random_state(disc, seed=0):
    rng = np.random.default_rng(seed)
    g = disc.geom
    Q = jnp.asarray(rng.standard_normal((2, g.d1, g.n_cells)))
    p = jnp.asarray(rng.standard_normal((g.d0, g.n_cells)))
    lam = jnp.asarray(rng.standard_normal((g.nt, g.n_facets)))
    return Q, p, lam


@pytest.mark.parametrize("k", [0, 1, 2])
def test_element_blocks_match_matrix_free(k):
    """Schur solve of the condensed system reproduces the full mixed solve.

    Strategy: pick a random exact state x = (Q, p, lam), form b = A x with the
    matrix-free kernels, then run condense -> (direct per-facet solve is not
    available) -> instead verify the identity
        S lam + (C A^{-1}) f_loc... via residuals:
    condense_rhs(b) - trace_matvec(lam_exact) must vanish, and
    back_substitute(b, lam_exact) must reproduce (Q, p).
    """
    disc = HDGDiscretisation(unit_square_mesh(3), k)
    g = disc.geom
    cs = build_condensed_system(disc, tau=1.0)
    Q, p, lam = random_state(disc)
    b_u, b_p, b_lam = mixed_matvec(disc, Q, p, lam)

    # Schur identity: S lam = condensed rhs
    rhs = condense_rhs(g, cs, b_u, b_p, b_lam)
    lhs = trace_matvec(g, cs, lam)
    assert float(jnp.abs(lhs - rhs).max()) < 1e-10

    # local recovery
    Q2, p2 = back_substitute(g, cs, b_u, b_p, lam)
    assert float(jnp.abs(Q2 - Q).max()) < 1e-10
    assert float(jnp.abs(p2 - p).max()) < 1e-10


def test_trace_nullspace():
    """S annihilates the constant trace vector (nullspace (0, 1, 1),
    hdg_imex.py:480-489)."""
    disc = HDGDiscretisation(unit_square_mesh(3), 1)
    g = disc.geom
    cs = build_condensed_system(disc)
    ones = jnp.ones((g.nt, g.n_facets))
    y = trace_matvec(g, cs, ones)
    assert float(jnp.abs(y).max()) < 1e-11
    # and the corresponding local solution for lam = 1 is (u, p) = (0, 1)
    zero_u = jnp.zeros((2, g.d1, g.n_cells))
    zero_p = jnp.zeros((g.d0, g.n_cells))
    # back-substitution with f = 0: x = -A^{-1} B lam; for lam = 1 the
    # nullspace vector gives x = (0, 1)
    u, p = back_substitute(g, cs, zero_u, zero_p, ones)
    assert float(jnp.abs(u).max()) < 1e-11
    assert float(jnp.abs(p - 1.0).max()) < 1e-11


@pytest.mark.parametrize("k", [1, 2])
def test_pressure_solve_manufactured_neumann_poisson(k):
    """Solve u + grad p = 0, div u = G with G = 2 pi^2 cos(pi x) cos(pi y);
    exact p = cos(pi x) cos(pi y) (zero-mean, homogeneous Neumann).
    Checks discretisation error decreases at the expected rate."""
    errs = []
    for nx in (4, 8):
        disc = HDGDiscretisation(unit_square_mesh(nx), k)
        g = disc.geom
        cs = build_condensed_system(disc)
        pi = jnp.pi
        Gq = 2 * pi**2 * jnp.cos(pi * g.xq[0]) * jnp.cos(pi * g.xq[1])
        f_p = F.cell_integrate(g, g.phi0, Gq)
        zero_u = jnp.zeros((2, g.d1, g.n_cells))
        zero_lam = jnp.zeros((g.nt, g.n_facets))
        u, p, lam, iters, relres = pressure_solve(g, cs, zero_u, f_p, zero_lam, rtol=1e-12)
        p = p - F.integral(g, g.phi0, p)  # zero mean (volume 1)
        p_exact = disc.interpolate_pressure(
            lambda x, y: jnp.cos(pi * x) * jnp.cos(pi * y)
        )
        p_exact = p_exact - F.integral(g, g.phi0, p_exact)
        err = float(jnp.sqrt(F.l2_norm_sq(g, g.phi0, p - p_exact)))
        errs.append(err)
        assert int(iters) > 0
    rate = np.log2(errs[0] / errs[1])
    assert rate > k + 0.6, (errs, rate)


def test_pressure_solve_exact_discrete_solution():
    """pressure_solve returns the exact discrete solution of a compatible
    system (residual at solver tolerance)."""
    disc = HDGDiscretisation(unit_square_mesh(4), 1)
    g = disc.geom
    cs = build_condensed_system(disc)
    Q, p, lam = random_state(disc, seed=3)
    # make rhs from a state, then resolve; deflation fixes the constant mode
    b_u, b_p, b_lam = mixed_matvec(disc, Q, p, lam)
    u2, p2, lam2, iters, relres = pressure_solve(g, cs, b_u, b_p, b_lam, rtol=1e-13)
    r_u, r_p, r_lam = mixed_matvec(disc, u2, p2, lam2)
    assert float(jnp.abs(r_u - b_u).max()) < 1e-8
    assert float(jnp.abs(r_p - b_p).max()) < 1e-8
    assert float(jnp.abs(r_lam - b_lam).max()) < 1e-8
