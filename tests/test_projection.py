"""Tests of the BDM projection (SURVEY.md section 4: 'BDM projection —
idempotence, continuity of normal traces')."""

import numpy as np
import jax.numpy as jnp
import pytest

from incompressibleeulerhdg.mesh.generators import unit_square_mesh, periodic_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.ops import fields as F
from incompressibleeulerhdg.ops.projection import build_bdm_projection, project_bdm


@pytest.fixture(params=[0, 1, 2], ids=["k0", "k1", "k2"])
def setup(request):
    disc = HDGDiscretisation(unit_square_mesh(4), request.param)
    proj = build_bdm_projection(disc)
    return disc, proj


def test_projection_preserves_conforming_fields(setup):
    """A polynomial velocity of degree <= k+1 with continuous normal trace and
    zero normal boundary component is reproduced exactly."""
    disc, proj = setup
    g = disc.geom
    # u = (x(1-x), y(1-y)): continuous, degree 2, u.n = 0 on the entire
    # boundary of the unit square -> exactly reproducible for k >= 1.
    if disc.degree >= 1:
        u = disc.interpolate_velocity(lambda x, y: (x * (1 - x), y * (1 - y)))
        ustar = project_bdm(g, proj, u)
        assert float(jnp.abs(ustar - u).max()) < 1e-11


def test_projection_idempotent(setup):
    disc, proj = setup
    g = disc.geom
    u = disc.interpolate_velocity(lambda x, y: (jnp.sin(3 * x) * y, jnp.cos(2 * y) + x))
    u1 = project_bdm(g, proj, u)
    u2 = project_bdm(g, proj, u1)
    assert float(jnp.abs(u2 - u1).max()) < 1e-10


def test_projection_normal_continuity(setup):
    """Q*.n is single-valued across interior facets and ~0 on the boundary."""
    disc, proj = setup
    g = disc.geom
    u = disc.interpolate_velocity(lambda x, y: (jnp.sin(3 * x) * y, jnp.cos(2 * y) + x))
    ustar = project_bdm(g, proj, u)
    s0, s1 = F.facet_traces(g, g.tphi1, ustar)
    n0 = jnp.einsum("aqf,af->qf", s0, g.normal)
    n1 = jnp.einsum("aqf,af->qf", s1, g.normal)
    ni = g.n_int
    assert float(jnp.abs(n0[:, :ni] - n1[:, :ni]).max()) < 1e-11
    assert float(jnp.abs(n0[:, ni:]).max()) < 1e-11


def test_projection_normal_is_average(setup):
    """On interior facets Q*.n equals the average of the two normal traces."""
    disc, proj = setup
    g = disc.geom
    u = disc.interpolate_velocity(lambda x, y: (x * y + jnp.sin(y), x - y * y))
    ustar = project_bdm(g, proj, u)
    u0, u1 = F.facet_traces(g, g.tphi1, u)
    s0, _ = F.facet_traces(g, g.tphi1, ustar)
    ni = g.n_int
    avg_n = 0.5 * jnp.einsum("aqf,af->qf", u0 + u1, g.normal)[:, :ni]
    star_n = jnp.einsum("aqf,af->qf", s0, g.normal)[:, :ni]
    assert float(jnp.abs(avg_n - star_n).max()) < 1e-11


def test_projection_interior_moments_preserved(setup):
    """int_K Q*.v = int_K Q.v for v in the Nedelec moment space."""
    disc, proj = setup
    if proj.n_interior_dofs == 0:
        pytest.skip("no interior dofs for k=0")
    g = disc.geom
    u = disc.interpolate_velocity(lambda x, y: (jnp.sin(2 * x + y), x * x - y))
    ustar = project_bdm(g, proj, u)

    def moments(w):
        wq = F.cell_values(g.phi1, w)  # (2, nq, nc)
        V = jnp.einsum("bac,aqc->bqc", g.jac_inv, wq)
        return g.det_jac * jnp.einsum("q,jqb,bqc->jc", g.wq, proj.vhat, V)

    assert float(jnp.abs(moments(u) - moments(ustar)).max()) < 1e-12


def test_projection_periodic():
    disc = HDGDiscretisation(periodic_square_mesh(5), 1)
    proj = build_bdm_projection(disc)
    g = disc.geom
    u = disc.interpolate_velocity(lambda x, y: (jnp.sin(x) * jnp.cos(y), jnp.cos(x)))
    ustar = project_bdm(g, proj, u)
    s0, s1 = F.facet_traces(g, g.tphi1, ustar)
    n0 = jnp.einsum("aqf,af->qf", s0, g.normal)
    n1 = jnp.einsum("aqf,af->qf", s1, g.normal)
    assert float(jnp.abs(n0 - n1).max()) < 1e-11
