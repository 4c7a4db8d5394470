"""Tests for auxiliary subsystems: CG spaces, tracer, vorticity, VTK output,
performance logging, gridspacing, RT element (SURVEY.md sections 2.1 C8-C11,
5)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from incompressibleeulerhdg.mesh.generators import unit_square_mesh, periodic_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.fem.cg import (
    build_cg_space,
    cg_project_dg,
    cg_gather,
    cg_mass_solve,
    cg_mass_matvec,
)
from incompressibleeulerhdg.ops import fields as F


def test_cg_space_dof_counts():
    mesh = unit_square_mesh(4)
    disc = HDGDiscretisation(mesh, 1)
    for deg, expected in [(1, mesh.n_vertices), (2, mesh.n_vertices + mesh.n_facets)]:
        sp = build_cg_space(disc, deg)
        assert sp.n_dofs == expected


def test_cg_projection_reproduces_continuous_fields():
    """L2 projection of (the DG interpolant of) a degree<=k+1 polynomial onto
    CG(k+1) reproduces it exactly; converting back to DG is the identity."""
    disc = HDGDiscretisation(unit_square_mesh(4), 1)
    g = disc.geom
    sp = build_cg_space(disc, 2)
    u = disc.interpolate_velocity(lambda x, y: (x * x - 0.3 * y, x * y + 1.0))
    x, iters = cg_project_dg(g, sp, u)
    u_back = cg_gather(sp, x)
    assert float(jnp.abs(u_back - u).max()) < 1e-10
    assert int(iters) < 60


def test_cg_mass_matvec_symmetric_and_integral():
    disc = HDGDiscretisation(unit_square_mesh(3), 1)
    g = disc.geom
    sp = build_cg_space(disc, 2)
    ones = jnp.ones(sp.n_dofs)
    # M 1 summed = volume of the domain
    assert abs(float(jnp.sum(cg_mass_matvec(g, sp, ones))) - 1.0) < 1e-12


def test_tracer_conservation_and_constant_preservation():
    """Upwind DG tracer advection with a divergence-free CG-projected velocity
    preserves constants and total mass on a periodic mesh."""
    from incompressibleeulerhdg.ops.tracer import tracer_step

    disc = HDGDiscretisation(periodic_square_mesh(6), 1)
    g = disc.geom
    sp = build_cg_space(disc, 2)
    u = disc.interpolate_velocity(lambda x, y: (jnp.sin(y) + 1.0, jnp.cos(x)))
    q0 = disc.interpolate_pressure(lambda x, y: jnp.sin(x) + 2.0)
    mass0 = float(F.integral(g, g.phi0, q0))
    q = q0
    for _ in range(3):
        q = tracer_step(g, q, u, 0.02, cg_space=sp)
    # conservation of total tracer mass (periodic, continuous velocity)
    assert abs(float(F.integral(g, g.phi0, q)) - mass0) < 1e-10
    # constants stay constant when velocity is divergence-free... sin/cos
    # velocity above is div-free; a constant tracer must remain constant
    qc = jnp.ones_like(q0)
    qc2 = tracer_step(g, qc, u, 0.02, cg_space=sp)
    assert float(jnp.abs(qc2 - 1.0).max()) < 1e-8


def test_vorticity_projection_rigid_rotation():
    """curl of the rigid rotation (y-c, -(x-c)) is -2 everywhere."""
    from incompressibleeulerhdg.ops.vorticity import vorticity_project
    from incompressibleeulerhdg.fem.lagrange import triangle_basis
    from incompressibleeulerhdg.fem.spaces import facet_ref_points

    disc = HDGDiscretisation(unit_square_mesh(4), 1)
    degree = disc.degree + 1
    sp = build_cg_space(disc, degree)
    basis = triangle_basis(degree)
    gphi = jnp.asarray(basis.tabulate_grad(disc.V1.qp))
    tphi = jnp.asarray(
        np.stack(
            [
                basis.tabulate(facet_ref_points(l, fl, disc.Vt.sq))
                for l in range(3)
                for fl in (0, 1)
            ]
        )
    )
    Q = disc.interpolate_velocity(lambda x, y: (y - 0.5, -(x - 0.5)))
    omega, iters = vorticity_project(disc, sp, Q, gphi, tphi)
    assert float(jnp.abs(omega + 2.0).max()) < 1e-9


def test_vtk_writer_roundtrip(tmp_path):
    from incompressibleeulerhdg.utils.vtk import (
        write_vtu,
        VTKTimeSeries,
        sample_dg_at_corners,
    )
    import xml.dom.minidom

    disc = HDGDiscretisation(unit_square_mesh(3), 1)
    Q = disc.interpolate_velocity(lambda x, y: (x, y))
    p = disc.interpolate_pressure(lambda x, y: x * y)
    fields = {
        "velocity": sample_dg_at_corners(disc, Q),
        "pressure": sample_dg_at_corners(disc, p),
    }
    path = str(tmp_path / "out.vtu")
    write_vtu(path, disc.mesh, fields)
    doc = xml.dom.minidom.parse(path)
    names = {a.getAttribute("Name") for a in doc.getElementsByTagName("DataArray")}
    assert {"velocity", "pressure", "connectivity", "offsets", "types"} <= names

    series = VTKTimeSeries(str(tmp_path / "anim.pvd"))
    series.write(disc.mesh, fields, time=0.0)
    series.write(disc.mesh, fields, time=0.5)
    pvd = open(tmp_path / "anim.pvd").read()
    assert 'timestep="0.5"' in pvd


def test_performance_log_and_averager():
    from incompressibleeulerhdg.utils.logging import PerformanceLog, Averager

    PerformanceLog.reset()
    with PerformanceLog("unit"):
        pass
    assert len(PerformanceLog.data["unit"]) == 1
    av = Averager()
    for v in (1.0, 2.0, 3.0):
        av.update(v)
    assert abs(av.value - 2.0) < 1e-14
    assert av.n_samples == 3
    assert av.min == 1.0


def test_progress_line_reports_each_step():
    import io
    from incompressibleeulerhdg.utils.logging import progress

    out = io.StringIO()
    assert list(progress(range(2, 5), out=out)) == [2, 3, 4]
    text = out.getvalue()
    assert "step 3/5" in text and "step 5/5" in text and text.endswith("\n")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and changes
    no JAX setting."""
    import jax
    from incompressibleeulerhdg.utils.compile_cache import (
        compile_cache_dir,
        enable_compile_cache,
    )

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the env var the cache is the fixed, git-ignored .jax_cache/
    at the checkout root — the same path in every process."""
    import os
    from incompressibleeulerhdg.utils.compile_cache import compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache_dir() == os.path.join(root, ".jax_cache")
    ignored = open(os.path.join(root, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_gridspacing():
    from incompressibleeulerhdg.utils.grid import gridspacing

    h_min, h_max = gridspacing(unit_square_mesh(4))
    assert abs(h_min - 0.25) < 1e-12
    assert abs(h_max - 0.25 * np.sqrt(2)) < 1e-12


def test_rt_element_basics():
    """RT interpolation/evaluation: interpolating a constant field reproduces
    it; divergence of the interpolant of a linear field is exact."""
    from incompressibleeulerhdg.ops import rt as RT

    disc = HDGDiscretisation(unit_square_mesh(4), 0)
    g = disc.geom
    rt = RT.build_rt_tables(disc)
    gd = RT.rt_interpolate(disc, rt, lambda x, y: (1.5 * jnp.ones_like(x), -0.5 * jnp.ones_like(x)))
    vals = RT.rt_eval_cellq(g, rt, gd)
    assert float(jnp.abs(vals[0] - 1.5).max()) < 1e-12
    assert float(jnp.abs(vals[1] + 0.5).max()) < 1e-12
    # divergence of interpolated linear field (x, y): div = 2
    gd2 = RT.rt_interpolate(disc, rt, lambda x, y: (x, y))
    div = RT.rt_divergence(g, rt, gd2)
    assert float(jnp.abs(div - 2.0).max()) < 1e-10
    # mass matrix SPD-ness: x^T M x > 0
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(g.n_facets))
    assert float(x @ RT.rt_mass_apply(g, rt, x)) > 0


def test_checkpoint_roundtrip(tmp_path):
    from incompressibleeulerhdg.utils.checkpoint import save_checkpoint, load_checkpoint

    path = str(tmp_path / "ck" / "state.npz")
    state = {
        "stage_Q": [np.ones((4, 6, 2)), np.zeros((4, 6, 2))],
        "p": np.arange(12.0).reshape(4, 3),
    }
    save_checkpoint(path, state, t=0.75, config={"nx": 8, "scheme": "imex_ssp2_332"})
    loaded, t, config = load_checkpoint(path, expect_config={"nx": 8})
    assert t == 0.75
    assert config["scheme"] == "imex_ssp2_332"
    assert np.array_equal(loaded["p"], state["p"])
    assert len(loaded["stage_Q"]) == 2
    assert np.array_equal(loaded["stage_Q"][0], state["stage_Q"][0])
    with pytest.raises(ValueError):
        load_checkpoint(path, expect_config={"nx": 16})
