"""Multi-device SPMD tests on the 8-way virtual CPU mesh (conftest sets
--xla_force_host_platform_device_count=8), the JAX analogue of multi-node
testing (SURVEY.md section 4d)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from incompressibleeulerhdg.mesh.generators import unit_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.ops import fields as F
from incompressibleeulerhdg.ops.forms import weak_divergence_apply
from incompressibleeulerhdg.linalg.condense import build_condensed_system, trace_matvec
from incompressibleeulerhdg.parallel.sharding import (
    make_device_mesh,
    shard_discretisation,
    shard_pytree,
)

needs_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_multidevice
def test_sharded_operators_match_single_device():
    """Cell-sharded weak-form kernels produce bitwise-comparable results."""
    disc = HDGDiscretisation(unit_square_mesh(6), 1)
    g = disc.geom
    cs = build_condensed_system(disc)
    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.standard_normal((2, g.d1, g.n_cells)))
    lam = jnp.asarray(rng.standard_normal((g.nt, g.n_facets)))

    ref_div = weak_divergence_apply(g, Q)
    ref_tm = trace_matvec(g, cs, lam)

    mesh = make_device_mesh(8)
    g_sh, cs_sh = shard_discretisation(disc, mesh, cs)
    Q_sh = shard_pytree(Q, mesh, g.n_cells, g.n_facets)
    lam_sh = shard_pytree(lam, mesh, g.n_cells, g.n_facets)

    with mesh:
        div_sh = jax.jit(weak_divergence_apply)(g_sh, Q_sh)
        tm_sh = jax.jit(trace_matvec)(g_sh, cs_sh, lam_sh)
    assert float(jnp.abs(div_sh - ref_div).max()) < 1e-12
    assert float(jnp.abs(tm_sh - ref_tm).max()) < 1e-12


@needs_multidevice
@pytest.mark.slow
def test_sharded_imex_solve_matches_single_device():
    """Full Taylor-Green IMEX steps on the 8-device mesh reproduce the
    single-device solution (VERDICT round 1, item 6): the halo exchanges
    GSPMD inserts for the facet<->cell gathers are numerically exact."""
    from incompressibleeulerhdg.models.problems import TaylorGreen
    from incompressibleeulerhdg.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )

    disc = HDGDiscretisation(unit_square_mesh(6), 1)
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, 0.1)
    problem = TaylorGreen(disc)
    g = disc.geom
    Q0 = disc.interpolate_velocity(problem.initial_condition()[0])
    p0 = stepper.shift_pressure(
        disc.interpolate_pressure(problem.initial_condition()[1])
    )
    lam0 = stepper._reconstruct_trace(Q0, p0)
    s = stepper.nstages
    sQ = [Q0] + [jnp.zeros_like(Q0)] * (s - 1)
    sp = [p0] + [jnp.zeros_like(p0)] * (s - 1)
    sl = [lam0] + [jnp.zeros_like(lam0)] * (s - 1)
    dummy_q = jnp.zeros_like(p0)
    step = jax.jit(stepper._make_step(problem.f_rhs(), with_tracer=False))

    def run(geom, proj, cs, pc, sQ, sp, sl):
        out = None
        for k in range(3):
            tn = jnp.asarray(k * 0.1, dtype=disc.dtype)
            out = step(geom, proj, cs, pc, sQ, sp, sl, tn, dummy_q, None)
            sQ, sp, sl = out[0], out[1], out[2]
        return sQ[0], sp[0]

    Q_ref, p_ref = run(g, stepper._proj, stepper._cs, stepper._gtmg, sQ, sp, sl)

    mesh = make_device_mesh(8)
    g_sh, cs_sh, pc_sh, proj_sh = shard_discretisation(
        disc, mesh, stepper._cs, stepper._gtmg, stepper._proj
    )
    nc, nf = g.n_cells, g.n_facets
    sQ_sh = shard_pytree(sQ, mesh, nc, nf)
    sp_sh = shard_pytree(sp, mesh, nc, nf)
    sl_sh = shard_pytree(sl, mesh, nc, nf)
    with mesh:
        Q_sh, p_sh = run(g_sh, proj_sh, cs_sh, pc_sh, sQ_sh, sp_sh, sl_sh)

    assert float(jnp.abs(Q_sh - Q_ref).max()) < 1e-11
    assert float(jnp.abs(p_sh - p_ref).max()) < 1e-11


@needs_multidevice
def test_sharded_step_collective_audit():
    """Compile the sharded step and audit the collectives GSPMD inserted:
    the facet<->cell lane gathers must lower to bounded halo traffic, not
    cell-array-sized all-gathers on every operator application."""
    from incompressibleeulerhdg.models.problems import TaylorGreen
    from incompressibleeulerhdg.timesteppers.hdg_imex import (
        IncompressibleEulerHDGIMEXSSP2_332,
    )
    import re

    disc = HDGDiscretisation(unit_square_mesh(6), 1)
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, 0.1)
    problem = TaylorGreen(disc)
    g = disc.geom
    Q0 = disc.interpolate_velocity(problem.initial_condition()[0])
    p0 = disc.interpolate_pressure(problem.initial_condition()[1])
    lam0 = stepper._reconstruct_trace(Q0, p0)
    s = stepper.nstages
    sQ = [Q0] + [jnp.zeros_like(Q0)] * (s - 1)
    sp = [p0] + [jnp.zeros_like(p0)] * (s - 1)
    sl = [lam0] + [jnp.zeros_like(lam0)] * (s - 1)
    dummy_q = jnp.zeros_like(p0)
    step = jax.jit(stepper._make_step(problem.f_rhs(), with_tracer=False))

    mesh = make_device_mesh(8)
    g_sh, cs_sh, pc_sh, proj_sh = shard_discretisation(
        disc, mesh, stepper._cs, stepper._gtmg, stepper._proj
    )
    nc, nf = g.n_cells, g.n_facets
    args = (
        g_sh,
        proj_sh,
        cs_sh,
        pc_sh,
        shard_pytree(sQ, mesh, nc, nf),
        shard_pytree(sp, mesh, nc, nf),
        shard_pytree(sl, mesh, nc, nf),
        jnp.asarray(0.0, disc.dtype),
        dummy_q,
        None,
    )
    with mesh:
        hlo = step.lower(*args).compile().as_text()
    counts = {
        name: len(re.findall(rf"\b{name}\b", hlo))
        for name in ("all-gather", "all-reduce", "collective-permute", "all-to-all")
    }
    # the program must be genuinely distributed (reductions for the Krylov
    # dot products / integrals at minimum)
    assert counts["all-reduce"] > 0, counts
    # gathers with data-dependent indices lower to all-gathers under GSPMD;
    # measured baseline for this program: ~1.5-2.2k all-gathers, ~600
    # collective-permutes (recorded in docs/ARCHITECTURE.md; the count moves
    # with solver-config knobs like the Schwarz sweep count).  This path is
    # the UNSTRUCTURED-mesh fallback only — the scalable structured path is
    # the slab decomposition, whose audit asserts ZERO all-gathers
    # (tests/test_slab.py).  The loose bound here is a regression guard
    # against the fallback's count exploding with program structure.
    assert counts["all-gather"] < 3000, counts
    assert counts["collective-permute"] < 1200, counts


@needs_multidevice
@pytest.mark.slow
def test_dryrun_multichip():
    """The full IMEX step compiles and runs over an 8-device mesh."""
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


@needs_multidevice
def test_conforming_sharded_collective_audit():
    """Collective audit of the conforming RT1xDG0 scheme's GSPMD fallback —
    the one scheme family without a slab route (its RT assembly uses
    index-table gathers the slab-local layout does not carry,
    timesteppers/common.py:slab_context).  The audit bounds what the
    fallback costs: the compiled step's collective COUNT is static (the CG
    loops compile once), and the largest all-gather operand is facet-sized,
    so per-iteration traffic stays O(nf) per device — measured numbers
    recorded in docs/ARCHITECTURE.md (round-5; the reference distributes
    this scheme under MPI, conforming_implicit.py:86)."""
    import re
    from incompressibleeulerhdg.models.problems import TaylorGreen
    from incompressibleeulerhdg.timesteppers.conforming_implicit import (
        IncompressibleEulerConformingImplicit,
    )
    from incompressibleeulerhdg.ops import rt as RT

    disc = HDGDiscretisation(unit_square_mesh(16), 0)
    stepper = IncompressibleEulerConformingImplicit(disc, 0.05, "upwind", True)
    problem = TaylorGreen(disc)
    rt = stepper._rt
    Q = RT.rt_interpolate(disc, rt, problem.initial_condition()[0])
    Q = Q * rt.int_dof_mask
    p = jnp.zeros(disc.geom.n_cells, disc.dtype)
    f_dofs = jnp.zeros_like(Q)

    mesh = make_device_mesh(8)
    geom_sh, rt_sh = shard_discretisation(disc, mesh, rt)
    nc, nf = disc.geom.n_cells, disc.geom.n_facets
    Q_sh, p_sh, f_sh = shard_pytree((Q, p, f_dofs), mesh, nc, nf)
    step = jax.jit(stepper._make_step())
    with mesh:
        hlo = step.lower(geom_sh, rt_sh, Q_sh, p_sh, f_sh).compile().as_text()
    counts = {
        name: len(re.findall(rf"\b{name}\b", hlo))
        for name in ("all-gather", "all-reduce", "collective-permute", "all-to-all")
    }
    assert counts["all-reduce"] > 0, counts  # genuinely distributed
    # regression bound on the static collective count (see docstring);
    # measured at this config: see docs/ARCHITECTURE.md
    assert counts["all-gather"] < 800, counts
