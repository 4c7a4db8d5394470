"""Profile the pieces of the HDG IMEX step and trace one tentative solve.

Times each component of the flagship timestep separately (BDM projection,
operator build, tentative matvec and colored sweep, tentative solve, GTMG
V-cycle, pressure solve) for BOTH tentative table layouts — the factored
(Kronecker) tables and the dense ones (``IEHDG_FACT=0``) — and reports the
bytes each of the matvec and the sweep must move (XLA's cost analysis) over
its time.  With ``--trace DIR`` it also records one ``jax.profiler`` trace
of a tentative solve on the factored tables and prints the device time,
launch count and bytes/s of its top kernels, and the device busy share of
the traced window.  XLA wraps loop bodies in CUDA command buffers, which the
trace shows as single ``command_buffer`` events; set
``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` to see each kernel.  Not part
of the test suite.

Usage: PROF_NX=512 python tools/profile_step.py [--trace chiprun_out/trace]
"""

import argparse
import glob
import os
import re
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from incompressibleeulerhdg.utils.compile_cache import enable_compile_cache
from incompressibleeulerhdg.mesh.generators import unit_square_mesh
from incompressibleeulerhdg.fem.discretisation import HDGDiscretisation
from incompressibleeulerhdg.models.problems import TaylorGreen
from incompressibleeulerhdg.timesteppers.hdg_imex import (
    IncompressibleEulerHDGIMEXSSP2_332,
)
from incompressibleeulerhdg.ops.forms import star_fields, weak_divergence_apply
from incompressibleeulerhdg.ops.projection import project_bdm
from incompressibleeulerhdg.ops import fields as F
from incompressibleeulerhdg.linalg.preconditioners import (
    build_tentative_operator,
    tentative_operator_matvec,
    _colored_apply_fused_bl,
)
from incompressibleeulerhdg.linalg.tentative import tentative_solve
from incompressibleeulerhdg.linalg.pressure import pressure_solve
from incompressibleeulerhdg.linalg.gtmg import gtmg_apply

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
_DTYPE_BYTES = {"f32": 4, "f64": 8, "s32": 4, "u32": 4, "pred": 1, "bf16": 2,
                "s8": 1, "u8": 1, "s64": 8, "u64": 8, "f16": 2, "c64": 8}
_SHAPE = re.compile(r"\b(f32|f64|s32|u32|pred|bf16|s8|u8|s64|u64|f16|c64)\[([\d,]*)\]")


def timeit(name, fn, *args, n=5):
    """Best of ``n`` warm wall-clock runs, each ended by block_until_ready."""
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(n):
        out = None  # free the previous result before the next call
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    nbytes = fn.lower(*args).compile().cost_analysis().get("bytes accessed")
    rate = ""
    if nbytes:
        bw = nbytes / best
        rate = (f"  {nbytes / 1e9:8.3f} GB  {bw / 1e9:7.0f} GB/s "
                f"({100 * bw / HBM_BYTES_PER_S:4.1f}% of 3.35 TB/s)")
    print(f"{name:>44s} : {best * 1e3:9.3f} ms{rate}", flush=True)
    return out


def fusion_bytes(hlo_text):
    """Bytes each instruction of a compiled module reads and writes, from
    the operand and result shapes on its line (an upper bound on what a
    fusion must move, a lower bound where it re-reads an operand)."""
    out = {}
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)", line)
        if not m or "fusion(" not in m.group(2) and "custom-call(" not in m.group(2):
            continue
        total = 0
        for dt, dims in _SHAPE.findall(m.group(2).split(", calls=")[0]):
            total += _DTYPE_BYTES[dt] * int(np.prod([int(d) for d in dims.split(",") if d] or [1]))
        out[m.group(1)] = total
    return out


def reduce_trace(trace_dir, bytes_by_op, top=15, plane_prefix="/device:GPU"):
    """Device kernels of the newest trace under ``trace_dir``: per HLO op
    the summed device time and launch count, and the busy share of the
    window spanned by the device events."""
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    per_op = defaultdict(lambda: [0, 0])
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats:
                    continue
                per_op[stats["hlo_op"]][0] += ev.duration_ns
                per_op[stats["hlo_op"]][1] += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        print("trace: no device kernel events found")
        return
    spans.sort()
    busy, cur_s, cur_e = 0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    total = sum(v[0] for v in per_op.values())
    print(f"trace: {len(spans)} kernels, device busy {busy / 1e6:.3f} ms of a "
          f"{window / 1e6:.3f} ms window (idle share {1 - busy / window:.3f}), "
          f"kernel time {total / 1e6:.3f} ms")
    rows = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    for op, (ns, cnt) in rows:
        b = bytes_by_op.get(op)
        rate = ""
        if b:
            bw = b * cnt / (ns * 1e-9)
            rate = (f"  {b / 1e6:9.1f} MB/launch  {bw / 1e9:6.0f} GB/s "
                    f"({100 * bw / HBM_BYTES_PER_S:4.1f}%)")
        print(f"  {op:>40s}: {ns / 1e6:9.3f} ms  x{cnt:<5d} "
              f"({100 * ns / total:4.1f}%){rate}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--trace", default=None,
                        help="directory for a jax.profiler trace of one tentative solve")
    args = parser.parse_args()
    enable_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")

    nx = int(os.environ.get("PROF_NX", 256))
    degree = int(os.environ.get("PROF_DEGREE", 2))
    dtype = jnp.float32
    dt = 1.0 / nx
    dev = jax.devices()[0]
    print(f"nx={nx} k={degree} f32 on {len(jax.devices())} x {dev.device_kind} "
          f"({dev.platform})", flush=True)

    disc = HDGDiscretisation(unit_square_mesh(nx), degree, dtype=dtype)
    stepper = IncompressibleEulerHDGIMEXSSP2_332(disc, dt)
    problem = TaylorGreen(disc)
    geom = disc.geom
    print(f"n_cells={geom.n_cells} n_facets={geom.n_facets}", flush=True)
    Q0 = jax.jit(lambda: disc.interpolate_velocity(problem.initial_condition()[0]))()
    c = 0.25 * dt  # SSP2(3,3,2) a_11 dt
    proj, cs, pc = stepper._proj, stepper._cs, stepper._gtmg
    rtol_t = stepper.rtol_tentative

    j_project = jax.jit(lambda g, pr, Q: project_bdm(g, pr, Q))
    Qs = timeit("project_bdm", j_project, geom, proj, Q0)
    star = jax.jit(star_fields)(geom, Qs)
    b_tent = jax.jit(lambda g, s, Q: c * F.mass_apply(g, g.m1, Q))(geom, star, Q0)
    nu = 2 * geom.d1
    v = Q0.reshape(nu, geom.n_cells)

    j_mv = jax.jit(tentative_operator_matvec)
    j_sweep = jax.jit(lambda g, op, v: _colored_apply_fused_bl(g, op, v, symmetric=True))
    j_tent = jax.jit(lambda g, s, b, op: tentative_solve(
        g, s, b, c, alpha=1.0, upwind=True, rtol=rtol_t, op=op,
        restart=stepper.tentative_restart, symmetric=stepper.tentative_symmetric))
    ops = {}
    for layout, flag in (("factored", "1"), ("dense", "0")):
        # a fresh jit per layout: IEHDG_FACT is read while the build traces
        j_build = jax.jit(lambda g, s: build_tentative_operator(g, s, c, 1.0, True))
        os.environ["IEHDG_FACT"] = flag
        try:
            op = timeit(f"[{layout}] build_tentative_operator", j_build, geom, star, n=3)
        finally:
            os.environ.pop("IEHDG_FACT", None)
        timeit(f"[{layout}] tentative matvec", j_mv, geom, op, Q0, n=20)
        timeit(f"[{layout}] symmetric colored sweep + A z", j_sweep, geom, op, v, n=20)
        u, its, rr = timeit(f"[{layout}] tentative_solve", j_tent, geom, star, b_tent, op, n=3)
        print(f"{'[' + layout + '] tentative iterations':>44s} : {int(its)} "
              f"(relres {float(rr):.2e})", flush=True)
        assert (op.D is None) == (layout == "factored")
        ops[layout] = op
        op = u = None
    ops.pop("dense")

    j_gtmg = jax.jit(lambda g, c_, p_, v: gtmg_apply(g, c_, p_, v))
    timeit("gtmg_apply (one V-cycle)", j_gtmg, geom, cs, pc,
           jnp.ones(geom.n_facets * cs.nt, dtype), n=10)
    f_p = jax.jit(weak_divergence_apply)(geom, Q0)
    j_press = jax.jit(lambda g, c_, fu, fp, fl: pressure_solve(
        g, c_, fu, fp, fl, rtol=stepper.rtol_pressure,
        precond=lambda v: gtmg_apply(g, c_, pc, v)))
    out = timeit("pressure_solve", j_press, geom, cs, jnp.zeros_like(Q0), f_p,
                 jnp.zeros((cs.nt, geom.n_facets), dtype), n=3)
    print(f"{'pressure iterations':>44s} : {int(out[3])}", flush=True)
    out = None

    if args.trace:
        op = ops["factored"]
        hlo = j_tent.lower(geom, star, b_tent, op).compile().as_text()
        jax.block_until_ready(j_tent(geom, star, b_tent, op))
        jax.profiler.start_trace(args.trace)
        jax.block_until_ready(j_tent(geom, star, b_tent, op))
        jax.profiler.stop_trace()
        print(f"trace of one factored tentative_solve ({nx}^2 k={degree} f32):")
        reduce_trace(args.trace, fusion_bytes(hlo))


if __name__ == "__main__":
    main()
