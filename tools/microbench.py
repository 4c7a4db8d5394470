"""Microbenchmarks of gather/layout primitives at production sizes.

Informs the batch-last layout refactor: which facet<->cell data-movement
pattern is fastest on real hardware.  Not part of the test suite.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_default_matmul_precision", "highest")

from incompressibleeulerhdg.mesh.generators import unit_square_mesh

NX = int(os.environ.get("MB_NX", 256))


def timeit(name, fn, *args, n=20, bytes_moved=None):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    bw = f"  {bytes_moved / dt / 1e9:7.0f} GB/s" if bytes_moved else ""
    print(f"{name:>46s} : {dt*1e3:8.3f} ms{bw}")


def main():
    m = unit_square_mesh(NX)
    nc, nf = m.n_cells, m.n_facets
    print(f"nc={nc} nf={nf}")
    rng = np.random.default_rng(0)
    cf0 = jnp.asarray(m.facet_cells[:, 0].astype(np.int32))  # (nf,) facet->cell
    cfl = jnp.asarray(m.cell_facets.astype(np.int32))  # (nc, 3) cell->facet
    f32 = jnp.float32

    A8f = jnp.asarray(rng.standard_normal((8, nf)), f32)
    A20f = jnp.asarray(rng.standard_normal((20, nf)), f32)
    A100f = jnp.asarray(rng.standard_normal((100, nf)), f32)
    A20c = jnp.asarray(rng.standard_normal((20, nc)), f32)
    B128f = jnp.asarray(rng.standard_normal((nf, 128)), f32)
    Bm20c = jnp.asarray(rng.standard_normal((nc, 20)), f32)

    # (a) lane (minor-axis) gathers, batch-last source
    timeit("lane gather (8,nf)->(8,nc)", jax.jit(lambda A: A[:, cf0[:nc]]), A8f,
           bytes_moved=8 * nc * 4 * 2)
    timeit("lane gather (20,nf)->(20,nc)", jax.jit(lambda A: A[:, cf0[:nc]]), A20f,
           bytes_moved=20 * nc * 4 * 2)
    timeit("lane gather (100,nf)->(100,nc)", jax.jit(lambda A: A[:, cf0[:nc]]), A100f,
           bytes_moved=100 * nc * 4 * 2)
    timeit("lane gather (20,nc)->(20,nf)", jax.jit(lambda A: A[:, cfl[:, 0]].at[:, 0].get() if False else A[:, jnp.asarray(m.facet_cells[:, 0])]), A20c,
           bytes_moved=20 * nf * 4 * 2)

    # (b) row gathers, batch-major source
    timeit("row gather (nf,128)->(nc,128)", jax.jit(lambda B: B[cf0[:nc]]), B128f,
           bytes_moved=128 * nc * 4 * 2)
    timeit("row gather (nc,20)->(nf,20) [pads 6.4x]", jax.jit(lambda B: B[jnp.asarray(m.facet_cells[:, 0])]), Bm20c,
           bytes_moved=20 * nf * 4 * 2)
    timeit("row gather+T (nc,20)->(20,nf)", jax.jit(lambda B: B[jnp.asarray(m.facet_cells[:, 0])].T), Bm20c,
           bytes_moved=20 * nf * 4 * 2)

    # (c) transposes
    timeit("transpose (20,nc)->(nc,20)", jax.jit(lambda A: A.T.copy() if False else jnp.swapaxes(A, 0, 1) + 0.0), A20c,
           bytes_moved=20 * nc * 4 * 2)

    # (d) block matvec einsum (the Krylov core)
    D = jnp.asarray(rng.standard_normal((20, 20, nc)), f32)
    x = jnp.asarray(rng.standard_normal((20, nc)), f32)
    timeit("bl block matvec (20,20,nc)x(20,nc)",
           jax.jit(lambda D, x: jnp.einsum("ijn,jn->in", D, x)), D, x,
           bytes_moved=(400 + 40) * nc * 4)

    # (e) masked-GEMM build piece: 6 x (100,8)@(8,nc)
    G = jnp.asarray(rng.standard_normal((6, 100, 8)), f32)
    C = jnp.asarray(rng.standard_normal((6, 8, nc)), f32)
    timeit("6x GEMM (100,8)@(8,nc)",
           jax.jit(lambda G, C: jnp.einsum("tiq,tqn->in", G, C)), G, C,
           bytes_moved=(6 * 8 + 100) * nc * 4)

    # (f) batched block inverse (20,20,nf)
    from incompressibleeulerhdg.linalg.smallinv import inv_bl
    Df = jnp.asarray(rng.standard_normal((20, 20, nf)), f32) + 10.0 * jnp.eye(20, dtype=f32)[:, :, None]
    timeit("batched inverse (20,20,nf)", jax.jit(inv_bl), Df, n=3,
           bytes_moved=2 * 400 * nf * 4)

    # (g) current assemble pattern: (nc,3,20) where-select sum
    z0 = jnp.asarray(rng.standard_normal((nf, 20)), f32)
    z1 = jnp.asarray(rng.standard_normal((nf, 20)), f32)
    sel = jnp.asarray(m.cell_facet_side == 0)

    def assemble_bm(z0, z1):
        a0 = z0[cfl]
        a1 = z1[cfl]
        return jnp.where(sel[:, :, None], a0, a1).sum(axis=1)

    timeit("assemble bm (nc,3,20) select-sum", jax.jit(assemble_bm), z0, z1,
           bytes_moved=(2 * 3 * 20 + 20) * nc * 4)

    # (h) assemble via 3 separate row gathers (no (nc,3,20) intermediate)
    def assemble_split(z0, z1):
        out = 0.0
        for l in range(3):
            fl = cfl[:, l]
            out = out + jnp.where(sel[:, l : l + 1], z0[fl], z1[fl])
        return out

    timeit("assemble bm 3x row-gather", jax.jit(assemble_split), z0, z1,
           bytes_moved=(2 * 3 * 20 + 20) * nc * 4)

    # (i) assemble batch-last via 3 lane gathers
    z0t, z1t = z0.T, z1.T
    self_sel = jnp.asarray((m.cell_facet_side == 0).T)

    def assemble_bl(z0t, z1t):
        out = 0.0
        for l in range(3):
            fl = cfl[:, l]
            out = out + jnp.where(self_sel[l][None, :], z0t[:, fl], z1t[:, fl])
        return out

    timeit("assemble bl 3x lane-gather", jax.jit(assemble_bl), z0t, z1t,
           bytes_moved=(2 * 3 * 20 + 20) * nc * 4)


if __name__ == "__main__":
    main()
