"""Mesh-sharded SPMD over a ``jax.sharding.Mesh`` of devices.

The reference's only distribution axis is MPI domain decomposition inherited
from Firedrake/PETSc (SURVEY.md section 2.4); its equivalent here is
*cell/facet sharding*: every array whose leading axis is ``n_cells`` or
``n_facets`` is partitioned across a 1-D device mesh, everything else
(reference tabulations, per-class operator tables) is replicated.  Under
``jit``, GSPMD then inserts the halo-exchange collectives for the
facet<->cell gathers/scatters automatically; global reductions (pressure
means, Krylov dot products — the ``assemble(p*dx)`` analogues) become
``psum`` over the device interconnect.

No TP/PP/EP analogue exists for this workload — the scaling dimension is
mesh resolution, and cell sharding is its data parallelism (SURVEY.md
sections 2.4, 5.7-5.8).
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_device_mesh", "shard_discretisation", "shard_state"]

AXIS = "cells"


def make_device_mesh(n_devices=None, devices=None):
    """1-D device mesh over the first n available devices."""
    if devices is None:
        devices = jax.devices()[: (n_devices or len(jax.devices()))]
    return Mesh(np.asarray(devices), (AXIS,))


def _spec_for(arr, n_cells, n_facets, ndev=1):
    if not hasattr(arr, "ndim") or arr.ndim < 1:
        return P()
    # XLA requires the sharded dim divisible by the device count; leaves
    # that don't divide (odd facet counts on unstructured meshes) stay
    # replicated — GSPMD composes sharded and replicated operands freely
    if arr.shape[0] in (n_cells, n_facets) and arr.shape[0] % ndev == 0:
        return P(AXIS)
    # batch-last operator tables (nu, nu, n_cells/facets)
    if arr.shape[-1] in (n_cells, n_facets) and arr.shape[-1] % ndev == 0:
        return P(*([None] * (arr.ndim - 1) + [AXIS]))
    return P()


def shard_pytree(tree, mesh, n_cells, n_facets):
    """device_put every leaf with cell/facet sharding on the leading axis."""
    ndev = mesh.devices.size

    def put(leaf):
        spec = _spec_for(leaf, n_cells, n_facets, ndev)
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def _strip_structured(tree):
    """Disable the shift-structured fast path for GSPMD-sharded runs.

    The structured kernels move data with grid reshapes/slices/rolls of the
    [lowers; uppers] cell axis; under flat contiguous cell sharding GSPMD
    lowers those to a resharding storm (measured 5k+ all-gathers at nx=6/8
    devices).  The gather path shards cleanly, so sharded executions use it;
    the scalable multi-chip route is the slab-decomposed shard_map step
    (parallel/slab.py), which keeps the structured kernels and exchanges
    single-row halos explicitly.
    """
    import dataclasses

    if hasattr(tree, "shift"):
        return dataclasses.replace(tree, shift=None)
    if hasattr(tree, "vshift"):
        return dataclasses.replace(tree, vshift=None)
    return tree


def shard_discretisation(disc, mesh, *extra_trees):
    """Shard the Geom pytree (and any extra operator pytrees) over the mesh.

    Returns (sharded geom, sharded extras...).  ``n_cells``/``n_facets`` are
    taken from the discretisation so per-class tables stay replicated.
    """
    nc = disc.geom.n_cells
    nf = disc.geom.n_facets
    out = [shard_pytree(_strip_structured(disc.geom), mesh, nc, nf)]
    for t in extra_trees:
        out.append(shard_pytree(_strip_structured(t), mesh, nc, nf))
    return tuple(out)


def shard_state(state, mesh, n_cells, n_facets):
    """Shard a state pytree (velocity/pressure/trace arrays)."""
    return shard_pytree(state, mesh, n_cells, n_facets)
