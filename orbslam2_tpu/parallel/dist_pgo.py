"""Distributed Sim(3) pose-graph optimization over a device mesh.

The essential-graph solver (ops/pose_graph.py — the reference's
Optimizer::OptimizeEssentialGraph, src/Optimizer.cpp:944) shares the BA
solver's shardable structure: all heavy work is PER EDGE (residuals + 14
numeric-Jacobian perturbations of Sim3 chains), reduced into per-vertex
blocks by segment-sum. So the sharding layer mirrors parallel/dist_ba.py:

- the EDGE arrays (e_i, e_j, measurements, validity) shard along the mesh
  axis — Jacobian evaluation is embarrassingly parallel;
- the VERTEX state ([K,7]-dof Sim3) stays replicated — K is the keyframe
  count (10^2-10^3), tiny next to E, and replication keeps the CG's
  per-iteration collective count constant (one all-reduce per edge->vertex
  segment-sum).

`optimize_pose_graph` is reused UNCHANGED — sharding is an annotation
layer, exactly as for BA. Checked by __graft_entry__.dryrun_multichip
(collectives asserted in the lowered HLO) and the sharded==single-device
parity test (tests/test_dist_ba.py::TestDistPGO).
"""
from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import pose_graph as PG
from .dist_ba import make_mesh  # noqa: F401  (re-export mesh)


def shard_pgo(mesh, svals, R, t, fixed, e_i, e_j, meas_s, meas_R, meas_t,
              e_valid, axis: str = "data"):
    """Place a pose-graph problem on the mesh: edge arrays sharded along
    the mesh axis, vertex state replicated. Edges are padded up to a
    multiple of the mesh size with e_valid=False identity edges (masked
    out of every reduction)."""
    import jax.numpy as jnp
    n = mesh.devices.size
    E = int(e_i.shape[0])
    pad = (-E) % n
    if pad:
        def padded(a, fill=0):
            shape = (pad,) + tuple(a.shape[1:])
            return jnp.concatenate([a, jnp.full(shape, fill, a.dtype)])
        e_i = padded(e_i)
        e_j = padded(e_j)
        meas_s = padded(meas_s, 1.0)
        meas_R = jnp.concatenate(
            [meas_R, jnp.broadcast_to(jnp.eye(3, dtype=meas_R.dtype),
                                      (pad, 3, 3))])
        meas_t = padded(meas_t)
        e_valid = jnp.concatenate([e_valid, jnp.zeros(pad, bool)])
    repl = NamedSharding(mesh, P())
    e1 = NamedSharding(mesh, P(axis))
    e2 = NamedSharding(mesh, P(axis, None))
    e3 = NamedSharding(mesh, P(axis, None, None))
    put = jax.device_put
    return (put(svals, repl), put(R, repl), put(t, repl), put(fixed, repl),
            put(e_i, e1), put(e_j, e1), put(meas_s, e1), put(meas_R, e3),
            put(meas_t, e2), put(e_valid, e1))


def dist_pose_graph(mesh, svals, R, t, fixed, e_i, e_j,
                    meas_s, meas_R, meas_t, e_valid,
                    iters: int = 20, cg_iters: int = 32,
                    axis: str = "data"):
    """optimize_pose_graph with the edge set sharded over the mesh.
    Single-device meshes work too (the annotations become no-ops)."""
    args = shard_pgo(mesh, svals, R, t, fixed, e_i, e_j,
                     meas_s, meas_R, meas_t, e_valid, axis)
    with jax.set_mesh(mesh):
        return PG.optimize_pose_graph(*args, iters=iters, cg_iters=cg_iters)


def lowered_collectives_pgo(mesh, svals, R, t, fixed, e_i, e_j,
                            meas_s, meas_R, meas_t, e_valid,
                            iters: int = 1, axis: str = "data"):
    """Compile the sharded solve and return the collective ops in the
    optimized HLO — the dryrun asserts this is non-empty (the sharding
    really communicates rather than silently replicating)."""
    args = shard_pgo(mesh, svals, R, t, fixed, e_i, e_j,
                     meas_s, meas_R, meas_t, e_valid, axis)
    lowered = jax.jit(
        PG.optimize_pose_graph, static_argnames=("iters", "cg_iters"),
    ).lower(*args, iters=iters)
    txt = lowered.compile().as_text()
    names = ("all-reduce", "all-gather", "reduce-scatter",
             "collective-permute")
    return sorted({n for n in names if n in txt})
