"""Distributed Schur-complement bundle adjustment over a device mesh.

The multi-host/multi-chip scaling axis of the engine (BASELINE.json north
star; the reference has no distributed backend at all — SURVEY.md §2.4).

Design: two data axes are sharded across the mesh —

- the EDGE list (observations): every per-edge op (residuals, Jacobians,
  the W couplings, the CG matvec's gathers) is embarrassingly parallel
- the POINT blocks: Hpp [P,3,3] assembly, the 3x3 point marginalization
  inverses, and the back-substitution dx_p = Hpp^-1 (bp - W^T dx_c) are all
  per-point; P is the large dimension (10-100x the camera count), so this
  is where the memory and FLOPs live (SURVEY §2.4 "KF/point blocks sharded
  per host")

Camera blocks (the reduced system, [C,6] with C small) stay replicated:
replicating its CG is free and keeps the per-iteration collective count
constant. Cross-shard traffic is exactly the BA communication pattern:
edge->point segment-sums (reduce into the point shards), point->edge
gathers (halo reads of Hpp_inv/points), and edge->camera segment-sums
(all-reduce into the replicated reduced system). GSPMD lowers all of them
from the input shardings — `ops/ba.ba_solve` is reused UNCHANGED, which is
the point of the design: sharding is an annotation layer, not a rewrite.

Checked by `__graft_entry__.dryrun_multichip` (run on four cards by
`chip_smoke.py --four-cards`): a KITTI-scale problem (128 cams / 8k points /
64k edges), an assertion that the lowered program contains collectives,
cost and inlier parity with one device, and a 1-vs-N-device step-time
report.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import ba as BA


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def problem_shardings(mesh: Mesh, axis: str = "data") -> BA.BAProblem:
    """The PartitionSpec tree for a BAProblem: edges and points sharded
    along the mesh axis, cameras replicated."""
    edge1 = NamedSharding(mesh, P(axis))
    edge2 = NamedSharding(mesh, P(axis, None))
    pt1 = NamedSharding(mesh, P(axis))
    pt2 = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())
    return BA.BAProblem(
        cam_T=repl, cam_fixed=repl, cam_valid=repl,
        pts=pt2, pt_valid=pt1,
        e_cam=edge1, e_pt=edge1, e_obs=edge2,
        e_stereo=edge1, e_info=edge1, e_valid=edge1)


def shard_problem(p: BA.BAProblem, mesh: Mesh, axis: str = "data") -> BA.BAProblem:
    """Place the problem on the mesh: edge arrays and point blocks sharded
    along the mesh axis, cameras replicated. Edge and point counts must
    divide by the mesh size (the pad buckets are powers of two)."""
    sh = problem_shardings(mesh, axis)
    return BA.BAProblem(*(jax.device_put(x, s) for x, s in zip(p, sh)))


def dist_ba_solve(p: BA.BAProblem, mesh: Mesh, fx, fy, cx, cy, bf,
                  iters1: int = 5, iters2: int = 10, cg_iters: int = 24,
                  axis: str = "data") -> BA.BAResult:
    """Solve BA with edges + point blocks sharded over the mesh. Single-chip
    calls work too (mesh of one device).

    solver is PINNED to "cg": the matrix-free CG formulation is the sharded
    design (edge-local matvecs + segment-sum collectives). ba_solve's "auto"
    dispatch would otherwise pick the single-device dense-Schur path at
    small-to-medium scales, which materializes the [P, C, 6, 3] coupling —
    a tensor GSPMD replicates rather than communicates (observed: the
    lowered HLO contained no collectives and the dryrun went red)."""
    p = shard_problem(p, mesh, axis)
    # the device_put input shardings alone make GSPMD communicate
    # (lowered_collectives asserts so); the mesh context lets the compiler
    # see the mesh for sharding-in-types
    with jax.set_mesh(mesh):
        return BA.ba_solve(p, fx, fy, cx, cy, bf,
                           iters1=iters1, iters2=iters2, cg_iters=cg_iters,
                           solver="cg")


def lowered_collectives(p: BA.BAProblem, mesh: Mesh, fx, fy, cx, cy, bf,
                        iters1=1, iters2=1, cg_iters=4,
                        axis: str = "data") -> list[str]:
    """Compile the sharded solve and return the collective ops present in
    the optimized HLO (all-reduce / all-gather / reduce-scatter /
    collective-permute) — the dryrun asserts this is non-empty, i.e. the
    sharding actually communicates rather than silently replicating."""
    p = shard_problem(p, mesh, axis)
    lowered = jax.jit(
        BA.ba_solve,
        static_argnames=("fx", "fy", "cx", "cy", "bf", "iters1", "iters2",
                         "cg_iters", "solver"),
    ).lower(p, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
            iters1=iters1, iters2=iters2, cg_iters=cg_iters, solver="cg")
    txt = lowered.compile().as_text()
    names = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute")
    return sorted({n for n in names if n in txt})

