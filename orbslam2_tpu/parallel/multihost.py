"""Multi-host distributed runtime (jax.distributed) for the BA backend.

One process per host, each driving all of that host's GPUs; the
collectives of the sharded solve run over NCCL (NVLink inside a host, the
network between hosts). Never start a second process on a card: a JAX
process reserves three quarters of a card's memory when it first uses it,
so a second one fails for want of memory. No launcher or benchmark in this
repository starts more than one process per card.

This module is the host-side plumbing: process-group initialization, the
global mesh, and a multi-host wrapper over `dist_ba.dist_ba_solve` (the
solver itself is host-count agnostic — GSPMD addresses the global device
set, so the same program scales from one card to many hosts).

Environment (standard jax.distributed contract):
    SLAM_COORDINATOR   host:port of process 0 (default 127.0.0.1:12321)
    SLAM_NUM_PROCESSES total process count   (default 1)
    SLAM_PROCESS_ID    this process's id     (default 0)

Single-process calls are no-ops that fall back to the local device set, so
the same entry point runs everywhere. A multi-host run is one process per
host:

    SLAM_NUM_PROCESSES=4 SLAM_PROCESS_ID=$i SLAM_COORDINATOR=host0:12321 \
        python -m orbslam2_tpu.parallel.multihost

which solves a sharded KITTI-scale BA problem over every card of every
host and verifies the result on process 0.
"""
from __future__ import annotations

import os

import numpy as np

import jax

from . import dist_ba


def init_distributed() -> dict:
    """Initialize jax.distributed from SLAM_* env vars (no-op when
    single-process). Returns a status dict."""
    n_proc = int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    if n_proc <= 1:
        return {"processes": 1, "process_id": 0,
                "devices": len(jax.devices()),
                "local_devices": len(jax.local_devices())}
    coordinator = os.environ.get("SLAM_COORDINATOR", "127.0.0.1:12321")
    pid = int(os.environ.get("SLAM_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=n_proc, process_id=pid)
    return {"processes": n_proc, "process_id": pid,
            "devices": len(jax.devices()),
            "local_devices": len(jax.local_devices())}


def global_mesh(axis: str = "data"):
    """1-D mesh over EVERY device of every process (the BA data axis).
    After init_distributed, jax.devices() is the global set."""
    return dist_ba.make_mesh(None, axis)


def solve_multihost(prob, fx, fy, cx, cy, bf, **kw):
    """Solve a BAProblem over the global mesh. Each process must pass the
    SAME host-side problem arrays (the map snapshot is replicated host-side
    — it is the solver state that shards); jax.device_put with a global
    NamedSharding distributes each process's local shard."""
    mesh = global_mesh()
    return dist_ba.dist_ba_solve(prob, mesh, fx, fy, cx, cy, bf, **kw)


def _fetch_replicated(x):
    """Read a replicated global array in a multi-process run: every process
    holds a full copy in its first addressable shard."""
    return np.asarray(x.addressable_shards[0].data)


def _main():
    import jax.numpy as jnp

    info = init_distributed()
    print(f"[multihost] {info}", flush=True)
    import sys
    sys.path.insert(0, os.getcwd())
    from __graft_entry__ import _make_ba_problem
    prob, (fx, fy, cx, cy, bf) = _make_ba_problem(128, 8192, 65536)
    res = solve_multihost(prob, fx, fy, cx, cy, bf, iters1=2, iters2=3,
                          cg_iters=12)
    # reduce the edge-sharded inlier mask on device (collective), then read
    # the replicated scalars from this process's addressable shard
    inl = int(_fetch_replicated(jnp.sum(res.e_inlier)))
    cost = float(_fetch_replicated(res.cost))
    assert np.isfinite(cost), "diverged"
    if info["process_id"] == 0:
        print(f"[multihost] BA over {info['devices']} devices / "
              f"{info['processes']} processes: cost={cost:.1f}, "
              f"inliers={inl}/65536", flush=True)


if __name__ == "__main__":
    _main()
