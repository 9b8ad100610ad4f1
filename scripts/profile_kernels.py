"""Per-kernel device timings with a roofline share (SURVEY.md phase 7).

Times each major device program in isolation with the chained-dependency
pattern (outputs feed the next call's inputs, one block_until_ready per
batch, so the loop measures device work rather than one dispatch each).

Run on the GPU:  python scripts/profile_kernels.py

Emits a markdown table with each kernel's median time and, where the
algorithm's minimum memory traffic is known from its shapes, that traffic
over the card's peak bandwidth (orbslam2_tpu.utils.DEVICE_PEAKS, keyed by
device_kind) divided by the measured time. A device missing from that
table is an error.
"""
import sys
import time

sys.path.insert(0, ".")


def timed(fn, args, n=30, chain=None):
    """Median per-call ms with async chaining. chain(out, args) -> args
    threads a dependency through successive calls."""
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
        if chain is not None:
            args = chain(out, args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    import jax
    from orbslam2_tpu.utils import (device_peaks, gpu_name_and_power_limit,
                                    require_gpu, setup_compile_cache)
    setup_compile_cache()
    dev = require_gpu()
    peaks = device_peaks(dev["kind"])
    import jax.numpy as jnp
    import numpy as np
    from orbslam2_tpu.config import OrbParams
    from orbslam2_tpu.ops import features as F
    from orbslam2_tpu.ops import matching as M
    from orbslam2_tpu.ops import pose_opt as PO
    from orbslam2_tpu.ops import refine as RF
    from orbslam2_tpu.ops import ba as BA
    import functools

    print(f"device: {dev} ({gpu_name_and_power_limit()})")
    rng = np.random.default_rng(0)
    params = OrbParams()
    H, W = 480, 640
    N = F.padded_capacity(params.n_features)
    rows = []

    # ---- extraction: pyramid + FAST + NMS + select + IC angle + BRIEF ----
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    ex = functools.partial(F.extract_orb, params=params, height=H, width=W)
    jex = jax.jit(lambda im: ex(im))
    ms = timed(jex, (img,))
    # traffic estimate: pyramid atlas [8,H,W] f32 read ~3x (FAST, blur,
    # windows) + FAST shifted-stack traffic if materialized
    bytes_min = 8 * H * W * 4 * 3
    rows.append(("extract_orb (1000 kp, 8 levels)", ms, bytes_min))

    # ---- Hamming matrix 1024x1024 ----
    da = jnp.asarray(rng.integers(0, 2**32, (N, 8), dtype=np.uint32))
    db = jnp.asarray(rng.integers(0, 2**32, (N, 8), dtype=np.uint32))
    jham = jax.jit(M.hamming_matrix)
    ms = timed(jham, (da, db))
    # the [N, N] int32 result must be written; inputs are negligible
    rows.append((f"hamming_matrix [{N}x{N}]", ms, N * N * 4 + 2 * N * 32))

    # ---- pose-only LM (4x10) ----
    pts = jnp.asarray(rng.uniform(-2, 2, (N, 3)).astype(np.float32) + [0, 0, 6])
    T = jnp.asarray(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32))
    pc = np.asarray(pts) @ np.eye(3).T
    obs = jnp.asarray(np.stack(
        [500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240,
         np.zeros(N)], -1).astype(np.float32))
    info = jnp.ones(N, jnp.float32)
    valid = jnp.ones(N, bool)
    jpo = jax.jit(lambda T: PO.pose_optimize(
        T, pts, obs, jnp.zeros(N, bool), info, valid,
        500.0, 500.0, 320.0, 240.0, 0.0).T)
    ms = timed(jpo, (T,), chain=lambda out, a: (out,))
    rows.append(("pose_optimize (4x10 LM, 1024 obs)", ms, None))

    # ---- LK refinement (512 windows) ----
    win = jnp.asarray(rng.uniform(0, 255, (N, 15, 15)).astype(np.float32))
    tpl = jnp.asarray(rng.uniform(0, 255, (N, 11, 11)).astype(np.float32))
    vm = jnp.ones(N, bool)
    jrf = jax.jit(RF.refine_offsets)
    ms = timed(jrf, (win, tpl, vm))
    rows.append((f"refine_offsets ({N} windows, IC-LK)", ms,
                 N * (15 * 15 + 11 * 11) * 4))

    # ---- Schur BA: local-BA-sized and GBA-sized ----
    from __graft_entry__ import _make_ba_problem
    for (C, P, E, tag) in ((16, 2048, 8192, "local-BA"),
                           (128, 8192, 65536, "global-BA")):
        prob, (fx, fy, cx, cy, bf) = _make_ba_problem(C, P, E)
        for solver in ("cg", "dense"):
            jba = jax.jit(lambda p, s=solver: BA.ba_solve(
                p, fx, fy, cx, cy, bf, iters1=5, iters2=10, cg_iters=24,
                solver=s).cam_T)
            ms = timed(jba, (prob,), n=10)
            rows.append((f"ba_solve[{solver}] {tag} (C={C} P={P} E={E}, "
                         f"5+10 LM)", ms, None))

    print()
    print("| kernel | median ms | min bytes | share of memory bound |")
    print("|---|---|---|---|")
    for name, ms, nbytes in rows:
        if nbytes is None:
            print(f"| {name} | {ms:.4f} | not modelled | not modelled |")
            continue
        bound_ms = nbytes / peaks["hbm_bytes_per_s"] * 1e3
        print(f"| {name} | {ms:.4f} | {nbytes} | {bound_ms / ms:.3f} |")


if __name__ == "__main__":
    main()
