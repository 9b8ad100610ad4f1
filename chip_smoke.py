#!/usr/bin/env python3
"""Run the SLAM system's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py               # one card
    python3 chip_smoke.py --four-cards  # four cards: the multi-device path

One card runs four phases, in order, and exits non-zero at the first that
fails:

- device:  a GPU must be JAX's first device (never the CPU); prints the
           card, its power limit, the JAX version, the default matmul
           precision, the compile-cache directory and the native library;
- kernels: each device program of the main path, compiled for the card at
           real widths (640x480, 1000 features, 8 levels), against the same
           function on the CPU in this process or a numpy oracle;
- system:  System(async_mapping=True).run_sequence(pipelined=True) on the
           seeded room, for the mono, RGB-D and stereo sensors;
- loop:    the RGB-D corridor lap, which must close a loop and apply a
           background global BA.

`--four-cards` runs only the multi-device path (sharded BA and PGO against
one card, and the corridor lap with its global BA on the 4-card mesh).

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# ---------------------------------------------------------------- tolerances
# Hamming distances are integers: exact.
# extract_orb: float reductions (FAST scores, intensity centroids) run in
# another order on the GPU, so scores that tie on one device can order
# differently on the other at a level's top-k budget boundary, and a
# rotated BRIEF offset that lands within rounding of x.5 can round the
# other way.
EXTRACT_COUNT_REL = 0.01       # keypoint count within 1%
EXTRACT_MATCH_PX = 0.5         # same keypoint: same octave, within 0.5 px
EXTRACT_MIN_MATCHED = 0.95     # at least 95% of keypoints matched
# matched keypoints with identical descriptors (999 of 1000 on an H100)
EXTRACT_MIN_DESC_EQUAL = 0.99
# Pose LM / BA / PGO: f32 segment sums are atomics on the GPU and the
# solves are iterative, so results agree to f32 convergence noise.
POSE_TOL = 1e-4                # max |T_gpu - T_cpu| after 4x10 LM
BA_COST_REL = 1e-3             # final BA cost, relative
PGO_T_TOL = 1e-3               # max |t_gpu - t_cpu| after PGO
RANSAC_POSE_TOL = 1e-3         # two-view / PnP pose, same model chosen
# System gates, the ones the end-to-end tests use.
ATE_LIMIT_M = {"mono": 0.02, "rgbd": 0.03, "stereo": 0.03}
LOOP_ATE_LIMIT_M = 0.03
# (frames, orbit). The default orbit keeps RGB-D and stereo on their first
# keyframe for the whole arc, so those two also move 3 m toward the back
# wall: that makes them create 3-5 keyframes, so mapping and local BA run.
SYSTEM_RUNS = {"mono": (180, {}),
               "rgbd": (120, {"radius": 1.2, "forward": 3.0}),
               "stereo": (120, {"radius": 1.2, "forward": 3.0})}
LOOP_FRAMES = 240


def log(msg: str) -> None:
    print(msg, flush=True)


# -------------------------------------------------------------------- device
def phase_device(n_cards: int = 1) -> tuple[dict, str]:
    """Require n_cards GPUs; print what the run is labelled with."""
    import jax
    from orbslam2_tpu import native
    from orbslam2_tpu.utils import (gpu_name_and_power_limit, require_gpu,
                                    setup_compile_cache)

    cache = setup_compile_cache()
    dev = require_gpu()
    if dev["count"] < n_cards:
        raise RuntimeError(f"{n_cards} GPUs needed, {dev['count']} found")
    card = gpu_name_and_power_limit()
    log(f"[device] device_kind {dev['kind']!r}, {dev['count']} device(s)")
    log(f"[device] nvidia-smi name,power.limit: {card}")
    log(f"[device] jax {jax.__version__}, default matmul precision "
        f"{jax.config.jax_default_matmul_precision}")
    log(f"[device] compile cache {cache}")
    loaded = native.available()
    log(f"[device] native map-ops library loaded: {loaded}")
    if not loaded:
        raise RuntimeError("the native map-ops library did not load")
    return dev, card


# ------------------------------------------------------------------- kernels
def _describe_memory(compiled) -> str:
    mem = compiled.memory_analysis()
    if mem is None:
        return "memory analysis unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')} "
                     f"{getattr(mem, f, 'n/a')} B" for f in fields)


def compare_on_devices(name: str, fn, args):
    """Compile `fn` for the default device (the card), run it, and run the
    same function on the CPU. Prints compile seconds (set-up time) and the
    compiled program's memory analysis. Returns (device_out, cpu_out) as
    numpy trees."""
    import jax
    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    compiled = jfn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    log(f"[kernels] {name}: compile {compile_s:.2f} s; "
        f"{_describe_memory(compiled)}")
    out = jax.device_get(compiled(*args))
    ref = jax.device_get(jfn(*jax.device_put(args, jax.devices("cpu")[0])))
    return out, ref


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def hamming_reference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy popcount oracle for ops.matching.hamming_matrix."""
    out = np.empty((len(a), len(b)), np.int32)
    for i in range(0, len(a), 128):
        x = np.bitwise_xor(a[i:i + 128, None, :], b[None, :, :])
        out[i:i + 128] = _POP8[x.view(np.uint8)].sum(-1)
    return out


def check_hamming(shapes=((1024, 1024), (2048, 2048))) -> dict:
    import jax
    from orbslam2_tpu.ops import matching as M
    rng = np.random.default_rng(0)
    res = {}
    for A, B in shapes:
        a = rng.integers(0, 2 ** 32, (A, 8), dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
        name = f"hamming_matrix[{A}x{B}]"
        t0 = time.perf_counter()
        compiled = jax.jit(M.hamming_matrix).lower(a, b).compile()
        log(f"[kernels] {name}: compile {time.perf_counter() - t0:.2f} s; "
            f"{_describe_memory(compiled)}")
        out = np.asarray(compiled(a, b))
        ok = np.array_equal(out, hamming_reference(a, b))
        log(f"[kernels] {name}: exact match with numpy popcount: {ok}")
        assert ok, f"{name} differs from the numpy popcount"
        res[name] = ok
    return res


def check_extract(height: int = 480, width: int = 640,
                  n_features: int = 1000, n_levels: int = 8) -> dict:
    from orbslam2_tpu.config import OrbParams
    from orbslam2_tpu.io import synth
    from orbslam2_tpu.ops import features as F
    params = OrbParams(n_features=n_features, n_levels=n_levels)
    scale = width / 640
    scene = synth.make_room(seed=0, width=width, height=height,
                            fx=500.0 * scale, fy=500.0 * scale)
    img = np.clip(synth.render_room(scene, synth.orbit_trajectory(2)[0],
                                    seed=0), 0, 255).astype(np.float32)
    out, ref = compare_on_devices(
        f"extract_orb[{height}x{width}, {n_features} kp, {n_levels} lv]",
        lambda im: F.extract_orb(im, params, height, width), (img,))
    gv, cv = np.flatnonzero(out.valid), np.flatnonzero(ref.valid)
    n_dev, n_cpu = len(gv), len(cv)
    d = np.linalg.norm(ref.xy[cv][:, None, :] - out.xy[gv][None, :, :],
                       axis=-1)
    d[ref.octave[cv][:, None] != out.octave[gv][None, :]] = np.inf
    nearest = np.argmin(d, axis=1)
    matched = d[np.arange(n_cpu), nearest] <= EXTRACT_MATCH_PX
    frac_matched = float(matched.mean()) if n_cpu else 0.0
    same_desc = np.all(ref.desc[cv[matched]]
                       == out.desc[gv[nearest[matched]]], axis=-1)
    frac_equal = float(same_desc.mean()) if matched.any() else 0.0
    r = dict(n_device=n_dev, n_cpu=n_cpu, frac_matched=frac_matched,
             frac_desc_equal=frac_equal)
    log(f"[kernels] extract_orb: {r}")
    assert n_cpu > 0 and abs(n_dev - n_cpu) <= EXTRACT_COUNT_REL * n_cpu, r
    assert frac_matched >= EXTRACT_MIN_MATCHED, r
    assert frac_equal >= EXTRACT_MIN_DESC_EQUAL, r
    return r


def _pose_problem(n_obs: int, seed: int = 0):
    """Points in front of a camera with 0.5 px noise and 5% gross
    outliers, observed from T_gt, and a perturbed starting pose."""
    import jax.numpy as jnp
    from orbslam2_tpu.geometry import se3
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n_obs), rng.uniform(-2, 2, n_obs),
                    rng.uniform(4, 10, n_obs)], -1).astype(np.float32)
    T_gt = np.asarray(se3.se3_exp(jnp.asarray(
        [0.1, -0.05, 0.2, 0.02, -0.01, 0.015], jnp.float32)))
    pc = pts @ T_gt[:, :3].T + T_gt[:, 3]
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                   500 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n_obs) < 0.05
    uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    T0 = np.asarray(se3.compose(se3.se3_exp(jnp.asarray(
        [0.03, -0.02, 0.04, 0.01, -0.01, 0.008], jnp.float32)),
        jnp.asarray(T_gt)))
    obs = np.concatenate([uv, np.zeros((n_obs, 1))], -1).astype(np.float32)
    return T0, pts, obs, T_gt


def check_pose_opt(n_obs: int = 1024) -> dict:
    from orbslam2_tpu.ops import pose_opt as PO
    T0, pts, obs, T_gt = _pose_problem(n_obs)
    args = (T0, pts, obs, np.zeros(n_obs, bool),
            np.ones(n_obs, np.float32), np.ones(n_obs, bool))
    out, ref = compare_on_devices(
        f"pose_optimize[4x10 LM, {n_obs} obs]",
        lambda *a: PO.pose_optimize(*a, 500.0, 500.0, 320.0, 240.0, 0.0),
        args)
    diff = float(np.abs(out.T - ref.T).max())
    err_gt = float(np.abs(out.T - T_gt).max())
    r = dict(max_abs_dT=diff, max_abs_err_vs_truth=err_gt,
             inliers_device=int(out.n_inliers), inliers_cpu=int(ref.n_inliers))
    log(f"[kernels] pose_optimize: {r}")
    assert diff <= POSE_TOL, r
    return r


def check_ba(C: int = 16, P: int = 2048, E: int = 8192) -> dict:
    from __graft_entry__ import _make_ba_problem
    from orbslam2_tpu.ops import ba as BA
    prob, (fx, fy, cx, cy, bf) = _make_ba_problem(C, P, E)
    out, ref = compare_on_devices(
        f"ba_solve[{C} cams / {P} pts / {E} edges]",
        lambda p: BA.ba_solve(p, fx, fy, cx, cy, bf), (prob,))
    c_dev, c_cpu = float(out.cost), float(ref.cost)
    rel = abs(c_dev - c_cpu) / max(abs(c_cpu), 1e-9)
    r = dict(cost_device=c_dev, cost_cpu=c_cpu, rel_diff=rel,
             inliers_device=int(out.e_inlier.sum()),
             inliers_cpu=int(ref.e_inlier.sum()))
    log(f"[kernels] ba_solve: {r}")
    assert np.isfinite(c_dev) and rel <= BA_COST_REL, r
    return r


def check_pgo(K: int = 256) -> dict:
    from __graft_entry__ import _make_pgo_problem
    from orbslam2_tpu.ops import pose_graph as PG
    args = _make_pgo_problem(K=K)
    out, ref = compare_on_devices(
        f"optimize_pose_graph[K={K}]",
        lambda *a: PG.optimize_pose_graph(*a), args)
    dt = float(np.abs(np.asarray(out[2]) - np.asarray(ref[2])).max())
    r = dict(max_abs_dt=dt)
    log(f"[kernels] optimize_pose_graph: {r}")
    assert np.isfinite(dt) and dt <= PGO_T_TOL, r
    return r


def _two_view_pair(n: int, planar: bool, seed: int):
    """Matched pixels of n points seen from two poses (0.2 px noise)."""
    import jax.numpy as jnp
    from orbslam2_tpu.geometry import se3
    rng = np.random.default_rng(seed)
    z = np.full(n, 4.0) if planar else rng.uniform(3, 8, n)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], -1)
    R = np.asarray(se3.so3_exp(jnp.array([0.02, -0.05, 0.01])))
    t = np.array([0.3, 0.02, 0.05])
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)

    def proj(P):
        uv = P @ K.T
        return uv[:, :2] / uv[:, 2:]

    xy1 = proj(pts) + rng.normal(0, 0.2, (n, 2))
    xy2 = proj(pts @ R.T + t) + rng.normal(0, 0.2, (n, 2))
    w = (((xy1 > 10) & (xy1 < [630, 470])).all(-1)
         & ((xy2 > 10) & (xy2 < [630, 470])).all(-1))
    return xy1.astype(np.float32), xy2.astype(np.float32), w, K


def check_two_view(n: int = 1024) -> dict:
    import jax
    from orbslam2_tpu.ops import twoview as TV
    res = {}
    for planar in (False, True):
        xy1, xy2, w, K = _two_view_pair(n, planar, seed=1 + planar)
        key = np.asarray(jax.random.PRNGKey(0))
        name = f"initialize_two_view[{n}, {'planar' if planar else 'general'}]"
        out, ref = compare_on_devices(name, TV.initialize_two_view,
                                      (key, xy1, xy2, w, K))
        dR = float(np.abs(out.R - ref.R).max())
        dt = float(np.abs(out.t - ref.t).max())
        r = dict(success=(bool(out.success), bool(ref.success)),
                 homography=(bool(out.used_homography),
                             bool(ref.used_homography)),
                 max_abs_dR=dR, max_abs_dt=dt)
        log(f"[kernels] {name}: {r}")
        assert bool(out.success) and bool(ref.success), r
        assert bool(out.used_homography) == bool(ref.used_homography), r
        assert dR <= RANSAC_POSE_TOL and dt <= RANSAC_POSE_TOL, r
        res[name] = r
    return res


def check_pnp(n: int = 1024) -> dict:
    import jax
    import jax.numpy as jnp
    from orbslam2_tpu.geometry import se3
    from orbslam2_tpu.ops import pnp
    rng = np.random.default_rng(3)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], -1).astype(np.float32)
    T = np.asarray(se3.se3_exp(jnp.asarray(
        [0.2, -0.1, 0.3, 0.05, -0.02, 0.03], jnp.float32)))
    pc = X @ T[:, :3].T + T[:, 3]
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                   500 * pc[:, 1] / pc[:, 2] + 240], -1).astype(np.float32)
    bad = rng.random(n) < 0.25          # gross outliers; inliers exact
    uv[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    key = np.asarray(jax.random.PRNGKey(0))
    out, ref = compare_on_devices(
        f"pnp_ransac[{n}]",
        lambda k, *a: pnp.pnp_ransac(k, *a, 500.0, 500.0, 320.0, 240.0),
        (key, X, uv, np.ones(n, np.float32), np.ones(n, bool)))
    dT = float(np.abs(out.T - ref.T).max())
    r = dict(inliers=(int(out.n_inliers), int(ref.n_inliers)),
             max_abs_dT=dT, err_vs_truth=float(np.abs(out.T - T).max()))
    log(f"[kernels] pnp_ransac: {r}")
    assert int(out.n_inliers) == int(ref.n_inliers), r
    assert dT <= RANSAC_POSE_TOL, r
    return r


def phase_kernels() -> dict:
    return dict(hamming=check_hamming(), extract=check_extract(),
                pose_opt=check_pose_opt(), ba=check_ba(), pgo=check_pgo(),
                two_view=check_two_view(), pnp=check_pnp())


# -------------------------------------------------------------------- system
def check_system_gates(sensor: str, row: dict) -> None:
    """The end-to-end tests' gates: tracked >= 90% of post-init frames,
    init within the first 30% of frames, ATE under the sensor's limit
    (Sim3-aligned for mono, metric otherwise), and more than one keyframe
    so that mapping and local BA ran."""
    from bench import tracking_gate
    assert tracking_gate(row), f"{sensor}: tracking gate failed: {row}"
    assert np.isfinite(row["ate_m"]) and row["ate_m"] < ATE_LIMIT_M[sensor], (
        f"{sensor}: ATE {row['ate_m']} m >= {ATE_LIMIT_M[sensor]} m")
    assert row["keyframes"] > 1, f"{sensor}: only {row['keyframes']} keyframe"


def phase_system(card: str) -> dict:
    from bench import _full_system
    rows = {}
    for sensor, (n, orbit) in SYSTEM_RUNS.items():
        row = _full_system(sensor, n_frames=n, warmup=False, **orbit)
        log(f"[system] {sensor}: median {row['median_ms']:.3f} ms/frame, "
            f"p99 {row['p99_ms']:.3f} ms (n={row['n_timed']}, cold run, "
            f"compiles included), tracked {row['tracked']}/"
            f"{row['n_trackable']} post-init, init frames {row['n_init']}, "
            f"keyframes {row['keyframes']}, ATE {row['ate_m'] * 100:.3f} cm, "
            f"wall {row['wall_s']:.1f} s on {card}")
        check_system_gates(sensor, row)
        rows[sensor] = row
    return rows


# ---------------------------------------------------------------------- loop
def run_corridor_loop(dist_min_cams: int | None = None) -> dict:
    """The RGB-D lap of the corridor circuit (tests/test_loop_closure_e2e):
    fixed-scale loop closure, essential-graph PGO and a background global
    BA. dist_min_cams lowers GlobalBA's threshold for the sharded solve."""
    from dataclasses import replace
    from orbslam2_tpu.config import Sensor, SlamConfig, with_camera
    from orbslam2_tpu.io import synth
    from orbslam2_tpu.system import System
    from orbslam2_tpu.utils.evaluation import ate_rmse, camera_centers

    n_frames = LOOP_FRAMES
    scene = synth.make_corridor(seed=3)
    gt = synth.corridor_trajectory(n_frames, radius=8.0)
    cfg = with_camera(
        SlamConfig(sensor=Sensor.RGBD, th_depth=25.0),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        width=scene.width, height=scene.height)
    cfg = replace(cfg, camera=replace(cfg.camera, bf=250.0))
    slam = System(cfg)
    gba = slam.global_ba
    gba_devices = []
    if dist_min_cams is not None:
        gba.dist_min_cams = dist_min_cams
    solver_fn = gba._solver_fn

    def recording_solver_fn(prob):
        solve, n_dev = solver_fn(prob)
        gba_devices.append(n_dev)
        return solve, n_dev
    gba._solver_fn = recording_solver_fn

    # ray-traced frames: numpy releases the GIL, so threads render ~4x
    # faster than one; rendering is set-up, not part of the run's wall time
    def render(i):
        return (synth.render_room(scene, gt[i], noise=2.5, seed=i),
                synth.depth_room(scene, gt[i]))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        frames = list(pool.map(render, range(n_frames)))
    render_s = time.perf_counter() - t0

    tracked = 0
    t0 = time.perf_counter()
    for i, (img, depth) in enumerate(frames):
        tracked += slam.track_rgbd(img, depth, i / 30.0) is not None
    slam.shutdown()
    wall = time.perf_counter() - t0
    ts, est = slam.tracker.trajectory()
    fids = np.round(np.asarray(ts) * 30).astype(int)
    ate = float(ate_rmse(camera_centers(est), camera_centers(gt[fids]),
                         with_scale=False))
    return dict(n=n_frames, tracked=tracked,
                loops=slam.loop_closer.n_loops_closed,
                gba_applied=gba.n_applied, gba_devices=gba_devices,
                keyframes=slam.map.n_keyframes, ate_m=ate, wall_s=wall,
                render_s=render_s)


def check_loop_gates(row: dict) -> None:
    assert row["tracked"] >= row["n"] - 5, f"tracking broke: {row}"
    assert row["loops"] >= 1, f"no loop closed: {row}"
    assert row["gba_applied"] >= 1, f"background GBA never applied: {row}"
    assert np.isfinite(row["ate_m"]) and row["ate_m"] < LOOP_ATE_LIMIT_M, (
        f"metric ATE {row['ate_m']} m: {row}")


def phase_loop(card: str) -> dict:
    row = run_corridor_loop()
    log(f"[loop] rgbd corridor: {row} on {card}")
    check_loop_gates(row)
    return row


def phase_four_cards(card: str, n_cards: int = 4) -> dict:
    """Sharded BA and PGO against one card, then the corridor lap with its
    background global BA forced onto the n-card mesh."""
    from __graft_entry__ import dryrun_multichip
    dry = dryrun_multichip(n_cards)
    log(f"[four-cards] KITTI-scale BA cost ratio {dry['cost_ratio']:.5f}, "
        f"inliers {dry['inliers_n']} vs {dry['inliers_1']}, PGO K="
        f"{dry['pgo_k']} max|dt| {dry['pgo_max_dt']:.3e}, collectives "
        f"{dry['collectives']}; step times (reported only) KITTI 1-card "
        f"{dry['kitti_step_s_1']:.4f} s vs {n_cards}-card "
        f"{dry['kitti_step_s_n']:.4f} s, 1M edges 1-card "
        f"{dry['crossover_step_s_1']:.4f} s vs {n_cards}-card "
        f"{dry['crossover_step_s_n']:.4f} s on {card}")
    row = run_corridor_loop(dist_min_cams=1)
    log(f"[four-cards] rgbd corridor, GBA on the mesh: {row} on {card}")
    check_loop_gates(row)
    assert row["gba_devices"] and max(row["gba_devices"]) == n_cards, (
        f"global BA never ran on the {n_cards}-card mesh: {row}")
    return dict(dryrun=dry, loop=row)


# ---------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card path and its 1-card reference")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    t_start = time.perf_counter()
    try:
        dev, card = phase_device(n_cards)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if args.four_cards:
        phases = [("four-cards", lambda: phase_four_cards(card, n_cards))]
    else:
        phases = [("kernels", phase_kernels),
                  ("system", lambda: phase_system(card)),
                  ("loop", lambda: phase_loop(card))]
    for name, run in phases:
        t0 = time.perf_counter()
        run()   # raises on the first failed gate: no phase is passed over
        log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
