"""KITTI-scale full-System endurance run (VERDICT r4 item 5).

Drives the COMPLETE production system — block-pipelined tracking, async
mapping with culling, loop closing, background GBA — over a 1000+ frame
synthetic corridor circuit with multiple laps (each revisit must close a
loop), the scale class where the reference's real workloads live
(KITTI 00 ~4500 frames, Examples/Stereo/stereo_kitti.cpp). Frames are
rendered lazily so memory stays flat.

Usage:
    python scripts/endurance_run.py [--frames 1200] [--laps 2.5]
        [--sensor mono|rgbd|stereo] [--cpu] [--noise 2.5]

Prints one JSON line with fps, ATE, map statistics AND a per-closure
record (VERDICT r4 item 5): for every explicit CorrectLoop — the frame it
fired at, the matched (kf, kc) pair, trajectory ATE immediately BEFORE and
AFTER the correction, the essential-graph edge census the PGO consumed
(spanning tree / covis>=100 / loop edges / LoopConnections), and the
SearchAndFuse merge count. `--min-loops N` makes the run exit non-zero
unless at least N closures fired (the multi-lap regression gate). Paste
into BASELINE.md (endurance section).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--laps", type=float, default=2.5)
    ap.add_argument("--sensor", default="mono",
                    choices=["mono", "rgbd", "stereo"])
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (fast compiles, for CI)")
    ap.add_argument("--noise", type=float, default=2.5)
    ap.add_argument("--radius", type=float, default=8.0)
    ap.add_argument("--helix", type=float, default=0.0,
                    help="camera descent per lap (m): each lap maps fresh "
                         "viewpoints, re-accumulating drift -> one closure "
                         "per revisit instead of one total")
    ap.add_argument("--scene", default="corridor",
                    choices=["corridor", "rings"],
                    help="rings = TWO nested corridor rings joined by "
                         "doorways (make_corridor_rings): the route laps "
                         "each ring with a revisit overlap, so the run "
                         "contains two distinct topological loops and "
                         "must close BOTH (the KITTI-00 multi-closure "
                         "regime); --frames/--laps/--radius are ignored "
                         "except --frames")
    ap.add_argument("--min-loops", type=int, default=0,
                    help="exit non-zero unless >= N explicit closures fired")
    args = ap.parse_args()

    import jax
    from orbslam2_tpu.utils import (gpu_name_and_power_limit, require_gpu,
                                    setup_compile_cache)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        device = {"platform": "cpu"}
    else:
        device = require_gpu()
        device["card"] = gpu_name_and_power_limit()
    setup_compile_cache()

    import numpy as np
    from dataclasses import replace
    from orbslam2_tpu.config import Sensor, SlamConfig, with_camera
    from orbslam2_tpu.io import synth
    from orbslam2_tpu.system import System
    from orbslam2_tpu.utils.evaluation import ate_rmse, camera_centers

    N = args.frames
    if args.scene == "rings":
        scene = synth.make_corridor_rings(seed=3)
        gt = synth.rings_trajectory(N)
    else:
        scene = synth.make_corridor(seed=3)
        gt = synth.corridor_trajectory(N, radius=args.radius, laps=args.laps,
                                       helix=args.helix)
    sensor = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD,
              "stereo": Sensor.STEREO}[args.sensor]
    cfg = with_camera(
        SlamConfig(sensor=sensor,
                   th_depth=25.0 if sensor != Sensor.MONOCULAR else 35.0),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        width=scene.width, height=scene.height)
    if sensor != Sensor.MONOCULAR:
        cfg = replace(cfg, camera=replace(cfg.camera, bf=250.0))
    baseline = cfg.camera.bf / cfg.camera.K[0][0]

    def frames():
        for i in range(N):
            img = synth.render_room(scene, gt[i], noise=args.noise, seed=i)
            data = {"image": np.clip(img, 0, 255).astype(np.uint8)}
            if sensor == Sensor.RGBD:
                data["depth"] = synth.depth_room(scene, gt[i])
            elif sensor == Sensor.STEREO:
                T_r = gt[i].copy()
                # right camera: shift along the camera x-axis by baseline
                T_r[:, 3] = T_r[:, 3] - np.array([baseline, 0, 0],
                                                 np.float32)
                imr = synth.render_room(scene, T_r, noise=args.noise,
                                        seed=10_000 + i)
                data["right"] = np.clip(imr, 0, 255).astype(np.uint8)
            yield i / 30.0, data

    slam = System(cfg, async_mapping=True)

    # --- per-closure instrumentation (reference regime: KITTI 00 closes
    # several loops against a mature map, src/LoopClosing.cpp:512-810) ---
    closures = []
    orig_correct = slam.loop_closer._correct_loop

    def measure_ate():
        ts, est = slam.tracker.trajectory()
        if len(est) < 10:
            return None
        fids = np.clip(np.round(np.asarray(ts) * 30).astype(int), 0, N - 1)
        return float(ate_rmse(camera_centers(est), camera_centers(gt[fids]),
                              with_scale=(sensor == Sensor.MONOCULAR)))

    def wrapped_correct(kf, kc, s12, R12, t12):
        pre = measure_ate()
        r = orig_correct(kf, kc, s12, R12, t12)
        post = measure_ate()
        closures.append({
            "at_frame": len(slam.tracker.frame_log),
            "kf": int(kf), "kc": int(kc), "scale": round(float(s12), 4),
            "ate_pre_m": round(pre, 4) if pre is not None else None,
            "ate_post_m": round(post, 4) if post is not None else None,
            "pgo_edges": dict(slam.loop_closer.last_pgo_edges),
            "fused": int(slam.loop_closer.n_loop_fused),
        })
        return r

    slam.loop_closer._correct_loop = wrapped_correct

    t0 = time.perf_counter()
    tracked = slam.run_sequence(frames(), pipelined=True, progress_every=200)
    wall = time.perf_counter() - t0
    slam.shutdown()

    recs = slam.metrics.records
    times = np.array([r.track_ms for r in recs])
    first_ok = next((i for i, r in enumerate(recs) if r.state == "OK"),
                    len(recs))
    med = float(np.median(times[max(first_ok, 8):]))
    ts, est = slam.tracker.trajectory()
    ate = float("nan")
    if len(est) >= 10:
        fids = np.clip(np.round(np.asarray(ts) * 30).astype(int), 0, N - 1)
        ate = float(ate_rmse(camera_centers(est), camera_centers(gt[fids]),
                             with_scale=(sensor == Sensor.MONOCULAR)))
    out = {
        "sensor": args.sensor, "frames": N, "laps": args.laps,
        "tracked": tracked, "first_ok": first_ok,
        "median_ms": round(med, 1),
        "fps": round(1000.0 / med, 2) if med > 0 else 0.0,
        "wall_s": round(wall, 1),
        "ate_m": round(ate, 4),
        "keyframes": slam.map.n_keyframes,
        "points": slam.map.n_points,
        "kf_created_total": int(slam.map.next_kf_id),
        "kf_culled": int(slam.map.next_kf_id) - slam.map.n_keyframes,
        "loops": slam.loop_closer.n_loops_closed,
        "gba_applied": slam.global_ba.n_applied,
        "loop_fused": slam.loop_closer.n_loop_fused,
        "closures": closures,
        "device": device,
    }
    print(json.dumps(out))
    if args.min_loops and len(closures) < args.min_loops:
        print(f"FAILED: {len(closures)} closures < --min-loops "
              f"{args.min_loops}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
