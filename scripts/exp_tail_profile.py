"""Per-frame tail profiler (VERDICT r4 items 2/6): run the bench workload
once on the GPU (or --cpu) with full phase timing, then print a per-frame
time table annotated with state/keyframe events and a tail breakdown —
which frames carry the mean-over-median excess, and what the mapper's
per-keyframe turnaround is.

Usage: python scripts/exp_tail_profile.py [--sensor mono] [--frames 120]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sensor", default="mono",
                    choices=["mono", "rgbd", "stereo"])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--timing", action="store_true",
                    help="ORBSLAM2_TPU_TIMING phase prints")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import os
    if args.timing:
        os.environ["ORBSLAM2_TPU_TIMING"] = "1"

    import jax
    from orbslam2_tpu.utils import require_gpu, setup_compile_cache
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        print(f"device: {require_gpu()}", flush=True)
    setup_compile_cache()
    import numpy as np
    from dataclasses import replace
    from orbslam2_tpu.config import Sensor, SlamConfig, with_camera
    from orbslam2_tpu.io import synth
    from orbslam2_tpu.system import System

    N = args.frames
    sensor = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD,
              "stereo": Sensor.STEREO}[args.sensor]
    scene = synth.make_room(seed=0)
    gt = synth.orbit_trajectory(N)
    cfg = with_camera(
        SlamConfig(sensor=sensor,
                   th_depth=25.0 if sensor != Sensor.MONOCULAR else 35.0),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        width=scene.width, height=scene.height)
    if sensor != Sensor.MONOCULAR:
        cfg = replace(cfg, camera=replace(cfg.camera, bf=250.0))
    baseline = cfg.camera.bf / cfg.camera.K[0][0]

    def make_frame(i):
        img = np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255
                      ).astype(np.uint8)
        data = {"image": img}
        if sensor == Sensor.RGBD:
            data["depth"] = synth.depth_room(scene, gt[i])
        elif sensor == Sensor.STEREO:
            T_r = gt[i].copy()
            T_r[:, 3] = T_r[:, 3] - np.array([baseline, 0, 0], np.float32)
            data["right"] = np.clip(
                synth.render_room(scene, T_r, seed=10_000 + i), 0, 255
            ).astype(np.uint8)
        return i / 30.0, data

    frames_data = [make_frame(i) for i in range(N)]
    # warmup (same recipe as bench.py)
    warm = System(cfg, async_mapping=True)
    warm.run_sequence(iter(frames_data), pipelined=True)
    warm.shutdown()

    slam = System(cfg, async_mapping=True)
    t0 = time.perf_counter()
    slam.run_sequence(iter(frames_data), pipelined=True)
    wall = time.perf_counter() - t0
    slam.shutdown()

    recs = slam.metrics.records
    times = np.array([r.track_ms for r in recs])
    kf_at = {}
    prev_kf = 0
    for i, r in enumerate(recs):
        if r.keyframes != prev_kf:
            kf_at[i] = r.keyframes
            prev_kf = r.keyframes
    n_warm = 8
    med = float(np.median(times[n_warm:]))
    mean = float(times[n_warm:].mean())
    print(f"\n=== {args.sensor}: median {med:.1f} mean {mean:.1f} "
          f"wall {wall:.1f}s kfs {slam.map.n_keyframes} ===")
    total_excess = float((times[n_warm:] - med).clip(0).sum())
    print(f"total excess over median: {total_excess:.0f} ms "
          f"({total_excess/ (N - n_warm):.1f} ms/frame of the mean)")
    order = np.argsort(-times)
    print("top-15 slowest frames:")
    for i in order[:15]:
        mark = f" KF->{kf_at[i]}" if i in kf_at else ""
        print(f"  frame {i:3d}: {times[i]:8.1f} ms state={recs[i].state}"
            f" inliers={recs[i].inliers}{mark}")
    # bucket the excess
    init_ex = float((times[n_warm:][np.array(
        [recs[i].state != 'OK' for i in range(n_warm, N)])] - med)
        .clip(0).sum()) if any(recs[i].state != 'OK'
                               for i in range(n_warm, N)) else 0.0
    kf_ids = [i for i in kf_at if i >= n_warm]
    kf_ex = float(sum(max(times[i] - med, 0) for i in kf_ids))
    print(f"excess in non-OK (init/lost) frames: {init_ex:.0f} ms; "
          f"excess in keyframe frames: {kf_ex:.0f} ms; "
          f"other: {total_excess - init_ex - kf_ex:.0f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
