"""End-to-end demo: run the full SLAM pipeline on a synthetic sequence.

Usage: python -m orbslam2_tpu.run_synth [n_frames] [--platform gpu|cpu]

Runs on the GPU by default and fails if there is none; `--platform cpu` is
the explicit opt-in for a CPU run.

Renders a corner-rich synthetic scene with exact ground truth, tracks it,
and reports per-frame state plus final ATE RMSE (Sim3-aligned, the
TUM-benchmark metric the reference is evaluated with).
"""
from __future__ import annotations

import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    platform = "gpu"
    if "--platform" in argv:
        i = argv.index("--platform")
        platform = argv[i + 1]
        del argv[i:i + 2]
    use_viewer = "--viewer" in argv
    if use_viewer:
        argv.remove("--viewer")
    from .utils import select_platform, setup_compile_cache
    select_platform(platform)
    setup_compile_cache()

    import numpy as np
    from .config import SlamConfig, Sensor, with_camera
    from .io import synth
    from .system import System
    from .utils.evaluation import ate_rmse, camera_centers

    n_frames = int(argv[0]) if argv else 40

    scene = synth.make_room(seed=0)
    gt = synth.orbit_trajectory(n_frames)
    cfg = with_camera(
        SlamConfig(sensor=Sensor.MONOCULAR),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=scene.width, height=scene.height)

    slam = System(cfg, use_viewer=use_viewer)
    times = []
    for i in range(n_frames):
        img = synth.render_room(scene, gt[i], seed=i)
        t0 = time.perf_counter()
        pose = slam.track_monocular(img, i / 30.0)
        times.append(time.perf_counter() - t0)
        stats = slam.map_stats()
        print(f"frame {i:3d}  state={stats['state']:<15} "
              f"kfs={stats['keyframes']:3d} pts={stats['points']:5d} "
              f"inliers={stats['last_inliers']:4d} "
              f"{'pose ok' if pose is not None else 'no pose'}  "
              f"{times[-1]*1e3:6.1f} ms", flush=True)

    slam.shutdown()  # drain mapping queue / background GBA, stop viewer
    ts, est = slam.tracker.trajectory()
    if len(est) >= 10:
        frame_ids = np.round(np.asarray(ts) * 30.0).astype(int)
        ate = ate_rmse(camera_centers(est), camera_centers(gt[frame_ids]))
        print(f"\ntracked {len(est)}/{n_frames} frames")
        print(f"ATE RMSE (Sim3-aligned): {ate*100:.2f} cm")
        med = np.median(times[5:]) if len(times) > 5 else np.median(times)
        print(f"median frame time: {med*1e3:.1f} ms ({1.0/med:.1f} fps)")
    else:
        print("\nTRACKING FAILED: fewer than 10 frames tracked")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
