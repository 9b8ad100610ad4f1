"""Benchmark: FULL-SYSTEM tracked frames/s on one GPU.

Runs on the GPU and refuses any other device. The headline
metric is the COMPLETE System — initialization, mapping, local BA,
keyframes, loop machinery all live — on a synthetic textured-room sequence
with exact ground truth, driven through the production block-pipelined
sequence runner (tracking.Tracker.run_blocked: K frames per device
dispatch, one batched readback per block; per-frame host bookkeeping,
keyframe creation and mapping run between blocks).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline: the reference binary, built from /root/reference and run
head-to-head on this machine (BASELINE.md "MEASURED baseline"), tracks at
33.7 ms/frame median on CPU — vs_baseline = 33.7 / median_ms_here. The
value is gated on actually tracking (>=90% frames) so a fast-but-lost run
cannot score.

Median AND mean are reported; warmup (compile) frames are excluded from
the median per the reference's own convention of steady-state medians
(Examples/Monocular/mono_tum.cc:112-120). Every result line names the
device: device_kind, device count, and the card's name and power limit.
"""
import json
import sys
import time

import numpy as np


def room_sequence(sensor_name: str, n_frames: int, **orbit):
    """The seeded textured room (640x480, fx 500, 1000 features) on an orbit
    trajectory (`orbit`: synth.orbit_trajectory's radius/forward): returns
    (cfg, frames, gt), frames as (timestamp, data) pairs for
    System.run_sequence, gt the [n, 3, 4] world->camera poses."""
    from dataclasses import replace
    from orbslam2_tpu.config import SlamConfig, Sensor, with_camera
    from orbslam2_tpu.io import synth

    sensor = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD,
              "stereo": Sensor.STEREO}[sensor_name]
    scene = synth.make_room(seed=0)
    gt = synth.orbit_trajectory(n_frames, **orbit)
    cfg = with_camera(
        SlamConfig(sensor=sensor,
                   th_depth=25.0 if sensor != Sensor.MONOCULAR else 35.0),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
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

    return cfg, [make_frame(i) for i in range(n_frames)], gt


def tracking_gate(row: dict) -> bool:
    """>=90% of post-init frames tracked AND initialization within the
    first 30% of the sequence — without the second clause a run that never
    initializes has n_trackable == 0 and the 0 >= 0 comparison would score
    a lost run."""
    return (row["tracked"] >= 0.9 * row["n_trackable"]
            and row["n_init"] <= 0.3 * row["n"])


def _full_system(sensor_name: str = "mono", n_frames: int = 180,
                 warmup: bool = True, **orbit):
    """One full-System run over the room sequence. warmup=True first drives
    a throwaway System over the same frames so the measured run's times
    exclude compilation; warmup=False measures a cold run."""
    from orbslam2_tpu.config import Sensor
    from orbslam2_tpu.system import System

    n_warm = 8    # compile + init frames excluded from the median
    cfg, frames_data, gt = room_sequence(sensor_name, n_frames, **orbit)
    sensor = cfg.sensor
    # Warmup pass: drive a throwaway System over the SAME sequence in the
    # SAME configuration so every steady-state program (init sweeps, the
    # block tracker, every BA/scatter bucket the run reaches, keyframe
    # mapping dispatches) is compiled before the measured run — XLA AOT
    # warmup, standard production practice. A shorter warmup leaves bucket
    # shapes uncompiled, and the measured run then re-traces mid-run.
    # The reference binary pays its startup (vocabulary load) outside its
    # per-frame instrumentation too (mono_tum.cc:78-95 times only Track*).
    if warmup:
        warm = System(cfg, async_mapping=True)
        warm.run_sequence(iter(frames_data), pipelined=True)
        warm.shutdown()
        _warm_ba_buckets(cfg)
    # Measured run: async_mapping=True is the production configuration —
    # keyframe mapping (triangulate/fuse/local-BA) runs on a worker thread
    # under MapState.lock, concurrent with block tracking, exactly the
    # reference's LocalMapping thread model (src/System.cpp:104-105).
    slam = System(cfg, async_mapping=True)
    t0 = time.perf_counter()
    tracked = slam.run_sequence(iter(frames_data), pipelined=True)
    wall = time.perf_counter() - t0
    slam.shutdown()   # drain the mapping worker before reading the map
    recs = slam.metrics.records
    times = np.array([r.track_ms for r in recs])
    med = float(np.median(times[n_warm:]))
    mean = float(times[n_warm:].mean())
    p90 = float(np.percentile(times[n_warm:], 90))
    p99 = float(np.percentile(times[n_warm:], 99))
    # monocular init legitimately consumes the first frames (parallax must
    # exceed the reference's 1-degree gate, src/Initializer.cpp:67); the
    # tracked-ratio gate therefore counts frames from the first OK frame,
    # exactly the population the reference's median-time instrumentation
    # covers (mono_tum.cc:112-120). n_init is reported for honesty.
    first_ok = next((i for i, r in enumerate(recs) if r.state == "OK"),
                    len(recs))
    n_trackable = n_frames - first_ok
    n_init = first_ok
    # ATE sanity (exact ground truth)
    ate = float("nan")
    try:
        from orbslam2_tpu.utils import evaluation as EV
        ts, poses = slam.tracker.trajectory()
        if len(poses) >= 10:
            sel = np.clip(np.round(np.asarray(ts) * 30).astype(int), 0,
                          n_frames - 1)
            ate = float(EV.ate_rmse(
                EV.camera_centers(poses), EV.camera_centers(gt[sel]),
                with_scale=(sensor == Sensor.MONOCULAR)))
    except Exception:
        pass
    return dict(median_ms=med, mean_ms=mean, p90_ms=p90, p99_ms=p99,
                n_timed=len(times) - n_warm, tracked=tracked,
                n=n_frames, n_trackable=n_trackable, n_init=n_init,
                wall_s=wall, keyframes=slam.map.n_keyframes, ate_m=ate)


def _warm_ba_buckets(cfg):
    """Force-load the small local-BA bucket programs the measured run can
    reach. The warmup System covers whatever buckets ITS nondeterministic
    keyframe schedule happened to hit; a missed (C, P, E) combo then costs
    a compiled-program cache load MID-measurement (a `ba` spike on one
    keyframe). Touching the 4 smallest combos here moves that cost into
    warmup deterministically."""
    import jax.numpy as jnp
    from orbslam2_tpu.ops import ba as BA

    cam = cfg.camera
    C = cfg.ba_cam_buckets[0]
    for P in cfg.ba_point_buckets[:2]:
        for E in cfg.ba_edge_buckets[:2]:
            prob = BA.BAProblem(
                cam_T=jnp.tile(jnp.eye(3, 4, dtype=jnp.float32), (C, 1, 1)),
                cam_fixed=jnp.arange(C) == 0,
                cam_valid=jnp.ones(C, bool),
                pts=jnp.tile(jnp.asarray([0.0, 0.0, 5.0], jnp.float32),
                             (P, 1)),
                pt_valid=jnp.ones(P, bool),
                e_cam=(jnp.arange(E) % C).astype(jnp.int32),
                e_pt=(jnp.arange(E) % P).astype(jnp.int32),
                e_obs=jnp.tile(jnp.asarray(
                    [cam.cx, cam.cy, 0.0], jnp.float32), (E, 1)),
                e_stereo=jnp.zeros(E, bool),
                e_info=jnp.ones(E, jnp.float32),
                e_valid=jnp.ones(E, bool))
            r = BA.ba_solve(prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
            np.asarray(r.cost)


def _microbench():
    """Fused tracking-step kernel with a per-frame readback (a per-frame
    np.asarray of the pose, as a live tracker needs it). Map frozen at
    frame 0: a kernel bench, not a system bench."""
    import jax
    import jax.numpy as jnp
    from orbslam2_tpu.config import OrbParams
    from orbslam2_tpu.engine_step import tracking_step
    from orbslam2_tpu.io import synth
    from orbslam2_tpu.ops import features as F

    params = OrbParams()
    H, W = 480, 640
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    scene = synth.make_scene(seed=0, width=W, height=H, fx=fx, fy=fy)
    gt = synth.orbit_trajectory(45)
    sf = jnp.asarray(F.scale_factors(params))
    sig2 = jnp.asarray(F.sigma2_per_octave(params))
    pc = scene.pts @ gt[0][:, :3].T + gt[0][:, 3]
    u_s = (fx * pc[:, 0] / pc[:, 2] + cx).astype(np.float32)
    v_s = (fy * pc[:, 1] / pc[:, 2] + cy).astype(np.float32)
    half_px = (scene.size_world * fx / pc[:, 2]).astype(np.float32)

    @jax.jit
    def build_map(img0, scene_pts, u_s, v_s, half_px):
        f0 = F.extract_orb(img0, params, H, W)
        d2 = ((u_s[None, :] - f0.xy[:, 0:1]) ** 2
              + (v_s[None, :] - f0.xy[:, 1:2]) ** 2)
        j = jnp.argmin(d2, axis=1)
        dj = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
        gate = f0.valid & (dj < (2.0 * half_px[j]) ** 2)
        return scene_pts[j], f0.desc, f0.octave, gate

    img0 = jnp.asarray(synth.render(scene, gt[0], seed=0))
    jp = build_map(img0, jnp.asarray(scene.pts.astype(np.float32)),
                   jnp.asarray(u_s), jnp.asarray(v_s), jnp.asarray(half_px))
    args = dict(params=params, height=H, width=W, fx=fx, fy=fy, cx=cx,
                cy=cy, bf=0.0)
    imgs = [jnp.asarray(synth.render(scene, gt[i], seed=i))
            for i in range(1, 45)]
    T = jnp.asarray(gt[0])
    for i in range(4):
        T, ninl, _ = tracking_step(imgs[i], T, *jp, sf, sig2, **args)
    _ = np.asarray(T)
    # per-frame readback loop
    T = jnp.asarray(gt[0])
    inls = []
    t0 = time.perf_counter()
    for i in range(4, 44):
        T, ninl, _ = tracking_step(imgs[i], T, *jp, sf, sig2, **args)
        _ = np.asarray(T)
        inls.append(ninl)
    per_frame = (time.perf_counter() - t0) / 40 * 1e3
    med_inl = int(np.median([int(x) for x in inls]))
    return per_frame, med_inl


def main():
    from orbslam2_tpu.utils import (gpu_name_and_power_limit, require_gpu,
                                    setup_compile_cache)
    try:
        device = require_gpu()
    except RuntimeError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    card = gpu_name_and_power_limit()
    setup_compile_cache()
    dev_label = (f"{device['kind']} x{device['count']} "
                 f"(nvidia-smi: {card})")
    print(f"# device: {dev_label}", file=sys.stderr, flush=True)

    full = _full_system()
    tracking_ok = tracking_gate(full)
    fps = 1000.0 / full["median_ms"] if full["median_ms"] > 0 else 0.0
    REF_MEDIAN_MS = 33.7  # measured reference binary median (BASELINE.md)
    result = {
        "metric": "tracked_frames_per_s_per_chip",
        "value": round(fps, 2) if tracking_ok else 0.0,
        "unit": "fps",
        "vs_baseline": (round(REF_MEDIAN_MS / full["median_ms"], 3)
                        if tracking_ok else 0.0),
        "envelope": {
            "median_ms": full["median_ms"],
            "mean_ms": full["mean_ms"],
            "p90_ms": full["p90_ms"],
            "ref_median_ms": REF_MEDIAN_MS,
        },
        "device": device,
        "card": card,
    }
    # flush immediately: stdout is block-buffered under a pipe and the
    # headline JSON must survive even if a driver timeout kills the
    # process during the auxiliary rows below
    print(json.dumps(result), flush=True)
    print(f"# FULL SYSTEM: median {full['median_ms']:.1f} ms/frame "
          f"(mean {full['mean_ms']:.1f}), tracked {full['tracked']}/"
          f"{full['n_trackable']} post-init ({full['n_init']} mono-init "
          f"frames of {full['n']}), keyframes {full['keyframes']}, "
          f"ATE {full['ate_m']*100:.2f} cm, wall {full['wall_s']:.1f} s, "
          f"device {dev_label}; vs_baseline = "
          f"{REF_MEDIAN_MS} ms (measured reference median) / ours",
          file=sys.stderr, flush=True)
    # multi-sensor rows (the reference's primary published results are
    # stereo/RGB-D — BASELINE.md): full-System medians on the same room
    for sensor_name in ("rgbd", "stereo"):
        try:
            row = _full_system(sensor_name, n_frames=48)
            ok = tracking_gate(row)
            print(f"# FULL SYSTEM [{sensor_name}]: median "
                  f"{row['median_ms']:.1f} ms/frame "
                  f"(mean {row['mean_ms']:.1f}), tracked {row['tracked']}/"
                  f"{row['n_trackable']}, keyframes {row['keyframes']}, "
                  f"metric ATE {row['ate_m']*100:.2f} cm, gate "
                  f"{'ok' if ok else 'FAILED'}, device {dev_label}",
                  file=sys.stderr)
        except Exception as e:
            print(f"# FULL SYSTEM [{sensor_name}] failed "
                  f"({type(e).__name__}: {e})", file=sys.stderr)
    try:
        micro_ms, med_inl = _microbench()
        print(f"# microbench (map-frozen fused step, per-frame pose "
              f"readback): {micro_ms:.2f} ms/frame, median inliers "
              f"{med_inl}, device {dev_label}", file=sys.stderr)
    except Exception as e:
        print(f"# microbench failed ({type(e).__name__}: {e})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
