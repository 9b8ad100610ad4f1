"""System facade: the public entry point of the engine.

JAX-native redesign of src/System.cpp: constructs the map, tracker, local
mapper (and loop closer once present), wires them together, and exposes the
reference's public API surface (include/System.h:63-110):

    System(cfg).track_monocular(img, t) -> Tcw [3,4] or None
    track_stereo(left, right, t) / track_rgbd(rgb, depth, t)
    save_trajectory_tum / save_keyframe_trajectory_tum / save_trajectory_kitti
    reset() / shutdown()

The reference's thread triad (System.cpp:97-126) is a host-side pipeline:
tracking runs inline per frame; local mapping and loop closing run per
keyframe (synchronously by default; `async_mapping=True` defers them to a
background executor thread with a bounded queue — same structure as the
reference's InsertKeyFrame handoff, src/LocalMapping.cpp:147-153).
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np

from .config import SlamConfig, Sensor
from .io import trajectory as traj_io
from .io.vocabulary import Vocabulary
from .global_ba import GlobalBA
from .local_mapping import LocalMapper
from .map.keyframe_db import KeyFrameDatabase
from .map.mapstate import MapState
from .ops.features import padded_capacity
from .loop_closing import LoopCloser
from .relocalization import Relocalizer
from .tracking import Tracker, TrackState

DEFAULT_VOCAB = Path(__file__).parent / "data" / "vocab_default.npz"


class System:
    def __init__(self, cfg: SlamConfig, async_mapping: bool = False,
                 vocabulary: Vocabulary | str | None = None,
                 use_viewer: bool = False, viewer_port: int = 0):
        self.cfg = cfg
        n_feat = padded_capacity(
            cfg.orb.n_features * (2 if cfg.sensor == Sensor.MONOCULAR else 1))
        self.map = MapState(cfg, n_feat)
        if vocabulary is None:
            vocabulary = Vocabulary.load(DEFAULT_VOCAB)
        elif isinstance(vocabulary, (str, Path)):
            vocabulary = (Vocabulary.load(vocabulary)
                          if str(vocabulary).endswith((".npz",))
                          else __import__("orbslam2_tpu.io.vocabulary",
                                          fromlist=["load_orbvoc_text"]
                                          ).load_orbvoc_text(vocabulary))
        self.vocabulary = vocabulary
        self.kf_db = KeyFrameDatabase(cfg, self.map, vocabulary.n_words)
        self.relocalizer = Relocalizer(cfg, self.map, vocabulary, self.kf_db)
        self.local_mapper = LocalMapper(cfg, self.map, kf_db=self.kf_db,
                                        bow_encode=self.relocalizer.frame_bow)
        self.global_ba = GlobalBA(cfg, self.map)
        self.loop_closer = LoopCloser(cfg, self.map, self.kf_db,
                                      self.local_mapper,
                                      global_ba=self.global_ba)
        self.local_mapper.loop_closer = self.loop_closer
        self.tracker = Tracker(cfg, self.map, self._mapper_proxy(),
                               relocalizer=self.relocalizer)
        self.tracker.reset_callback = self.reset
        from .utils.metrics import MetricsLog
        self.metrics = MetricsLog()
        self._async = async_mapping
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        if async_mapping:
            self._queue = queue.Queue(maxsize=3)
            self._worker = threading.Thread(target=self._mapping_loop, daemon=True)
            self._worker.start()
        # optional live viewer thread (System ctor bUseViewer,
        # src/System.cpp:111-114)
        self.viewer = None
        self._reset_pending = False
        if use_viewer:
            from .viz.live_viewer import LiveViewer
            self.viewer = LiveViewer(self, port=viewer_port)
            print(f"[viewer] http://{self.viewer.host}:{self.viewer.port}/",
                  flush=True)

    # --------------------------------------------------------------- pipeline
    def _mapper_proxy(self):
        sys_self = self

        class _Proxy:
            def __init__(self):
                # deferred keyframes that hit a momentarily full queue
                # (nearly unreachable: the keyframe decision applies the
                # reference's <3 backpressure via queue_depth); retried on
                # the next proxy call instead of processing inline, which
                # would race the worker mid-keyframe (ADVICE r3 item 2)
                self._pending: list[int] = []

            def _flush_pending(self):
                while self._pending:
                    try:
                        sys_self._queue.put_nowait(self._pending[0])
                    except queue.Full:
                        return
                    self._pending.pop(0)

            def process(self, kf):
                if sys_self._async:
                    # NEVER block here: the tracker calls this while holding
                    # MapState.lock, and the mapping worker needs that lock
                    # to drain the queue — a blocking put() deadlocks.
                    self._flush_pending()
                    try:
                        sys_self._queue.put_nowait(kf)
                    except queue.Full:
                        self._pending.append(kf)
                else:
                    sys_self.local_mapper.process(kf)

            def queue_depth(self):
                """KeyframesInQueue (src/LocalMapping.cpp:941): drives the
                keyframe-decision backpressure (src/Tracking.cpp:1417)."""
                if not sys_self._async or sys_self._queue is None:
                    return 0
                self._flush_pending()
                return sys_self._queue.qsize() + len(self._pending)

            def idle(self):
                """AcceptKeyFrames (src/LocalMapping.cpp:794): true when the
                mapper has neither queued nor in-flight work. Counted via
                the queue's unfinished-task counter (task_done fires after
                process() returns), closing the get()->busy TOCTOU window
                (ADVICE r3 item 3)."""
                if not sys_self._async:
                    return True
                self._flush_pending()
                return (sys_self._queue.unfinished_tasks == 0
                        and not self._pending)

            def interrupt_ba(self):
                """LocalMapping::InterruptBA (src/Tracking.cpp:1412): the
                tracker wants to insert a keyframe while the mapper is busy
                — abort the running local BA so the queue drains faster."""
                sys_self.local_mapper.interrupt_ba()

            def run_ba(self, *a, **kw):
                return sys_self.local_mapper.run_ba(*a, **kw)

            def register(self, kf):
                sys_self.local_mapper.register_keyframe(kf)

        self._proxy = _Proxy()
        return self._proxy

    def _mapping_loop(self):
        while True:
            kf = self._queue.get()
            if kf is None:
                self._queue.task_done()
                return
            try:
                self.local_mapper.process(kf)
            finally:
                self._queue.task_done()

    # ------------------------------------------------------------- public API
    def track_monocular(self, img: np.ndarray, timestamp: float):
        assert self.cfg.sensor == Sensor.MONOCULAR
        gray = self._gray(img)
        return self._tracked(timestamp, lambda: self.tracker.process_image(
            gray, timestamp), viewer_img=gray)

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        assert self.cfg.sensor == Sensor.RGBD
        gray = self._gray(img)
        return self._tracked(timestamp, lambda: self.tracker.process_image(
            gray, timestamp, depth_map=depth), viewer_img=gray)

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float):
        assert self.cfg.sensor == Sensor.STEREO
        gray = self._gray(left)
        return self._tracked(timestamp, lambda: self.tracker.process_image(
            gray, timestamp, right_img=self._gray(right)), viewer_img=gray)

    def _tracked(self, timestamp: float, fn, viewer_img=None):
        import time as _t
        if self._reset_pending:
            # reset requested off-thread (viewer menu): apply it here on
            # the tracking thread, the reference's mbReset handshake
            # (src/System.cpp:255-262)
            self._reset_pending = False
            self.reset()
        kfs_before = self.map.n_keyframes
        t0 = _t.perf_counter()
        pose = fn()
        dt = (_t.perf_counter() - t0) * 1e3
        if self.viewer is not None and viewer_img is not None \
                and self.tracker.last_frame is not None:
            self.viewer.update(viewer_img, self.tracker.last_frame)
        self.metrics.append(
            frame_id=len(self.metrics.records), timestamp=timestamp,
            state=self.tracker.state.name,
            inliers=self.tracker.matches_inliers,
            keyframes=self.map.n_keyframes, points=self.map.n_points,
            loops=self.loop_closer.n_loops_closed, track_ms=dt,
            created_keyframe=self.map.n_keyframes != kfs_before)
        return pose

    def run_sequence(self, frames, progress_every: int = 0,
                     pipelined: bool = True):
        """Sequence runner.

        pipelined=True (default): the production block driver
        (tracking.Tracker.run_blocked) — K frames per device dispatch with
        one block kept in flight, so sequence throughput is bounded by
        device compute and transfers, not by the host<->device round
        trip. Init, loss,
        relocalization and localization-only mode fall back to the sync
        path automatically. pipelined=False: one fused dispatch + blocking
        readback per frame (lowest per-frame latency).

        frames: iterable of (timestamp, dict) with keys image [+depth|right].
        Returns the number of tracked frames.
        """
        import time as _t
        tracked = 0
        n = 0
        if pipelined and not self.localization_mode_active:
            for ts, pose in self.tracker.run_blocked(frames, self._gray):
                # amortized per-frame cost (block share + own finish time),
                # maintained by the driver — the raw yield-to-yield gap
                # would charge a whole block to its first frame
                dt = self.tracker.last_frame_ms
                self.metrics.append(
                    frame_id=len(self.metrics.records), timestamp=ts,
                    state=self.tracker.state.name,
                    inliers=self.tracker.matches_inliers,
                    keyframes=self.map.n_keyframes,
                    points=self.map.n_points,
                    loops=self.loop_closer.n_loops_closed, track_ms=dt,
                    created_keyframe=False)
                tracked += int(pose is not None)
                n += 1
                if progress_every and n % progress_every == 0:
                    print(f"frame {n}: {self.map_stats()}", flush=True)
            return tracked
        for ts, data in frames:
            gray = self._gray(data["image"])
            pose = self._tracked(ts, lambda: self.tracker.process_image(
                gray, ts,
                depth_map=data.get("depth"),
                right_img=(self._gray(data["right"]) if "right" in data else None)),
                viewer_img=gray)
            tracked += int(pose is not None)
            n += 1
            if progress_every and n % progress_every == 0:
                print(f"frame {n}: {self.map_stats()}", flush=True)
        return tracked

    @property
    def localization_mode_active(self) -> bool:
        return self.tracker.localization_only

    @staticmethod
    def _gray(img: np.ndarray) -> np.ndarray:
        if img.ndim == 3:
            img = img @ np.array([0.299, 0.587, 0.114], np.float32)
        if img.dtype == np.uint8:
            return img
        # canonicalize to u8: shipping u8 is 4x cheaper than f32 AND keeps
        # the hot block program at ONE traced variant regardless of data
        # source (a float-gray dataset would otherwise trace and compile a
        # second copy of the block program; sensor images are 8-bit
        # to begin with, matching the reference's cv::Mat CV_8U input)
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    # ------------------------------------------------------------------ state
    def activate_localization_mode(self):
        """Tracking-only against the frozen map
        (System::ActivateLocalizationMode, src/System.cpp:267)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    @property
    def tracking_state(self) -> TrackState:
        return self.tracker.state

    def map_stats(self) -> dict:
        return {
            "keyframes": self.map.n_keyframes,
            "points": self.map.n_points,
            "state": self.tracker.state.name,
            "last_inliers": self.tracker.matches_inliers,
            "loops": self.loop_closer.n_loops_closed,
        }

    def shutdown(self):
        """System::Shutdown (src/System.cpp:285): drain the mapping queue
        and wait for a running global BA, applying its result."""
        if self.viewer is not None:
            self.viewer.stop()
            self.viewer = None
        if self._async and self._queue is not None:
            # drain deferred keyframes first (blocking puts are safe here:
            # the tracking thread holds no map lock during shutdown)
            for kf in getattr(self._proxy, "_pending", []):
                self._queue.put(kf)
            if hasattr(self._proxy, "_pending"):
                self._proxy._pending.clear()
            self._queue.put(None)
            self._worker.join(timeout=30)
        self.global_ba.wait_and_apply()

    def request_reset(self):
        """Off-thread reset request (viewer menu / System::Reset flag,
        src/System.cpp:279): applied on the tracking thread at the next
        track_* call."""
        self._reset_pending = True

    def reset(self):
        """System::Reset (src/System.cpp:279; Tracking::Reset :2030)."""
        self.global_ba.abort_and_join()
        n_feat = self.map.kf_xy.shape[1]
        self.map = MapState(self.cfg, n_feat)
        self.kf_db = KeyFrameDatabase(self.cfg, self.map, self.vocabulary.n_words)
        self.relocalizer = Relocalizer(self.cfg, self.map, self.vocabulary,
                                       self.kf_db)
        self.local_mapper = LocalMapper(self.cfg, self.map, kf_db=self.kf_db,
                                        bow_encode=self.relocalizer.frame_bow)
        self.global_ba = GlobalBA(self.cfg, self.map)
        self.loop_closer = LoopCloser(self.cfg, self.map, self.kf_db,
                                      self.local_mapper,
                                      global_ba=self.global_ba)
        self.local_mapper.loop_closer = self.loop_closer
        self.tracker = Tracker(self.cfg, self.map, self._mapper_proxy(),
                               relocalizer=self.relocalizer)
        self.tracker.reset_callback = self.reset

    # ------------------------------------------------------------- checkpoint
    def save_map(self, path):
        """Map checkpoint (capability gain over the reference, where
        SaveMap/LoadMap is a TODO — include/System.h:112-114)."""
        self.map.save(path)

    def load_map(self, path):
        """Restore a saved map and re-enter localization against it: the
        keyframe database is rebuilt and the tracker set LOST so the next
        frame relocalizes."""
        from .tracking import TrackState
        self.global_ba.abort_and_join()
        self.map = MapState.load(path, self.cfg)
        self.kf_db = KeyFrameDatabase(self.cfg, self.map, self.vocabulary.n_words)
        self.relocalizer = Relocalizer(self.cfg, self.map, self.vocabulary,
                                       self.kf_db)
        self.local_mapper = LocalMapper(self.cfg, self.map, kf_db=self.kf_db,
                                        bow_encode=self.relocalizer.frame_bow)
        self.global_ba = GlobalBA(self.cfg, self.map)
        self.loop_closer = LoopCloser(self.cfg, self.map, self.kf_db,
                                      self.local_mapper,
                                      global_ba=self.global_ba)
        self.local_mapper.loop_closer = self.loop_closer
        self.tracker = Tracker(self.cfg, self.map, self._mapper_proxy(),
                               relocalizer=self.relocalizer)
        for k in self.map.kf_ids:
            self.local_mapper.register_keyframe(int(k))
        self.tracker.state = TrackState.LOST
        self.tracker.ref_kf = int(self.map.kf_ids[-1]) if self.map.n_keyframes else -1

    # -------------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path):
        ts, poses = self.tracker.trajectory()
        traj_io.save_tum(path, ts, poses)

    def save_keyframe_trajectory_tum(self, path):
        ids = self.map.kf_ids
        order = ids[np.argsort(self.map.kf_timestamp[ids])]
        traj_io.save_tum(path, self.map.kf_timestamp[order],
                         self.map.kf_pose[order])

    def save_trajectory_kitti(self, path):
        ts, poses = self.tracker.trajectory()
        traj_io.save_kitti(path, poses)
