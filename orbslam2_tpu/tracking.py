"""Per-frame tracking: the front-end state machine.

JAX-native redesign of src/Tracking.cpp. The reference's 2000-line
pointer-walking state machine becomes a thin host orchestrator around a
handful of jitted device programs per frame:

    extract_orb -> (match_motion_model | match_descriptors_ratio)
                -> pose_optimize -> match_local_points -> pose_optimize

State machine {NOT_INITIALIZED, OK, LOST} (include/Tracking.h:81-87; the
reference's SYSTEM_NOT_READY/NO_IMAGES_YET collapse into construction).
Monocular initialization follows Tracking::MonocularInitialization (:729) +
CreateInitialMapMonocular (:834): windowed matching, batched H/F RANSAC,
initial two-keyframe map, global BA, median-depth scale normalization.

Keyframe decision mirrors NeedNewKeyFrame (:1308) conditions c1a/c1b/c2.
Relocalization (BoW + EPnP RANSAC) lives in relocalization.py.
"""
from __future__ import annotations

from enum import IntEnum

import jax
import jax.numpy as jnp
import numpy as np

from . import engine_step as ES
from .config import SlamConfig, Sensor
from .frontend.frame import Frame, FrameBuilder
from .frontend import matcher as FM
from .geometry import se3
from .geometry import se3_np
from .map.mapstate import MapState
from .geometry import camera as cam_mod
from .ops import ba as BA
from .ops import features as F
from .ops import matching as M
from .ops import pose_opt as PO
from .ops import refine as RF
from .ops import twoview as TV


class TrackState(IntEnum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


def _np(x):
    return np.asarray(x)


DEPTH_WIRE_Q = 2048.0  # wire quantization for float depth (power of two:
#                        exact f32 rescale; 0.49 mm resolution, 32 m range)


def _depth_wire(depth_map: np.ndarray, cfg_factor: float):
    """Depth map in its cheapest lossless wire form: (u16 array, device
    scale-to-meters). A float32 depth frame is 1.2 MB at 480x640 — 4x the
    u8 image — so depth
    ships as uint16 in native sensor units where possible (TUM depth PNGs
    ARE u16; src/Frame.cpp:773 ComputeStereoFromRGBD consumes
    raw/DepthMapFactor) and as 1/2048-m fixed point otherwise. The device
    program multiplies by the returned factor (engine_step._frame_core)."""
    if depth_map.dtype == np.uint16:
        return depth_map, float(cfg_factor)
    if cfg_factor < 1.0 / 1024.0:
        # float carrying raw u16 sensor units (dataset loaders decode the
        # PNG then cast): the round trip through u16 is exact
        return np.round(depth_map).astype(np.uint16), float(cfg_factor)
    m = np.asarray(depth_map, np.float32) * np.float32(cfg_factor)
    q = m * np.float32(DEPTH_WIRE_Q)
    # out-of-range depth (>=32 m) becomes 0 = "no depth" rather than a
    # wrong clipped value; the reference treats d<=0 as no-measurement
    q = np.where((q >= 65535.0) | (q < 0.0), 0.0, q)
    return q.astype(np.uint16), 1.0 / DEPTH_WIRE_Q


def _ensure_patch(frame: Frame):
    """Materialize a fused frame's photometric windows from the device
    (deferred: they are ~1 MB/frame and only needed for fallback matching,
    keyframe creation, or re-upload after a broken device chain). The block
    driver stores (stacked [K,N,15,15] handle, k) to avoid per-frame eager
    device slicing."""
    if frame.patch is None and getattr(frame, "_patch_dev", None) is not None:
        pd = frame._patch_dev
        if isinstance(pd, tuple):
            stacked, k = pd
            frame.patch = np.asarray(stacked[k]).astype(np.float32)
        else:
            frame.patch = np.asarray(pd).astype(np.float32)
        frame._patch_dev = None


class Tracker:
    def __init__(self, cfg: SlamConfig, mp: MapState, local_mapper=None,
                 relocalizer=None):
        self.cfg = cfg
        self.map = mp
        self.local_mapper = local_mapper
        self.relocalizer = relocalizer
        self.reset_callback = None  # wired by System (System::Reset path)
        cam = cfg.camera
        self.K = np.array(cam.K, np.float32)
        self.sf = F.scale_factors(cfg.orb)
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        self.builder = FrameBuilder(cfg)
        # mono init uses a double feature budget (src/Tracking.cpp:148-149)
        self.init_builder = (FrameBuilder(cfg, cfg.orb.n_features * 2)
                             if cfg.sensor == Sensor.MONOCULAR else self.builder)

        self.state = TrackState.NOT_INITIALIZED
        self.localization_only = False  # ActivateLocalizationMode
        self.init_ref: Frame | None = None
        self.last_frame: Frame | None = None
        self.velocity: np.ndarray | None = None  # T_cur_last [3,4]
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.init_frame_id: int = -1
        self.last_reloc_frame_id: int = -1  # mnLastRelocFrameId
        self.matches_inliers: int = 0
        self._rng = jax.random.PRNGKey(0)
        # trajectory log: (timestamp, ref_kf, T_frame_wrt_refkf, lost)
        # (mlRelativeFramePoses etc., include/Tracking.h:109-112)
        self.frame_log: list[tuple[float, int, np.ndarray, bool]] = []
        self.n_lost_frames = 0
        # fused-path state: device mirror of the map point table (re-uploaded
        # when map.generation changes) and the last frame's device-side
        # feature arrays (chained between fused frames to avoid re-upload)
        self._mirror = None
        self._mirror_gen = -1
        self._last_dev = None
        self._last_dev_frame_id = -1
        self._sf_dev = jnp.asarray(self.sf)
        self._sig2_dev = jnp.asarray(self.sigma2)
        # fused mono-init state: the reference attempt's device outputs
        # (chained — never re-uploaded), its (frame_id, ts, n_valid), and
        # the all-zero ref placeholder for the no-reference dispatch
        self._init_out = None
        self._init_meta = None
        self._init_ref_args = None
        self._init_zero = None

    # ------------------------------------------------------------------ utils
    def _next_key(self):
        self._rng, k = jax.random.split(self._rng)
        return k

    def _refine_measurements(self, frame: Frame, mask: np.ndarray,
                             templates: np.ndarray):
        """Feature-metric re-measurement (ops/refine.py): align the masked
        features' photometric windows to the given per-feature templates
        [N, 11, 11] and shift their measured positions by the recovered
        subpixel offset. Skips features already refined this frame (windows
        are centered on the ORIGINAL detection, so a second application
        would double-count the shift)."""
        _ensure_patch(frame)
        if frame.patch is None:
            return
        if not hasattr(frame, "_refined"):
            frame._refined = np.zeros(frame.capacity, bool)
        mask = mask & ~frame._refined
        if not mask.any():
            return
        delta, ok = RF.refine_offsets(
            jnp.asarray(frame.patch), jnp.asarray(templates.astype(np.float32)),
            jnp.asarray(mask))
        ok = _np(ok) & mask
        if not ok.any():
            return
        delta = _np(delta)
        frame._refined |= ok
        sf = self.sf[np.clip(frame.octave, 0, len(self.sf) - 1)]
        frame.xy_raw = frame.xy_raw + delta * (sf * ok)[:, None]
        und = _np(cam_mod.undistort_pixels(
            self.cfg.camera, jnp.asarray(frame.xy_raw)))
        # the offset is measured in raw-image pixels; for the undistorted
        # coords this assumes a locally-identity undistortion Jacobian (exact
        # for distortion-free cameras, <1% error at typical k1)
        frame.xy = np.where(ok[:, None], und, frame.xy)
        # the virtual/matched right-u shifts with u (keeps disparity for
        # stereo, keeps ur == u - bf/z for RGB-D)
        has_ur = ok & (frame.ur >= 0)
        frame.ur = np.where(has_ur, frame.ur + delta[:, 0] * sf, frame.ur)

    def _refine_against_points(self, frame: Frame, feat_mask: np.ndarray):
        """Refine the masked features against their bound map points'
        anchor templates."""
        pt = np.clip(frame.pt_idx, 0, None)
        mask = feat_mask & (frame.pt_idx >= 0)
        if not mask.any():
            return
        self._refine_measurements(frame, mask, self.map.pt_patch[pt])

    def _pose_optimize(self, frame: Frame) -> int:
        """Run motion-only BA on the frame's current point associations and
        prune outlier associations (Tracking.cpp:1034-1057 pattern)."""
        pt = frame.pt_idx
        bound = (pt >= 0) & frame.valid & self.map.pt_valid[np.clip(pt, 0, None)]
        ok = bound | (frame.tmp_valid & frame.valid)
        pts_xyz = np.where(bound[:, None], self.map.pt_xyz[np.clip(pt, 0, None)],
                           frame.tmp_xyz)
        obs = np.concatenate([frame.xy, frame.ur[:, None]], -1).astype(np.float32)
        is_st = frame.ur >= 0
        info = (1.0 / self.sigma2)[np.clip(frame.octave, 0, len(self.sigma2) - 1)]
        cam = self.cfg.camera
        res = PO.pose_optimize(
            jnp.asarray(frame.pose), jnp.asarray(pts_xyz), jnp.asarray(obs),
            jnp.asarray(is_st & ok), jnp.asarray(info.astype(np.float32)),
            jnp.asarray(ok), cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        frame.pose = _np(res.T)
        inl = _np(res.inliers)
        frame.pt_idx = np.where(ok & ~inl, -1, frame.pt_idx)
        frame.tmp_valid = frame.tmp_valid & inl
        # count only MAP-point inliers: temporal VO matches aid the
        # optimization but must not feed tracking-quality / keyframe
        # decisions (the reference's nmatchesMap, src/Tracking.cpp:1230-1241)
        return int((inl & bound).sum())

    # ------------------------------------------------------------- main entry
    def process_image(self, img: np.ndarray, timestamp: float,
                      depth_map: np.ndarray | None = None,
                      right_img: np.ndarray | None = None) -> np.ndarray | None:
        if (self.state == TrackState.OK and self.last_frame is not None
                and self.last_frame.pose is not None):
            # steady state: the whole per-frame hot path is ONE device
            # dispatch + one batched readback (engine_step.track_frame_full).
            # velocity None (first frame after init/reloc) runs the same
            # program with a ZERO-velocity prediction; on a short 30 fps
            # baseline the windowed motion-model search covers it, and the
            # staged TrackReferenceKeyFrame fallback still fires when it
            # does not (the reference goes straight to BoW matching here,
            # src/Tracking.cpp:381-387 — same fallback, one dispatch later)
            return self._track_fused(img, timestamp, depth_map, right_img)
        if (self.state == TrackState.NOT_INITIALIZED
                and self.cfg.sensor == Sensor.MONOCULAR):
            # fused mono init: one dispatch + a 16-float readback per
            # attempt instead of 3-4 staged dispatches with readbacks
            return self._mono_init_fused(img, timestamp)
        builder = (self.init_builder
                   if self.state == TrackState.NOT_INITIALIZED else self.builder)
        frame = builder.build(img, timestamp, depth_map=depth_map,
                              right_img=right_img)
        return self.track(frame)

    def track(self, frame: Frame) -> np.ndarray | None:
        # staged (non-fused) path: init, fallbacks, relocalization. Rare in
        # steady state — hold the map lock for the whole frame (the
        # reference also holds mMutexMapUpdate across Track(),
        # src/Tracking.cpp:336).
        with self.map.lock:
            return self._track_locked(frame)

    def _track_locked(self, frame: Frame) -> np.ndarray | None:
        if self.state == TrackState.NOT_INITIALIZED:
            if self.cfg.sensor == Sensor.MONOCULAR:
                self._monocular_initialization(frame)
            else:
                self._stereo_initialization(frame)
            if self.state == TrackState.OK:
                self._log_frame(frame, lost=False)
                return frame.pose
            return None

        # CheckReplacedInLastFrame (src/Tracking.cpp:372): the last frame's
        # point ids may have been replaced/culled by mapping or loop fusion;
        # follow redirects / drop dead ids, then un-quarantine freed slots
        # (safe now — no frame holds stale ids any more).
        if self.last_frame is not None:
            self.last_frame.pt_idx = self.map.resolve_point_ids(
                self.last_frame.pt_idx)
        self.map.release_retired_points()

        ok = False
        if self.state == TrackState.OK:
            if self.velocity is not None:
                ok = self._track_with_motion_model(frame)
            if not ok:
                ok = self._track_reference_keyframe(frame)
        else:  # LOST
            ok = self._relocalize(frame)

        if ok:
            ok = self._track_local_map(frame)

        return self._finish_frame(frame, ok)

    def _finish_frame(self, frame: Frame, ok: bool) -> np.ndarray | None:
        """Shared per-frame tail: state transition, velocity update, keyframe
        decision, trajectory log (the end of Tracking::Track,
        src/Tracking.cpp:526-626)."""
        if ok:
            self.state = TrackState.OK
            if self.last_frame is not None and self.last_frame.pose is not None:
                # orthonormalized: f32 scale leakage in this composition is
                # otherwise amplified geometrically by the prediction
                # recurrence (se3_np.orthonormalize)
                self.velocity = se3_np.orthonormalize(se3_np.compose(
                    frame.pose, se3_np.inverse(self.last_frame.pose)))
            # localization-only mode: track against the frozen map
            # (System::ActivateLocalizationMode, src/System.cpp:267)
            if not self.localization_only and self._need_new_keyframe(frame):
                self._create_keyframe(frame)
            self.n_lost_frames = 0
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.n_lost_frames += 1
            # reset when lost right after initialization with a tiny map
            # (src/Tracking.cpp:590-598). Unlike the reference we also require
            # the loss to be EARLY (our keyframe culling keeps maps small
            # forever, so a pure map-size gate would fire on mature sessions)
            early = (self.init_frame_id >= 0 and
                     frame.frame_id - self.init_frame_id <= 10)
            if (not self.localization_only and self.map.n_keyframes <= 5
                    and self.n_lost_frames == 1 and early
                    and self.reset_callback is not None
                    and self.map.n_keyframes > 0):
                self.reset_callback()

        self._log_frame(frame, lost=not ok)
        self.last_frame = frame
        return frame.pose if ok else None

    def _log_frame(self, frame: Frame, lost: bool):
        if frame.pose is None or self.ref_kf < 0:
            self.frame_log.append((frame.timestamp, -1, np.eye(3, 4, dtype=np.float32), True))
            return
        T_ref = self.map.kf_pose[self.ref_kf]
        T_rel = se3_np.compose(frame.pose, se3_np.inverse(T_ref))
        self.frame_log.append((frame.timestamp, self.ref_kf, T_rel, lost))

    # --------------------------------------------------------- initialization
    def _monocular_initialization(self, frame: Frame):
        if self.init_ref is None or self.init_ref.n_valid < 100:
            self.init_ref = frame if frame.n_valid > 100 else None
            return
        if frame.n_valid <= 100:
            self.init_ref = None
            return
        ref = self.init_ref
        res = M.search_for_initialization(
            jnp.asarray(ref.xy), jnp.asarray(ref.desc), jnp.asarray(ref.valid),
            jnp.asarray(ref.angle), jnp.asarray(frame.xy), jnp.asarray(frame.desc),
            jnp.asarray(frame.valid), jnp.asarray(frame.angle))
        idx = _np(res.idx)
        n_matches = int((idx >= 0).sum())
        if n_matches < 100:  # src/Tracking.cpp:784-790
            self.init_ref = None
            return
        m = idx >= 0
        # refine the second view's measurements against the reference
        # frame's windows so H/F estimation + triangulation see subpixel-
        # consistent correspondences
        if ref.patch is not None:
            mask_cur = np.zeros(frame.capacity, bool)
            mask_cur[idx[m]] = True
            templates = np.zeros((frame.capacity,) + self.map.pt_patch.shape[1:],
                                 np.float32)
            templates[idx[m]] = _np(RF.template_of(ref.patch[m]))
            self._refine_measurements(frame, mask_cur, templates)
        xy2 = np.zeros_like(ref.xy)
        xy2[m] = frame.xy[idx[m]]
        tv = TV.initialize_two_view(
            self._next_key(), jnp.asarray(ref.xy), jnp.asarray(xy2),
            jnp.asarray(m), jnp.asarray(self.K))
        if not bool(tv.success):
            return
        good = _np(tv.good) & m
        if good.sum() < 50:
            return
        X = _np(tv.points3d)
        self._create_initial_map_monocular(ref, frame, idx, good, _np(tv.R), _np(tv.t), X)

    def _create_initial_map_monocular(self, ref: Frame, frame: Frame, idx,
                                      good, R, t, X):
        """CreateInitialMapMonocular (src/Tracking.cpp:834-1004)."""
        mp = self.map
        T0 = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
        T1 = np.hstack([R, t[:, None]]).astype(np.float32)
        ref.pose = T0
        frame.pose = T1

        pt_ids = mp.add_points(X[good].astype(np.float32),
                               ref.desc[good], ref_kf=0, first_kf=0,
                               patch=(_np(RF.template_of(ref.patch[good]))
                                      if ref.patch is not None else None))
        pt_of_ref = np.full(ref.capacity, -1, np.int32)
        pt_of_ref[np.flatnonzero(good)] = pt_ids
        pt_of_cur = np.full(frame.capacity, -1, np.int32)
        pt_of_cur[idx[good]] = pt_ids

        k0 = mp.add_keyframe(T0, ref.timestamp, ref.frame_id, ref.xy, ref.octave,
                             ref.angle, ref.desc, ref.valid, pt_of_ref,
                             patch=ref.patch, xy0=ref.xy0)
        k1 = mp.add_keyframe(T1, frame.timestamp, frame.frame_id, frame.xy,
                             frame.octave, frame.angle, frame.desc, frame.valid,
                             pt_of_cur, patch=frame.patch, xy0=frame.xy0)
        mp.pt_ref_kf[pt_ids] = k1

        # global BA on the initial map, 20 iters (src/Tracking.cpp:907)
        if self.local_mapper is not None:
            self.local_mapper.run_ba([k0, k1], fixed=[k0], iters=(5, 15))
            if hasattr(self.local_mapper, "register"):
                self.local_mapper.register(k0)
                self.local_mapper.register(k1)

        # median-depth scale normalization (src/Tracking.cpp:913-938)
        pc = mp.pt_xyz[pt_ids] @ mp.kf_pose[k0, :, :3].T + mp.kf_pose[k0, :, 3]
        median_depth = float(np.median(pc[:, 2]))
        if median_depth < 0 or (mp.kf_pt[k1] >= 0).sum() < 80:
            self._reset_initialization(pt_ids, [k0, k1])
            return
        inv = 1.0 / median_depth
        mp.kf_pose[k1, :, 3] *= inv
        mp.pt_xyz[pt_ids] *= inv
        mp.refresh_point_stats(pt_ids)

        frame.pose = mp.kf_pose[k1].copy()
        frame.pt_idx = pt_of_cur
        self.ref_kf = k1
        self.last_kf_frame_id = frame.frame_id
        # the init frame carries 2x the tracker's feature budget
        # (src/Tracking.cpp:148-149); squeeze it to tracker capacity so the
        # NEXT frame can run the fused/blocked zero-velocity path (whose
        # program shapes are fixed at n_features). Bound rows survive
        # preferentially; pt_idx entries are map point IDS, so row
        # subsetting never invalidates a binding.
        self.last_frame = self._squeeze_frame(
            frame, F.padded_capacity(self.builder.orb.n_features))
        self.init_ref = None
        self.init_frame_id = frame.frame_id
        self.state = TrackState.OK

    def _squeeze_frame(self, frame: Frame, n: int) -> Frame:
        """Row-subset a frame to capacity n: point-bound rows first, then
        the highest-response unbound valid rows. Identity when n >= cap."""
        if frame.capacity <= n:
            return frame
        bound = frame.pt_idx >= 0 if frame.pt_idx is not None else \
            np.zeros(frame.capacity, bool)
        resp = np.where(frame.valid, frame.response, -np.inf)
        order = np.lexsort((-resp, ~bound))  # bound rows first, by response
        rows = np.sort(order[:n])
        fr = Frame(
            frame_id=frame.frame_id, timestamp=frame.timestamp,
            xy=frame.xy[rows], xy_raw=frame.xy_raw[rows],
            octave=frame.octave[rows], angle=frame.angle[rows],
            response=frame.response[rows], desc=frame.desc[rows],
            valid=frame.valid[rows],
            depth=frame.depth[rows] if frame.depth is not None else None,
            ur=frame.ur[rows] if frame.ur is not None else None,
            patch=frame.patch[rows] if frame.patch is not None else None,
            xy0=frame.xy0[rows] if frame.xy0 is not None else None,
            ur0=frame.ur0[rows] if frame.ur0 is not None else None)
        fr.pose = frame.pose
        fr.pt_idx = (frame.pt_idx[rows] if frame.pt_idx is not None
                     else np.full(n, -1, np.int32))
        if hasattr(frame, "_refined"):
            fr._refined = frame._refined[rows]
        return fr

    def _reset_initialization(self, pt_ids, kfs):
        self.map.remove_points(pt_ids)
        for k in kfs:
            self.map.remove_keyframe(k)
        self.init_ref = None

    # ---------------------------------------------------- fused mono init
    def _frame_from_mats(self, fmat, imat, desc, patch, frame_id,
                         timestamp) -> Frame:
        """Materialize a host Frame from the TrackFrameOut/MonoInitOut
        packed feature tensors (same decode as _ensure_features)."""
        fr = Frame(
            frame_id=frame_id, timestamp=timestamp,
            xy=fmat[:, 0:2].copy(), xy_raw=fmat[:, 2:4].copy(),
            octave=imat[:, 0].copy(), angle=fmat[:, 9].copy(),
            response=fmat[:, 10].copy(), desc=desc,
            valid=imat[:, 4] != 0, depth=fmat[:, 8].copy(),
            ur=fmat[:, 6].copy(), patch=patch.astype(np.float32),
            xy0=fmat[:, 4:6].copy(), ur0=fmat[:, 7].copy())
        fr._refined = imat[:, 3] != 0
        return fr

    def _mono_init_fused(self, img, timestamp) -> np.ndarray | None:
        """MonocularInitialization driven by the fused device program
        (engine_step.mono_init_step): one dispatch + one 16-float readback
        per attempt; the full feature/point tensors are fetched ONCE, on
        success. State machine semantics identical to
        _monocular_initialization (src/Tracking.cpp:729-832)."""
        ib = self.init_builder
        N = ib.orb.n_features
        cam = self.cfg.camera
        frame_id = ib._next_id
        ib._next_id += 1
        if self._init_ref_args is None:
            if self._init_zero is None:
                self._init_zero = (
                    jnp.zeros((N, 2), jnp.float32),
                    jnp.zeros((N, 8), jnp.uint32),
                    jnp.zeros((N,), bool),
                    jnp.zeros((N,), jnp.float32),
                    jnp.zeros((N, 15, 15), jnp.uint8))
            ref_args = self._init_zero
        else:
            ref_args = self._init_ref_args
        out = ES.mono_init_step(
            jnp.asarray(img), self._next_key(), *ref_args,
            self._sf_dev, params=ib.orb, cam=cam)
        hdr = _np(out.hdr)
        n_valid, n_matches, success, n_good = (int(v) for v in hdr[:4])

        def set_ref():
            self._init_out = out
            self._init_meta = (frame_id, timestamp, n_valid)
            self._init_ref_args = (out.fmat[:, 0:2], out.desc,
                                   out.imat[:, 4] != 0, out.fmat[:, 9],
                                   out.patch)

        def clear_ref():
            self._init_out = None
            self._init_meta = None
            self._init_ref_args = None

        if self._init_out is None or self._init_meta[2] < 100:
            # (re)pick the reference frame (src/Tracking.cpp:735-754)
            if n_valid > 100:
                set_ref()
            else:
                clear_ref()
            return None
        if n_valid <= 100:
            clear_ref()
            return None
        if n_matches < 100:  # src/Tracking.cpp:784-790
            clear_ref()
            return None
        if not success or n_good < 50:
            return None  # keep the reference, try the next frame

        # success: materialize both frames + the init geometry (one
        # batched round trip), then build the initial map
        from .utils import fetch
        ro = self._init_out
        (r_fmat, r_imat, r_desc, r_patch, c_fmat, c_imat, c_desc, c_patch,
         idx, good, X, xy2, xy2_raw, refok) = fetch(
            ro.fmat, ro.imat, ro.desc, ro.patch,
            out.fmat, out.imat, out.desc, out.patch,
            out.idx, out.good, out.X, out.xy2, out.xy2_raw, out.ref_ok)
        ref_id, ref_ts, _ = self._init_meta
        ref = self._frame_from_mats(r_fmat, r_imat, r_desc, r_patch,
                                    ref_id, ref_ts)
        frame = self._frame_from_mats(c_fmat, c_imat, c_desc, c_patch,
                                      frame_id, timestamp)
        # apply the in-program feature-metric refinement to the frame copy
        frame.xy[idx[refok]] = xy2[refok]
        frame.xy_raw[idx[refok]] = xy2_raw[refok]
        good = good & (idx >= 0)
        R = hdr[4:13].reshape(3, 3).astype(np.float32)
        t = hdr[13:16].astype(np.float32)
        with self.map.lock:
            self._create_initial_map_monocular(ref, frame, idx, good, R, t, X)
            if self.state == TrackState.OK:
                clear_ref()
                self._log_frame(frame, lost=False)
                return frame.pose
        return None

    def _stereo_initialization(self, frame: Frame):
        """StereoInitialization (src/Tracking.cpp:637-727): single-frame
        bootstrap from depth."""
        if frame.n_valid < 500:
            return
        mp = self.map
        frame.pose = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
        has_depth = (frame.depth > 0) & frame.valid
        ids = np.flatnonzero(has_depth)
        if len(ids) < 100:
            return
        z = frame.depth[ids]
        cam = self.cfg.camera
        x = (frame.xy[ids, 0] - cam.cx) / cam.fx * z
        y = (frame.xy[ids, 1] - cam.cy) / cam.fy * z
        X = np.stack([x, y, z], -1).astype(np.float32)
        pt_ids = mp.add_points(X, frame.desc[ids], ref_kf=0, first_kf=0,
                               patch=(_np(RF.template_of(frame.patch[ids]))
                                      if frame.patch is not None else None))
        pt_of = np.full(frame.capacity, -1, np.int32)
        pt_of[ids] = pt_ids
        mp.add_keyframe(frame.pose, frame.timestamp, frame.frame_id, frame.xy,
                        frame.octave, frame.angle, frame.desc, frame.valid,
                        pt_of, depth=frame.depth, ur=frame.ur,
                        patch=frame.patch, xy0=frame.xy0, ur0=frame.ur0)
        mp.refresh_point_stats(pt_ids)
        frame.pt_idx = pt_of
        self.ref_kf = 0
        self.last_kf_frame_id = frame.frame_id
        self.last_frame = frame
        if self.local_mapper is not None and hasattr(self.local_mapper, "register"):
            self.local_mapper.register(0)
        self.init_frame_id = frame.frame_id
        self.state = TrackState.OK

    # --------------------------------------------------------------- tracking
    def _track_with_motion_model(self, frame: Frame) -> bool:
        """TrackWithMotionModel (src/Tracking.cpp:1161-1243)."""
        last = self.last_frame
        self._ensure_features(last)
        frame.pose = se3_np.orthonormalize(
            se3_np.compose(self.velocity, last.pose))
        pt = last.pt_idx
        ok = (pt >= 0) & self.map.pt_valid[np.clip(pt, 0, None)]
        pts_xyz = self.map.pt_xyz[np.clip(pt, 0, None)].copy()
        pt_desc = self.map.pt_desc[np.clip(pt, 0, None)].copy()
        if self.cfg.sensor != Sensor.MONOCULAR and self.localization_only \
                and last.frame_id != self.last_kf_frame_id:
            # temporal "VO" points: unmatched last-frame features with depth
            # are backprojected for motion-model matching
            # (Tracking::UpdateLastFrame, src/Tracking.cpp:1065-1160).
            # LOCALIZATION-ONLY: upstream ORB-SLAM2 gates this on
            # mbOnlyTracking (the annotated fork dropped that check). In
            # mapping mode these points backproject the LAST frame's pose
            # error into pseudo-landmarks that then outvote the map in pose
            # optimization -- a positive feedback loop we measured as
            # geometric (x2.5/frame) trajectory runaway on the synthetic
            # room. With a live map the close points come from keyframes.
            tmp = (~ok) & last.valid & (last.depth > 0) & \
                (last.depth < 2 * self.cfg.close_depth_threshold)
            if tmp.any() and last.pose is not None:
                cam_ = self.cfg.camera
                z = last.depth[tmp]
                x = (last.xy[tmp, 0] - cam_.cx) / cam_.fx * z
                y = (last.xy[tmp, 1] - cam_.cy) / cam_.fy * z
                Rwc = last.pose[:, :3].T
                Ow = -Rwc @ last.pose[:, 3]
                pts_xyz[tmp] = (np.stack([x, y, z], -1) @ Rwc.T + Ow).astype(np.float32)
                pt_desc[tmp] = last.desc[tmp]
                ok = ok | tmp
        if ok.sum() < 10:
            return False
        cam = self.cfg.camera
        th = 7.0 if self.cfg.sensor != Sensor.MONOCULAR else 15.0
        for radius_th in (th, 2 * th):  # widening retry (src/Tracking.cpp:1192)
            res = FM.match_motion_model(
                jnp.asarray(frame.pose),
                jnp.asarray(pts_xyz),
                jnp.asarray(ok),
                jnp.asarray(pt_desc),
                jnp.asarray(last.octave), jnp.asarray(last.angle),
                jnp.asarray(frame.xy), jnp.asarray(frame.octave),
                jnp.asarray(frame.desc), jnp.asarray(frame.valid),
                jnp.asarray(frame.angle), jnp.asarray(frame.ur),
                jnp.asarray(self.sf),
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, float(radius_th),
                self.cfg.orb.n_levels, float(np.log(self.cfg.orb.scale_factor)))
            midx = _np(res.idx)
            n = int((midx >= 0).sum())
            if n >= 20:
                break
        if n < 20:
            return False
        frame.pt_idx = np.full(frame.capacity, -1, np.int32)
        src = np.flatnonzero(midx >= 0)
        frame.pt_idx[midx[src]] = pt[src]
        # temporal matches carry the backprojected position instead
        tmp_src = src[pt[src] < 0]
        if len(tmp_src):
            frame.tmp_xyz[midx[tmp_src]] = pts_xyz[tmp_src]
            frame.tmp_valid[midx[tmp_src]] = True
        # feature-metric re-measurement: map-point matches align to the
        # point's anchor template; temporal VO matches align to the last
        # frame's window (frame-to-frame consistency)
        templates = self.map.pt_patch[np.clip(frame.pt_idx, 0, None)].copy()
        mask = frame.pt_idx >= 0
        if len(tmp_src):
            _ensure_patch(last)
        if len(tmp_src) and last.patch is not None:
            cur = midx[tmp_src]
            templates[cur] = _np(RF.template_of(last.patch[tmp_src]))
            mask[cur] = True
        self._refine_measurements(frame, mask, templates)
        n_inl = self._pose_optimize(frame)
        self.matches_inliers = n_inl
        return n_inl >= 10

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """TrackReferenceKeyFrame (src/Tracking.cpp:1007-1063).

        Matching is node-gated SearchByBoW when the vocabulary is available
        (the reference always gates by FeatureVector node,
        src/ORBmatcher.cpp:243-299 — the gate is faster AND rejects
        perceptually-aliased matches that the global ratio test admits);
        the ungated ratio match remains as the no-vocabulary fallback."""
        if self.ref_kf < 0:
            return False
        mp = self.map
        k = self.ref_kf
        has_pt = mp.kf_pt[k] >= 0
        kf_nodes = mp.kf_bow_node[k]
        if self.relocalizer is not None and (kf_nodes >= 0).any():
            _, qnodes = self.relocalizer.frame_bow(frame.desc, frame.valid)
            res = FM.match_by_bow(
                jnp.asarray(mp.kf_desc[k]), jnp.asarray(has_pt),
                jnp.asarray(mp.kf_angle[k]), jnp.asarray(kf_nodes),
                jnp.asarray(frame.desc), jnp.asarray(frame.valid),
                jnp.asarray(frame.angle), jnp.asarray(qnodes))
        else:
            res = FM.match_descriptors_ratio(
                jnp.asarray(mp.kf_desc[k]), jnp.asarray(has_pt),
                jnp.asarray(mp.kf_angle[k]),
                jnp.asarray(frame.desc), jnp.asarray(frame.valid),
                jnp.asarray(frame.angle))
        midx = _np(res.idx)
        n = int((midx >= 0).sum())
        if n < 15:
            return False
        frame.pose = (self.last_frame.pose.copy()
                      if self.last_frame is not None and self.last_frame.pose is not None
                      else mp.kf_pose[k].copy())
        frame.pt_idx = np.full(frame.capacity, -1, np.int32)
        src = np.flatnonzero(midx >= 0)
        frame.pt_idx[midx[src]] = mp.kf_pt[k, src]
        self._refine_against_points(frame, frame.pt_idx >= 0)
        n_inl = self._pose_optimize(frame)
        self.matches_inliers = n_inl
        return n_inl >= 10

    # ----------------------------------------------------------- fused frame
    def _refresh_mirror(self):
        """Sync the device mirror of the map point table. Incremental: only
        rows dirtied since the last sync are re-uploaded, as ONE jitted
        donated scatter dispatch (engine_step.mirror_scatter — the per-field
        eager .at[].set of round 3 compiled per field per bucket and cost
        seconds mid-run); unbounded churn (loop corrections, capacity
        growth) falls back to a full upload. Patches ship as u8 (matching
        MapState.kf_patch storage) — the full table is ~8 MB not ~32 MB.
        The dispatch is ASYNC: callers consume the returned device handles
        in later dispatches on the same stream, so nothing blocks here."""
        mp = self.map
        if self._mirror is not None and self._mirror_gen == mp.generation:
            return

        def host_rows(ids=None):
            sl = slice(None) if ids is None else ids
            return (mp.pt_xyz[sl], mp.pt_desc[sl],
                    np.clip(np.round(mp.pt_patch[sl]), 0, 255).astype(np.uint8),
                    mp.pt_normal[sl], mp.pt_min_dist[sl], mp.pt_max_dist[sl],
                    mp.pt_valid[sl])

        dirty = mp.drain_dirty_points()
        if (self._mirror is None or dirty is None
                or len(dirty) > ES.MIRROR_BUCKETS[-1]):
            self._mirror = tuple(jnp.asarray(a) for a in host_rows())
        elif len(dirty):
            # pad the id set to a fixed bucket so the scatter program
            # compiles once per bucket size, not once per unique count
            # (duplicated leading id: scatter-set with equal rows is benign)
            n = len(dirty)
            bucket = next(b for b in ES.MIRROR_BUCKETS if b >= n)
            dirty = np.concatenate(
                [dirty, np.full(bucket - n, dirty[0], dirty.dtype)])
            self._mirror = ES.mirror_scatter(
                self._mirror, jnp.asarray(dirty.astype(np.int32)),
                tuple(jnp.asarray(r) for r in host_rows(dirty)))
        self._mirror_gen = mp.generation

    def _last_dev_arrays(self, last: Frame):
        """Device handles of the last frame's per-feature arrays — chained
        from the previous fused output when possible, uploaded otherwise."""
        if self._last_dev_frame_id != last.frame_id or self._last_dev is None:
            self._ensure_features(last)
            _ensure_patch(last)
            patch = last.patch if last.patch is not None else np.zeros(
                (last.capacity, F.PATCH_WIN, F.PATCH_WIN), np.float32)
            self._last_dev = dict(
                xy=jnp.asarray(last.xy), desc=jnp.asarray(last.desc),
                octave=jnp.asarray(last.octave),
                angle=jnp.asarray(last.angle),
                # u8 on the wire (the program casts; matches map storage)
                patch=jnp.asarray(
                    np.clip(np.round(patch), 0, 255).astype(np.uint8)),
                valid=jnp.asarray(last.valid), depth=jnp.asarray(last.depth))
            self._last_dev_frame_id = last.frame_id
        return self._last_dev

    def _track_fused(self, img, timestamp, depth_map=None, right_img=None):
        """Steady-state frame: one fused device dispatch
        (engine_step.track_frame_full) + one batched readback, then host
        bookkeeping only. Falls back to the staged path when the motion
        model fails (rare) — the staged matchers/optimizers are the same
        kernels, so behavior is identical to the reference's
        TrackWithMotionModel -> TrackReferenceKeyFrame cascade."""
        import os
        import time as _time
        timing = os.environ.get("ORBSLAM2_TPU_TIMING") == "1"
        _t = _time.perf_counter if timing else (lambda: 0.0)
        t0 = _t()
        mp = self.map
        cfg = self.cfg
        cam = cfg.camera
        last = self.last_frame
        # --- map-read critical section: everything that touches the host
        # map arrays happens under the map lock (Map::mMutexMapUpdate,
        # include/Map.h:62); the device dispatch below captures the inputs
        # so the lock is NOT held while the device works ---
        with mp.lock:
            # CheckReplacedInLastFrame + quarantine release
            # (src/Tracking.cpp:372)
            last.pt_idx = mp.resolve_point_ids(last.pt_idx)
            mp.release_retired_points()
            self._refresh_mirror()
            t1 = _t()

            lp_pad, pvalid, best_kf = self._select_local_points(last.pt_idx)
            if lp_pad is None:
                frame = self.builder.build(img, timestamp, depth_map=depth_map,
                                           right_img=right_img)
                return self.track(frame)

            # velocity None -> zero-velocity prediction (see process_image)
            T_pred = (last.pose if self.velocity is None
                      else se3_np.orthonormalize(
                          se3_np.compose(self.velocity, last.pose)))
            tmp_enable = bool(cfg.sensor != Sensor.MONOCULAR
                              and self.localization_only
                              and last.frame_id != self.last_kf_frame_id)
            sensor = {Sensor.MONOCULAR: "mono", Sensor.RGBD: "rgbd",
                      Sensor.STEREO: "stereo"}[cfg.sensor]
            # ship images/depth in their cheapest wire form (u8 / u16): the
            # device program casts to f32 after upload (_frame_core)
            img_dev = jnp.asarray(img)
            wire_factor = float(cfg.depth_map_factor)
            if sensor == "rgbd":
                d16, wire_factor = _depth_wire(depth_map,
                                               cfg.depth_map_factor)
                aux = jnp.asarray(d16)
            elif sensor == "stereo":
                aux = jnp.asarray(right_img)
            else:
                aux = img_dev
            ld = self._last_dev_arrays(last)
            if timing:
                jax.block_until_ready(list(ld.values()))
                jax.block_until_ready(list(self._mirror))
                jax.block_until_ready(img_dev)
                t1b = _t()
                print(f"  [fused-inputs ready: +{1e3*(t1b-t1):.1f} ms]",
                      flush=True)
            out = ES.track_frame_full(
                img_dev, aux, jnp.asarray(T_pred), jnp.asarray(last.pose),
                jnp.asarray(last.pt_idx), ld["xy"], ld["desc"], ld["octave"],
                ld["angle"], ld["patch"], ld["valid"], ld["depth"],
                jnp.asarray(tmp_enable),
                *self._mirror, jnp.asarray(lp_pad), jnp.asarray(pvalid),
                jnp.float32(3.0 if self.n_lost_frames > 0 else 1.0),
                self._sf_dev, self._sig2_dev,
                params=self.builder.orb, cam=cam, sensor=sensor,
                close_th=float(cfg.close_depth_threshold),
                depth_factor=wire_factor,
                log_scale=float(np.log(cfg.orb.scale_factor)))
        t2 = _t()

        # one batched readback of everything EXCEPT the photometric windows
        # (~1 MB; fetched lazily by _ensure_patch only when a fallback,
        # keyframe creation, or re-upload actually needs them).
        # ORDER MATTERS: wait for the compute first (block on the tiny
        # header), THEN start the async copies — copy_to_host_async on a
        # not-yet-computed array can degrade to one synchronous round trip
        # per leaf.
        jax.block_until_ready(out.hdr)
        host_fields = out._replace(patch=None)
        for leaf in jax.tree_util.tree_leaves(host_fields):
            leaf.copy_to_host_async()
        hdr, fmat, imat, desc, in_frustum = (
            np.asarray(out.hdr), np.asarray(out.fmat), np.asarray(out.imat),
            np.asarray(out.desc), np.asarray(out.in_frustum))
        if timing:
            print(f"  [fused: prep {1e3*(t1-t0):.1f} lp+dispatch "
                  f"{1e3*(t2-t1):.1f} readback {1e3*(_t()-t2):.1f} ms]",
                  flush=True)
        T1 = hdr[:12].reshape(3, 4)
        T2 = hdr[12:24].reshape(3, 4)
        n_cand, n_mm, n_inl1_map, n_inl2_map = (int(v) for v in hdr[24:28])
        kp_mm_row = imat[:, 1]
        kp_src_arr = imat[:, 2]

        # --- map-write critical section: binding decode, visibility
        # bookkeeping, keyframe decision/creation ---
        t3 = _t()
        with mp.lock:
            r = self._track_fused_finish(
                mp, cam, last, timestamp, T2, n_cand, n_mm, n_inl1_map,
                n_inl2_map, kp_mm_row, kp_src_arr, fmat, imat, desc,
                in_frustum, lp_pad, pvalid, best_kf, out)
        if timing:
            print(f"  [finish: {1e3*(_t()-t3):.1f} ms]", flush=True)
        return r

    def _track_fused_finish(self, mp, cam, last, timestamp, T2, n_cand, n_mm,
                            n_inl1_map, n_inl2_map, kp_mm_row, kp_src_arr,
                            fmat, imat, desc, in_frustum, lp_pad, pvalid,
                            best_kf, out):
        frame = Frame(
            frame_id=self.builder._next_id, timestamp=timestamp,
            xy=fmat[:, 0:2].copy(), xy_raw=fmat[:, 2:4].copy(),
            octave=imat[:, 0].copy(), angle=fmat[:, 9].copy(),
            response=fmat[:, 10].copy(), desc=desc,
            valid=imat[:, 4] != 0, depth=fmat[:, 8].copy(),
            ur=fmat[:, 6].copy(), patch=None,
            xy0=fmat[:, 4:6].copy(), ur0=fmat[:, 7].copy())
        frame._patch_dev = out.patch
        self.builder._next_id += 1
        frame._refined = imat[:, 3] != 0

        N = frame.capacity
        mm_success = (n_cand >= 10 and n_mm >= 20 and n_inl1_map >= 10)
        if not mm_success:
            # staged fallback (TrackReferenceKeyFrame path). The fused
            # attempt may have refined some measurements already;
            # frame._refined prevents double-refinement.
            self._last_dev = None  # frame arrays may mutate below
            ok = self._track_reference_keyframe(frame)
            if ok:
                ok = self._track_local_map(frame)
            return self._finish_frame(frame, ok)

        # decode final bindings: kp_src is a last-frame slot (< N) or
        # N + local-map row
        src = kp_src_arr
        is_mm = (src >= 0) & (src < N)
        is_lp = src >= N
        pt_from_mm = last.pt_idx[np.clip(src, 0, N - 1)]
        frame.pt_idx = np.where(
            is_mm, pt_from_mm,
            np.where(is_lp,
                     lp_pad[np.clip(src - N, 0, len(lp_pad) - 1)], -1)
        ).astype(np.int32)
        tmp_kp = is_mm & (pt_from_mm < 0)
        frame.pt_idx[tmp_kp] = -1
        # the ids were snapshotted BEFORE the device dispatch; the async
        # mapper may have culled/replaced points while the device worked —
        # re-resolve under this lock so keyframe creation can never bind a
        # dead slot (observed as a dangling kf_pt binding under load)
        frame.pt_idx = mp.resolve_point_ids(frame.pt_idx)
        frame.tmp_valid = tmp_kp
        if tmp_kp.any():
            rows = src[tmp_kp]
            z = last.depth[rows]
            x = (last.xy[rows, 0] - cam.cx) / cam.fx * z
            y = (last.xy[rows, 1] - cam.cy) / cam.fy * z
            Rwc = last.pose[:, :3].T
            Ow = -Rwc @ last.pose[:, 3]
            frame.tmp_xyz[tmp_kp] = (np.stack([x, y, z], -1) @ Rwc.T + Ow
                                     ).astype(np.float32)
        frame.pose = T2.copy()
        self.ref_kf = best_kf

        # visibility / found bookkeeping (src/Tracking.cpp:1592-1616 + :1286)
        surv_rows = kp_mm_row[kp_mm_row >= 0]
        cur_pts = last.pt_idx[surv_rows]
        cur_pts = cur_pts[cur_pts >= 0]
        mp.pt_visible[lp_pad[in_frustum & pvalid]] += 1
        mp.pt_visible[cur_pts] += 1
        matched = frame.pt_idx[frame.pt_idx >= 0]
        mp.pt_found[matched] += 1

        n_inl = n_inl2_map
        self.matches_inliers = n_inl
        need = 50 if self.n_lost_frames > 0 else 30
        ok = n_inl >= need
        if ok and out is not None:
            # chain this frame's device arrays into the next fused call
            # (cheap on-device slices of the packed outputs; no host hop)
            self._last_dev = dict(
                xy=out.fmat[:, 0:2], desc=out.desc, octave=out.imat[:, 0],
                angle=out.fmat[:, 9], patch=out.patch,
                valid=out.imat[:, 4] != 0, depth=out.fmat[:, 8])
            self._last_dev_frame_id = frame.frame_id
        else:
            self._last_dev = None
        return self._finish_frame(frame, ok)

    # ----------------------------------------------------------- block driver
    def run_blocked(self, frames, to_gray, block: int = 6,
                    pipeline_depth: int = 2):
        """K-frames-per-dispatch, depth-1 pipelined driver
        (engine_step.track_frames_block): the sequence throughput mode.

        Two latency hiders compose:
        - K frames per dispatch amortize the host<->device round trip and
          the per-dispatch overhead over `block` frames;
        - one block stays IN FLIGHT: block i+1 is dispatched (chain carry =
          device handles of block i's outputs) BEFORE block i's readback,
          so the device computes and transfers while the host finishes
          the previous block. Per-frame wall approaches
          max(upload, compute, readback, host)/K instead of their sum.

        Host bookkeeping (state machine, keyframe decisions, mapping) runs
        per frame after each block's single packed readback; map updates
        reach the device at the next dispatch boundary (bounded staleness
        of <= 2 blocks, the same lag class as the reference's concurrent
        LocalMapping). Falls back to the synchronous per-frame paths for
        init/loss/relocalization and partial-block tails. Yields
        (ts, pose|None) in order."""
        import time as _time
        buf: list = []
        inflight: list = []  # dispatched-not-finished blocks, oldest first
        # per-yield amortized frame time (a block's wall cost divided over
        # its frames) — System.run_sequence reads this for honest per-frame
        # metrics (the raw yield-to-yield gap assigns a whole block to its
        # first frame)
        self.last_frame_ms = 0.0

        def sync_one(item):
            ts, gray, depth_map, right = item
            t0 = _time.perf_counter()
            pose = self.process_image(gray, ts, depth_map=depth_map,
                                      right_img=right)
            self.last_frame_ms = (_time.perf_counter() - t0) * 1e3
            self._blk_chain = None
            return ts, pose

        def finish_oldest():
            """Finish the oldest in-flight block; on a chain break,
            discard every block dispatched on top of it (their device
            carries consumed garbage) and re-track their frames sync."""
            nonlocal inflight
            ctx = inflight.pop(0)
            ok = yield from self._blk_finish(ctx)
            if not ok:
                bad, inflight = inflight, []
                self._blk_chain = None
                for ctx2 in bad:
                    real = ctx2["chunk"][:ctx2.get("n_real",
                                                   len(ctx2["chunk"]))]
                    for item in real:
                        yield sync_one(item)

        def flush(full_only=False):
            nonlocal buf, inflight
            while True:
                # velocity None (first frame after init) is fine: the block
                # seed falls back to a zero-velocity prediction
                can = (self.state == TrackState.OK
                       and self.last_frame is not None
                       and self.last_frame.pose is not None
                       and not self.localization_only)
                if can and len(buf) >= block:
                    chunk, buf = buf[:block], buf[block:]
                    ctx = self._blk_dispatch(chunk)
                    if ctx is None:  # no local points: sync the chunk
                        while inflight:
                            yield from finish_oldest()
                        self._blk_chain = None
                        for item in chunk:
                            yield sync_one(item)
                        continue
                    inflight.append(ctx)
                    if len(inflight) > pipeline_depth:
                        yield from finish_oldest()
                    continue
                # final flush with a partial tail: pad the chunk to the
                # block's static width by repeating the last frame and let
                # _blk_finish drop the padded outputs — one amortized block
                # dispatch instead of per-frame sync round trips
                if not full_only and can and 0 < len(buf) < block:
                    chunk_real, buf = buf, []
                    chunk = chunk_real + [chunk_real[-1]] * (
                        block - len(chunk_real))
                    ctx = self._blk_dispatch(chunk)
                    if ctx is None:  # no local points: sync the tail
                        while inflight:
                            yield from finish_oldest()
                        self._blk_chain = None
                        for item in chunk_real:
                            yield sync_one(item)
                        continue
                    ctx["n_real"] = len(chunk_real)
                    inflight.append(ctx)
                    continue
                # a sync frame must run next only when frames are waiting
                # and blocks cannot absorb them (not-OK state, tail flush);
                # otherwise leave the in-flight blocks IN FLIGHT and return
                # for more input — that in-flight overlap is the pipeline.
                need_sync = bool(buf) and not (full_only and can)
                if (need_sync or not full_only) and inflight:
                    yield from finish_oldest()
                    continue  # state may have changed: re-evaluate
                if need_sync:
                    item, buf = buf[0], buf[1:]
                    yield sync_one(item)
                    continue
                return

        for ts, data in frames:
            gray = to_gray(data["image"])
            depth = data.get("depth")
            right = to_gray(data["right"]) if "right" in data else None
            buf.append((ts, gray, depth, right))
            yield from flush(full_only=True)
        yield from flush(full_only=False)

    def _blk_seed(self):
        last = self.last_frame
        with self.map.lock:
            last.pt_idx = self.map.resolve_point_ids(last.pt_idx)
            ld = self._last_dev_arrays(last)
        T_last = jnp.asarray(last.pose)
        # velocity None -> zero-velocity seed (T_prev == T_last makes the
        # on-device constant-velocity prediction the identity)
        T_prev = jnp.asarray(
            last.pose if self.velocity is None else se3_np.compose(
                se3_np.inverse(self.velocity), last.pose).astype(np.float32))
        self._blk_chain = (T_last, T_prev, jnp.asarray(last.pt_idx),
                          ld["xy"], ld["desc"], ld["octave"], ld["angle"],
                          ld["patch"], ld["valid"], ld["depth"])
        self._blk_bindings = last.pt_idx

    def _blk_dispatch(self, chunk):
        """Host prep + async dispatch of one block (no readback). Returns a
        ctx for _blk_finish, or None when no local-map slice exists."""
        import os
        import time as _time
        timing = os.environ.get("ORBSLAM2_TPU_TIMING") == "1"
        t0 = _time.perf_counter()
        mp = self.map
        cfg = self.cfg
        cam = cfg.camera
        if getattr(self, "_blk_chain", None) is None:
            self._blk_seed()
        t_lock = _time.perf_counter()
        with mp.lock:
            t_locked = _time.perf_counter()
            self._refresh_mirror()
            t_mirror = _time.perf_counter()
            lp_pad, pvalid, best_kf = self._select_local_points(
                self._blk_bindings)
            if lp_pad is None:
                self._blk_chain = None
                return None
            t_lp = _time.perf_counter()
            sensor = {Sensor.MONOCULAR: "mono", Sensor.RGBD: "rgbd",
                      Sensor.STEREO: "stereo"}[cfg.sensor]
            # ship images in their native dtype (u8 when the source is u8:
            # 4x less host->device traffic) and depth as u16 (2x less than
            # f32);
            # the device program casts after upload
            imgs = jnp.asarray(np.stack([c[1] for c in chunk]))
            wire_factor = float(cfg.depth_map_factor)
            if sensor == "rgbd":
                wired = [_depth_wire(c[2], cfg.depth_map_factor)
                         for c in chunk]
                wire_factor = wired[0][1]
                auxs = jnp.asarray(np.stack([w[0] for w in wired]))
            elif sensor == "stereo":
                auxs = jnp.asarray(np.stack([c[3] for c in chunk]))
            else:
                auxs = imgs
            t_up = _time.perf_counter()
            outs, chain2, packed = ES.track_frames_block(
                imgs, auxs, *self._blk_chain,
                *self._mirror, jnp.asarray(lp_pad), jnp.asarray(pvalid),
                self._sf_dev, self._sig2_dev,
                params=self.builder.orb, cam=cam, sensor=sensor,
                close_th=float(cfg.close_depth_threshold),
                depth_factor=wire_factor,
                log_scale=float(np.log(cfg.orb.scale_factor)))
            t_disp = _time.perf_counter()
        self._blk_chain = chain2
        if timing:
            print(f"  [blk-dispatch: seed {1e3*(t_lock-t0):.0f} lockwait "
                  f"{1e3*(t_locked-t_lock):.0f} mirror "
                  f"{1e3*(t_mirror-t_locked):.0f} lp {1e3*(t_lp-t_mirror):.0f} "
                  f"upload {1e3*(t_up-t_lp):.0f} dispatch "
                  f"{1e3*(t_disp-t_up):.0f} ms]", flush=True)
        ctx = dict(outs=outs, packed=packed, chunk=chunk, lp_pad=lp_pad,
                   pvalid=pvalid, best_kf=best_kf,
                   t_dispatch=_time.perf_counter(), packed_np=None)
        # prefetch the packed readback on a background thread: issuing the
        # device->host copy from the tracking thread would put its wait on
        # every block's critical path; the thread absorbs the wait
        # (np.asarray releases the GIL) and _blk_finish just joins it.
        import threading

        def _prefetch():
            try:
                ctx["packed_np"] = np.asarray(packed)
            except Exception:
                ctx["packed_np"] = None
        th = threading.Thread(target=_prefetch, daemon=True)
        th.start()
        ctx["prefetch"] = th
        return ctx

    def _blk_finish(self, ctx):
        """Read back one dispatched block (single packed leaf) and run the
        per-frame host bookkeeping. Yields (ts, pose); returns True while
        the chain stays intact (False -> caller discards any block
        dispatched on top of this one)."""
        import os
        import time as _time
        timing = os.environ.get("ORBSLAM2_TPU_TIMING") == "1"
        t0 = _time.perf_counter()
        mp = self.map
        cam = self.cfg.camera
        chunk = ctx["chunk"]
        outs = ctx["outs"]
        lp_pad, pvalid, best_kf = ctx["lp_pad"], ctx["pvalid"], ctx["best_kf"]
        K = len(chunk)
        N = outs.kp_pt.shape[1]
        pf = ctx.get("prefetch")
        if pf is not None:
            pf.join()
        pk = ctx["packed_np"]
        if pk is None:  # prefetch failed: fall back to a direct fetch
            pk = np.asarray(ctx["packed"])
        if timing:
            print(f"  [blk-fetch: {1e3*(_time.perf_counter()-t0):.0f} ms]",
                  flush=True)
        # tail blocks are padded to the static width by repeating the last
        # frame; only the real rows get host bookkeeping / yields, and the
        # chain (which consumed the duplicates) is dropped afterwards
        K_real = ctx.get("n_real", K)
        blk_share = (_time.perf_counter() - t0) * 1e3 / K_real
        P = len(lp_pad)
        for k in range(K_real):
            t_fin = _time.perf_counter()
            ts = chunk[k][0]
            hdr = pk[k, :32].copy().view(np.float32)
            kp_pt_raw = pk[k, 32:32 + N]
            kp_mm = pk[k, 32 + N:32 + 2 * N]
            flags = pk[k, 32 + 2 * N:32 + 3 * N]
            depth = pk[k, 32 + 3 * N:32 + 4 * N].copy().view(np.float32)
            frus_w = pk[k, 32 + 4 * N:].copy().view(np.uint32)
            frus = ((frus_w[:, None] >> np.arange(32, dtype=np.uint32))
                    & 1).astype(bool).ravel()[:P]
            T2 = hdr[12:24].reshape(3, 4)
            n_cand, n_mm, n_inl1_map, n_inl2_map = (int(v) for v in hdr[24:28])
            mm_success = (n_cand >= 10 and n_mm >= 20 and n_inl1_map >= 10)
            with mp.lock:
                kp_pt = mp.resolve_point_ids(kp_pt_raw)
                pose = self._blk_finish_frame(
                    mp, ts, T2, n_inl2_map, kp_pt, kp_mm, flags, depth,
                    frus, lp_pad, pvalid, best_kf, outs, k, mm_success)
                mp.release_retired_points()
            self.last_frame_ms = blk_share + (_time.perf_counter()
                                              - t_fin) * 1e3
            yield ts, pose
            if pose is None or self.state != TrackState.OK or not mm_success:
                # chain broken mid-block: remaining frames re-track sync
                self._blk_chain = None
                for item in chunk[k + 1:K_real]:
                    t0s = _time.perf_counter()
                    pose2 = self.process_image(item[1], item[0],
                                               depth_map=item[2],
                                               right_img=item[3])
                    self.last_frame_ms = (_time.perf_counter() - t0s) * 1e3
                    yield item[0], pose2
                return False
            self._blk_bindings = self.last_frame.pt_idx
        if K_real < K:
            self._blk_chain = None
        return True

    def _blk_finish_frame(self, mp, timestamp, T2, n_inl2_map, kp_pt, kp_mm,
                          flags, depth, in_frustum, lp_pad, pvalid, best_kf,
                          outs, k, mm_success):
        """Per-frame host bookkeeping for the block driver: builds a LAZY
        frame (features stay on device in `outs`; materialized only by
        keyframe creation / fallback paths via _ensure_features), applies
        the visibility/found counters, and runs the shared state-machine
        tail."""
        frame = Frame(
            frame_id=self.builder._next_id, timestamp=timestamp,
            xy=None, xy_raw=None, octave=None, angle=None, response=None,
            desc=None, valid=flags % 2 != 0, depth=depth.copy(),
            ur=None, patch=None, n_feat=len(kp_pt))
        self.builder._next_id += 1
        frame._lazy = (outs, k)
        frame._patch_dev = (outs.patch, k)
        if not mm_success:
            # staged fallback needs real features
            self._ensure_features(frame)
            self._last_dev = None
            ok = self._track_reference_keyframe(frame)
            if ok:
                ok = self._track_local_map(frame)
            return self._finish_frame(frame, ok)

        frame.pt_idx = kp_pt.astype(np.int32).copy()
        # temporal VO bindings never occur here (the block program runs
        # with tmp_enable=False; localization-only mode uses the sync path)
        frame.pose = T2.copy()
        self.ref_kf = best_kf

        # visibility / found bookkeeping (src/Tracking.cpp:1592-1616 + :1286)
        last = self.last_frame
        surv_rows = kp_mm[kp_mm >= 0]
        cur_pts = last.pt_idx[surv_rows]
        cur_pts = cur_pts[cur_pts >= 0]
        mp.pt_visible[lp_pad[in_frustum & pvalid]] += 1
        mp.pt_visible[cur_pts] += 1
        matched = frame.pt_idx[frame.pt_idx >= 0]
        mp.pt_found[matched] += 1

        self.matches_inliers = n_inl2_map
        need = 50 if self.n_lost_frames > 0 else 30
        return self._finish_frame(frame, n_inl2_map >= need)

    def _ensure_features(self, frame: Frame):
        """Materialize a lazy block-driver frame's per-feature arrays from
        the stacked device outputs (one batched fetch; the photometric
        windows stay deferred via _ensure_patch)."""
        lazy = getattr(frame, "_lazy", None)
        if lazy is None:
            return
        outs, k = lazy
        frame._lazy = None
        from .utils import fetch
        if getattr(frame, "_patch_dev", None) is not None:
            # one combined round trip: the callers that materialize
            # features (keyframe creation, fallbacks) need the photometric
            # windows immediately after — fetching them separately would
            # add a round trip per keyframe
            fmat, imat, desc, patch = fetch(
                outs.fmat[k], outs.imat[k], outs.desc[k], outs.patch[k])
            frame.patch = patch.astype(np.float32)
            frame._patch_dev = None
        else:
            fmat, imat, desc = fetch(outs.fmat[k], outs.imat[k], outs.desc[k])
        frame.xy = fmat[:, 0:2].copy()
        frame.xy_raw = fmat[:, 2:4].copy()
        frame.xy0 = fmat[:, 4:6].copy()
        frame.ur = fmat[:, 6].copy()
        frame.ur0 = fmat[:, 7].copy()
        frame.angle = fmat[:, 9].copy()
        frame.response = fmat[:, 10].copy()
        frame.octave = imat[:, 0].copy()
        frame.desc = desc
        frame._refined = imat[:, 3] != 0
        # depth/valid were decoded from the packed readback already

    def _relocalize(self, frame: Frame) -> bool:
        if self.relocalizer is None:
            return self._track_reference_keyframe(frame)
        ok = self.relocalizer.relocalize(frame)
        if ok:
            self.matches_inliers = int((frame.pt_idx >= 0).sum())
            self.last_reloc_frame_id = frame.frame_id
        return ok

    def _select_local_points(self, ref_bindings: np.ndarray):
        """Select the local-map slice from a frame's point bindings:
        K1 covisibility voting + neighbor expansion (UpdateLocalKeyFrames,
        src/Tracking.cpp:1665-1760) then the covered point set
        (UpdateLocalPoints, :1630-1663). Returns (lp_pad [cap] int32,
        pvalid [cap] bool, best_kf) or (None, None, -1)."""
        mp = self.map
        cur_pts = ref_bindings[ref_bindings >= 0]
        if len(cur_pts) == 0:
            return None, None, -1
        seen = np.zeros(mp.pt_xyz.shape[0], bool)
        seen[cur_pts] = True
        votes = (seen[np.clip(mp.kf_pt, 0, None)] & (mp.kf_pt >= 0)).sum(axis=1)
        votes[~mp.kf_valid] = 0
        k1 = np.flatnonzero(votes > 0)
        if len(k1) == 0:
            return None, None, -1
        best_kf = int(k1[np.argmax(votes[k1])])
        local_kfs = list(k1[np.argsort(-votes[k1])][:60])
        for k in local_kfs[:10]:
            for kn in mp.covisible_kfs(k, 10):
                if kn not in local_kfs:
                    local_kfs.append(int(kn))
            if len(local_kfs) >= 80:  # cap (src/Tracking.cpp:1730)
                break
        local_kfs = local_kfs[:80]
        # point set ordered by keyframe covisibility rank: when the slice
        # exceeds the device cap, the points of the STRONGEST local
        # keyframes survive (the r3 code truncated an id-sorted array —
        # an arbitrary prefix; the reference bounds by KF count only)
        rows = mp.kf_pt[local_kfs].ravel()
        first = np.unique(rows, return_index=True)[1]
        lp = rows[np.sort(first)]
        lp = lp[(lp >= 0) & mp.pt_valid[np.clip(lp, 0, None)]]
        cap = self.cfg.local_points_cap
        if len(lp) > cap:
            from .utils.metrics import log_event
            log_event("local_points_truncated", total=int(len(lp)), cap=cap)
            lp = lp[:cap]
        pad = cap - len(lp)
        lp_pad = np.concatenate([lp, np.zeros(pad, lp.dtype)]).astype(np.int32)
        pvalid = np.concatenate([np.ones(len(lp), bool), np.zeros(pad, bool)])
        return lp_pad, pvalid, best_kf

    def _track_local_map(self, frame: Frame) -> bool:
        """TrackLocalMap (src/Tracking.cpp:1247-1306) + SearchLocalPoints."""
        mp = self.map
        cur_pts = frame.pt_idx[frame.pt_idx >= 0]
        lp_pad, pvalid, best_kf = self._select_local_points(frame.pt_idx)
        if lp_pad is None:
            return False
        self.ref_kf = best_kf
        already = pvalid & np.isin(lp_pad, cur_pts)

        cam = self.cfg.camera
        th = 3.0 if self.n_lost_frames > 0 else 1.0
        res, in_frustum = FM.match_local_points(
            jnp.asarray(frame.pose), jnp.asarray(mp.pt_xyz[lp_pad]),
            jnp.asarray(pvalid), jnp.asarray(mp.pt_desc[lp_pad]),
            jnp.asarray(mp.pt_normal[lp_pad]), jnp.asarray(mp.pt_min_dist[lp_pad]),
            jnp.asarray(mp.pt_max_dist[lp_pad]), jnp.asarray(already),
            jnp.asarray(frame.xy), jnp.asarray(frame.octave),
            jnp.asarray(frame.desc), jnp.asarray(frame.valid),
            jnp.asarray(frame.ur),
            jnp.asarray(self.sf), cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            cam.width, cam.height, self.cfg.orb.n_levels,
            float(np.log(self.cfg.orb.scale_factor)), float(th))
        midx = _np(res.idx)
        frus = _np(in_frustum)
        # IncreaseVisible for frustum points + currently matched
        mp.pt_visible[lp_pad[frus & pvalid]] += 1
        mp.pt_visible[cur_pts] += 1
        # bind new associations (only unmatched keypoints get them)
        src = np.flatnonzero(midx >= 0)
        for s in src:
            kp = midx[s]
            if frame.pt_idx[kp] < 0:
                frame.pt_idx[kp] = lp_pad[s]

        # refine the NEW associations (earlier-stage ones are already done)
        self._refine_against_points(frame, frame.pt_idx >= 0)
        n_inl = self._pose_optimize(frame)
        matched = frame.pt_idx[frame.pt_idx >= 0]
        mp.pt_found[matched] += 1
        self.matches_inliers = n_inl
        # stricter right after relocalization (src/Tracking.cpp:1294-1300)
        need = 50 if self.n_lost_frames > 0 else 30
        return n_inl >= need

    # -------------------------------------------------------------- keyframes
    def _need_new_keyframe(self, frame: Frame) -> bool:
        """NeedNewKeyFrame (src/Tracking.cpp:1308-1434), the annotated
        fork's exact rule set:

        - relocalization cooldown: no insert within mMaxFrames of the last
          relocalization while the map is large (:1329)
        - ratioMap (stereo/RGB-D): tracked-in-map close points / all
          close-depth candidates (:1352-1372)
        - thRefRatio 0.75, 0.4 when nKFs<2, 0.9 monocular (:1378-1383)
        - thMapRatio 0.35, 0.20 when inliers>300 (:1386-1388)
        - c1a: >= mMaxFrames since last keyframe
        - c1b: >= mMinFrames and mapper idle
        - c1c: non-mono and (inliers < 0.25*ref or ratioMap < 0.3)
        - c2: (inliers < thRefRatio*ref or ratioMap < thMapRatio) and
          inliers > 15
        - insert iff (c1a|c1b|c1c)&c2; when the mapper is busy, interrupt
          its BA (InterruptBA, :1412) and insert only for stereo/RGB-D with
          a short queue (<3, :1417); monocular never inserts while busy."""
        if self.ref_kf < 0:
            return False
        mp = self.map
        n_kfs = mp.n_keyframes
        max_f = self.cfg.max_frames_between_kf
        if (self.last_reloc_frame_id >= 0
                and frame.frame_id < self.last_reloc_frame_id + max_f
                and n_kfs > max_f):
            return False
        min_obs = 3 if n_kfs > 2 else 2
        obs_counts = mp.point_obs_count()
        ref_pts = mp.kf_pt[self.ref_kf]
        ref_matches = int(((ref_pts >= 0) &
                           (obs_counts[np.clip(ref_pts, 0, None)] >= min_obs)).sum())
        ratio_map = 1.0
        if self.cfg.sensor != Sensor.MONOCULAR:
            close = (frame.depth > 0) & \
                (frame.depth < self.cfg.close_depth_threshold) & frame.valid
            pt = frame.pt_idx
            in_map = (pt >= 0) & (obs_counts[np.clip(pt, 0, None)] > 0)
            n_total = int(close.sum())
            n_map = int((close & in_map).sum())
            ratio_map = n_map / max(1, n_total)
        th_ref = 0.75
        if n_kfs < 2:
            th_ref = 0.4
        if self.cfg.sensor == Sensor.MONOCULAR:
            th_ref = 0.9
        th_map = 0.20 if self.matches_inliers > 300 else 0.35
        lm = self.local_mapper
        idle_fn = getattr(lm, "idle", None) if lm is not None else None
        idle = idle_fn() if idle_fn is not None else True
        frames_since = frame.frame_id - self.last_kf_frame_id
        c1a = frames_since >= max_f
        c1b = frames_since >= self.cfg.min_frames_between_kf and idle
        c1c = self.cfg.sensor != Sensor.MONOCULAR and \
            (self.matches_inliers < 0.25 * ref_matches or ratio_map < 0.3)
        c2 = (self.matches_inliers < th_ref * ref_matches
              or ratio_map < th_map) and self.matches_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        interrupt = getattr(lm, "interrupt_ba", None)
        if interrupt is not None:
            interrupt()
        if self.cfg.sensor == Sensor.MONOCULAR:
            return False
        return getattr(lm, "queue_depth", lambda: 0)() < 3

    def _create_keyframe(self, frame: Frame):
        """CreateNewKeyFrame (src/Tracking.cpp:1436-1534). For stereo/RGB-D,
        spawn close-depth points for unmatched features (:1459-1519).

        The keyframe pose is first re-optimized against the LIVE map: under
        the block driver the frame's pose was computed on device against a
        mirror up to ~2 blocks stale (pre-BA point positions), and keyframe
        poses anchor triangulation — polishing them against fresh geometry
        measured 4.4 cm -> 1.1 cm blocked-mono keyframe ATE. Also prunes
        associations that became outliers under the fresh geometry. On the
        synchronous path this second optimization is ~idempotent."""
        mp = self.map
        lazy = getattr(frame, "_lazy", None)
        polish = frame.pose is not None and (frame.pt_idx >= 0).sum() >= 10
        if lazy is not None and polish:
            # block-driver frame: the features still live on device, so the
            # polish runs on the DEVICE feature slices and its result comes
            # back in the SAME batched round trip as the feature
            # materialization — the staged path paid 2 extra round trips
            # per keyframe (fetch features, then dispatch+fetch the polish
            # on the host copies)
            outs, k_row = lazy
            frame._lazy = None
            pt = frame.pt_idx
            bound = (pt >= 0) & frame.valid & mp.pt_valid[np.clip(pt, 0, None)]
            pts_xyz = mp.pt_xyz[np.clip(pt, 0, None)].astype(np.float32)
            fmat_d = outs.fmat[k_row]
            obs_d = jnp.concatenate([fmat_d[:, 0:2], fmat_d[:, 6:7]], -1)
            info_d = (1.0 / self._sig2_dev)[jnp.clip(
                outs.imat[k_row][:, 0], 0, len(self.sigma2) - 1)]
            bound_d = jnp.asarray(bound)
            cam = self.cfg.camera
            res = PO.pose_optimize(
                jnp.asarray(frame.pose), jnp.asarray(pts_xyz), obs_d,
                (fmat_d[:, 6] >= 0) & bound_d, info_d, bound_d,
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
            from .utils import fetch
            fmat, imat, desc, patch, T_new, inl = fetch(
                outs.fmat[k_row], outs.imat[k_row], outs.desc[k_row],
                outs.patch[k_row], res.T, res.inliers)
            frame.xy = fmat[:, 0:2].copy()
            frame.xy_raw = fmat[:, 2:4].copy()
            frame.xy0 = fmat[:, 4:6].copy()
            frame.ur = fmat[:, 6].copy()
            frame.ur0 = fmat[:, 7].copy()
            frame.angle = fmat[:, 9].copy()
            frame.response = fmat[:, 10].copy()
            frame.octave = imat[:, 0].copy()
            frame.desc = desc
            frame._refined = imat[:, 3] != 0
            frame.patch = patch.astype(np.float32)
            frame._patch_dev = None
            frame.pose = T_new.copy()
            frame.pt_idx = np.where(bound & ~np.asarray(inl), -1,
                                    frame.pt_idx)
        else:
            self._ensure_features(frame)
            _ensure_patch(frame)
            if polish:
                self._pose_optimize(frame)
        k = mp.add_keyframe(frame.pose, frame.timestamp, frame.frame_id,
                            frame.xy, frame.octave, frame.angle, frame.desc,
                            frame.valid, frame.pt_idx,
                            depth=frame.depth, ur=frame.ur, patch=frame.patch,
                            xy0=frame.xy0, ur0=frame.ur0)
        if self.cfg.sensor != Sensor.MONOCULAR:
            self._spawn_depth_points(frame, k)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        if self.local_mapper is not None:
            self.local_mapper.process(k)
            frame.pose = mp.kf_pose[k].copy()

    def _spawn_depth_points(self, frame: Frame, k: int):
        has_depth = (frame.depth > 0) & frame.valid & (frame.pt_idx < 0)
        close = has_depth & (frame.depth < self.cfg.close_depth_threshold)
        # the reference sorts candidates by depth and inserts every close one
        # PLUS the 100 nearest even beyond ThDepth (src/Tracking.cpp:1477-1487)
        cand = np.flatnonzero(has_depth)
        order = cand[np.argsort(frame.depth[cand])]
        ids = order[close[order] | (np.arange(len(order)) < 100)]
        if len(ids) == 0:
            return
        cam = self.cfg.camera
        mp = self.map
        Twc_R = mp.kf_pose[k, :, :3].T
        Ow = -Twc_R @ mp.kf_pose[k, :, 3]
        z = frame.depth[ids]
        x = (frame.xy[ids, 0] - cam.cx) / cam.fx * z
        y = (frame.xy[ids, 1] - cam.cy) / cam.fy * z
        Xc = np.stack([x, y, z], -1)
        Xw = Xc @ Twc_R.T + Ow
        pt_ids = mp.add_points(Xw.astype(np.float32), frame.desc[ids],
                               ref_kf=k, first_kf=k,
                               patch=(_np(RF.template_of(frame.patch[ids]))
                                      if frame.patch is not None else None))
        mp.kf_pt[k, ids] = pt_ids
        frame.pt_idx[ids] = pt_ids
        mp.refresh_point_stats(pt_ids)

    # ------------------------------------------------------------- trajectory
    def trajectory(self):
        """Recover the full frame trajectory by chaining relative poses
        through (possibly BA-corrected) reference keyframes
        (System::SaveTrajectoryTUM, src/System.cpp:307-370)."""
        out_ts, out_T = [], []
        for ts, ref, T_rel, lost in self.frame_log:
            if ref < 0 or lost:  # lost frames carry no reliable pose
                continue
            T_ref = self.map.resolve_kf_pose(ref)
            if T_ref is None:
                continue
            T = se3_np.compose(T_rel, T_ref)
            if not np.isfinite(T).all():
                continue
            out_ts.append(ts)
            out_T.append(T)
        return np.array(out_ts), (np.stack(out_T) if out_T else
                                  np.zeros((0, 3, 4), np.float32))
