"""Local mapping: per-keyframe map growth and refinement.

JAX-native redesign of src/LocalMapping.cpp. The reference's mapping thread
becomes a pipeline stage invoked per keyframe (synchronously or from an
async executor — system.py); each step is a batched device program plus
host bookkeeping on the SoA map:

- MapPointCulling (:241)       -> `cull_recent_points` (vectorized rules)
- CreateNewMapPoints (:298)    -> epipolar-gated matching kernel + batched
  DLT triangulation with the reference's chi2/parallax/scale gates
- SearchInNeighbors (:611)     -> `fuse_neighbors` (projection fuse kernel)
- Optimizer::LocalBundleAdjustment (src/Optimizer.cpp:564) -> `local_ba`
  on bucketed fixed shapes via ops/ba.ba_solve
- KeyFrameCulling (:832)       -> `cull_keyframes` (>=90% redundancy rule)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .config import SlamConfig, Sensor
from .map.mapstate import MapState
from .ops import ba as BA
from .ops import features as F
from .ops import refine as RF
from .utils import fetch


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def build_ba_problem(mp: MapState, cfg: SlamConfig, sigma2: np.ndarray,
                     cams: list[int], fixed: list[int],
                     points: np.ndarray | None = None):
    """Construct a bucketed fixed-shape BAProblem from map slices.

    Returns (prob, meta) where meta carries the index bookkeeping needed to
    write results back: cam_arr, points, kf_of_e, fi (feature index per
    edge), E_need, and n_dropped (edges beyond the bucket, subsampled out).
    """
    cam_arr = np.asarray(cams, np.int32)
    if points is None:
        points = np.unique(mp.kf_pt[cam_arr])
        points = points[points >= 0]
        points = points[mp.pt_valid[points]]
    pt_buckets = cfg.ba_point_buckets
    P = _bucket(len(points), pt_buckets)
    points = points[:P]

    # edge list: observations of selected points by selected cams
    pt_slot = np.full(mp.pt_xyz.shape[0], -1, np.int32)
    pt_slot[points] = np.arange(len(points))
    cam_slot = np.full(mp.kf_pose.shape[0], -1, np.int32)
    cam_slot[cam_arr] = np.arange(len(cam_arr))
    sub_pt = mp.kf_pt[cam_arr]                       # [C, N]
    e_mask = (sub_pt >= 0) & (pt_slot[np.clip(sub_pt, 0, None)] >= 0)
    ci, fi = np.where(e_mask)
    E_need = len(ci)
    E = _bucket(E_need, cfg.ba_edge_buckets)
    n_dropped = max(E_need - E, 0)
    if E_need > E:
        keep = np.random.default_rng(0).choice(E_need, E, replace=False)
        ci, fi = ci[keep], fi[keep]
        E_need = E
    kf_of_e = cam_arr[ci]
    pt_of_e = sub_pt[ci, fi]
    uv = mp.kf_xy[kf_of_e, fi]
    ur = mp.kf_ur[kf_of_e, fi]
    octv = mp.kf_octave[kf_of_e, fi]
    info = (1.0 / sigma2)[np.clip(octv, 0, len(sigma2) - 1)]

    C = _bucket(len(cam_arr), cfg.ba_cam_buckets)
    padC = C - len(cam_arr)
    padP = P - len(points)
    padE = E - E_need

    fixed_set = set(fixed)
    prob = BA.BAProblem(
        cam_T=jnp.asarray(np.concatenate(
            [mp.kf_pose[cam_arr],
             np.tile(np.eye(3, 4, dtype=np.float32), (padC, 1, 1))])),
        cam_fixed=jnp.asarray(np.concatenate(
            [np.array([c in fixed_set for c in cams]),
             np.ones(padC, bool)])),
        cam_valid=jnp.asarray(np.concatenate(
            [np.ones(len(cam_arr), bool), np.zeros(padC, bool)])),
        pts=jnp.asarray(np.concatenate(
            [mp.pt_xyz[points], np.zeros((padP, 3), np.float32)])),
        pt_valid=jnp.asarray(np.concatenate(
            [np.ones(len(points), bool), np.zeros(padP, bool)])),
        e_cam=jnp.asarray(np.concatenate(
            [cam_slot[kf_of_e], np.zeros(padE, np.int32)]).astype(np.int32)),
        e_pt=jnp.asarray(np.concatenate(
            [pt_slot[pt_of_e], np.zeros(padE, np.int32)]).astype(np.int32)),
        e_obs=jnp.asarray(np.concatenate(
            [np.stack([uv[:, 0], uv[:, 1], np.maximum(ur, 0.0)], -1),
             np.zeros((padE, 3), np.float32)]).astype(np.float32)),
        e_stereo=jnp.asarray(np.concatenate([ur >= 0, np.zeros(padE, bool)])),
        e_info=jnp.asarray(np.concatenate(
            [info, np.zeros(padE)]).astype(np.float32)),
        e_valid=jnp.asarray(np.concatenate(
            [np.ones(E_need, bool), np.zeros(padE, bool)])),
    )
    meta = {"cam_arr": cam_arr, "points": points, "kf_of_e": kf_of_e,
            "fi": fi, "E_need": E_need, "fixed_set": fixed_set,
            "n_dropped": n_dropped}
    return prob, meta


class KFStore:
    """Device-resident cache of every keyframe's IMMUTABLE feature tensors
    (pristine undistorted positions kf_xy0, octaves, descriptors, photometric
    patches).

    CreateNewMapPoints gathers 20 covisible neighbors' full feature tables
    per keyframe; re-uploading them from the host cost ~5.5 MB per mapper
    step. These four fields never change after
    add_keyframe, so each keyframe row crosses the wire ONCE and every
    later dispatch gathers it on device. Mutable inputs (poses, free-slot
    masks) stay host-supplied — they are tiny.

    Staleness: kf slots are monotonic in normal operation (alloc_kf never
    reuses a culled slot), but load_map/reset repopulate slots wholesale —
    each synced row therefore remembers the kf_frame_id it was uploaded
    for and re-syncs on mismatch. Capacity tracks the host arrays (which
    grow by doubling); growth pads the device arrays in place."""

    def __init__(self, mp: MapState):
        self.map = mp
        self._cap = 0
        self._arrs = None           # (xy0, octave, desc, patch) device arrays
        self._sync_fid = np.zeros(0, np.int64)   # kf_frame_id at sync (-2 = never)

    def ensure(self, ids) -> tuple:
        """Sync any missing/stale rows among `ids`; return the device arrays
        (xy0 [K,N,2] f32, octave [K,N] i32, desc [K,N,8] u32,
        patch [K,N,15,15] u8). Call under the map lock."""
        mp = self.map
        K = mp.kf_xy0.shape[0]
        if K > self._cap:
            grow = K - self._cap
            if self._arrs is None:
                self._arrs = (
                    jnp.zeros((K,) + mp.kf_xy0.shape[1:], jnp.float32),
                    jnp.zeros((K,) + mp.kf_octave.shape[1:], jnp.int32),
                    jnp.zeros((K,) + mp.kf_desc.shape[1:], jnp.uint32),
                    jnp.zeros((K,) + mp.kf_patch.shape[1:], jnp.uint8),
                )
            else:
                self._arrs = tuple(
                    jnp.concatenate(
                        [a, jnp.zeros((grow,) + a.shape[1:], a.dtype)])
                    for a in self._arrs)
            self._sync_fid = np.concatenate(
                [self._sync_fid, np.full(grow, -2, np.int64)])
            self._cap = K
        ids = np.unique(np.asarray(ids, np.int64))
        stale = ids[self._sync_fid[ids] != mp.kf_frame_id[ids]]
        # fixed scatter widths so the device update compiles once per
        # bucket, not once per distinct row count; padding repeats the
        # first row (same id, same data — an idempotent write)
        while len(stale):
            chunk, stale = stale[:256], stale[256:]
            B = _bucket(len(chunk), (1, 4, 16, 64, 256))
            padded = np.concatenate(
                [chunk, np.full(B - len(chunk), chunk[0], chunk.dtype)])
            sid = jnp.asarray(padded.astype(np.int32))
            xy0, octv, desc, patch = self._arrs
            self._arrs = (
                xy0.at[sid].set(jnp.asarray(mp.kf_xy0[padded])),
                octv.at[sid].set(jnp.asarray(mp.kf_octave[padded])),
                desc.at[sid].set(jnp.asarray(mp.kf_desc[padded])),
                patch.at[sid].set(jnp.asarray(mp.kf_patch[padded])),
            )
            self._sync_fid[chunk] = mp.kf_frame_id[chunk]
        return self._arrs


class LocalMapper:
    def __init__(self, cfg: SlamConfig, mp: MapState, loop_closer=None,
                 kf_db=None, bow_encode=None):
        self.cfg = cfg
        self.map = mp
        self.loop_closer = loop_closer
        self.kf_db = kf_db
        self.bow_encode = bow_encode
        self.sf = F.scale_factors(cfg.orb)
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        # recent points: pt_id -> (birth counter, birth keyframe). The birth
        # keyframe lets us detect a recycled slot (pt_first_kf changed) so a
        # stale entry can't kill a fresh point that reused the slot.
        self.recent: dict[int, tuple[int, int]] = {}
        self.kf_counter = 0
        self.kf_store = KFStore(mp)
        # InterruptBA (src/LocalMapping.cpp:InterruptBA / mbAbortBA): the
        # tracker sets this when it wants to insert a keyframe while the
        # mapper is busy; local_ba skips its solve (the next keyframe's
        # window re-optimizes the same region), draining the queue faster.
        import threading
        self._interrupt_ba = threading.Event()

    def interrupt_ba(self):
        """Request the current/next local BA be skipped (InterruptBA,
        src/LocalMapping.cpp — mbAbortBA)."""
        self._interrupt_ba.set()

    def register_keyframe(self, kf: int):
        """BoW transform + place-recognition index insert
        (ProcessNewKeyFrame's ComputeBoW + KeyFrameDatabase::add). Also
        stores the per-feature FeatureVector gate nodes for node-gated
        SearchByBoW (src/ORBmatcher.cpp:243-299)."""
        if self.kf_db is not None and self.bow_encode is not None:
            vec, nodes = self.bow_encode(self.map.kf_desc[kf],
                                         self.map.kf_feat_valid[kf])
            self.map.kf_bow_node[kf] = nodes
            self.kf_db.add(kf, vec)

    # ------------------------------------------------------------- refinement
    def _refine_obs_absolute(self, tkf: int, feats: np.ndarray,
                             templates: np.ndarray):
        """Template-align keyframe observations (ops/refine.py): for each
        (tkf, feats[i]) write kf_xy = kf_xy0 + LK offset vs templates[i].
        ABSOLUTE w.r.t. the stored window center, so re-refinement against a
        different template never compounds. Fixed 512-pair buckets."""
        mp = self.map
        if len(feats) == 0:
            return
        Mb = 2048
        sf = self.sf
        for s in range(0, len(feats), Mb):
            f = feats[s:s + Mb]
            t = templates[s:s + Mb]
            n = len(f)
            pad = Mb - n
            fp = np.concatenate([f, np.zeros(pad, f.dtype)])
            # u8 on the wire (refine_offsets casts on device)
            win = np.clip(np.round(mp.kf_patch[tkf, fp]), 0, 255
                          ).astype(np.uint8)
            tpl = np.concatenate(
                [np.clip(np.round(t), 0, 255).astype(np.uint8),
                 np.zeros((pad,) + t.shape[1:], np.uint8)])
            vmask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
            delta, ok = RF.refine_offsets(
                jnp.asarray(win), jnp.asarray(tpl), jnp.asarray(vmask))
            delta, ok = fetch(delta, ok)
            ok = ok & vmask
            if not ok.any():
                continue
            fo = fp[ok]
            lv = np.clip(mp.kf_octave[tkf, fo], 0, len(sf) - 1)
            d = delta[ok] * sf[lv][:, None]
            mp.kf_xy[tkf, fo] = mp.kf_xy0[tkf, fo] + d
            ur0 = mp.kf_ur0[tkf, fo]
            mp.kf_ur[tkf, fo] = np.where(ur0 >= 0, ur0 + d[:, 0], ur0)

    def _refine_obs_multi(self, kfs: np.ndarray, feats: np.ndarray,
                          templates: np.ndarray):
        """_refine_obs_absolute across MULTIPLE keyframes in one batched
        dispatch: entry i refines observation (kfs[i], feats[i]) against
        templates[i]. Host gathers the windows; the device program is the
        same fixed-bucket refine_offsets."""
        mp = self.map
        if len(feats) == 0:
            return
        Mb = 2048
        sf = self.sf
        for s in range(0, len(feats), Mb):
            k = kfs[s:s + Mb]
            f = feats[s:s + Mb]
            t = templates[s:s + Mb]
            n = len(f)
            pad = Mb - n
            kp = np.concatenate([k, np.zeros(pad, k.dtype)])
            fp = np.concatenate([f, np.zeros(pad, f.dtype)])
            # u8 on the wire (refine_offsets casts on device)
            win = np.clip(np.round(mp.kf_patch[kp, fp]), 0, 255
                          ).astype(np.uint8)
            tpl = np.concatenate(
                [np.clip(np.round(t), 0, 255).astype(np.uint8),
                 np.zeros((pad,) + t.shape[1:], np.uint8)])
            vmask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
            delta, ok = RF.refine_offsets(
                jnp.asarray(win), jnp.asarray(tpl), jnp.asarray(vmask))
            delta, ok = fetch(delta, ok)
            ok = ok & vmask
            if not ok.any():
                continue
            ko, fo = kp[ok], fp[ok]
            lv = np.clip(mp.kf_octave[ko, fo], 0, len(sf) - 1)
            d = delta[ok] * sf[lv][:, None]
            mp.kf_xy[ko, fo] = mp.kf_xy0[ko, fo] + d
            ur0 = mp.kf_ur0[ko, fo]
            mp.kf_ur[ko, fo] = np.where(ur0 >= 0, ur0 + d[:, 0], ur0)

    def refine_bound_observations(self, kf: int):
        """Re-measure every point-bound feature of a new keyframe against its
        point's anchor template, so BA edges are template-consistent even
        when the frame-level refinement used a different (temporal VO)
        template."""
        mp = self.map
        feats = np.flatnonzero(mp.kf_pt[kf] >= 0)
        if len(feats) == 0:
            return
        self._refine_obs_absolute(kf, feats, mp.pt_patch[mp.kf_pt[kf, feats]])

    # ---------------------------------------------- split prep (dispatch/apply)
    def _refine_bound_dispatch(self, kf: int):
        """Dispatch half of refine_bound_observations: start the per-bucket
        refine programs and return (bucket contexts, device handles) without
        fetching. Windows/templates ship as u8 (4x fewer bytes than f32;
        refine_offsets casts on device)."""
        mp = self.map
        feats = np.flatnonzero(mp.kf_pt[kf] >= 0)
        if len(feats) == 0:
            return []
        templates = mp.pt_patch[mp.kf_pt[kf, feats]]
        # the keyframe's windows gather from the device-resident store
        # (kf_patch is immutable after add_keyframe); only the point anchor
        # templates still cross the wire (mutable via point replace/merge)
        _, _, _, patch_d = self.kf_store.ensure([kf])
        Mb = 2048
        buckets = []
        for s in range(0, len(feats), Mb):
            f = feats[s:s + Mb]
            t = templates[s:s + Mb]
            n = len(f)
            pad = Mb - n
            fp = np.concatenate([f, np.zeros(pad, f.dtype)])
            win = patch_d[kf][jnp.asarray(fp)]
            tpl = np.concatenate(
                [np.clip(np.round(t), 0, 255).astype(np.uint8),
                 np.zeros((pad,) + t.shape[1:], np.uint8)])
            vmask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
            delta, ok = RF.refine_offsets(
                win, jnp.asarray(tpl), jnp.asarray(vmask))
            buckets.append((fp, vmask, delta, ok))
        return buckets

    def _refine_bound_apply(self, kf: int, buckets):
        """Host half: apply fetched refine offsets (same math as
        _refine_obs_absolute's tail). `buckets` entries carry host arrays
        for delta/ok by the time this runs."""
        mp = self.map
        sf = self.sf
        for fp, vmask, delta, ok in buckets:
            ok = np.asarray(ok) & vmask
            if not ok.any():
                continue
            fo = fp[ok]
            d = np.asarray(delta)[ok] * sf[
                np.clip(mp.kf_octave[kf, fo], 0, len(sf) - 1)][:, None]
            mp.kf_xy[kf, fo] = mp.kf_xy0[kf, fo] + d
            ur0 = mp.kf_ur0[kf, fo]
            mp.kf_ur[kf, fo] = np.where(ur0 >= 0, ur0 + d[:, 0], ur0)

    # ---------------------------------------------------------------- process
    def process(self, kf: int):
        """ProcessNewKeyFrame + the per-KF pipeline (LocalMapping::Run,
        src/LocalMapping.cpp:48-170).

        Thread safety: every stage takes the map lock around its HOST
        read/apply sections and releases it across device dispatches
        (create_new_points / fuse_neighbors / run_ba), so with
        async_mapping=True the tracker's fused frames interleave with the
        mapping compute but never observe torn map state."""
        import os
        import time as _time
        timing = os.environ.get("ORBSLAM2_TPU_TIMING") == "1"
        _t = _time.perf_counter if timing else (lambda: 0.0)
        t0 = _t()
        self.kf_counter += 1
        # a stale interrupt from before this keyframe entered the queue
        # must not cancel ITS BA (mbAbortBA is cleared per keyframe)
        self._interrupt_ba.clear()
        # --- prep, split into dispatch / fetch / apply: the BoW word
        # assignment and the observation refinement are device programs, and
        # fetching them one-by-one UNDER the map lock would put 2-3 device
        # round trips inside the tracker's critical section on every
        # keyframe. Dispatch both while holding the lock (cheap, async),
        # fetch them together OUTSIDE the lock, re-take it to apply. Safe:
        # only this thread culls keyframes/points, so the snapshot cannot
        # go stale in between. ---
        bow_owner = getattr(self.bow_encode, "__self__", None)
        bow_split = (self.kf_db is not None and bow_owner is not None
                     and hasattr(bow_owner, "frame_bow_dispatch"))
        with self.map.lock:
            bow_dev = (bow_owner.frame_bow_dispatch(
                self.map.kf_desc[kf], self.map.kf_feat_valid[kf])
                if bow_split else None)
            buckets = self._refine_bound_dispatch(kf)
            # spanning-tree parent: most covisible KF at insertion
            if self.map.kf_parent[kf] < 0:
                w = self.map.covisibility_weights(kf)
                if w.max() > 0:
                    self.map.kf_parent[kf] = int(np.argmax(w))
        t0a = _t()
        leaves = list(bow_dev) if bow_dev is not None else []
        for b in buckets:
            leaves.extend(b[2:])
        if leaves:
            got = iter(fetch(*leaves))
            if bow_dev is not None:
                bow_host = (next(got), next(got), next(got))
            buckets = [(fp, vm, next(got), next(got))
                       for fp, vm, _, _ in buckets]
        t0b = _t()
        with self.map.lock:
            if bow_dev is not None:
                vec, nodes = bow_owner.frame_bow_finish(*bow_host)
                self.map.kf_bow_node[kf] = nodes
                self.kf_db.add(kf, vec)
            elif self.kf_db is not None and self.bow_encode is not None:
                self.register_keyframe(kf)
            t0c = _t()
            self._refine_bound_apply(kf, buckets)
            t0d = _t()
            self.map.refresh_point_stats(
                np.unique(self.map.kf_pt[kf][self.map.kf_pt[kf] >= 0]))
            t0e = _t()
            self.cull_recent_points()
        t1 = _t()
        if timing:
            print(f"  [mapper-prep kf={kf}: dispatch {1e3*(t0a-t0):.0f} "
                  f"fetch {1e3*(t0b-t0a):.0f} bow {1e3*(t0c-t0b):.0f} "
                  f"refine-apply {1e3*(t0d-t0c):.0f} stats "
                  f"{1e3*(t0e-t0d):.0f} cull {1e3*(t1-t0e):.0f} ms]",
                  flush=True)
        self.create_new_points(kf)
        t2 = _t()
        self.fuse_neighbors(kf)
        t3 = _t()
        self.local_ba(kf)
        t4 = _t()
        with self.map.lock:
            self.cull_keyframes(kf)
            if self.loop_closer is not None:
                self.loop_closer.process(kf)
        if timing:
            t5 = _t()
            print(f"  [mapper kf={kf}: prep {1e3*(t1-t0):.0f} newpts "
                  f"{1e3*(t2-t1):.0f} fuse {1e3*(t3-t2):.0f} ba "
                  f"{1e3*(t4-t3):.0f} cull+loop {1e3*(t5-t4):.0f} ms]",
                  flush=True)

    # ---------------------------------------------------------------- culling
    def cull_recent_points(self):
        """MapPointCulling (src/LocalMapping.cpp:241-296): kill points with
        found-ratio < 0.25, or too few observers after 2 keyframes; graduate
        after 3."""
        if not self.recent:
            return
        mp = self.map
        ids = np.fromiter(self.recent.keys(), np.int64)
        birth = np.array([v[0] for v in self.recent.values()], np.int64)
        birth_kf = np.array([v[1] for v in self.recent.values()], np.int64)
        stale = mp.pt_first_kf[ids] != birth_kf  # slot recycled: drop entry
        age = self.kf_counter - birth
        obs = mp.point_obs_count()[ids]
        found_ratio = mp.pt_found[ids] / np.maximum(mp.pt_visible[ids], 1.0)
        min_obs = 2 if self.cfg.sensor == Sensor.MONOCULAR else 3
        kill = ((found_ratio < 0.25) | ((age >= 2) & (obs <= min_obs))
                | ~mp.pt_valid[ids]) & ~stale
        graduate = (age >= 3) & ~kill
        mp.remove_points(ids[kill & mp.pt_valid[ids]])
        for p in ids[kill | graduate | stale]:
            self.recent.pop(int(p), None)

    def cull_keyframes(self, kf: int):
        """KeyFrameCulling (src/LocalMapping.cpp:832-921): discard a local
        covisible KF if >=90% of its (close, for stereo/RGB-D) points are
        seen by >=3 OTHER keyframes at the same or finer scale
        (scaleLeveli <= scaleLevel + 1, :873-908)."""
        mp = self.map
        for k in mp.covisible_kfs(kf):
            k = int(k)
            if k == kf or mp.kf_frame_id[k] <= 1:
                continue
            feats = np.flatnonzero(mp.kf_pt[k] >= 0)
            pts = mp.kf_pt[k, feats]
            if self.cfg.sensor != Sensor.MONOCULAR:
                # only close, positive-depth points count (:861-866)
                d = mp.kf_depth[k, feats]
                keep = (d > 0) & (d < self.cfg.close_depth_threshold)
                feats, pts = feats[keep], pts[keep]
            n_pts = len(pts)
            if n_pts == 0:
                continue
            # every observation of this KF's points, with observer octave
            rows, cols, obs_pt = mp.observations_of(pts)
            lv_of_pt = np.full(mp.pt_xyz.shape[0], 0, np.int32)
            lv_of_pt[pts] = mp.kf_octave[k, feats]
            same_or_finer = (rows != k) & (
                mp.kf_octave[rows, cols] <= lv_of_pt[obs_pt] + 1)
            n_good_obs = np.bincount(obs_pt[same_or_finer],
                                     minlength=mp.pt_xyz.shape[0])
            redundant = n_good_obs[pts] >= 3
            if redundant.sum() > 0.9 * n_pts:
                mp.remove_keyframe(k)
                if self.kf_db is not None:
                    self.kf_db.erase(k)

    # ----------------------------------------------------------- new points
    def create_new_points(self, kf: int):
        """CreateNewMapPoints (src/LocalMapping.cpp:298-610), batched: the
        per-neighbor match/refine/triangulate loop runs as ONE device
        dispatch over all neighbors (engine_keyframe.map_new_points) with
        one readback; the host applies slot allocation and writebacks."""
        mp = self.map
        with mp.lock:
            dispatched = self._create_new_points_dispatch(kf)
        if dispatched is None:
            return
        neighbors, k_valid, out = dispatched
        ints, flts = fetch(*out)  # one batched two-leaf readback
        idx = ints[..., 0]
        ok = ints[..., 1] % 2 != 0
        okr = ints[..., 1] // 2 != 0
        X = flts[..., 0:3]
        delta = flts[..., 3:5]
        with mp.lock:
            self._create_new_points_apply(kf, neighbors, k_valid,
                                          idx, X, ok, delta, okr)

    def _create_new_points_dispatch(self, kf: int):
        mp = self.map
        cfg = self.cfg
        n_neigh = 20 if cfg.sensor == Sensor.MONOCULAR else 10
        neighbors = [int(k) for k in mp.covisible_kfs(kf, n_neigh)]
        if not neighbors:
            return None
        cam = cfg.camera
        T1 = mp.kf_pose[kf]
        Ow1 = -T1[:, :3].T @ T1[:, 3]
        free1 = (mp.kf_pt[kf] < 0) & mp.kf_feat_valid[kf]

        # host-side per-neighbor gates (src/LocalMapping.cpp:349-365)
        k_valid = np.zeros(len(neighbors), bool)
        for i, kn in enumerate(neighbors):
            T2 = mp.kf_pose[kn]
            Ow2 = -T2[:, :3].T @ T2[:, 3]
            baseline = float(np.linalg.norm(Ow1 - Ow2))
            if cfg.sensor == Sensor.MONOCULAR:
                pts2 = mp.kf_pt[kn]
                vis = pts2 >= 0
                if vis.sum() < 20:
                    continue
                pc = mp.pt_xyz[pts2[vis]] @ T2[:, :3].T + T2[:, 3]
                med_depth = float(np.median(pc[:, 2]))
                if med_depth <= 0 or baseline / med_depth < 0.01:
                    continue
            elif baseline < cam.baseline:
                continue
            k_valid[i] = True
        if not k_valid.any():
            return None

        # fixed neighbor bucket: pad by repeating the first neighbor with
        # k_valid False (compiles once per (sensor, capacity))
        K = n_neigh
        nb = np.asarray(
            neighbors + [neighbors[0]] * (K - len(neighbors)), np.int32)
        k_valid = np.concatenate(
            [k_valid, np.zeros(K - len(neighbors), bool)])
        free2 = (mp.kf_pt[nb] < 0) & mp.kf_feat_valid[nb]

        from . import engine_keyframe as EK
        # immutable feature tensors come from the device-resident store
        # (one row upload per keyframe lifetime); only poses and the
        # mutable free-slot masks cross the wire here (~25 KB vs ~5.5 MB)
        xy0_d, oct_d, desc_d, patch_d = self.kf_store.ensure(
            [kf] + list(np.unique(nb)))
        nb_d = jnp.asarray(nb)
        out = EK.map_new_points(
            jnp.asarray(T1), xy0_d[kf],
            oct_d[kf], desc_d[kf],
            jnp.asarray(free1), patch_d[kf],
            jnp.asarray(mp.kf_pose[nb]), xy0_d[nb_d],
            oct_d[nb_d], desc_d[nb_d],
            jnp.asarray(free2), patch_d[nb_d],
            jnp.asarray(k_valid),
            jnp.asarray(self.sigma2), jnp.asarray(self.sf),
            cam.fx, cam.fy, cam.cx, cam.cy, self.cfg.orb.scale_factor)
        return neighbors, k_valid, out

    def _create_new_points_apply(self, kf: int, neighbors, k_valid,
                                 idx, X, ok, delta, okr):
        mp = self.map
        anchor_tpl_full = None
        all_new: list = []
        for j in range(len(neighbors)):
            if not k_valid[j]:
                continue
            kn = neighbors[j]
            i1 = np.flatnonzero(idx[j] >= 0)
            if len(i1) == 0:
                continue
            i2 = idx[j, i1]
            # writebacks mirror the staged path: the anchor observation is
            # reset to the pristine detection (it IS the template center),
            # the neighbor observation adopts the on-device LK refinement
            mp.kf_xy[kf, i1] = mp.kf_xy0[kf, i1]
            mp.kf_ur[kf, i1] = mp.kf_ur0[kf, i1]
            ref = okr[j, i1]
            if ref.any():
                i2r, i1r = i2[ref], i1[ref]
                lv = np.clip(mp.kf_octave[kn, i2r], 0, len(self.sf) - 1)
                d = delta[j, i1r] * self.sf[lv][:, None]
                mp.kf_xy[kn, i2r] = mp.kf_xy0[kn, i2r] + d
                ur0 = mp.kf_ur0[kn, i2r]
                mp.kf_ur[kn, i2r] = np.where(ur0 >= 0, ur0 + d[:, 0], ur0)
            good = ok[j, i1]
            if not good.any():
                continue
            i1o, i2o, Xo = i1[good], i2[good], X[j, i1[good]]
            if anchor_tpl_full is None:
                anchor_tpl_full = np.asarray(RF.template_of(
                    jnp.asarray(mp.kf_patch[kf].astype(np.float32))))
            try:
                pt_ids = mp.add_points(Xo.astype(np.float32),
                                       mp.kf_desc[kf, i1o], ref_kf=kf,
                                       first_kf=kf,
                                       patch=anchor_tpl_full[i1o])
            except RuntimeError:
                return  # point capacity exhausted
            mp.kf_pt[kf, i1o] = pt_ids
            mp.kf_pt[kn, i2o] = pt_ids
            for p in pt_ids:
                self.recent[int(p)] = (self.kf_counter, kf)
            all_new.append(pt_ids)
        if all_new:
            # one batched stat refresh for ALL neighbors' new points (the
            # per-neighbor refresh re-derived stats of earlier neighbors'
            # points repeatedly — pure host cost, measured ~x5 overcount)
            mp.refresh_point_stats(np.concatenate(all_new))

    # -------------------------------------------------------------------- fuse
    def fuse_neighbors(self, kf: int):
        """SearchInNeighbors (src/LocalMapping.cpp:611-721): project the new
        keyframe's points into neighbors and neighbors' points into the new
        keyframe; merge duplicates keeping the most-observed point.

        Batched: both fuse directions run as ONE device dispatch
        (engine_keyframe.fuse_targets) with one readback; matches are
        computed against the pre-fuse map state (the host loop's only
        cross-pair coupling was point-id redirects, resolved below), then
        the merge bookkeeping applies sequentially on the host as before."""
        mp = self.map
        with mp.lock:
            dispatched = self._fuse_dispatch(kf)
        if dispatched is None:
            return
        targets, tg, a_lp, b_lp, obs_counts, out = dispatched
        idx_a, idx_b = fetch(*out)  # one batched readback, lock free
        with mp.lock:
            self._fuse_apply(kf, targets, tg, a_lp, b_lp, obs_counts,
                             idx_a, idx_b)

    def _fuse_dispatch(self, kf: int):
        mp = self.map
        cam = self.cfg.camera
        targets = [int(k) for k in mp.covisible_kfs(kf, 10)]
        if not targets:
            return None
        obs_counts = mp.point_obs_count()

        Tn = 10  # static target bucket
        tg = np.asarray(targets + [targets[0]] * (Tn - len(targets)), np.int32)
        t_live = np.arange(Tn) < len(targets)

        def point_set(kfs, cap):
            pts = mp.kf_pt[kfs]
            pids = np.unique(pts[pts >= 0])
            pids = pids[mp.pt_valid[pids]][:cap]
            pad = cap - len(pids)
            lp = np.concatenate([pids, np.zeros(pad, pids.dtype)])
            pv = np.concatenate([np.ones(len(pids), bool), np.zeros(pad, bool)])
            return lp, pv

        cap = self.cfg.local_points_cap
        a_lp, a_pv = point_set(np.asarray([kf]), min(cap, mp.kf_pt.shape[1]))
        b_lp, b_pv = point_set(tg[t_live], cap)
        if not a_pv.any() and not b_pv.any():
            return None

        from . import engine_keyframe as EK
        # octaves/descriptors gather from the device-resident store; the
        # refined positions (kf_xy/kf_ur), masks and point table are mutable
        # and still ship from the host
        _, oct_d, desc_d, _ = self.kf_store.ensure([kf] + list(np.unique(tg)))
        tg_d = jnp.asarray(tg)
        out = EK.fuse_targets(
            jnp.asarray(mp.kf_pose[tg]), jnp.asarray(mp.kf_xy[tg]),
            oct_d[tg_d], desc_d[tg_d],
            jnp.asarray(mp.kf_feat_valid[tg] & t_live[:, None]),
            jnp.asarray(mp.kf_ur[tg]),
            jnp.asarray(mp.pt_xyz[a_lp]), jnp.asarray(a_pv),
            jnp.asarray(mp.pt_desc[a_lp]), jnp.asarray(mp.pt_normal[a_lp]),
            jnp.asarray(mp.pt_min_dist[a_lp]), jnp.asarray(mp.pt_max_dist[a_lp]),
            jnp.asarray(mp.kf_pose[kf]), jnp.asarray(mp.kf_xy[kf]),
            oct_d[kf], desc_d[kf],
            jnp.asarray(mp.kf_feat_valid[kf]), jnp.asarray(mp.kf_ur[kf]),
            jnp.asarray(mp.pt_xyz[b_lp]), jnp.asarray(b_pv),
            jnp.asarray(mp.pt_desc[b_lp]), jnp.asarray(mp.pt_normal[b_lp]),
            jnp.asarray(mp.pt_min_dist[b_lp]), jnp.asarray(mp.pt_max_dist[b_lp]),
            jnp.asarray(self.sf), cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            cam.width, cam.height, self.cfg.orb.n_levels,
            float(np.log(self.cfg.orb.scale_factor)))
        return targets, tg, a_lp, b_lp, obs_counts, out

    def _fuse_apply(self, kf: int, targets, tg, a_lp, b_lp, obs_counts,
                    idx_a, idx_b):
        mp = self.map
        touched: list[int] = []
        refine_kf, refine_feat, refine_pt = [], [], []
        jobs = [(tg[j], a_lp, idx_a[j]) for j in range(len(targets))]
        jobs.append((kf, b_lp, idx_b))
        redirects: dict[int, int] = {}  # merges applied within this fuse
        for dst_kf, lp, midx in jobs:
            dst_kf = int(dst_kf)
            lp_res = mp.resolve_point_ids(lp)  # one vectorized resolve/job
            for s in np.flatnonzero(midx >= 0):
                p = int(lp_res[s])
                while p in redirects:  # follow intra-fuse merge redirects
                    p = redirects[p]
                if p < 0 or not mp.pt_valid[p]:
                    continue
                feat = int(midx[s])
                existing = int(mp.kf_pt[dst_kf, feat])
                if existing == p:
                    continue
                if existing >= 0 and mp.pt_valid[existing]:
                    # merge: keep the point with more observations
                    # (ORBmatcher::Fuse, src/ORBmatcher.cpp:1091-1113)
                    if obs_counts[existing] >= obs_counts[p]:
                        mp.replace_point(p, existing)
                        redirects[p] = existing
                        touched.append(existing)
                    else:
                        mp.replace_point(existing, p)
                        redirects[existing] = p
                        mp.kf_pt[dst_kf, feat] = p
                        touched.append(p)
                else:
                    mp.kf_pt[dst_kf, feat] = p
                    touched.append(p)
                    refine_kf.append(dst_kf)
                    refine_feat.append(feat)
                    refine_pt.append(p)
        if refine_feat:
            # template-align the fresh observations (merge-branch features
            # keep their earlier refinement; their templates were duplicates
            # of the same physical corner) — one batched dispatch across all
            # destination keyframes
            self._refine_obs_multi(np.asarray(refine_kf),
                                   np.asarray(refine_feat),
                                   mp.pt_patch[np.asarray(refine_pt)])
        if touched:
            mp.refresh_point_stats(np.unique(touched))

    # ---------------------------------------------------------------- local BA
    def local_ba(self, kf: int, abort_check=None):
        """LocalBundleAdjustment window construction
        (src/Optimizer.cpp:564-941): local cams = current + covisible; local
        points = their points; fixed cams = other observers of those points."""
        if self._interrupt_ba.is_set():
            # aborted by the tracker (InterruptBA): skip this window's solve
            self._interrupt_ba.clear()
            return
        mp = self.map
        with mp.lock:
            sel = self._local_ba_select(kf)
        if sel is None:
            return
        cams, fixed, lpts = sel
        self.run_ba(cams, fixed=fixed, points=lpts)

    def _local_ba_select(self, kf: int):
        mp = self.map
        local = [kf] + [int(k) for k in mp.covisible_kfs(kf)]
        local = local[:self.cfg.local_ba_cam_cap]
        lpts = np.unique(mp.kf_pt[local])
        lpts = lpts[(lpts >= 0)]
        lpts = lpts[mp.pt_valid[lpts]]
        if len(lpts) < 10:
            return
        # fixed second ring: KFs observing local points but not in local set
        seen = np.zeros(mp.pt_xyz.shape[0], bool)
        seen[lpts] = True
        observers = np.flatnonzero(
            ((seen[np.clip(mp.kf_pt, 0, None)] & (mp.kf_pt >= 0)).any(axis=1))
            & mp.kf_valid)
        fixed = [int(k) for k in observers if int(k) not in local][:24]
        # gauge fixing (cfg.local_ba_gauge):
        #  "window" — the fixed second ring when present, plus the oldest
        #  camera in the window (extra anchors for short synthetic windows).
        #  "ref" — the reference's exact rule: fix ONLY the second ring and
        #  the map-origin KF when it is local (src/Optimizer.cpp:640-652);
        #  any residual gauge freedom is handled by LM damping, as in g2o.
        # A/B ATE measurements for both in PARITY.md (deviation table).
        cams = local + fixed
        fixed_mask = np.zeros(len(cams), bool)
        fixed_mask[len(local):] = True
        global_oldest = mp.kf_frame_id[mp.kf_valid].min()
        if self.cfg.local_ba_gauge == "ref":
            for i, c in enumerate(cams):
                if mp.kf_frame_id[c] <= global_oldest:
                    fixed_mask[i] = True
            if not fixed_mask.any():
                # degenerate gauge-free window: keep LM-damped (reference
                # behavior), but anchor when the window IS the whole map
                # to avoid global drift of a tiny bootstrap map
                if len(cams) >= mp.n_keyframes:
                    fixed_mask[int(np.argmin(mp.kf_frame_id[cams]))] = True
        else:
            if not fixed_mask.any():
                fixed_mask[int(np.argmin(mp.kf_frame_id[local]))] = True
            if mp.kf_frame_id[cams].min() <= global_oldest:
                fixed_mask[int(np.argmin(mp.kf_frame_id[cams]))] = True

        return cams, [cams[i] for i in np.flatnonzero(fixed_mask)], lpts

    def run_ba(self, cams: list[int], fixed: list[int],
               points: np.ndarray | None = None, iters=(5, 10)):
        """Build a bucketed BAProblem from map slices, solve, write back,
        and prune outlier observations."""
        mp = self.map
        with mp.lock:
            prob, meta = build_ba_problem(mp, self.cfg, self.sigma2, cams,
                                          fixed, points)
        if meta["n_dropped"]:
            from .utils.metrics import log_event
            log_event("ba_edges_dropped", dropped=meta["n_dropped"],
                      kept=meta["E_need"])
        cam_p = self.cfg.camera
        # solve + readback happen OUTSIDE the map lock: the solver iterates
        # on its own snapshot (the BAProblem arrays), so tracking frames
        # interleave with the BA compute — the reference's concurrent
        # LocalMapping thread, without its data races
        res = BA.ba_solve(prob, cam_p.fx, cam_p.fy, cam_p.cx, cam_p.cy,
                          cam_p.bf, iters1=iters[0], iters2=iters[1])
        cam_arr, points = meta["cam_arr"], meta["points"]
        new_T, new_pts, inl = fetch(res.cam_T, res.pts, res.e_inlier)
        new_T = new_T[:len(cam_arr)]
        new_pts = new_pts[:len(points)]
        inl = inl[:meta["E_need"]]
        with mp.lock:
            fixed_set = meta["fixed_set"]
            kf_of_e, fi = meta["kf_of_e"], meta["fi"]
            for i, c in enumerate(cams):
                if c not in fixed_set:
                    mp.kf_pose[c] = new_T[i]
            mp.pt_xyz[points] = new_pts
            mp.mark_points_dirty(points)  # direct geometry write (mirror)
            # prune outlier observations (src/Optimizer.cpp:845-941)
            bad = ~inl
            if bad.any():
                mp.kf_pt[kf_of_e[bad], fi[bad]] = -1
            mp.refresh_point_stats(points)
