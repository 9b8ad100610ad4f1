"""Relocalization: recover the camera after tracking loss.

JAX-native redesign of Tracking::Relocalization (src/Tracking.cpp:1800-2028):
BoW candidates from the keyframe database -> per-candidate descriptor
matching -> batched PnP RANSAC -> LM pose refinement -> projective rescue.
The reference alternates per-candidate CPU loops; here each candidate costs
two device dispatches. ALL database candidates above the 0.75*best cut are
tried, best-score first (src/Tracking.cpp:1814-1828 iterates the full set;
the loop exits on the first candidate that reaches the 50-inlier gate).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .config import SlamConfig
from .frontend import matcher as FM
from .frontend.frame import Frame
from .map.keyframe_db import KeyFrameDatabase
from .map.mapstate import MapState
from .ops import bow as BOW
from .ops import features as F
from .ops import pnp as PNP
from .ops import pose_opt as PO
from .io.vocabulary import Vocabulary


class Relocalizer:
    def __init__(self, cfg: SlamConfig, mp: MapState, voc: Vocabulary,
                 db: KeyFrameDatabase):
        self.cfg = cfg
        self.map = mp
        self.voc = voc
        self.db = db
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        self._key = jax.random.PRNGKey(17)
        self._dev_voc = None  # device-resident vocabulary tables (lazy)

    def _voc_dev(self):
        """Device copies of the vocabulary tables, uploaded ONCE.

        jnp.asarray of a host numpy array re-uploads on every call — for
        the 153k-node vocabulary that was ~12 MB (node_desc + children +
        word ids) per frame_bow, inside every keyframe's prep fetch.
        The tables are immutable for the life of the vocabulary."""
        if self._dev_voc is None:
            self._dev_voc = (jnp.asarray(self.voc.node_desc),
                             jnp.asarray(self.voc.node_children),
                             jnp.asarray(self.voc.node_word))
        return self._dev_voc

    def frame_bow_dispatch(self, desc: np.ndarray, valid: np.ndarray):
        """Async half of frame_bow: start the device word-assignment and
        return the (words, wvalid, nodes) device handles WITHOUT fetching —
        callers that batch several round trips (LocalMapper's keyframe
        prep) fetch these together with their other results and feed the
        host arrays to frame_bow_finish."""
        nd, nc, nw = self._voc_dev()
        return BOW.assign_words(
            nd, nc, nw, jnp.asarray(desc),
            jnp.asarray(valid), self.voc.levels)

    def frame_bow_finish(self, words, wvalid, nodes):
        """Host half of frame_bow: sparse tf-idf vector from fetched word
        assignments."""
        w = np.asarray(words)[np.asarray(wvalid)]
        uniq, counts = np.unique(w, return_counts=True)
        wt = self.voc.word_weight[uniq] * counts
        s = wt.sum()
        if s > 0:
            wt = wt / s
        return ((uniq.astype(np.int32), wt.astype(np.float32)),
                np.asarray(nodes, np.int32))

    def frame_bow(self, desc: np.ndarray, valid: np.ndarray):
        """Sparse tf-idf BoW of a frame plus per-feature gate nodes.

        Returns ((word_ids, L1-normalized weights), nodes [N]) — nodes are
        the depth-2 vocabulary nodes per feature (the reference's
        FeatureVector, used to gate SearchByBoW candidate pairs,
        src/ORBmatcher.cpp:243-299). The device kernel assigns words; the
        sparse vector is built on host so memory stays O(words-per-frame)
        regardless of vocabulary size."""
        words, wvalid, nodes = self.frame_bow_dispatch(desc, valid)
        return self.frame_bow_finish(np.asarray(words), np.asarray(wvalid),
                                     np.asarray(nodes))

    def relocalize(self, frame: Frame) -> bool:
        vec, qnodes = self.frame_bow(frame.desc, frame.valid)
        candidates = self.db.detect_reloc_candidates(vec)
        if len(candidates) == 0:
            return False
        mp = self.map
        cam = self.cfg.camera
        for k in candidates:
            k = int(k)
            has_pt = mp.kf_pt[k] >= 0
            res = FM.match_by_bow(
                jnp.asarray(mp.kf_desc[k]), jnp.asarray(has_pt),
                jnp.asarray(mp.kf_angle[k]),
                jnp.asarray(mp.kf_bow_node[k]),
                jnp.asarray(frame.desc), jnp.asarray(frame.valid),
                jnp.asarray(frame.angle), jnp.asarray(qnodes))
            midx = np.asarray(res.idx)
            src = np.flatnonzero(midx >= 0)
            if len(src) < 15:  # src/Tracking.cpp:1862
                continue
            # PnP on the matched subset, padded to frame capacity
            N = frame.capacity
            X = np.zeros((N, 3), np.float32)
            uv = np.zeros((N, 2), np.float32)
            sg = np.ones(N, np.float32)
            val = np.zeros(N, bool)
            pts = mp.kf_pt[k, src]
            ok = mp.pt_valid[np.clip(pts, 0, None)] & (pts >= 0)
            tgt = midx[src[ok]]
            X[:len(tgt)] = mp.pt_xyz[pts[ok]]
            uv[:len(tgt)] = frame.xy[tgt]
            sg[:len(tgt)] = self.sigma2[
                np.clip(frame.octave[tgt], 0, len(self.sigma2) - 1)]
            val[:len(tgt)] = True
            if val.sum() < 10:
                continue
            self._key, sub = jax.random.split(self._key)
            pr = PNP.pnp_ransac(sub, jnp.asarray(X), jnp.asarray(uv),
                                jnp.asarray(sg), jnp.asarray(val),
                                cam.fx, cam.fy, cam.cx, cam.cy)
            if int(pr.n_inliers) < 10:
                continue
            # refine with the pose optimizer on the matched set
            frame.pose = np.asarray(pr.T)
            frame.pt_idx = np.full(frame.capacity, -1, np.int32)
            frame.pt_idx[tgt] = pts[ok]
            n_inl = self._pose_opt(frame)
            if n_inl < 10:  # src/Tracking.cpp:1898
                continue
            # projective rescue rounds (src/Tracking.cpp:1908-1950): when
            # the BoW matches alone cannot reach the 50-inlier acceptance
            # gate, project the candidate keyframe's remaining points with
            # the estimated pose — a coarse pass (window 10, ORBdist 100),
            # re-optimize, then for marginal results a narrow pass
            # (window 3, ORBdist 64) and a final optimization.
            if n_inl < 50:
                n_add = self._rescue(frame, k, window=10.0, orb_dist=100)
                if n_inl + n_add >= 50:
                    n_inl = self._pose_opt(frame)
                    if 30 <= n_inl < 50:
                        n_add2 = self._rescue(frame, k, window=3.0,
                                              orb_dist=64)
                        if n_inl + n_add2 >= 50:
                            n_inl = self._pose_opt(frame)
            if n_inl < 50:  # bMatch gate (src/Tracking.cpp:1958)
                continue
            return True
        return False

    def _pose_opt(self, frame: Frame) -> int:
        """Motion-only pose optimization over the frame's current bindings;
        prunes outlier associations (the PoseOptimization + outlier-erase
        pattern of Tracking::Relocalization, src/Tracking.cpp:1890-1906)."""
        mp = self.map
        cam = self.cfg.camera
        pvalid = (frame.pt_idx >= 0) & mp.pt_valid[np.clip(frame.pt_idx, 0, None)]
        obs = np.concatenate([frame.xy, frame.ur[:, None]], -1).astype(np.float32)
        info = (1.0 / self.sigma2)[np.clip(frame.octave, 0, len(self.sigma2) - 1)]
        opt = PO.pose_optimize(
            jnp.asarray(frame.pose),
            jnp.asarray(mp.pt_xyz[np.clip(frame.pt_idx, 0, None)]),
            jnp.asarray(obs), jnp.asarray((frame.ur >= 0) & pvalid),
            jnp.asarray(info.astype(np.float32)), jnp.asarray(pvalid),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        frame.pose = np.asarray(opt.T)
        inl = np.asarray(opt.inliers)
        frame.pt_idx = np.where(pvalid & ~inl, -1, frame.pt_idx)
        return int((inl & pvalid).sum())

    def _rescue(self, frame: Frame, k: int, window: float,
                orb_dist: int) -> int:
        """SearchByProjection(CurrentFrame, KF, sAlreadyFound, th, ORBdist)
        (src/ORBmatcher.cpp:1723-1851): project the candidate keyframe's
        map points not yet bound to the frame through the current pose
        estimate and bind window-gated descriptor matches. Returns the
        number of new associations."""
        mp = self.map
        cam = self.cfg.camera
        pts = mp.kf_pt[k]
        pts = np.unique(pts[pts >= 0])
        pts = pts[mp.pt_valid[pts]]
        bound = frame.pt_idx[frame.pt_idx >= 0]
        pts = pts[~np.isin(pts, bound)]
        if len(pts) == 0:
            return 0
        T = frame.pose
        Xc = mp.pt_xyz[pts] @ T[:, :3].T + T[:, 3]
        z = Xc[:, 2]
        u = cam.fx * Xc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * Xc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        Ow = -T[:, :3].T @ T[:, 3]
        dist_w = np.linalg.norm(mp.pt_xyz[pts] - Ow[None], axis=-1)
        band = (dist_w >= 0.8 * mp.pt_min_dist[pts]) & \
               (dist_w <= 1.2 * mp.pt_max_dist[pts])
        ok = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & \
            (v < cam.height) & band
        sel = np.flatnonzero(ok)
        if len(sel) == 0:
            return 0
        log_scale = float(np.log(self.cfg.orb.scale_factor))
        ratio = np.maximum(mp.pt_max_dist[pts], 1e-9) / \
            np.maximum(dist_w, 1e-9)
        pred = np.clip(np.ceil(np.log(ratio) / log_scale), 0,
                       self.cfg.orb.n_levels - 1).astype(np.int32)
        cap = 1024
        sel = sel[:cap]
        pad = cap - len(sel)
        uvp = np.concatenate([np.stack([u[sel], v[sel]], -1),
                              np.zeros((pad, 2))]).astype(np.float32)
        descp = np.concatenate([mp.pt_desc[pts[sel]],
                                np.zeros((pad, 8), np.uint32)])
        predp = np.concatenate([pred[sel], np.zeros(pad, np.int32)])
        pv = np.concatenate([np.ones(len(sel), bool), np.zeros(pad, bool)])
        from .ops import matching as M
        res = M.search_by_projection(
            jnp.asarray(uvp), jnp.asarray(predp), jnp.full(cap, window),
            jnp.asarray(descp), jnp.asarray(pv),
            jnp.asarray(frame.xy), jnp.asarray(frame.octave),
            jnp.asarray(frame.desc),
            jnp.asarray(frame.valid & (frame.pt_idx < 0)),
            jnp.asarray(F.scale_factors(self.cfg.orb)),
            max_dist=orb_dist, ratio=None, level_window=(-1, 1))
        res = M.resolve_duplicate_targets(res, frame.capacity)
        midx = np.asarray(res.idx)[:len(sel)]
        got = np.flatnonzero(midx >= 0)
        n_new = 0
        for i in got:
            kp = int(midx[i])
            if frame.pt_idx[kp] < 0:
                frame.pt_idx[kp] = pts[sel[i]]
                n_new += 1
        return n_new
