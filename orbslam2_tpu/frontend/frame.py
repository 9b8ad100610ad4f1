"""Per-frame feature container and construction.

JAX-native Frame (src/Frame.cpp): construction runs the device extraction
program, undistorts keypoints, and (for stereo/RGB-D) assigns depths. The
64x48 acceleration grid (include/Frame.h:37-38) is unnecessary — candidate
gating happens inside the dense masked matching kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..ops import features as F


@dataclass
class Frame:
    frame_id: int
    timestamp: float
    xy: np.ndarray       # [N, 2] undistorted level-0 coords
    xy_raw: np.ndarray   # [N, 2] raw pixel coords
    octave: np.ndarray   # [N]
    angle: np.ndarray    # [N]
    response: np.ndarray
    desc: np.ndarray     # [N, 8] uint32
    valid: np.ndarray    # [N]
    depth: np.ndarray    # [N] (-1 mono)
    ur: np.ndarray       # [N] right-image u (-1 mono)
    patch: np.ndarray = None  # [N, 15, 15] f32 photometric windows centered
    #                           on the ORIGINAL detection (ops/refine.py)
    xy0: np.ndarray = None    # [N, 2] pristine undistorted detection coords
    #                           (refinement mutates xy; xy0 == patch centers)
    ur0: np.ndarray = None    # [N] pristine right-u measurements
    pose: np.ndarray | None = None        # [3, 4] Tcw
    pt_idx: np.ndarray = field(default=None)  # [N] map point per feature (-1)
    # temporal "VO" points (stereo/RGB-D motion tracking): world positions
    # for features matched to depth-backprojected last-frame features that
    # carry no map point (Tracking::UpdateLastFrame). Never enter the map.
    tmp_xyz: np.ndarray = field(default=None)
    tmp_valid: np.ndarray = field(default=None)
    # LAZY frames (block driver): per-feature arrays stay on device and xy
    # etc. are None until tracking.Tracker._ensure_features materializes
    # them; n_feat carries the capacity until then.
    n_feat: int = 0

    def __post_init__(self):
        n = self.xy.shape[0] if self.xy is not None else self.n_feat
        self.n_feat = n
        if self.pt_idx is None:
            self.pt_idx = np.full(n, -1, np.int32)
        if self.tmp_xyz is None:
            self.tmp_xyz = np.zeros((n, 3), np.float32)
            self.tmp_valid = np.zeros(n, bool)

    @property
    def capacity(self) -> int:
        return self.n_feat

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


class FrameBuilder:
    """Builds Frames by dispatching the extraction program.

    One builder per extractor configuration (the reference builds separate
    ORBextractors for left/right/init, src/Tracking.cpp:141-149)."""

    def __init__(self, cfg: SlamConfig, n_features: int | None = None):
        self.cfg = cfg
        orb = cfg.orb
        if n_features is not None and n_features != orb.n_features:
            from dataclasses import replace
            orb = replace(orb, n_features=n_features)
        self.orb = orb
        self._next_id = 0

    def dispatch(self, img: np.ndarray,
                 depth_map: np.ndarray | None = None,
                 right_img: np.ndarray | None = None):
        """Start the device extraction without blocking (JAX dispatch is
        async): returns a handle for `finalize`. Enables pipelining the next
        frame's extraction under the current frame's host work
        (System.run_sequence)."""
        h, w = img.shape
        # native dtype on upload (u8 images are 4x fewer bytes than f32);
        # extract_orb casts to f32 on device
        feats = F.extract_orb(jnp.asarray(img), self.orb, h, w)
        return (feats, img, depth_map, right_img)

    def finalize(self, handle, timestamp: float) -> Frame:
        feats, img, depth_map, right_img = handle
        return self._assemble(feats, img, timestamp, depth_map, right_img)

    def build(self, img: np.ndarray, timestamp: float,
              depth_map: np.ndarray | None = None,
              right_img: np.ndarray | None = None) -> Frame:
        return self.finalize(self.dispatch(img, depth_map, right_img), timestamp)

    def _assemble(self, feats, img, timestamp: float,
                  depth_map: np.ndarray | None,
                  right_img: np.ndarray | None) -> Frame:
        h, w = img.shape
        xy_raw = np.asarray(feats.xy)
        und = np.asarray(cam_mod.undistort_pixels(self.cfg.camera, feats.xy))
        n = xy_raw.shape[0]
        depth = np.full(n, -1.0, np.float32)
        ur = np.full(n, -1.0, np.float32)
        if right_img is not None:
            # stereo path: inputs must be rectified (reference requirement;
            # EuRoC driver rectifies online, Examples/Stereo/stereo_EuRoC.cpp).
            # Keypoint-to-keypoint disparity is already sub-pixel (Harris-
            # snapped detection), measured BETTER than the SAD slide refine
            # the reference needed for its integer keypoints — so the direct
            # match is the default; ops/stereo.refine_disparity stays
            # available.
            from .stereo import stereo_depths_for_frame
            ur, depth, _ = stereo_depths_for_frame(self.cfg, feats, right_img)
            ur, depth = np.asarray(ur), np.asarray(depth)
        elif depth_map is not None:
            # RGB-D: depth lookup at the keypoint, virtual right coord
            # (Frame::ComputeStereoFromRGBD, src/Frame.cpp:773-800). Two
            # deliberate upgrades over the reference's integer-truncated
            # lookup, both measured on the synthetic room:
            # 1. bilinear depth at the subpixel keypoint (truncation costs
            #    up to 1px of slant-dependent depth error);
            # 2. reject keypoints on depth DISCONTINUITIES (3x3 range
            #    > 10% of z): corners that sit on object boundaries have
            #    ill-defined depth, and their biased virtual-ur edges are
            #    exactly what pose optimization then locks onto (observed
            #    as a geometric tracking runaway; the chi2 gate cannot
            #    reject a structurally-consistent outlier population).
            # depth arrives in raw sensor units (u16 from the loaders or
            # float); scale to meters in f32
            dm = (np.asarray(depth_map, np.float32)
                  * np.float32(self.cfg.depth_map_factor))
            x = np.clip(xy_raw[:, 0], 0, w - 1.001)
            y = np.clip(xy_raw[:, 1], 0, h - 1.001)
            x0 = x.astype(int)
            y0 = y.astype(int)
            fx_ = (x - x0)[:, None]
            fy_ = (y - y0)[:, None]
            x1 = np.minimum(x0 + 1, w - 1)
            y1 = np.minimum(y0 + 1, h - 1)
            corners = np.stack([dm[y0, x0], dm[y0, x1],
                                dm[y1, x0], dm[y1, x1]], -1)
            wgt = np.concatenate([(1 - fx_) * (1 - fy_), fx_ * (1 - fy_),
                                  (1 - fx_) * fy_, fx_ * fy_], -1)
            d = (corners * wgt).sum(-1)
            # 3x3 depth range around the keypoint (discontinuity test)
            xi = np.clip(np.round(x).astype(int), 1, w - 2)
            yi = np.clip(np.round(y).astype(int), 1, h - 2)
            neigh = np.stack([dm[yi + dy, xi + dx]
                              for dy in (-1, 0, 1) for dx in (-1, 0, 1)], -1)
            flat_ok = (neigh.max(-1) - neigh.min(-1)) < 0.1 * np.maximum(d, 1e-6)
            ok = (corners > 0).all(-1) & (d > 0) & flat_ok
            depth = np.where(ok, d, -1.0).astype(np.float32)
            ur = np.where(ok, und[:, 0] - self.cfg.camera.bf / np.maximum(d, 1e-6),
                          -1.0).astype(np.float32)
        frame = Frame(
            frame_id=self._next_id,
            timestamp=timestamp,
            xy=und,
            xy_raw=xy_raw,
            octave=np.asarray(feats.octave),
            angle=np.asarray(feats.angle),
            response=np.asarray(feats.response),
            desc=np.asarray(feats.desc),
            valid=np.asarray(feats.valid),
            depth=depth,
            ur=ur,
            patch=np.asarray(feats.patch),
            xy0=und.copy(),
            ur0=ur.copy(),
        )
        self._next_id += 1
        return frame
