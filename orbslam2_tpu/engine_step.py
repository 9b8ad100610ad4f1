"""The fused per-frame tracking device programs.

Two entry points:

- `tracking_step`: the minimal "forward step" (extract -> project+match ->
  pose LM) used by __graft_entry__.entry() as the compile-check target and
  by bench.py.

- `track_frame_full`: the PRODUCTION per-frame program — the reference's
  entire steady-state Track() hot path (src/Tracking.cpp:320-628 OK branch)
  as ONE device dispatch: extraction + undistortion + depth association,
  motion-model search with the 2x widening retry, feature-metric LK
  refinement, pose LM, frustum-gated local-map search, second refinement,
  second pose LM. The host reads back one batched set of outputs per frame
  (a single device->host round trip) and keeps only the
  bookkeeping: keyframe decisions, map updates, state transitions.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import OrbParams
from .frontend import matcher as FM
from .geometry import camera as cam_mod
from .ops import features as F
from .ops import matching as M
from .ops import pose_opt as PO
from .ops import refine as RF
from .ops import stereo as ST
from .ops import twoview as TV


@functools.partial(
    jax.jit,
    static_argnames=("params", "height", "width", "fx", "fy", "cx", "cy", "bf"))
def tracking_step(img, T_pred, pts_xyz, pt_desc, pt_octave, pt_valid,
                  scale_factors, sigma2,
                  params: OrbParams, height: int, width: int,
                  fx: float, fy: float, cx: float, cy: float, bf: float):
    """One tracked frame: extract -> project+match -> pose-only LM.

    Returns (T_new [3,4], n_inliers, features)."""
    feats = F.extract_orb(img, params, height, width)

    R, t = T_pred[:, :3], T_pred[:, 3]
    pc = pts_xyz @ R.T + t
    z = pc[:, 2]
    ok = pt_valid & (z > 0.1)
    uv = jnp.stack([fx * pc[:, 0] / jnp.maximum(z, 1e-6) + cx,
                    fy * pc[:, 1] / jnp.maximum(z, 1e-6) + cy], -1)
    res = M.search_by_projection(
        uv, pt_octave, jnp.full(pts_xyz.shape[0], 15.0), pt_desc, ok,
        feats.xy, feats.octave, feats.desc, feats.valid, scale_factors,
        max_dist=M.TH_HIGH, ratio=0.9, level_window=(-1, 1))
    res = M.resolve_duplicate_targets(res, feats.xy.shape[0])

    # scatter matches into per-keypoint observation slots
    n_kp = feats.xy.shape[0]
    target = jnp.where(res.valid, res.idx, n_kp)  # n_kp = out-of-bounds, dropped
    kp_pt = jnp.full((n_kp,), -1, jnp.int32).at[target].set(
        jnp.arange(pts_xyz.shape[0]), mode="drop")
    matched = kp_pt >= 0
    obs = jnp.concatenate([feats.xy, jnp.zeros((n_kp, 1))], -1)
    info = 1.0 / sigma2[jnp.clip(feats.octave, 0, sigma2.shape[0] - 1)]
    opt = PO.pose_optimize(
        T_pred, pts_xyz[jnp.clip(kp_pt, 0)], obs,
        jnp.zeros((n_kp,), bool), info, matched & feats.valid,
        fx, fy, cx, cy, bf)
    return opt.T, opt.n_inliers, feats


# Fixed dirty-row bucket sizes for the mirror scatter (one compile each;
# larger sets fall back to a full mirror upload).
MIRROR_BUCKETS = (2048, 8192)


@functools.partial(jax.jit, donate_argnums=(0,))
def mirror_scatter(mirror, ids, rows):
    """Scatter-update the device point-table mirror in ONE dispatch.

    mirror: tuple of [P, ...] device arrays (donated — updated in place);
    ids: [B] int32 row indices (padded bucket; duplicate leading id);
    rows: tuple of [B, ...] replacement rows, same field order as mirror.
    """
    return tuple(m.at[ids].set(r) for m, r in zip(mirror, rows))


class TrackFrameOut(NamedTuple):
    """Device-side result of track_frame_full, PACKED into few tensors.

    Every fetched array costs its own device->host round trip, so the
    per-frame readback is
    exactly four leaves: hdr + fmat + imat + desc (+ in_frustum); the
    photometric windows (patch) are deferred and fetched only when a
    fallback / keyframe creation needs them.

    hdr  [32] f32: T1 (rows flattened, 12), T2 (12), n_cand, n_mm,
                   n_inl1_map, n_inl2_map (counts are exact in f32), pad
    fmat [N,11] f32: xy(2) xy_raw(2) xy0(2) ur ur0 depth angle response
    imat [N,5] i32: octave, kp_mm_row, kp_src, refined, valid
    desc [N,8] u32
    in_frustum [P] bool
    patch [N,15,15] u8 (deferred)
    """

    hdr: jnp.ndarray
    fmat: jnp.ndarray
    imat: jnp.ndarray
    desc: jnp.ndarray
    in_frustum: jnp.ndarray
    patch: jnp.ndarray
    kp_pt: jnp.ndarray   # [N] i32 resolved map-point id per keypoint (-1) —
    #                      lets the NEXT frame's program chain bindings
    #                      device-side (pipelined driver, no host decode)
    T_out: jnp.ndarray   # [3,4] final pose (same as hdr[12:24]; a separate
    #                      leaf so the pipelined driver can chain it without
    #                      touching the readback tensors)


def _rgbd_depth(dm, xy_raw, und_x, cam, H: int, W: int):
    """RGB-D depth association on device (Frame::ComputeStereoFromRGBD,
    src/Frame.cpp:773-800, with the engine's bilinear + discontinuity
    upgrades — see frontend/frame.py for the rationale)."""
    x = jnp.clip(xy_raw[:, 0], 0, W - 1.001)
    y = jnp.clip(xy_raw[:, 1], 0, H - 1.001)
    x0 = x.astype(jnp.int32)
    y0 = y.astype(jnp.int32)
    fx_ = x - x0
    fy_ = y - y0
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    flat = dm.ravel()

    def at(yy, xx):
        return jnp.take(flat, yy * W + xx)

    c00, c01 = at(y0, x0), at(y0, x1)
    c10, c11 = at(y1, x0), at(y1, x1)
    d = ((c00 * (1 - fx_) + c01 * fx_) * (1 - fy_)
         + (c10 * (1 - fx_) + c11 * fx_) * fy_)
    xi = jnp.clip(jnp.round(x).astype(jnp.int32), 1, W - 2)
    yi = jnp.clip(jnp.round(y).astype(jnp.int32), 1, H - 2)
    neigh = jnp.stack([at(yi + dy, xi + dx)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)], -1)
    flat_ok = (neigh.max(-1) - neigh.min(-1)) < 0.1 * jnp.maximum(d, 1e-6)
    ok = (c00 > 0) & (c01 > 0) & (c10 > 0) & (c11 > 0) & (d > 0) & flat_ok
    depth = jnp.where(ok, d, -1.0)
    ur = jnp.where(ok, und_x - cam.bf / jnp.maximum(d, 1e-6), -1.0)
    return depth, ur


@functools.partial(
    jax.jit,
    static_argnames=("params", "cam", "sensor", "close_th", "depth_factor",
                     "log_scale"))
def track_frame_full(img, aux, T_pred, T_last,
                     last_pt, last_xy, last_desc, last_octave, last_angle,
                     last_patch, last_valid, last_depth, tmp_enable,
                     m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd, m_valid,
                     lp_ids, lp_mask, lp_radius_th, sf, sig2,
                     params: OrbParams, cam, sensor: str,
                     close_th: float, depth_factor: float, log_scale: float
                     ) -> TrackFrameOut:
    """One tracked frame, fused (see module docstring).

    aux: depth map [H,W] (rgbd), right image [H,W] (stereo), or img (mono,
    ignored). last_*: previous frame's per-feature arrays (device-chained).
    m_*: the map-point device mirror (full point table; gathered by index).
    lp_ids/lp_mask: the local-map slice (host-selected from covisibility).
    tmp_enable: traced bool — include temporal VO candidates
    (localization-only mode, Tracking::UpdateLastFrame).

    T_pred may be [3,4] (the host's motion-model prediction) or [2,3,4]
    (T_last_pose, T_prev_pose): in the latter case the constant-velocity
    prediction T_pred = (T_last ∘ T_prev^-1) ∘ T_last is computed ON DEVICE
    so the pipelined driver can chain frames without a host round trip
    (Tracking::Track's mVelocity*mLastFrame.mTcw, src/Tracking.cpp:1166).
    """
    if T_pred.ndim == 3:
        T_pred = _predict_pose(T_pred[0], T_pred[1])
    return _frame_core(img, aux, T_pred, T_last, last_pt, last_xy, last_desc,
                       last_octave, last_angle, last_patch, last_valid,
                       last_depth, tmp_enable, m_xyz, m_desc, m_patch,
                       m_normal, m_mind, m_maxd, m_valid, lp_ids, lp_mask,
                       lp_radius_th, sf, sig2, params, cam, sensor, close_th,
                       depth_factor, log_scale)


def _predict_pose(Tl, Tp):
    """Constant-velocity prediction T_pred = (Tl ∘ Tp^-1) ∘ Tl with SO(3)
    projection (f32 scale leakage compounds geometrically through the
    recurrence — same rationale as se3_np.orthonormalize)."""
    Rl, tl_ = Tl[:, :3], Tl[:, 3]
    Rp, tp_ = Tp[:, :3], Tp[:, 3]
    Rv = Rl @ Rp.T
    tv = tl_ - Rv @ tp_
    Rpred = Rv @ Rl
    tpred = Rv @ tl_ + tv
    U, _, Vt = jnp.linalg.svd(Rpred)
    det = jnp.linalg.det(U @ Vt)
    Rorth = U @ jnp.diag(jnp.stack([1.0 + 0 * det, 1.0 + 0 * det, det])) @ Vt
    return jnp.concatenate([Rorth, tpred[:, None]], axis=1)


def _frame_core(img, aux, T_pred, T_last,
                last_pt, last_xy, last_desc, last_octave, last_angle,
                last_patch, last_valid, last_depth, tmp_enable,
                m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd, m_valid,
                lp_ids, lp_mask, lp_radius_th, sf, sig2,
                params: OrbParams, cam, sensor: str,
                close_th: float, depth_factor: float, log_scale: float
                ) -> TrackFrameOut:
    H, W = cam.height, cam.width
    N = last_pt.shape[0]

    # ---- stage 1: extraction + undistortion + depth association ----
    # images may arrive as uint8 (4x fewer bytes to upload than f32); all
    # compute is f32
    img = img.astype(jnp.float32)
    aux = aux.astype(jnp.float32)
    last_patch = last_patch.astype(jnp.float32)
    feats = F.extract_orb(img, params, H, W)
    xy_und = cam_mod.undistort_pixels(cam, feats.xy)
    if sensor == "rgbd":
        depth, ur = _rgbd_depth(aux * depth_factor, feats.xy, xy_und[:, 0],
                                cam, H, W)
    elif sensor == "stereo":
        feats_r = F.extract_orb(aux, params, H, W)
        ur, depth = ST.stereo_match(
            feats.xy, feats.octave, feats.desc, feats.valid,
            feats_r.xy, feats_r.octave, feats_r.desc, feats_r.valid,
            sf, cam.bf, cam.fx)
    else:
        depth = jnp.full((feats.xy.shape[0],), -1.0)
        ur = jnp.full((feats.xy.shape[0],), -1.0)
    ur0 = ur

    # ---- stage 2: motion-model candidates (rows = last-frame slots) ----
    ptc = jnp.clip(last_pt, 0)
    bound_last = (last_pt >= 0) & m_valid[ptc]
    # temporal VO candidates: unmatched close-depth last-frame features
    # backprojected with the last pose (Tracking::UpdateLastFrame,
    # src/Tracking.cpp:1065-1160; localization-only gate as upstream)
    tmp_sel = (tmp_enable & ~bound_last & last_valid & (last_depth > 0)
               & (last_depth < 2.0 * close_th))
    Rl, tl = T_last[:, :3], T_last[:, 3]
    Xc = cam_mod.backproject(cam, last_xy, last_depth)
    Xw = (Xc - tl[None]) @ Rl  # Rwc = Rl^T; Xw = Rl^T (Xc - tl)
    mm_xyz = jnp.where(bound_last[:, None], m_xyz[ptc], Xw)
    mm_desc = jnp.where(bound_last[:, None], m_desc[ptc], last_desc)
    mm_tpl = jnp.where(bound_last[:, None, None],
                       m_patch[ptc].astype(jnp.float32),
                       RF.template_of(last_patch))
    mm_ok = bound_last | tmp_sel
    n_cand = jnp.sum(mm_ok)

    th = 7.0 if sensor != "mono" else 15.0
    res_mm, n_mm = FM.motion_model_core(
        T_pred, mm_xyz, mm_ok, mm_desc, last_octave, last_angle,
        xy_und, feats.octave, feats.desc, feats.valid, feats.angle, ur, sf,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, th)

    # keypoint-side binding: kp -> last-frame slot
    tgt = jnp.where(res_mm.idx >= 0, res_mm.idx, N)
    kp_mm = jnp.full((N,), -1, jnp.int32).at[tgt].set(
        jnp.arange(N), mode="drop")
    bound0 = kp_mm >= 0

    # ---- stage 3: feature-metric refinement of MM matches ----
    tpl_kp = mm_tpl[jnp.clip(kp_mm, 0)]
    delta, okr = RF.refine_offsets(feats.patch, tpl_kp, bound0 & feats.valid)
    sf_kp = sf[jnp.clip(feats.octave, 0, sf.shape[0] - 1)]
    shift = delta * (sf_kp * okr)[:, None]
    xy_raw1 = feats.xy + shift
    xy1 = jnp.where(okr[:, None], cam_mod.undistort_pixels(cam, xy_raw1),
                    xy_und)
    ur = jnp.where(okr & (ur >= 0), ur + shift[:, 0], ur)
    refined0 = okr

    # ---- stage 4: pose optimization 1 ----
    info = 1.0 / sig2[jnp.clip(feats.octave, 0, sig2.shape[0] - 1)]
    obs1 = jnp.concatenate([xy1, ur[:, None]], -1)
    valid1 = bound0 & feats.valid
    opt1 = PO.pose_optimize(
        T_pred, mm_xyz[jnp.clip(kp_mm, 0)], obs1, valid1 & (ur >= 0), info,
        valid1, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    inl1 = opt1.inliers
    kp_is_map = bound0 & bound_last[jnp.clip(kp_mm, 0)]
    n_inl1_map = jnp.sum(inl1 & kp_is_map)
    kp_mm = jnp.where(valid1 & ~inl1, -1, kp_mm)  # prune outlier bindings
    bound1 = kp_mm >= 0

    # ---- stage 5: local-map candidates + already-bound mask ----
    lpc = jnp.clip(lp_ids, 0)
    lp_ok = lp_mask & m_valid[lpc]
    # a local point is "already matched" if a surviving MM binding carries it
    surv_pt = jnp.where(bound1 & bound_last[jnp.clip(kp_mm, 0)],
                        last_pt[jnp.clip(kp_mm, 0)], -1)  # [N] pt id or -1
    already = jnp.any((surv_pt[None, :] == lp_ids[:, None])
                      & (surv_pt[None, :] >= 0), axis=1)

    res_lp, in_frustum = FM.local_points_core(
        opt1.T, m_xyz[lpc], lp_ok, m_desc[lpc], m_normal[lpc],
        m_mind[lpc], m_maxd[lpc], already,
        xy1, feats.octave, feats.desc, feats.valid & ~bound1, ur, sf,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, W, H,
        params.n_levels, log_scale, lp_radius_th)
    P = lp_ids.shape[0]
    tgt2 = jnp.where(res_lp.idx >= 0, res_lp.idx, N)
    kp_lp = jnp.full((N,), -1, jnp.int32).at[tgt2].set(
        jnp.arange(P), mode="drop")
    kp_lp = jnp.where(bound1, -1, kp_lp)  # MM bindings win
    bound_lp = kp_lp >= 0

    # ---- stage 6: refinement of the new local-map matches ----
    tpl2 = m_patch[lpc][jnp.clip(kp_lp, 0)].astype(jnp.float32)
    delta2, ok2 = RF.refine_offsets(feats.patch, tpl2,
                                    bound_lp & ~refined0 & feats.valid)
    shift2 = delta2 * (sf_kp * ok2)[:, None]
    xy_raw2 = xy_raw1 + shift2
    xy2 = jnp.where(ok2[:, None], cam_mod.undistort_pixels(cam, xy_raw2), xy1)
    ur = jnp.where(ok2 & (ur >= 0), ur + shift2[:, 0], ur)
    refined = refined0 | ok2

    # ---- stage 7: pose optimization 2 over the union of bindings ----
    pts2 = jnp.where(bound1[:, None], mm_xyz[jnp.clip(kp_mm, 0)],
                     m_xyz[lpc][jnp.clip(kp_lp, 0)])
    valid2 = (bound1 | bound_lp) & feats.valid
    obs2 = jnp.concatenate([xy2, ur[:, None]], -1)
    opt2 = PO.pose_optimize(
        opt1.T, pts2, obs2, valid2 & (ur >= 0), info, valid2,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    inl2 = opt2.inliers
    kp_map2 = (bound1 & bound_last[jnp.clip(kp_mm, 0)]) | bound_lp
    n_inl2_map = jnp.sum(inl2 & kp_map2)
    # final bindings post-prune
    kp_src = jnp.where(bound1, kp_mm, jnp.where(bound_lp, N + kp_lp, -1))
    kp_src = jnp.where(valid2 & ~inl2, -1, kp_src)
    # resolved point id per keypoint (temporal VO slots stay -1) — the
    # device-side equivalent of the host binding decode, so the pipelined
    # driver can feed this straight into the next frame's `last_pt`
    pt_mm = last_pt[jnp.clip(kp_mm, 0)]
    kp_pt_out = jnp.where(
        kp_src < 0, -1,
        jnp.where(kp_src < N, pt_mm,
                  lp_ids[jnp.clip(kp_src - N, 0, lp_ids.shape[0] - 1)]))

    hdr = jnp.concatenate([
        opt1.T.ravel(), opt2.T.ravel(),
        jnp.stack([n_cand, n_mm, n_inl1_map, n_inl2_map]).astype(jnp.float32),
        jnp.zeros(4, jnp.float32)])
    fmat = jnp.concatenate([
        xy2, xy_raw2, xy_und,
        ur[:, None], ur0[:, None], depth[:, None],
        feats.angle[:, None], feats.response[:, None]], axis=1)
    imat = jnp.stack([
        feats.octave, kp_mm, kp_src,
        refined.astype(jnp.int32), feats.valid.astype(jnp.int32)], axis=1)
    return TrackFrameOut(
        hdr=hdr, fmat=fmat, imat=imat, desc=feats.desc,
        in_frustum=in_frustum,
        # u8: matches the map's own window storage (MapState.kf_patch) and
        # is 4x cheaper to fetch; the host materializes it lazily
        patch=jnp.clip(jnp.round(feats.patch), 0, 255).astype(jnp.uint8),
        kp_pt=kp_pt_out.astype(jnp.int32), T_out=opt2.T)


@functools.partial(
    jax.jit,
    static_argnames=("params", "cam", "sensor", "close_th", "depth_factor",
                     "log_scale"))
def track_frames_block(imgs, auxs, T_last, T_prev,
                       last_pt, last_xy, last_desc, last_octave, last_angle,
                       last_patch, last_valid, last_depth,
                       m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd,
                       m_valid, lp_ids, lp_mask, sf, sig2,
                       params: OrbParams, cam, sensor: str,
                       close_th: float, depth_factor: float, log_scale: float):
    """K frames tracked in ONE device dispatch (lax.scan over _frame_core).

    The driver amortizes one dispatch + one batched readback over a K-frame
    block. The pose/velocity recurrence and the binding chain live in the
    scan carry; the local-map slice (lp_ids) is frozen for the block (it
    changes only at keyframes — the host applies those between blocks, the
    same lag the reference's concurrent LocalMapping thread has).

    imgs: [K, H, W]; auxs: [K, ...] depth/right/imgs (by sensor).
    Returns (TrackFrameOut stacked over K, chain) where chain is the tuple
    of device arrays the next block consumes verbatim — no host hop, no
    eager slicing. The carried patch stays u8 (as uploaded / as emitted by
    _frame_core) so the seed block and chained blocks are ONE program
    variant — a second dtype variant would re-trace + re-compile this (big)
    program mid-run.
    """
    def step(carry, inputs):
        (Tl, Tp, c_pt, c_xy, c_desc, c_oct, c_ang, c_patch, c_valid,
         c_depth) = carry
        img, aux = inputs
        T_pred = _predict_pose(Tl, Tp)
        out = _frame_core(
            img, aux, T_pred, Tl, c_pt, c_xy, c_desc, c_oct, c_ang,
            c_patch, c_valid, c_depth, jnp.asarray(False),
            m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd, m_valid,
            lp_ids, lp_mask, jnp.float32(1.0), sf, sig2,
            params, cam, sensor, close_th, depth_factor, log_scale)
        carry2 = (out.T_out, Tl, out.kp_pt, out.fmat[:, 0:2], out.desc,
                  out.imat[:, 0], out.fmat[:, 9],
                  out.patch, out.imat[:, 4] != 0,
                  out.fmat[:, 8])
        return carry2, out

    carry0 = (T_last, T_prev, last_pt, last_xy, last_desc, last_octave,
              last_angle, last_patch.astype(jnp.uint8), last_valid,
              last_depth)
    chain, outs = jax.lax.scan(step, carry0, (imgs, auxs))

    # ---- packed per-frame readback: ONE device->host leaf per block ----
    # Every fetched leaf costs a device->host round trip, so the per-frame
    # readback is packed into a single int32 tensor [K, 32 + 4N + P/32]:
    #   [0:32)        hdr (f32 bitcast: poses + counts)
    #   [32:32+N)     kp_pt   resolved point id per keypoint (-1)
    #   [+N:+2N)      kp_mm   last-frame slot per keypoint (-1)
    #   [+2N:+3N)     flags   valid | refined<<1
    #   [+3N:+4N)     depth   (f32 bitcast; -1 mono)
    #   [+4N:]        in_frustum bitpacked 32/word
    # The full per-feature tensors (fmat/imat/desc/patch) stay ON DEVICE in
    # `outs`; the host materializes a frame's features lazily (only for
    # keyframe creation and fallback paths — tracking.Frame lazy load).
    K = imgs.shape[0]
    hdr_i = jax.lax.bitcast_convert_type(outs.hdr, jnp.int32)
    depth_i = jax.lax.bitcast_convert_type(outs.fmat[:, :, 8], jnp.int32)
    flags = outs.imat[:, :, 4] + 2 * outs.imat[:, :, 3]
    P = outs.in_frustum.shape[1]
    pad = (-P) % 32
    frus = outs.in_frustum
    if pad:
        frus = jnp.pad(frus, ((0, 0), (0, pad)))
    frus_w = jax.lax.bitcast_convert_type(
        jnp.sum(frus.reshape(K, -1, 32).astype(jnp.uint32)
                * (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)), -1),
        jnp.int32)
    packed = jnp.concatenate(
        [hdr_i, outs.kp_pt, outs.imat[:, :, 1], flags, depth_i, frus_w],
        axis=1)
    return outs, chain, packed


class MonoInitOut(NamedTuple):
    """Device-side result of mono_init_step.

    hdr [16] f32: [n_valid, n_matches, success, n_good, R.ravel()(9), t(3)]
    — the only leaf the host fetches per attempt (one round trip); the rest
    stays on device and is materialized ONCE when initialization succeeds.
    idx/good/X/xy2*: per REFERENCE-frame row (search_for_initialization's
    match layout). fmat/imat/desc/patch: the current frame's features in
    the TrackFrameOut packing, so the host Frame decode is shared.
    """
    hdr: jnp.ndarray
    idx: jnp.ndarray        # [N] int32: ref row -> current feature (-1)
    good: jnp.ndarray       # [N] bool: triangulated inlier (pre mask-join)
    X: jnp.ndarray          # [N, 3] points in ref-camera frame
    xy2: jnp.ndarray        # [N, 2] refined und position of the match
    xy2_raw: jnp.ndarray    # [N, 2] refined raw position
    ref_ok: jnp.ndarray     # [N] bool: match existed AND was LK-refined
    fmat: jnp.ndarray       # [N, 11] (TrackFrameOut layout; depth/ur = -1)
    imat: jnp.ndarray       # [N, 5]
    desc: jnp.ndarray       # [N, 8] u32
    patch: jnp.ndarray      # [N, 15, 15] u8


@functools.partial(jax.jit, static_argnames=("params", "cam"))
def mono_init_step(img, key, ref_xy, ref_desc, ref_valid, ref_angle,
                   ref_patch, sf, params: OrbParams, cam) -> MonoInitOut:
    """One monocular-initialization attempt, fused into a single dispatch.

    The reference's MonocularInitialization (src/Tracking.cpp:729-832:
    SearchForInitialization -> Initializer::Initialize H/F RANSAC) ran here
    as 3-4 separate host-driven stages, each paying a device round trip.
    Fused: extraction, windowed init matching,
    feature-metric refinement of the matches against the reference frame's
    templates, and the 200-hypothesis H+F two-view RANSAC all run in ONE
    program; the host fetches a 16-float header to drive the state machine
    and materializes the big tensors only on success.

    ref_*: the reference frame's feature arrays (device-chained from ITS
    OWN mono_init_step dispatch — never re-uploaded). For the first frame
    (no reference yet) the caller passes zeros with ref_valid all-False:
    the match count comes back 0 and the host only consumes n_valid.
    """
    H, W = cam.height, cam.width
    img = img.astype(jnp.float32)
    feats = F.extract_orb(img, params, H, W)
    xy_und = cam_mod.undistort_pixels(cam, feats.xy)
    res = M.search_for_initialization(
        ref_xy, ref_desc, ref_valid, ref_angle,
        xy_und, feats.desc, feats.valid, feats.angle)
    idx = res.idx
    m = idx >= 0
    n_matches = jnp.sum(m)

    # feature-metric refinement: matched current windows against the
    # reference frame's anchor templates (same semantics as the host path:
    # tracking._refine_measurements over mask_cur)
    tpl = RF.template_of(ref_patch.astype(jnp.float32))
    winc = feats.patch[jnp.clip(idx, 0)]
    delta, okr = RF.refine_offsets(winc, tpl, m)
    okr = okr & m
    oct_c = feats.octave[jnp.clip(idx, 0)]
    sf_c = sf[jnp.clip(oct_c, 0, sf.shape[0] - 1)]
    shift = delta * (sf_c * okr)[:, None]
    xy2_raw = feats.xy[jnp.clip(idx, 0)] + shift
    xy2u = cam_mod.undistort_pixels(cam, xy2_raw)
    xy2 = jnp.where(okr[:, None], xy2u, xy_und[jnp.clip(idx, 0)])
    xy2 = jnp.where(m[:, None], xy2, 0.0)

    K3 = jnp.array([[cam.fx, 0.0, cam.cx],
                    [0.0, cam.fy, cam.cy],
                    [0.0, 0.0, 1.0]], jnp.float32)
    tv = TV.initialize_two_view(key, ref_xy, xy2, m, K3)

    n_valid = jnp.sum(feats.valid)
    hdr = jnp.concatenate([
        jnp.stack([n_valid, n_matches,
                   tv.success.astype(jnp.int32),
                   jnp.sum(tv.good & m)]).astype(jnp.float32),
        tv.R.ravel(), tv.t])

    N = feats.xy.shape[0]
    neg1 = jnp.full((N, 1), -1.0, jnp.float32)
    fmat = jnp.concatenate([
        xy_und, feats.xy, xy_und, neg1, neg1, neg1,
        feats.angle[:, None], feats.response[:, None]], axis=1)
    # per-CURRENT-feature refined flag (scatter from ref rows)
    refined_cur = jnp.zeros((N,), jnp.int32).at[
        jnp.where(okr, idx, N)].set(1, mode="drop")
    zeros = jnp.zeros((N,), jnp.int32)
    imat = jnp.stack([feats.octave, zeros - 1, zeros - 1,
                      refined_cur, feats.valid.astype(jnp.int32)], axis=1)
    return MonoInitOut(
        hdr=hdr, idx=idx, good=tv.good, X=tv.points3d,
        xy2=xy2, xy2_raw=xy2_raw, ref_ok=okr,
        fmat=fmat, imat=imat, desc=feats.desc,
        patch=jnp.clip(jnp.round(feats.patch), 0, 255).astype(jnp.uint8))
