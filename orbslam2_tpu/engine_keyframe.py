"""Fused per-keyframe mapping device programs.

The reference's LocalMapping::CreateNewMapPoints and SearchInNeighbors
(src/LocalMapping.cpp:298-610, :611-721) loop over covisible neighbors with
per-pair matching/triangulation/fusion. Run as host loops with one device
dispatch (+ blocking readback) per neighbor, that is ~60 round trips per
keyframe.

These programs batch each loop into ONE device dispatch + ONE readback:

- `map_new_points`: lax.scan over the neighbor axis — epipolar-gated
  matching (frontend/matcher.epipolar_match_core), feature-metric LK
  refinement of the neighbor observation against the anchor template
  (ops/refine.refine_offsets), DLT triangulation with the reference's
  chi2/parallax/scale gates (ops/triangulation.triangulate_gated). The
  anchor's free-feature mask is carried through the scan so a feature
  consumed by neighbor j cannot re-match in neighbor j+1 (same sequential
  semantics as the host loop and the reference).

- `fuse_targets`: lax.scan over fuse targets — the new keyframe's points
  projected into each neighbor (ORBmatcher::Fuse direction 1) plus the
  union of the neighbors' points projected into the new keyframe
  (direction 2), in one dispatch.

The host keeps only the bookkeeping: slot allocation, observation merges,
covisibility updates (local_mapping.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .frontend import matcher as FM
from .ops import refine as RF
from .ops import triangulation as TRI


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "scale_factor"))
def map_new_points(T1, xy1, oct1, desc1, free1, patch1,
                   Tn, xy2_0, oct2, desc2, free2, patch2, k_valid,
                   sigma2, sf,
                   fx: float, fy: float, cx: float, cy: float,
                   scale_factor: float):
    """Batched CreateNewMapPoints over K neighbors in one dispatch.

    T1 [3,4] anchor pose; xy1 [N,2] anchor PRISTINE undistorted coords
    (kf_xy0 — the anchor observation is reset to the detection and serves
    as the template center); oct1/desc1/free1/patch1: anchor features.
    Tn [K,3,4]; xy2_0/oct2/desc2/free2/patch2: neighbor feature arrays
    [K,N,...] (xy2_0 = the neighbors' pristine kf_xy0); k_valid [K] bool
    (host-side baseline/median-depth gate, src/LocalMapping.cpp:349-365).

    Returns (idx [K,N], X [K,N,3], ok [K,N], delta [K,N,2], okr [K,N]):
    idx = per-anchor-slot neighbor feature match (-1 none, pre-gate);
    X/ok = triangulated world point and acceptance; delta/okr = the LK
    refinement of the MATCHED NEIGHBOR observation in its level pixels
    (host applies kf_xy[kn, idx] = kf_xy0[kn, idx] + delta * sf[oct]).
    """
    tpl1 = RF.template_of(patch1.astype(jnp.float32))  # [N,11,11]

    def step(free1_carry, inputs):
        T2, xy2j, oct2j, desc2j, free2j, patch2j, kv = inputs
        res = FM.epipolar_match_core(
            T1, T2, xy1, oct1, desc1, free1_carry & kv,
            xy2j, oct2j, desc2j, free2j, sigma2, fx, fy, cx, cy)
        idx = res.idx                                   # [N] anchor -> nbr
        matched = idx >= 0
        j = jnp.clip(idx, 0)
        # refine the neighbor observation against the anchor template
        win = patch2j[j].astype(jnp.float32)            # [N,15,15]
        delta, okr = RF.refine_offsets(win, tpl1, matched)
        okr = okr & matched
        sfj = sf[jnp.clip(oct2j[j], 0, sf.shape[0] - 1)]
        xy2m = xy2j[j] + delta * (sfj * okr)[:, None]   # refined nbr coords
        X, ok = TRI.triangulate_gated(
            T1, T2, xy1, xy2m, oct1, oct2j[j], matched, sigma2, sf,
            fx, fy, cx, cy, scale_factor)
        ok = ok & matched
        free1_next = free1_carry & ~ok
        return free1_next, (idx, X, ok, delta, okr)

    _, (idx, X, ok, delta, okr) = jax.lax.scan(
        step, free1, (Tn, xy2_0, oct2, desc2, free2, patch2, k_valid))
    # pack into TWO readback leaves (each fetched leaf costs a device->host
    # round trip): ints [K,N,2] = (idx, ok|okr<<1); floats [K,N,5]
    # = (X, delta)
    ints = jnp.stack([idx, ok.astype(jnp.int32)
                      + 2 * okr.astype(jnp.int32)], axis=-1)
    flts = jnp.concatenate([X, delta], axis=-1)
    return ints, flts


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "bf", "width", "height",
                     "n_levels", "log_scale"))
def fuse_targets(T_t, kp_xy_t, kp_oct_t, kp_desc_t, kp_valid_t, kp_ur_t,
                 a_xyz, a_valid, a_desc, a_normal, a_mind, a_maxd,
                 T_kf, kp_xy_k, kp_oct_k, kp_desc_k, kp_valid_k, kp_ur_k,
                 b_xyz, b_valid, b_desc, b_normal, b_mind, b_maxd,
                 sf, fx: float, fy: float, cx: float, cy: float, bf: float,
                 width: int, height: int, n_levels: int, log_scale: float):
    """Batched SearchInNeighbors fuse in one dispatch.

    Direction 1: the new keyframe's point set a_* [Pa] projected into each
    of T fuse targets (poses T_t [T,3,4], feature arrays [T,N,...]).
    Direction 2: the union of the targets' points b_* [Pb] projected into
    the new keyframe (T_kf, [N,...] feature arrays).

    Returns (idx_a [T,Pa], idx_b [Pb]) — matched keypoint per point or -1.
    """
    no_already_a = jnp.zeros(a_xyz.shape[0], bool)

    def step(_, inputs):
        T2, xyj, octj, descj, validj, urj = inputs
        res, _ = FM.local_points_core(
            T2, a_xyz, a_valid, a_desc, a_normal, a_mind, a_maxd,
            no_already_a, xyj, octj, descj, validj, urj, sf,
            fx, fy, cx, cy, bf, width, height, n_levels, log_scale,
            jnp.float32(3.0), dedup=False)
        return 0, res.idx

    _, idx_a = jax.lax.scan(
        step, 0, (T_t, kp_xy_t, kp_oct_t, kp_desc_t, kp_valid_t, kp_ur_t))

    res_b, _ = FM.local_points_core(
        T_kf, b_xyz, b_valid, b_desc, b_normal, b_mind, b_maxd,
        jnp.zeros(b_xyz.shape[0], bool),
        kp_xy_k, kp_oct_k, kp_desc_k, kp_valid_k, kp_ur_k, sf,
        fx, fy, cx, cy, bf, width, height, n_levels, log_scale,
        jnp.float32(3.0), dedup=False)
    return idx_a, res_b.idx


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "bf", "width", "height",
                     "n_levels", "log_scale"))
def fuse_scw(T_g, kp_xy_g, kp_oct_g, kp_desc_g, kp_valid_g, kp_ur_g,
             p_xyz, p_valid, p_desc, p_normal, p_mind, p_maxd,
             sf, fx: float, fy: float, cx: float, cy: float, bf: float,
             width: int, height: int, n_levels: int, log_scale: float):
    """Group-wide loop fusion (ORBmatcher::Fuse(Scw) swept over the
    corrected covisible group — LoopClosing::SearchAndFuse,
    src/LoopClosing.cpp:744-789) in ONE dispatch.

    T_g [G,3,4]: the group's CORRECTED (SE3-demoted) poses — projecting
    the demoted pose is numerically identical to projecting the Scw
    similarity (the scale cancels in the perspective divide; the distance
    band uses |p_c|/s which the demoted pose yields directly).
    kp_* [G,N,...]: the group keyframes' feature arrays.
    p_* [P]: the loop-region point set (padded, p_valid mask).

    Returns idx [G,P]: matched keypoint per (group KF, loop point), -1
    none. dedup=False — multiple loop points claiming one keypoint MUST
    surface so the host can merge (the reference's replace mechanism).
    Radius th=1.0 -> 2.5-4 px x scale (the reference's Fuse(Scw) 4 px)."""
    no_already = jnp.zeros(p_xyz.shape[0], bool)

    def step(_, inputs):
        T2, xyj, octj, descj, validj, urj = inputs
        res, _ = FM.local_points_core(
            T2, p_xyz, p_valid, p_desc, p_normal, p_mind, p_maxd,
            no_already, xyj, octj, descj, validj, urj, sf,
            fx, fy, cx, cy, bf, width, height, n_levels, log_scale,
            jnp.float32(1.0), dedup=False)
        return 0, res.idx

    _, idx = jax.lax.scan(
        step, 0, (T_g, kp_xy_g, kp_oct_g, kp_desc_g, kp_valid_g, kp_ur_g))
    return idx
