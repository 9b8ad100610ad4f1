"""Hamming descriptor matching kernels (batched XLA).

Batched redesign of ORBmatcher (src/ORBmatcher.cpp). The reference walks
per-feature grid buckets; here every variant is one dense masked [A, B]
XOR-popcount matrix (one fused elementwise reduction, fixed shapes), with the
same gating rules:

- DescriptorDistance (:1901)      -> `hamming_matrix` via lax.population_count
- TH_HIGH=100 / TH_LOW=50 / HISTO_LENGTH=30 constants (:37-39)
- nn-ratio test + rotation-histogram consistency (ComputeThreeMaxima, :1854)
- SearchForInitialization (:499)  -> windowed masked matching
- SearchByProjection(F, vpMapPoints) (:63) and (cur, last) (:1564)
  -> `search_by_projection`: project, gate by radius * octave scale,
     predicted-level window, then masked Hamming argmin.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
# Python int, NOT jnp.int32: a module-level jnp array is created on the
# default device at import time and captured by every program that closes
# over it; a plain int is a trace-time literal.
BIG = 1 << 20


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """[A, 8] u32 x [B, 8] u32 -> [A, B] int32 Hamming distances.

    XLA fuses the XOR, popcount and 8-word sum into one kernel whose cost is
    writing the [A, B] result (PERF.md, "Hamming matrix")."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def rotation_consistency(angle_a, angle_b, match_idx, valid):
    """Keep only matches whose orientation difference falls in the 3 dominant
    histogram bins (ORBmatcher::ComputeThreeMaxima, src/ORBmatcher.cpp:1854).

    angle_a: [A]; angle_b: [B]; match_idx: [A] index into B (-1 invalid).
    Returns updated valid mask [A].
    """
    rot = angle_a - angle_b[jnp.clip(match_idx, 0)]
    binf = rot * (HISTO_LENGTH / (2.0 * np.pi))
    bins = jnp.mod(jnp.round(binf).astype(jnp.int32), HISTO_LENGTH)
    hist = jnp.zeros((HISTO_LENGTH,), jnp.int32).at[bins].add(valid.astype(jnp.int32))
    top3 = jax.lax.top_k(hist, 3)[0]
    # reference drops bins 2/3 if weaker than 0.1 * max
    thresh = jnp.maximum((0.1 * top3[0]).astype(jnp.int32), 1)
    keep_count = jnp.where(top3 >= thresh, top3, -1)
    in_top = (hist[bins])[:, None] == keep_count[None, :]
    return valid & jnp.any(in_top, axis=-1)


class MatchResult(NamedTuple):
    idx: jnp.ndarray    # [A] int32 index into B, -1 if unmatched
    dist: jnp.ndarray   # [A] int32 Hamming distance (BIG if unmatched)

    @property
    def valid(self):
        return self.idx >= 0


def masked_best_match(dist: jnp.ndarray, cand_mask: jnp.ndarray,
                      max_dist: int, ratio: float | None) -> MatchResult:
    """Best + second-best along axis 1 with candidate mask, distance gate and
    optional Lowe ratio test."""
    d = jnp.where(cand_mask, dist, BIG)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(BIG)
    second = jnp.min(d2, axis=1)
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    return MatchResult(jnp.where(ok, best_idx, -1), jnp.where(ok, best, BIG))


def mutual_filter(res_ab: MatchResult, res_ba: MatchResult) -> MatchResult:
    """Cross-check: keep a->b only if b->a points back."""
    back = res_ba.idx[jnp.clip(res_ab.idx, 0)]
    ok = res_ab.valid & (back == jnp.arange(res_ab.idx.shape[0]))
    return MatchResult(jnp.where(ok, res_ab.idx, -1),
                       jnp.where(ok, res_ab.dist, BIG))


@functools.partial(jax.jit, static_argnames=("window", "ratio",
                                             "check_orientation"))
def search_for_initialization(xy_a, desc_a, valid_a, angle_a,
                              xy_b, desc_b, valid_b, angle_b,
                              window: float = 100.0, ratio: float = 0.9,
                              check_orientation: bool = True) -> MatchResult:
    """Monocular-init windowed matching
    (ORBmatcher::SearchForInitialization, src/ORBmatcher.cpp:499-630).

    jit at def-site: called from the host during mono init — eager op-by-op
    execution would cost hundreds of tiny dispatches per call, and sub-0.5 s
    per-op compiles never enter the persistent cache. One program fixes
    both."""
    dist = hamming_matrix(desc_a, desc_b)
    dxy = xy_a[:, None, :] - xy_b[None, :, :]
    in_window = (jnp.abs(dxy[..., 0]) < window) & (jnp.abs(dxy[..., 1]) < window)
    cand = in_window & valid_a[:, None] & valid_b[None, :]
    res = masked_best_match(dist, cand, TH_LOW, ratio)
    ok = res.valid
    if check_orientation:
        ok = rotation_consistency(angle_a, angle_b, res.idx, ok)
    return MatchResult(jnp.where(ok, res.idx, -1), jnp.where(ok, res.dist, BIG))


@functools.partial(jax.jit, static_argnames=("max_dist", "ratio",
                                             "level_window"))
def search_by_projection(proj_uv, pred_level, radius, pt_desc, pt_valid,
                         kp_xy, kp_octave, kp_desc, kp_valid,
                         scale_factors, max_dist: int = TH_HIGH,
                         ratio: float | None = 0.8,
                         level_window: tuple[int, int] = (-1, 1),
                         pt_ur=None, kp_ur=None) -> MatchResult:
    """Project-and-match: map points (rows) vs frame keypoints (cols).

    proj_uv: [P, 2] projected pixel positions of points (undistorted coords)
    pred_level: [P] predicted octave per point (PredictScale,
        src/MapPoint.cpp:489-530)
    radius: [P] base search radius in level-0 pixels (already view-cos scaled,
        src/ORBmatcher.cpp:166-172); effective radius *= scale(pred_level)
    level_window: keypoint octave must be within [pred+lo, pred+hi]
        (src/ORBmatcher.cpp:96-97 via GetFeaturesInArea level bounds)
    pt_ur/kp_ur: predicted vs measured right-u; stereo keypoints must also
        agree in the right image, |pt_ur - kp_ur| <= r_eff
        (src/ORBmatcher.cpp:123-129)

    Returns per-point best keypoint match.
    """
    sf = jnp.asarray(scale_factors)
    r_eff = radius * sf[jnp.clip(pred_level, 0, sf.shape[0] - 1)]
    duv = proj_uv[:, None, :] - kp_xy[None, :, :]
    within = (jnp.abs(duv[..., 0]) <= r_eff[:, None]) & (
        jnp.abs(duv[..., 1]) <= r_eff[:, None]
    )
    lv_ok = (kp_octave[None, :] >= pred_level[:, None] + level_window[0]) & (
        kp_octave[None, :] <= pred_level[:, None] + level_window[1]
    )
    cand = within & lv_ok & pt_valid[:, None] & kp_valid[None, :]
    if pt_ur is not None and kp_ur is not None:
        er_ok = (kp_ur[None, :] < 0) | (
            jnp.abs(pt_ur[:, None] - kp_ur[None, :]) <= r_eff[:, None])
        cand = cand & er_ok
    dist = hamming_matrix(pt_desc, kp_desc)
    return masked_best_match(dist, cand, max_dist, ratio)


def resolve_duplicate_targets(res: MatchResult, n_targets: int) -> MatchResult:
    """Ensure each target (keypoint) is claimed by at most one source (point):
    keep the lowest-distance claimant. Scatter-min over targets."""
    tgt = jnp.clip(res.idx, 0)
    best_per_tgt = jnp.full((n_targets,), BIG, jnp.int32).at[tgt].min(
        jnp.where(res.valid, res.dist, BIG)
    )
    # a source keeps its match only if it achieves the min for that target;
    # break exact ties by lowest source index
    achieves = res.valid & (res.dist == best_per_tgt[tgt])
    first_claimant = jnp.full((n_targets,), jnp.iinfo(jnp.int32).max, jnp.int32).at[tgt].min(
        jnp.where(achieves, jnp.arange(res.idx.shape[0]), jnp.iinfo(jnp.int32).max)
    )
    keep = achieves & (first_claimant[tgt] == jnp.arange(res.idx.shape[0]))
    return MatchResult(jnp.where(keep, res.idx, -1), jnp.where(keep, res.dist, BIG))
