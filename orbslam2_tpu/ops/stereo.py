"""Stereo keypoint matching kernel.

JAX-native redesign of Frame::ComputeStereoMatches (src/Frame.cpp:551-770):
the reference builds per-row candidate tables and loops; here the whole
left-vs-right association is one dense masked Hamming matrix with the same
gates:

- row band: |v_L - v_R| <= 2 * scale(octave_R) (src/Frame.cpp:574-589)
- octave window: octave_R in [octave_L - 1, octave_L + 1] (:628)
- disparity range (0, max_disp], max_disp = fx i.e. depth >= baseline
  (:591-595)
- Hamming <= TH_HIGH, then a median-based outlier trim
  (1.5 * 1.4 * median, :754-769, applied to Hamming distance here — the
  reference applies it to the SAD refine score; deviation documented)

Sub-pixel SAD refinement (:662-750) is ported as `refine_disparity`: an
11x11 window slid +-5 on the matched pyramid level, parabola fit on the SAD
minimum — one batched gather program over all matches.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import matching as M
from . import features as F


@functools.partial(jax.jit, static_argnames=("bf", "fx"))
def stereo_match(l_xy, l_oct, l_desc, l_valid,
                 r_xy, r_oct, r_desc, r_valid,
                 scale_factors, bf: float, fx: float):
    """Associate left keypoints with right keypoints along epipolar rows.

    Inputs are level-0 (raw/rectified) coords. Returns (ur [N], depth [N]),
    -1 where unmatched.
    """
    sf = jnp.asarray(scale_factors)
    dv = jnp.abs(l_xy[:, None, 1] - r_xy[None, :, 1])
    band = 2.0 * sf[jnp.clip(r_oct, 0, sf.shape[0] - 1)]
    row_ok = dv <= band[None, :]
    d_oct = l_oct[:, None] - r_oct[None, :]
    oct_ok = (d_oct >= -1) & (d_oct <= 1)
    disp = l_xy[:, None, 0] - r_xy[None, :, 0]
    disp_ok = (disp > 0.1) & (disp <= fx)
    cand = row_ok & oct_ok & disp_ok & l_valid[:, None] & r_valid[None, :]

    dist = M.hamming_matrix(l_desc, r_desc)
    res = M.masked_best_match(dist, cand, M.TH_HIGH, ratio=None)

    matched = res.valid
    best_disp = jnp.where(matched,
                          l_xy[:, 0] - r_xy[jnp.clip(res.idx, 0), 0], -1.0)
    # median-based trim of weak matches
    d = jnp.where(matched, res.dist, 10_000)
    med = jnp.nanmedian(jnp.where(matched, res.dist.astype(jnp.float32), jnp.nan))
    med = jnp.nan_to_num(med, nan=float(M.TH_HIGH))
    keep = matched & (d.astype(jnp.float32) <= 1.5 * 1.4 * med) & (best_disp > 0.1)

    depth = jnp.where(keep, bf / jnp.maximum(best_disp, 1e-6), -1.0)
    ur = jnp.where(keep, r_xy[jnp.clip(res.idx, 0), 0], -1.0)
    return ur, depth


def _build_atlas(img, n_levels, scale, H0, W0):
    """Pyramid atlas [L, H0, W0] (same construction as ops/features.py)."""
    sizes = F.level_sizes(H0, W0, n_levels, scale)
    atlas = jnp.zeros((n_levels, H0, W0), img.dtype)
    level_img = img
    for lv in range(n_levels):
        h, w = sizes[lv]
        if lv > 0:
            level_img = jax.image.resize(level_img, (h, w), method="bilinear")
        atlas = atlas.at[lv, :h, :w].set(level_img)
        atlas = atlas.at[lv, h:, :w].set(level_img[-1][None, :])
        atlas = atlas.at[lv, :h, w:].set(level_img[:, -1][:, None])
        atlas = atlas.at[lv, h:, w:].set(level_img[-1, -1])
    return atlas


_W = 5       # window half-size (11x11, src/Frame.cpp:664)
_SLIDE = 5   # disparity slide range +-5 (src/Frame.cpp:675)


@functools.partial(jax.jit, static_argnames=("n_levels", "scale", "height",
                                             "width", "bf"))
def refine_disparity(left_img, right_img, l_xy, l_oct, ur0, depth0,
                     n_levels: int, scale: float, height: int, width: int,
                     bf: float):
    """Sub-pixel SAD refinement of matched stereo pairs
    (Frame::ComputeStereoMatches second phase, src/Frame.cpp:662-750):
    for each left keypoint with an integer match at ur0, slide an 11x11
    window on the matched pyramid level +-5 px, take the SAD minimum with a
    parabola fit, and re-derive (ur, depth). Matches whose SAD valley is at
    the slide border are dropped (as the reference does).

    l_xy: [N, 2] level-0 coords; l_oct: [N]; ur0/depth0: [N] from
    `stereo_match` (-1 = unmatched).
    """
    la = _build_atlas(left_img, n_levels, scale, height, width)
    ra = _build_atlas(right_img, n_levels, scale, height, width)
    sf = jnp.asarray(F.scale_factors(
        type("P", (), {"scale_factor": scale, "n_levels": n_levels})()))
    inv_sf = 1.0 / sf[jnp.clip(l_oct, 0, n_levels - 1)]

    matched = ur0 > 0
    # level coords of the left keypoint and the right match
    lx = jnp.round(l_xy[:, 0] * inv_sf).astype(jnp.int32)
    ly = jnp.round(l_xy[:, 1] * inv_sf).astype(jnp.int32)
    rx = jnp.round(ur0 * inv_sf).astype(jnp.int32)
    margin = _W + _SLIDE + 1
    lx = jnp.clip(lx, margin, width - margin)
    ly = jnp.clip(ly, margin, height - margin)
    rx = jnp.clip(rx, margin, width - margin)
    lvl = jnp.clip(l_oct, 0, n_levels - 1)

    def window(atlas, l, cy, cx):
        # [N, 11, 11] gather
        def one(l_, y_, x_):
            return jax.lax.dynamic_slice(
                atlas, (l_, y_ - _W, x_ - _W), (1, 2 * _W + 1, 2 * _W + 1))[0]
        return jax.vmap(one)(l, cy, cx)

    wl = window(la, lvl, ly, lx)                      # [N, 11, 11]
    wl = wl - wl[:, _W:_W + 1, _W:_W + 1]             # center-normalized (:698)

    sads = []
    for dx in range(-_SLIDE, _SLIDE + 1):
        wr = window(ra, lvl, ly, rx + dx)
        wr = wr - wr[:, _W:_W + 1, _W:_W + 1]
        sads.append(jnp.sum(jnp.abs(wl - wr), axis=(1, 2)))
    sad = jnp.stack(sads, axis=-1)                    # [N, 11]

    best = jnp.argmin(sad, axis=-1)
    interior = (best > 0) & (best < 2 * _SLIDE)
    bi = jnp.clip(best, 1, 2 * _SLIDE - 1)
    c0 = jnp.take_along_axis(sad, (bi - 1)[:, None], 1)[:, 0]
    c1 = jnp.take_along_axis(sad, bi[:, None], 1)[:, 0]
    c2 = jnp.take_along_axis(sad, (bi + 1)[:, None], 1)[:, 0]
    denom = c0 - 2.0 * c1 + c2
    delta = 0.5 * (c0 - c2) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1e6)
    delta = jnp.clip(delta, -1.0, 1.0)  # (:737 rejects |delta|>1; we clamp)
    ok = matched & interior & (jnp.abs(delta) <= 1.0)

    best_ur_level = rx.astype(jnp.float32) + (bi - _SLIDE).astype(jnp.float32) + delta
    ur = best_ur_level * sf[lvl]
    disp = l_xy[:, 0] - ur
    good = ok & (disp > 0.01) & (disp <= width)
    ur_out = jnp.where(good, ur, jnp.where(matched, ur0, -1.0))
    # keep the integer match when refinement is rejected (conservative)
    depth_out = jnp.where(ur_out > 0, bf / jnp.maximum(l_xy[:, 0] - ur_out, 1e-6), -1.0)
    return ur_out, depth_out
