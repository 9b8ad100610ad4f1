"""ORB feature extraction as fixed-shape batched XLA programs.

JAX-native redesign of the reference's ORBextractor (src/ORBextractor.cpp):

- `ComputePyramid` (:1197)        -> bilinear resize per level (static shapes)
- cell-FAST `ComputeKeyPointsOctTree` (:819) -> dense vectorized FAST-9/16
  response maps (16 shifted images + bit-packed contiguous-arc test)
- `DistributeOctTree` quadtree (:571) -> per-cell best-corner bonus + global
  top-k per level: same spatial-uniformity goal, but a data-parallel
  selection instead of sequential node splitting
- `IC_Angle` (:79)                -> batched 31x31 patch gather + masked
  intensity-centroid moments
- `computeOrbDescriptor` (:113)   -> rotated 256-pair BRIEF via batched
  image gathers on the blurred level image, packed into 8 uint32 words

Deviations from the reference (documented for ATE parity review):
- FAST score: sum of threshold-exceeding circle differences over the
  brighter/darker side (reference uses OpenCV's arc-min score). Only affects
  corner ranking, not detection.
- BRIEF pattern: deterministic seeded Gaussian pairs (sigma = patch/5,
  clipped to radius 13) instead of OpenCV's learned bit_pattern_31_ table
  (which is a vendored data blob we do not copy). The vocabulary used for
  place recognition is trained on the same pattern (io/vocabulary.py), so
  the system is self-consistent.

Everything below is shape-static and jit-safe; per-level Python loops unroll
at trace time (8 levels).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import OrbParams

HALF_PATCH = 15
PATCH = 31
EDGE_BORDER = 20  # reference EDGE_THRESHOLD=19 (src/ORBextractor.cpp:76)
# Photometric template window per keypoint: 15x15 search patch (allows +-2px
# LK refinement of an 11x11 template) sampled at the subpixel detection
# position from the blurred level image. The reference achieves subpixel
# consistency only for stereo via SAD slides (src/Frame.cpp:662-750); here a
# stored patch gives every observation a template to align against.
PATCH_WIN = 15
TEMPLATE_WIN = 11

# FAST-9/16 Bresenham circle of radius 3, (dy, dx), clockwise.
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def level_sizes(height: int, width: int, n_levels: int, scale: float):
    """Static pyramid level shapes."""
    out = []
    for lv in range(n_levels):
        s = scale ** lv
        out.append((max(8, int(round(height / s))), max(8, int(round(width / s)))))
    return out


def features_per_level(n_features: int, n_levels: int, scale: float):
    """Geometric per-level feature budget (ORBextractor ctor logic,
    src/ORBextractor.cpp:436-452)."""
    inv = 1.0 / scale
    n_first = n_features * (1 - inv) / (1 - inv ** n_levels)
    budgets, total = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n_first * inv ** lv))
        budgets.append(b)
        total += b
    budgets.append(max(n_features - total, 0))
    return budgets


@functools.lru_cache(maxsize=8)
def brief_pattern(seed: int = 7) -> np.ndarray:
    """Deterministic 256-pair BRIEF sampling pattern, shape [256, 4] =
    (ax, ay, bx, by), Gaussian sigma=patch/5, clipped to radius 13 so any
    rotation stays inside the 31x31 patch + border margin."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(256, 4))
    pts = np.clip(pts, -13.0, 13.0)
    # clip to radius 13 per endpoint
    for off in (0, 2):
        r = np.sqrt(pts[:, off] ** 2 + pts[:, off + 1] ** 2)
        f = np.where(r > 13.0, 13.0 / r, 1.0)
        pts[:, off] *= f
        pts[:, off + 1] *= f
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _ic_angle_masks():
    """Circular mask and coordinate grids for the intensity centroid.
    Cached as numpy (caching device arrays would leak tracers under jit)."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    mask = (xs ** 2 + ys ** 2) <= HALF_PATCH ** 2
    return (mask.astype(np.float32), xs.astype(np.float32), ys.astype(np.float32))


def fast_response(img: jnp.ndarray, th_high: float, th_low: float):
    """Dense FAST-9/16 corner response at two thresholds.

    Returns (resp_high, resp_low): response maps, zero at non-corners.
    img is float32 [H, W] in [0, 255].
    """
    pad = jnp.pad(img, 3, mode="edge")
    H, W = img.shape
    shifted = jnp.stack(
        [pad[3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W] for dy, dx in _CIRCLE], axis=0
    )  # [16, H, W]
    d = shifted - img[None]  # circle minus center

    def corner_and_score(th):
        bright = (d > th).astype(jnp.uint32)
        dark = (d < -th).astype(jnp.uint32)

        def has_run9(bits16):
            # pack 16 bools -> uint32 mask, duplicate, AND of 9 shifts
            weights = (2 ** np.arange(16)).astype(np.uint32)
            m = jnp.sum(bits16 * jnp.asarray(weights)[:, None, None], axis=0)
            m2 = m | (m << 16)
            run = m2
            for k in range(1, 9):
                run = run & (m2 >> k)
            return (run & jnp.uint32(0xFFFF)) != 0

        is_b = has_run9(bright)
        is_d = has_run9(dark)
        sb = jnp.sum(jnp.maximum(d - th, 0.0), axis=0)
        sd = jnp.sum(jnp.maximum(-d - th, 0.0), axis=0)
        score = jnp.where(is_b, sb, 0.0)
        score = jnp.maximum(score, jnp.where(is_d, sd, 0.0))
        return score

    return corner_and_score(th_high), corner_and_score(th_low)


def nms3(resp):
    """3x3 non-max suppression (OpenCV FAST's nonmaxSuppression=true, used by
    the reference at src/ORBextractor.cpp:875)."""
    pad = jnp.pad(resp, 1, mode="constant")
    H, W = resp.shape
    mx = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            mx = jnp.maximum(mx, pad[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W])
    return jnp.where(resp >= mx, resp, 0.0)


def _border_mask(H: int, W: int, border: int):
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    return (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )


def select_keypoints(resp_high, resp_low, budget: int, cell: int, border: int):
    """Budgeted spatially-uniform corner selection (replaces DistributeOctTree).

    Priority order: (1) best high-threshold corner of each cell, (2) remaining
    high-threshold corners by score, (3) best low-threshold corner per cell,
    (4) remaining low-threshold corners. Encoded as additive score bonuses,
    then one global top-k. Mirrors the reference's per-cell threshold fallback
    (src/ORBextractor.cpp:875-883) + quadtree best-per-node retention.
    """
    H, W = resp_high.shape
    bmask = _border_mask(H, W, border)
    rh = jnp.where(bmask, nms3(resp_high), 0.0)
    rl = jnp.where(bmask, nms3(resp_low), 0.0)

    # normalize scores into [0, 1) so bonuses dominate tiers
    def norm(r):
        return r / (jnp.max(r) + 1e-6)

    nh, nl = norm(rh), norm(rl)

    Hp = (H + cell - 1) // cell * cell
    Wp = (W + cell - 1) // cell * cell

    def cell_best_mask(r):
        rp = jnp.pad(r, ((0, Hp - H), (0, Wp - W)))
        c = rp.reshape(Hp // cell, cell, Wp // cell, cell)
        cmax = c.max(axis=(1, 3), keepdims=True)
        best = (c == cmax) & (c > 0)
        return best.reshape(Hp, Wp)[:H, :W]

    tier = jnp.zeros_like(rh)
    tier = jnp.where(rl > 0, 1.0 + nl, tier)                    # tier 1: low-th corner
    tier = jnp.where(cell_best_mask(rl), 3.0 + nl, tier)        # tier 3: cell-best low
    tier = jnp.where(rh > 0, 5.0 + nh, tier)                    # tier 5: high-th corner
    tier = jnp.where(cell_best_mask(rh) & (rh > 0), 7.0 + nh, tier)  # tier 7: cell-best high

    flat = tier.ravel()
    scores, idx = jax.lax.top_k(flat, budget)
    ys = idx // W
    xs = idx % W
    valid = scores > 0
    resp = jnp.where(rh.ravel()[idx] > 0, rh.ravel()[idx], rl.ravel()[idx])
    return xs, ys, jnp.where(valid, resp, 0.0), valid


def _gather_patches(img, xs, ys):
    """[K] integer centers -> [K, 31, 31] patches (centers assumed >= border
    from the edge, enforced by selection)."""

    def one(x, y):
        return jax.lax.dynamic_slice(
            img, (y - HALF_PATCH, x - HALF_PATCH), (PATCH, PATCH)
        )

    return jax.vmap(one)(xs, ys)


def ic_angles(img, xs, ys):
    """Intensity-centroid orientation (IC_Angle, src/ORBextractor.cpp:79-111).
    Returns angle in radians, [K]."""
    mask, gx, gy = _ic_angle_masks()
    patches = _gather_patches(img, xs, ys)  # [K, 31, 31]
    pm = patches * mask
    m10 = jnp.sum(pm * gx, axis=(1, 2))
    m01 = jnp.sum(pm * gy, axis=(1, 2))
    return jnp.arctan2(m01, m10)


def brief_descriptors(img_blur, xs, ys, angles):
    """Rotated-BRIEF (computeOrbDescriptor, src/ORBextractor.cpp:113-157):
    sample 256 point pairs rotated by the keypoint angle from the blurred
    level image; bit i = I(a_i) < I(b_i). Returns [K, 8] uint32."""
    H, W = img_blur.shape
    pat = jnp.asarray(brief_pattern())  # [256, 4]
    ca, sa = jnp.cos(angles), jnp.sin(angles)  # [K]

    def rotxy(px, py):
        # [K, 256] rotated integer offsets
        rx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]).astype(jnp.int32)
        ry = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]).astype(jnp.int32)
        return rx, ry

    ax, ay = rotxy(pat[:, 0], pat[:, 1])
    bx, by = rotxy(pat[:, 2], pat[:, 3])

    def sample(dx, dy):
        x = jnp.clip(xs[:, None] + dx, 0, W - 1)
        y = jnp.clip(ys[:, None] + dy, 0, H - 1)
        return jnp.take(img_blur.ravel(), y * W + x)

    bits = (sample(ax, ay) < sample(bx, by)).astype(jnp.uint32)  # [K, 256]
    words = bits.reshape(-1, 8, 32)
    weights = jnp.asarray((2 ** np.arange(32)).astype(np.uint32))
    return jnp.sum(words * weights[None, None, :], axis=-1, dtype=jnp.uint32)


def gaussian_blur7(img, sigma: float = 2.0):
    """Separable 7x7 Gaussian (reference blurs before BRIEF,
    src/ORBextractor.cpp:1167)."""
    r = 3
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    kj = jnp.asarray(k)
    pad = jnp.pad(img, ((r, r), (r, r)), mode="edge")
    # horizontal then vertical via shifts (small static unroll, fuses well)
    H, W = img.shape
    h = sum(kj[i] * pad[r: r + H, i: i + W] for i in range(2 * r + 1))
    hpad = jnp.pad(h, ((r, r), (0, 0)), mode="edge")
    return sum(kj[i] * hpad[i: i + H, :] for i in range(2 * r + 1))


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set (the device-side Frame payload,
    cf. include/Frame.h keypoint/descriptor members)."""

    xy: jnp.ndarray        # [N, 2] float32, level-0 pixel coords (raw image)
    response: jnp.ndarray  # [N] float32
    angle: jnp.ndarray     # [N] float32 radians
    octave: jnp.ndarray    # [N] int32
    desc: jnp.ndarray      # [N, 8] uint32 (256-bit)
    valid: jnp.ndarray     # [N] bool
    patch: jnp.ndarray     # [N, 15, 15] float32, blurred level-image window
    #                        centered exactly on the subpixel keypoint

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def padded_capacity(n_features: int) -> int:
    return int(math.ceil(n_features / 256) * 256)


def _fast_response_batched(atlas, th_high: float, th_low: float):
    """FAST-9/16 over the whole pyramid atlas [L, H, W] at once."""
    pad = jnp.pad(atlas, ((0, 0), (3, 3), (3, 3)), mode="edge")
    L, H, W = atlas.shape
    shifted = jnp.stack(
        [pad[:, 3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W] for dy, dx in _CIRCLE],
        axis=0,
    )  # [16, L, H, W]
    d = shifted - atlas[None]

    def corner_and_score(th):
        bright = (d > th).astype(jnp.uint32)
        dark = (d < -th).astype(jnp.uint32)

        def has_run9(bits16):
            weights = (2 ** np.arange(16)).astype(np.uint32)
            m = jnp.sum(bits16 * jnp.asarray(weights)[:, None, None, None], axis=0)
            m2 = m | (m << 16)
            run = m2
            for k in range(1, 9):
                run = run & (m2 >> k)
            return (run & jnp.uint32(0xFFFF)) != 0

        is_b = has_run9(bright)
        is_d = has_run9(dark)
        sb = jnp.sum(jnp.maximum(d - th, 0.0), axis=0)
        sd = jnp.sum(jnp.maximum(-d - th, 0.0), axis=0)
        score = jnp.where(is_b, sb, 0.0)
        return jnp.maximum(score, jnp.where(is_d, sd, 0.0))

    return corner_and_score(th_high), corner_and_score(th_low)


def _nms3_batched(resp):
    pad = jnp.pad(resp, ((0, 0), (1, 1), (1, 1)))
    L, H, W = resp.shape
    mx = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            mx = jnp.maximum(mx, pad[:, 1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W])
    return jnp.where(resp >= mx, resp, 0.0)


def gaussian_blur7_batched(atlas, sigma: float = 2.0):
    """Separable 7x7 Gaussian over [L, H, W]."""
    r = 3
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    kj = jnp.asarray((k / k.sum()).astype(np.float32))
    L, H, W = atlas.shape
    pad = jnp.pad(atlas, ((0, 0), (0, 0), (r, r)), mode="edge")
    h = sum(kj[i] * pad[:, :, i: i + W] for i in range(2 * r + 1))
    hpad = jnp.pad(h, ((0, 0), (r, r), (0, 0)), mode="edge")
    return sum(kj[i] * hpad[:, i: i + H, :] for i in range(2 * r + 1))


@functools.partial(jax.jit, static_argnames=("params", "height", "width"))
def extract_orb(img, params: OrbParams, height: int, width: int) -> FrameFeatures:
    """Full ORB extraction over the pyramid. img: [H, W] float32 [0, 255].

    Replaces ORBextractor::operator() (src/ORBextractor.cpp:1120-1195).
    Batched design: all pyramid levels live in one padded atlas [L, H, W] so
    FAST, NMS, blur and the angle/descriptor gathers are single batched ops
    (the reference loops levels; unrolling 8 subgraphs also made XLA compiles
    ~8x slower). Per-level work that must stay separate (budgeted top-k) is
    a small unrolled loop over response slices.
    """
    # accept any integer/float dtype: callers upload the cheapest form (u8)
    # and all compute is f32
    img = img.astype(jnp.float32)
    L = params.n_levels
    sizes = level_sizes(height, width, L, params.scale_factor)
    budgets = features_per_level(params.n_features, L, params.scale_factor)
    min_size = 2 * EDGE_BORDER + 8
    H0, W0 = height, width

    # ---- pyramid atlas ----
    atlas = jnp.zeros((L, H0, W0), img.dtype)
    level_img = img
    for lv in range(L):
        h, w = sizes[lv]
        if h < min_size or w < min_size:
            continue
        if lv > 0:
            level_img = jax.image.resize(level_img, (h, w), method="bilinear")
        # replicate last row/col outward so FAST/blur edge handling stays sane
        atlas = atlas.at[lv, :h, :w].set(level_img)
        atlas = atlas.at[lv, h:, :w].set(level_img[-1][None, :])
        atlas = atlas.at[lv, :h, w:].set(level_img[:, -1][:, None])
        atlas = atlas.at[lv, h:, w:].set(level_img[-1, -1])

    # ---- batched FAST + NMS, masked to per-level valid interiors ----
    rh, rl = _fast_response_batched(atlas, params.ini_th_fast, params.min_th_fast)
    ys_g = jax.lax.broadcasted_iota(jnp.int32, (L, H0, W0), 1)
    xs_g = jax.lax.broadcasted_iota(jnp.int32, (L, H0, W0), 2)
    interior = jnp.stack([
        (ys_g[lv] >= EDGE_BORDER) & (ys_g[lv] < sizes[lv][0] - EDGE_BORDER)
        & (xs_g[lv] >= EDGE_BORDER) & (xs_g[lv] < sizes[lv][1] - EDGE_BORDER)
        if sizes[lv][0] >= min_size and sizes[lv][1] >= min_size
        else jnp.zeros((H0, W0), bool)
        for lv in range(L)
    ])
    rh = jnp.where(interior, _nms3_batched(rh), 0.0)
    rl = jnp.where(interior, _nms3_batched(rl), 0.0)

    # ---- per-level budgeted selection (tiered cell-uniform top-k) ----
    cell = params.cell_size
    Hp = (H0 + cell - 1) // cell * cell
    Wp = (W0 + cell - 1) // cell * cell

    def cell_best_mask(r):
        rp = jnp.pad(r, ((0, 0), (0, Hp - H0), (0, Wp - W0)))
        c = rp.reshape(L, Hp // cell, cell, Wp // cell, cell)
        cmax = c.max(axis=(2, 4), keepdims=True)
        best = (c == cmax) & (c > 0)
        return best.reshape(L, Hp, Wp)[:, :H0, :W0]

    def norm(r):
        return r / (jnp.max(r, axis=(1, 2), keepdims=True) + 1e-6)

    nh, nl = norm(rh), norm(rl)
    tier = jnp.zeros_like(rh)
    tier = jnp.where(rl > 0, 1.0 + nl, tier)
    tier = jnp.where(cell_best_mask(rl), 3.0 + nl, tier)
    tier = jnp.where(rh > 0, 5.0 + nh, tier)
    tier = jnp.where(cell_best_mask(rh) & (rh > 0), 7.0 + nh, tier)

    xs_list, ys_list, lvl_list, resp_list, valid_list = [], [], [], [], []
    for lv in range(L):
        scores, idx = jax.lax.top_k(tier[lv].ravel(), budgets[lv])
        ys = idx // W0
        xs = idx % W0
        valid = scores > 0
        r = jnp.where(rh[lv].ravel()[idx] > 0, rh[lv].ravel()[idx],
                      rl[lv].ravel()[idx])
        xs_list.append(xs)
        ys_list.append(ys)
        lvl_list.append(jnp.full((budgets[lv],), lv, jnp.int32))
        resp_list.append(jnp.where(valid, r, 0.0))
        valid_list.append(valid)

    xs = jnp.concatenate(xs_list)
    ys = jnp.concatenate(ys_list)
    lvl = jnp.concatenate(lvl_list)
    resp = jnp.concatenate(resp_list)
    valid = jnp.concatenate(valid_list)

    # sub-pixel localization: 1D quadratic fits on a SMOOTH corner response
    # (Harris) around each FAST peak. The FAST score itself is piecewise and
    # its parabola fit carries a motion-correlated bias (~0.3 px) that, at
    # low parallax, systematically inflates BA baselines (observed 2x
    # translation drift). Harris on the blurred atlas is C1-smooth.
    blur = gaussian_blur7_batched(atlas)
    gx = 0.5 * (jnp.roll(blur, -1, axis=2) - jnp.roll(blur, 1, axis=2))
    gy = 0.5 * (jnp.roll(blur, -1, axis=1) - jnp.roll(blur, 1, axis=1))

    def box3(x):
        s = x + jnp.roll(x, 1, 2) + jnp.roll(x, -1, 2)
        return s + jnp.roll(s, 1, 1) + jnp.roll(s, -1, 1)

    Ixx, Iyy, Ixy = box3(gx * gx), box3(gy * gy), box3(gx * gy)
    resp_map = Ixx * Iyy - Ixy * Ixy - 0.04 * (Ixx + Iyy) ** 2
    flat_resp = resp_map.reshape(-1)

    def rsample(dy, dx):
        xq = jnp.clip(xs + dx, 0, W0 - 1)
        yq = jnp.clip(ys + dy, 0, H0 - 1)
        return jnp.take(flat_resp, (lvl * H0 + yq) * W0 + xq)

    # snap to the local Harris argmax within the 3x3 neighborhood of the
    # FAST peak (the two responses peak up to 1px apart; fitting a parabola
    # off-peak biases the refinement), then 1D quadratic fits there
    neigh = jnp.stack([jnp.stack([rsample(dy, dx) for dx in (-1, 0, 1)], -1)
                       for dy in (-1, 0, 1)], -2)  # [K, 3(dy), 3(dx)]
    flat9 = neigh.reshape(-1, 9)
    arg = jnp.argmax(flat9, axis=-1)
    snap_dy = arg // 3 - 1
    snap_dx = arg % 3 - 1
    xs_s = jnp.clip(xs + snap_dx, 1, W0 - 2)
    ys_s = jnp.clip(ys + snap_dy, 1, H0 - 2)

    def rsample_s(dy, dx):
        return jnp.take(flat_resp, (lvl * H0 + (ys_s + dy)) * W0 + (xs_s + dx))

    c0 = rsample_s(0, 0)

    def subpix(m, p):
        denom = m - 2.0 * c0 + p
        off = 0.5 * (m - p) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1e6)
        return jnp.clip(off, -0.5, 0.5)

    dx_sub = (xs_s - xs) + subpix(rsample_s(0, -1), rsample_s(0, 1))
    dy_sub = (ys_s - ys) + subpix(rsample_s(-1, 0), rsample_s(1, 0))

    # ---- orientation: batched circular-moment gather over the atlas ----
    mask_np, gx_np, gy_np = _ic_angle_masks()
    mask, gx, gy = jnp.asarray(mask_np), jnp.asarray(gx_np), jnp.asarray(gy_np)

    def one_patch(l, x, y):
        return jax.lax.dynamic_slice(
            atlas, (l, y - HALF_PATCH, x - HALF_PATCH), (1, PATCH, PATCH))[0]

    patches = jax.vmap(one_patch)(lvl, xs, ys)  # [K, 31, 31]
    pm = patches * mask
    ang = jnp.arctan2(jnp.sum(pm * gy, axis=(1, 2)), jnp.sum(pm * gx, axis=(1, 2)))

    # ---- descriptors: rotated BRIEF gathers on the blurred atlas ----
    pat = jnp.asarray(brief_pattern())
    ca, sa = jnp.cos(ang), jnp.sin(ang)

    def rotxy(px, py):
        rx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]).astype(jnp.int32)
        ry = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]).astype(jnp.int32)
        return rx, ry

    ax, ay = rotxy(pat[:, 0], pat[:, 1])
    bx, by = rotxy(pat[:, 2], pat[:, 3])
    flat = blur.reshape(-1)

    def sample(dx, dy):
        x = jnp.clip(xs[:, None] + dx, 0, W0 - 1)
        y = jnp.clip(ys[:, None] + dy, 0, H0 - 1)
        return jnp.take(flat, (lvl[:, None] * H0 + y) * W0 + x)

    bits = (sample(ax, ay) < sample(bx, by)).astype(jnp.uint32)
    words = bits.reshape(-1, 8, 32)
    weights = jnp.asarray((2 ** np.arange(32)).astype(np.uint32))
    desc = jnp.sum(words * weights[None, None, :], axis=-1, dtype=jnp.uint32)

    # ---- photometric patches: bilinear 15x15 windows on the blurred level
    # image, centered exactly at the subpixel keypoint (LK templates) ----
    px = xs.astype(jnp.float32) + dx_sub
    py = ys.astype(jnp.float32) + dy_sub
    r = PATCH_WIN // 2
    off = jnp.arange(-r, r + 1, dtype=jnp.float32)
    gxq = px[:, None, None] + off[None, None, :]   # [K, 1, 15]
    gyq = py[:, None, None] + off[None, :, None]   # [K, 15, 1]
    x0 = jnp.clip(jnp.floor(gxq).astype(jnp.int32), 0, W0 - 2)
    y0 = jnp.clip(jnp.floor(gyq).astype(jnp.int32), 0, H0 - 2)
    fx_ = jnp.clip(gxq - x0, 0.0, 1.0)
    fy_ = jnp.clip(gyq - y0, 0.0, 1.0)
    base = lvl[:, None, None] * (H0 * W0)

    def samp(yy, xx):
        return jnp.take(flat, base + yy * W0 + xx)

    patch = ((samp(y0, x0) * (1 - fx_) + samp(y0, x0 + 1) * fx_) * (1 - fy_)
             + (samp(y0 + 1, x0) * (1 - fx_) + samp(y0 + 1, x0 + 1) * fx_) * fy_)

    # ---- scale coords to level 0, pad to capacity ----
    sf = jnp.asarray(scale_factors(params))[lvl]
    xy = jnp.stack([px * sf, py * sf], -1)

    feats = FrameFeatures(xy=xy, response=resp, angle=ang, octave=lvl,
                          desc=desc, valid=valid, patch=patch)
    cap = padded_capacity(params.n_features)
    n = xy.shape[0]
    if n < cap:
        pad = cap - n
        feats = FrameFeatures(
            xy=jnp.pad(feats.xy, ((0, pad), (0, 0))),
            response=jnp.pad(feats.response, (0, pad)),
            angle=jnp.pad(feats.angle, (0, pad)),
            octave=jnp.pad(feats.octave, (0, pad)),
            desc=jnp.pad(feats.desc, ((0, pad), (0, 0))),
            valid=jnp.pad(feats.valid, (0, pad)),
            patch=jnp.pad(feats.patch, ((0, pad), (0, 0), (0, 0))),
        )
    return feats


def scale_factors(params: OrbParams) -> np.ndarray:
    return (params.scale_factor ** np.arange(params.n_levels)).astype(np.float32)


def sigma2_per_octave(params: OrbParams) -> np.ndarray:
    """Per-octave measurement variance sigma^2 = scale^2, the BA information
    weighting (src/Optimizer.cpp:376-377)."""
    return (scale_factors(params) ** 2).astype(np.float32)
