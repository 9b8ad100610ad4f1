"""Feature-metric subpixel match refinement (batched inverse-compositional LK).

Why: detector positions carry ~0.3px noise that is partly motion-correlated;
at the synthetic scenes' depth/baseline ratios this noise dominates ATE (a
0.3px disparity error at z=8m, f=500, b=0.2m is a 0.5m depth error per point).
The reference mitigates this only for stereo rows via SAD sub-pixel slides
(src/Frame.cpp:662-750); all mono/projective measurements stay at detector
precision. Here EVERY accepted match is re-measured photometrically: the map
point's template patch (stored at point creation, ops/features.py PATCH_WIN)
is aligned against the observing feature's patch by a fixed-iteration 2-dof
Lucas-Kanade solve. All observations of a point then agree to ~0.05px on the
SAME template, so triangulation and BA see consistent geometry.

Pure patch-vs-patch: no images are retained anywhere. A frame/keyframe keeps
a 15x15 window per keypoint (centered exactly on its subpixel detection); the
template is the central 11x11 of the anchor observation's window. The LK
displacement is bounded by the window margin (+-2px), which matching already
guarantees.

All shapes static; jitted once per (M,) batch size bucket.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .features import PATCH_WIN, TEMPLATE_WIN

_R_WIN = PATCH_WIN // 2      # 7
_R_TPL = TEMPLATE_WIN // 2   # 5
_N_ITERS = 8
_MAX_SHIFT = float(_R_WIN - _R_TPL)  # 2px: stay inside the stored window


def _cubic_weights(f):
    """Catmull-Rom kernel weights for taps at offsets [-1, 0, 1, 2] of the
    fractional position f. Bilinear sampling biases the SSD minimum by up to
    ~0.1px on curved intensity profiles; cubic cuts the median refinement
    error ~3x (measured in tests/test_refine.py's analytic-field setup)."""
    f2, f3 = f * f, f * f * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3


@functools.lru_cache(maxsize=1)
def _gauss_weight():
    """Gaussian weighting of the template window (downweights the rim, which
    is most affected by scale/rotation mismatch between observations)."""
    r = _R_TPL
    g = np.exp(-0.5 * (np.arange(-r, r + 1) / (0.6 * r)) ** 2)
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def template_of(patch: jnp.ndarray) -> jnp.ndarray:
    """Central 11x11 crop of a 15x15 window: the anchor template."""
    c = _R_WIN - _R_TPL
    return patch[..., c:c + TEMPLATE_WIN, c:c + TEMPLATE_WIN]


@jax.jit
def refine_offsets(patches: jnp.ndarray, templates: jnp.ndarray,
                   valid: jnp.ndarray):
    """Align each template to its observation window.

    patches:   [M, 15, 15] f32 — window around the current measurement
               (center pixel == the measurement, from FrameFeatures.patch)
    templates: [M, 11, 11] f32 — the point's anchor template
    valid:     [M] bool

    Returns (delta [M, 2] (dx, dy) in the window's level-pixel units, ok [M]).
    Apply as xy_level0 += delta * scale_factor[octave] where ok.
    """
    M = patches.shape[0]
    # accept u8 uploads (4x fewer bytes than f32)
    patches = patches.astype(jnp.float32)
    templates = templates.astype(jnp.float32)
    w = jnp.asarray(_gauss_weight())  # [11, 11]

    # bias-corrected template and its gradients (inverse-compositional: the
    # Jacobian/Hessian come from the template and are iteration-invariant)
    tmean = jnp.sum(templates * w[None], axis=(1, 2), keepdims=True)
    T = templates - tmean
    gx = 0.5 * (jnp.roll(T, -1, axis=2) - jnp.roll(T, 1, axis=2))
    gy = 0.5 * (jnp.roll(T, -1, axis=1) - jnp.roll(T, 1, axis=1))
    # roll wraps at the rim; zero it out (the Gaussian window already ~does)
    rim = np.zeros((TEMPLATE_WIN, TEMPLATE_WIN), np.float32)
    rim[1:-1, 1:-1] = 1.0
    rimj = jnp.asarray(rim)[None]
    gx, gy = gx * rimj, gy * rimj

    h11 = jnp.sum(w * gx * gx, axis=(1, 2))
    h12 = jnp.sum(w * gx * gy, axis=(1, 2))
    h22 = jnp.sum(w * gy * gy, axis=(1, 2))
    det = h11 * h22 - h12 * h12
    conditioned = det > 1e-4
    inv_det = 1.0 / jnp.where(conditioned, det, 1.0)

    # sample grid: template pixel (i, j) maps to window coords
    # (c + dy + i, c + dx + j), c = 2.
    #
    # GATHER-FREE sampling: because the shift (dx, dy) is a single scalar
    # per feature, the cubic interpolation is a per-feature blend of 8
    # STATICALLY-shifted copies of the window along each axis (the 4
    # Catmull-Rom taps live at floor-offset s-1..s+2 with s = floor(c+d) in
    # {0..4}); tap selection becomes a one-hot weight vector. This replaces
    # the earlier [M,11,11] dynamic gathers, which are carry-dependent
    # gathers inside lax.scan, with static slices and a weighted sum.
    c = float(_R_WIN - _R_TPL)
    N_SHIFT = 8  # taps at j + t for t in -1..6

    def shift_weights(d):
        """[M] scalar shift in [-c, c] -> [M, 8] blend weights over the
        t = -1..6 statically-shifted copies."""
        q = c + d                                    # in [0, 2c]
        s = jnp.clip(jnp.floor(q).astype(jnp.int32), 0, int(2 * c))
        f = jnp.clip(q - s, 0.0, 1.0)
        w0, w1, w2, w3 = _cubic_weights(f)           # each [M]
        taps = jnp.stack([w0, w1, w2, w3], -1)       # [M, 4]
        t_idx = jnp.arange(N_SHIFT)  # shifted copy t_idx samples col j+t_idx-1
        # tap q sits at col j + s - 1 + q  ->  copy index t_idx = s + q
        sel = (t_idx[None, :, None] == (s[:, None, None]
                                        + jnp.arange(4)[None, None, :]))
        return jnp.sum(jnp.where(sel, taps[:, None, :], 0.0), -1)  # [M, 8]

    padx = jnp.pad(patches, ((0, 0), (0, 0), (1, 2)), mode="edge")
    pady_base = None  # y-pass pads the x-pass output

    def sample(dx, dy):
        """Catmull-Rom sample of each window at the shifted template grid,
        as two separable shift-blend passes. dx, dy: [M]."""
        wx = shift_weights(dx)                       # [M, 8]
        wy = shift_weights(dy)
        xout = 0.0
        for t in range(N_SHIFT):
            xout = xout + wx[:, t, None, None] * padx[:, :, t:t + TEMPLATE_WIN]
        pady = jnp.pad(xout, ((0, 0), (1, 2), (0, 0)), mode="edge")
        out = 0.0
        for t in range(N_SHIFT):
            out = out + wy[:, t, None, None] * pady[:, t:t + TEMPLATE_WIN, :]
        return out  # [M, 11, 11]

    def step(carry, _):
        dx, dy = carry
        img = sample(dx, dy)
        imean = jnp.sum(img * w[None], axis=(1, 2), keepdims=True)
        resid = (img - imean) - T
        bx = jnp.sum(w * gx * resid, axis=(1, 2))
        by = jnp.sum(w * gy * resid, axis=(1, 2))
        # solve H d = b; inverse-compositional translation update: p <- p - d
        ddx = (h22 * bx - h12 * by) * inv_det
        ddy = (h11 * by - h12 * bx) * inv_det
        dx = jnp.clip(dx - ddx, -_MAX_SHIFT, _MAX_SHIFT)
        dy = jnp.clip(dy - ddy, -_MAX_SHIFT, _MAX_SHIFT)
        return (dx, dy), None

    zeros = jnp.zeros((M,), jnp.float32)
    (dx, dy), _ = jax.lax.scan(step, (zeros, zeros), None, length=_N_ITERS)

    # accept: well-conditioned, inside the trust region, and the aligned
    # residual is no worse than the unaligned one
    img0 = sample(zeros, zeros)
    imgf = sample(dx, dy)

    def ssd(img):
        im = jnp.sum(img * w[None], axis=(1, 2), keepdims=True)
        return jnp.sum(w * ((img - im) - T) ** 2, axis=(1, 2))

    ok = (valid & conditioned
          & (jnp.maximum(jnp.abs(dx), jnp.abs(dy)) < _MAX_SHIFT - 1e-3)
          & (ssd(imgf) <= ssd(img0)))
    delta = jnp.stack([dx, dy], -1)
    return jnp.where(ok[:, None], delta, 0.0), ok
