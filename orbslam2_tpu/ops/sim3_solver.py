"""Batched Horn closed-form Sim(3) RANSAC for loop alignment.

JAX-native redesign of Sim3Solver (src/Sim3Solver.cpp): the reference runs
sequential RANSAC over 3-point sets with Horn 1987's closed form
(ComputeSim3, :249-370); here every hypothesis is one lane of a vmapped
kernel. Same structure: centroid removal, M = sum p1' p2'^T, the 4x4 N
matrix's dominant eigenvector as quaternion, scale from the deviation
ratio (fixed to 1 for stereo/RGB-D, :321-341), two-way reprojection
inlier voting (CheckInliers, :372-420).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

N_HYPOTHESES = 256


def _quat_R_2to1(q):
    """Horn's dominant eigenvector -> rotation mapping frame-2 points into
    frame 1 (with M = sum p1' p2'^T the raw quaternion rotation maps 1->2;
    transpose for the 2->1 convention used throughout)."""
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    R12 = jnp.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])
    return R12.T


class Sim3Result(NamedTuple):
    s: jnp.ndarray
    R: jnp.ndarray          # [3, 3] maps cam2 coords into cam1 frame
    t: jnp.ndarray
    inliers: jnp.ndarray    # [N]
    n_inliers: jnp.ndarray


def _horn_sim3(P1, P2, fix_scale: bool):
    """Closed-form similarity aligning P2 -> P1. P1, P2: [M, 3]."""
    c1 = P1.mean(0)
    c2 = P2.mean(0)
    q1 = P1 - c1
    q2 = P2 - c2
    M = q1.T @ q2  # [3, 3]
    # Horn's 4x4 N matrix
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ])
    w, v = jnp.linalg.eigh(N)
    q = v[:, -1]  # (w, x, y, z)
    R = _quat_R_2to1(q)
    if fix_scale:
        s = jnp.float32(1.0)
    else:
        # s = sum(q1 . R q2) / sum |q2|^2 (src/Sim3Solver.cpp:321-341)
        num = jnp.sum(q1 * (q2 @ R.T))
        den = jnp.sum(q2 * q2)
        s = num / jnp.maximum(den, 1e-12)
    t = c1 - s * (R @ c2)
    return s, R, t


@functools.partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy", "fix_scale"))
def sim3_ransac(key, P1, P2, sigma2_1, sigma2_2, valid,
                fx: float, fy: float, cx: float, cy: float,
                fix_scale: bool = False) -> Sim3Result:
    """P1/P2: [N, 3] matched 3D points in the two camera frames.
    sigma2_*: [N] per-match pixel variance (chi2 gate 9.210 * sigma2,
    src/Sim3Solver.cpp:84-92). Returns the best S12 (maps 2 -> 1)."""
    n = P1.shape[0]
    probs = valid.astype(jnp.float32) / jnp.maximum(jnp.sum(valid), 1.0)
    keys = jax.random.split(key, N_HYPOTHESES)

    def hypo(k):
        idx = jax.random.choice(k, n, (3,), replace=False, p=probs)
        return _horn_sim3(P1[idx], P2[idx], fix_scale)

    ss, Rs, ts = jax.vmap(hypo)(keys)

    def proj(P):
        z = jnp.maximum(P[:, 2], 1e-6)
        return jnp.stack([fx * P[:, 0] / z + cx, fy * P[:, 1] / z + cy], -1)

    uv1_obs = proj(P1)
    uv2_obs = proj(P2)

    def score(s, R, t):
        P2in1 = s * (P2 @ R.T) + t
        s_inv = 1.0 / jnp.maximum(s, 1e-12)
        P1in2 = s_inv * ((P1 - t) @ R)
        e1 = jnp.sum((proj(P2in1) - uv1_obs) ** 2, -1) / sigma2_1
        e2 = jnp.sum((proj(P1in2) - uv2_obs) ** 2, -1) / sigma2_2
        inl = valid & (e1 < 9.210) & (e2 < 9.210)
        return jnp.sum(inl), inl

    counts, inls = jax.vmap(score)(ss, Rs, ts)
    best = jnp.argmax(counts)
    # refit on the winning inlier set (weighted Horn over all inliers)
    w = inls[best].astype(jnp.float32)
    wsum = jnp.maximum(w.sum(), 1.0)
    c1 = jnp.sum(P1 * w[:, None], 0) / wsum
    c2 = jnp.sum(P2 * w[:, None], 0) / wsum
    q1 = (P1 - c1) * w[:, None]
    q2 = (P2 - c2) * w[:, None]
    M = q1.T @ (P2 - c2)
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    Nm = jnp.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ])
    _, v = jnp.linalg.eigh(Nm)
    R = _quat_R_2to1(v[:, -1])
    if fix_scale:
        s = jnp.float32(1.0)
    else:
        num = jnp.sum(q1 * ((P2 - c2) @ R.T))
        den = jnp.sum(w[:, None] * (P2 - c2) ** 2)
        s = num / jnp.maximum(den, 1e-12)
    t = c1 - s * (R @ c2)
    cnt, inl = score(s, R, t)
    use_refit = cnt >= counts[best]
    s = jnp.where(use_refit, s, ss[best])
    R = jnp.where(use_refit, R, Rs[best])
    t = jnp.where(use_refit, t, ts[best])
    inl_f = jnp.where(use_refit, inl, inls[best])
    return Sim3Result(s=s, R=R, t=t, inliers=inl_f,
                      n_inliers=jnp.where(use_refit, cnt, counts[best]))


def _sim3_apply(s, R, t, P):
    return s * (P @ R.T) + t


def _sim3_residuals(xi, s0, R0, t0, P1, P2, uv1, uv2, inv_s1, inv_s2,
                    fx, fy, cx, cy, fix_scale):
    """Two-way reprojection residuals of the perturbed similarity
    S = exp(xi) ∘ S0 (left-multiplicative 7-dof tangent)."""
    from ..geometry import sim3 as s3
    D = s3.exp(xi if not fix_scale else xi.at[6].set(0.0))
    S = s3.compose(D, {"s": s0, "R": R0, "t": t0})
    s, R, t = S["s"], S["R"], S["t"]

    def proj(P):
        z = jnp.maximum(P[:, 2], 1e-6)
        return jnp.stack([fx * P[:, 0] / z + cx, fy * P[:, 1] / z + cy], -1)

    P2in1 = _sim3_apply(s, R, t, P2)
    P1in2 = (1.0 / s) * ((P1 - t) @ R)
    r1 = (proj(P2in1) - uv1) * inv_s1[:, None]
    r2 = (proj(P1in2) - uv2) * inv_s2[:, None]
    return jnp.concatenate([r1, r2], axis=0)  # [2N, 2]


@functools.partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy",
                                             "fix_scale", "iters"))
def optimize_sim3(s0, R0, t0, P1, P2, uv1, uv2, sigma2_1, sigma2_2, valid,
                  fx: float, fy: float, cx: float, cy: float,
                  fix_scale: bool = False, iters: int = 10):
    """Gauss-Newton refinement of a relative Sim3 over matched pairs — the
    reference's fifth optimizer entry point (Optimizer::OptimizeSim3,
    src/Optimizer.cpp:1281-1496: g2o VertexSim3Expmap + paired forward/
    inverse projection edges, numerically differentiated). Returns
    (s, R, t, inliers, n_inliers)."""
    inv_s1 = 1.0 / jnp.sqrt(sigma2_1)
    inv_s2 = 1.0 / jnp.sqrt(sigma2_2)
    w2 = jnp.concatenate([valid, valid]).astype(jnp.float32)
    eps = 1e-4

    def gn_step(carry, _):
        s, R, t = carry
        base = _sim3_residuals(jnp.zeros(7), s, R, t, P1, P2, uv1, uv2,
                               inv_s1, inv_s2, fx, fy, cx, cy, fix_scale)
        # Huber weights at sqrt(10) normalized-residual norm (delta ~ chi2 10)
        nrm = jnp.linalg.norm(base, axis=-1)
        hub = jnp.where(nrm <= 3.16, 1.0, 3.16 / jnp.maximum(nrm, 1e-9))
        wgt = w2 * hub
        cols = []
        for k in range(7):
            xp = jnp.zeros(7).at[k].set(eps)
            rp = _sim3_residuals(xp, s, R, t, P1, P2, uv1, uv2, inv_s1,
                                 inv_s2, fx, fy, cx, cy, fix_scale)
            rm = _sim3_residuals(-xp, s, R, t, P1, P2, uv1, uv2, inv_s1,
                                 inv_s2, fx, fy, cx, cy, fix_scale)
            cols.append((rp - rm) / (2 * eps))
        J = jnp.stack(cols, axis=-1)  # [2N, 2, 7]
        H = jnp.einsum("nri,n,nrj->ij", J, wgt, J) + 1e-6 * jnp.eye(7)
        g = -jnp.einsum("nri,n,nr->i", J, wgt, base)
        dx = jnp.linalg.solve(H, g)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        from ..geometry import sim3 as s3
        D = s3.exp(dx if not fix_scale else dx.at[6].set(0.0))
        S = s3.compose(D, {"s": s, "R": R, "t": t})
        return (S["s"], S["R"], S["t"]), None

    (s, R, t), _ = jax.lax.scan(gn_step, (jnp.asarray(s0, jnp.float32), R0, t0),
                                None, length=iters)
    # final chi2 classification at threshold 10 per direction
    # (src/Optimizer.cpp:1435-1445 uses chi2 > 10 to drop edges)
    base = _sim3_residuals(jnp.zeros(7), s, R, t, P1, P2, uv1, uv2,
                           inv_s1, inv_s2, fx, fy, cx, cy, fix_scale)
    n = P1.shape[0]
    chi1 = jnp.sum(base[:n] ** 2, -1)
    chi2_ = jnp.sum(base[n:] ** 2, -1)
    inl = valid & (chi1 < 9.210) & (chi2_ < 9.210)
    return s, R, t, inl, jnp.sum(inl)
