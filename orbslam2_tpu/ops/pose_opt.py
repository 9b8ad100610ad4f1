"""Motion-only bundle adjustment (the per-frame hot optimizer).

JAX-native replacement for Optimizer::PoseOptimization
(src/Optimizer.cpp:306-562): 4 rounds x 10 LM iterations on one SE3 vertex
with unary reprojection edges; after each round observations are
re-classified by chi2 (5.991 mono / 7.815 stereo); the robust Huber kernel
is dropped after round 2 (:491-492).

Everything is fixed-shape and jit-compiled: the 6x6 normal system is built
by masked reductions over all N observations, LM damping with accept/reject
handled via jnp.where (no data-dependent host control flow).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import ba_core as BC


class PoseOptResult(NamedTuple):
    T: jnp.ndarray        # [3, 4] optimized Tcw
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray


def _normal_system(T, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf, robust):
    res, pc = BC.project_residual(T, pts, obs, is_stereo, fx, fy, cx, cy, bf)
    Jp, _ = BC.residual_jacobians(pc, is_stereo, fx, fy, bf)
    chi2, w = BC.chi2_and_weight(res, is_stereo, info, robust)
    depth_ok = pc[:, 2] > 0.05  # f32-safe depth floor (see ops/ba.py MIN_DEPTH)
    m = (active & depth_ok & (chi2 < 1e5)).astype(jnp.float32) * w * info
    H = jnp.einsum("nri,n,nrj->ij", Jp, m, Jp)
    g = -jnp.einsum("nri,n,nr->i", Jp, m, res)
    # the accept/reject objective MUST be the same (robust) cost the step
    # model minimizes (see ba_core.robust_cost)
    rho = BC.robust_cost(chi2, is_stereo, robust)
    cost = jnp.sum(jnp.where(active & depth_ok, jnp.minimum(rho, 1e6), 0.0))
    return H, g, cost, chi2, depth_ok


def _lm_rounds(T0, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf,
               robust: bool, n_iters: int):
    def body(carry, _):
        T, lam = carry
        H, g, cost, _, _ = _normal_system(
            T, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf, robust)
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
        dx = jnp.linalg.solve(Hd, g)
        T_new = se3.retract(T, dx)
        _, _, cost_new, _, _ = _normal_system(
            T_new, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf, robust)
        accept = cost_new < cost
        T = jax.tree.map(lambda a, b: jnp.where(accept, a, b), T_new, T)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7), jnp.minimum(lam * 4.0, 1e4))
        return (T, lam), None

    (T, _), _ = jax.lax.scan(body, (T0, jnp.float32(1e-3)), None, length=n_iters)
    return T


@functools.partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy", "bf"))
def pose_optimize(T0, pts, obs_uvr, is_stereo, octave_sigma2_inv, valid,
                  fx: float, fy: float, cx: float, cy: float, bf: float
                  ) -> PoseOptResult:
    """Optimize a single camera pose against fixed world points.

    T0: [3, 4] initial Tcw; pts: [N, 3] world points; obs_uvr: [N, 3]
    (u, v, u_r); is_stereo: [N] bool; octave_sigma2_inv: [N] information
    (1/sigma^2 of the observation octave); valid: [N] initial edge validity.
    """
    inliers = valid

    for rnd in range(4):
        robust = rnd < 2  # kernel dropped after round 2 (src/Optimizer.cpp:491)
        T0 = _lm_rounds(T0, pts, obs_uvr, is_stereo, octave_sigma2_inv,
                        inliers, fx, fy, cx, cy, bf, robust, n_iters=10)
        # re-classify ALL valid observations at the new pose (:450-526)
        res, pc = BC.project_residual(T0, pts, obs_uvr, is_stereo, fx, fy, cx, cy, bf)
        chi2, _ = BC.chi2_and_weight(res, is_stereo, octave_sigma2_inv, robust=False)
        th = jnp.where(is_stereo, BC.CHI2_STEREO, BC.CHI2_MONO)
        inliers = valid & (chi2 <= th) & (pc[:, 2] > 0.05)

    return PoseOptResult(T=T0, inliers=inliers, n_inliers=jnp.sum(inliers))
