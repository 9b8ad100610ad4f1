"""Batched Schur-complement bundle adjustment (the g2o replacement).

JAX-native redesign of Optimizer::LocalBundleAdjustment
(src/Optimizer.cpp:564-941) and GlobalBundleAdjustemnt/BundleAdjustment
(:44-304), replacing g2o's sparse BlockSolver_6_3 + LinearSolverEigen +
OptimizationAlgorithmLevenberg with:

- residual/Jacobian evaluation as one fused fixed-shape kernel over the
  observation edge list (mono + stereo edges unified, ba_core.py)
- block assembly via segment-sums (Hcc [C,6,6], Hpp [P,3,3], per-edge
  coupling W [E,6,3])
- point marginalization via batched 3x3 inverses (the reference's
  `setMarginalized(true)` Schur trick, src/Optimizer.cpp:707)
- the reduced camera system solved MATRIX-FREE by block-Jacobi
  preconditioned conjugate gradient: S = Hcc - W Hpp^-1 W^T is never
  formed; S@x costs two edge-gathers + two segment-sums. This is what
  makes the solver shardable across devices: all edge ops are local,
  the segment-sums become psum/reduce-scatter collectives over a mesh
  (parallel/dist_ba.py).
- Levenberg-Marquardt accept/reject with jnp.where (no host sync), the
  reference's two-phase schedule (5 iters, chi2 outlier cut at
  5.991/7.815, 10 more iters, src/Optimizer.cpp:790-841) is preserved.

Abortability: the reference's mbAbortBA flag (src/Optimizer.cpp:639-640)
maps to running `ba_solve` in bounded-iteration chunks from the host and
checking the abort flag between chunks (system.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import ba_core as BC


MIN_DEPTH = 0.05    # meters; below this J ~ 1/z^2 risks f32 overflow
CHI2_TRIM = 1e5     # edges beyond this are excluded from the normal system


def _seg_sum(x, idx, n):
    return jax.ops.segment_sum(x, idx, num_segments=n)


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. Invalid edges/cameras/points are masked."""

    cam_T: jnp.ndarray      # [C, 3, 4] Tcw
    cam_fixed: jnp.ndarray  # [C] bool (pose held constant)
    cam_valid: jnp.ndarray  # [C] bool
    pts: jnp.ndarray        # [P, 3] world points
    pt_valid: jnp.ndarray   # [P] bool
    e_cam: jnp.ndarray      # [E] int32 camera index
    e_pt: jnp.ndarray       # [E] int32 point index
    e_obs: jnp.ndarray      # [E, 3] (u, v, u_r)
    e_stereo: jnp.ndarray   # [E] bool
    e_info: jnp.ndarray     # [E] float32 (1/sigma^2)
    e_valid: jnp.ndarray    # [E] bool


class BAResult(NamedTuple):
    cam_T: jnp.ndarray
    pts: jnp.ndarray
    e_inlier: jnp.ndarray   # [E] final chi2 classification
    cost: jnp.ndarray


def _edge_terms(p: BAProblem, cam_T, pts, e_active, fx, fy, cx, cy, bf, robust):
    """Residuals, Jacobians and weights for every edge."""
    Te = cam_T[p.e_cam]                      # [E, 3, 4]
    Xe = pts[p.e_pt]                         # [E, 3]
    R, t = Te[..., :3], Te[..., 3]
    pc = jnp.einsum("eij,ej->ei", R, Xe) + t
    z = pc[:, 2]
    z_safe = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    iz = 1.0 / z_safe
    u = fx * pc[:, 0] * iz + cx
    v = fy * pc[:, 1] * iz + cy
    ur = u - bf * iz
    res = jnp.stack(
        [u - p.e_obs[:, 0], v - p.e_obs[:, 1],
         jnp.where(p.e_stereo, ur - p.e_obs[:, 2], 0.0)], axis=-1)
    Jp, Jpc = BC.residual_jacobians(pc, p.e_stereo, fx, fy, bf)
    Jpt = Jpc @ R                            # world-point Jacobian [E, 3, 3]
    chi2, w = BC.chi2_and_weight(res, p.e_stereo, p.e_info, robust)
    # depth floor + hopeless-outlier trim: near-zero depth makes J ~ 1/z^2
    # overflow f32 in the H assembly (observed: z=0.009 -> chi2 2e5 -> NaN)
    usable = e_active & (z > MIN_DEPTH) & (chi2 < CHI2_TRIM)
    m = usable.astype(jnp.float32) * w * p.e_info
    # accept/reject objective must match the (robust) step model: comparing
    # raw chi2 lets a few large outliers dominate the test and drives LM to
    # the L2 optimum instead of the Huber one (see ba_core.robust_cost)
    rho = BC.robust_cost(chi2, p.e_stereo, robust)
    cost = jnp.sum(jnp.where(e_active & (z > MIN_DEPTH),
                             jnp.minimum(rho, CHI2_TRIM), 0.0))
    return res, Jp, Jpt, m, cost, chi2, z


def _dense_schur_step(p: BAProblem, Hcc_d, Hpp_inv, W, rhs, free_cam):
    """Materialize the reduced camera system S = Hcc_d - W Hpp^-1 W^T and
    solve it by dense Cholesky. For single-device problems (local BA:
    6C ~ 100 dof; global BA at KITTI scale: 6C ~ 800 dof) this replaces the
    24 sequential CG matvecs with ONE batched MXU einsum + one small
    factorization — the LM iteration's critical path stops being a chain of
    tiny gather/segment-sum kernels. The matrix-free CG path remains the
    sharded/distributed story (parallel/dist_ba.py) and the fallback when
    [P, C, 6, 3] would not fit.
    """
    C = Hcc_d.shape[0]
    P = Hpp_inv.shape[0]
    # G[p, c] = sum of W_e over edges (c observes p): scatter by (pt, cam)
    G = _seg_sum(W, p.e_pt * C + p.e_cam, P * C).reshape(P, C, 6, 3)
    Y = jnp.einsum("pcij,pjk->pcik", G, Hpp_inv)
    coupling = jnp.einsum("pcik,pdjk->cidj", Y, G)          # [C,6,C,6]
    S = -coupling
    diag = jnp.arange(C)
    S = S.at[diag, :, diag, :].add(Hcc_d)
    S = S.reshape(6 * C, 6 * C)
    # restrict to free cameras: identity rows/cols elsewhere (their rhs is 0)
    f = jnp.repeat(free_cam[:, 0], 6)
    S = S * f[:, None] * f[None, :] + jnp.diag(jnp.where(f > 0, 1e-6, 1.0))
    chol = jax.scipy.linalg.cho_factor(S, lower=True)
    dx = jax.scipy.linalg.cho_solve(chol, rhs.reshape(-1) * f)
    return (dx * f).reshape(C, 6)


def _lm_iteration(p: BAProblem, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf,
                  robust, cg_iters: int, dense_schur: bool = False):
    C = cam_T.shape[0]
    P = pts.shape[0]
    res, Jp, Jpt, m, cost, _, _ = _edge_terms(
        p, cam_T, pts, e_active, fx, fy, cx, cy, bf, robust)

    free_cam = (p.cam_valid & ~p.cam_fixed).astype(jnp.float32)[:, None]

    # block assembly (segment sums over the edge list)
    Hcc = _seg_sum(jnp.einsum("eri,e,erj->eij", Jp, m, Jp), p.e_cam, C)
    bc = _seg_sum(-jnp.einsum("eri,e,er->ei", Jp, m, res), p.e_cam, C)
    Hpp = _seg_sum(jnp.einsum("eri,e,erj->eij", Jpt, m, Jpt), p.e_pt, P)
    bp = _seg_sum(-jnp.einsum("eri,e,er->ei", Jpt, m, res), p.e_pt, P)
    W = jnp.einsum("eri,e,erj->eij", Jp, m, Jpt)  # [E, 6, 3]

    # LM damping (multiplicative on block diagonals)
    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = jnp.linalg.inv(Hpp_d)           # [P, 3, 3] point marginalization

    def coupling(x):
        """W Hpp^-1 W^T @ x for camera-stacked x [C, 6]."""
        u = jnp.einsum("eij,ei->ej", W, x[p.e_cam])          # [E, 3] = W^T x
        vp = _seg_sum(u, p.e_pt, P)
        wp = jnp.einsum("pij,pj->pi", Hpp_inv, vp)
        ze = jnp.einsum("eij,ej->ei", W, wp[p.e_pt])         # [E, 6]
        return _seg_sum(ze, p.e_cam, C)

    def S_mv(x):
        x = x * free_cam
        y = jnp.einsum("cij,cj->ci", Hcc_d, x) - coupling(x)
        return y * free_cam

    # Schur RHS: bc - W Hpp^-1 bp
    hb = jnp.einsum("pij,pj->pi", Hpp_inv, bp)
    rhs = (bc - _seg_sum(jnp.einsum("eij,ej->ei", W, hb[p.e_pt]), p.e_cam, C))
    rhs = rhs * free_cam

    if dense_schur:
        dx_c = _dense_schur_step(p, Hcc_d, Hpp_inv, W, rhs, free_cam)
        return _apply_step(p, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf,
                           robust, dx_c, Hpp_inv, W, bp, m, cost, free_cam)

    # block-Jacobi preconditioned CG on the reduced camera system
    Minv = jnp.linalg.inv(Hcc_d + 1e-6 * eye6)

    def precond(r):
        return jnp.einsum("cij,cj->ci", Minv, r) * free_cam

    def cg_body(carry, _):
        x, r, zvec, pdir, rz = carry
        Ap = S_mv(pdir)
        denom = jnp.sum(pdir * Ap)
        # Krylov breakdown guard: S is PSD up to damping, but the mono scale
        # gauge makes denom ~ 0 along the near-null direction; a raw division
        # there produced NaNs (observed at specific cg_iters counts). On
        # breakdown, freeze the iterate.
        ok = denom > 1e-12
        alpha = jnp.where(ok, rz / jnp.where(ok, denom, 1.0), 0.0)
        x = x + alpha * pdir
        r = r - alpha * Ap
        z_new = precond(r)
        rz_new = jnp.sum(r * z_new)
        beta = jnp.where(rz > 1e-20, rz_new / jnp.where(rz > 1e-20, rz, 1.0), 0.0)
        pdir = z_new + beta * pdir
        return (x, r, z_new, pdir, rz_new), None

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    (dx_c, *_), _ = jax.lax.scan(
        cg_body, (x0, r0, z0, z0, jnp.sum(r0 * z0)), None, length=cg_iters)

    return _apply_step(p, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf,
                       robust, dx_c, Hpp_inv, W, bp, m, cost, free_cam)


def _apply_step(p: BAProblem, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf,
                robust, dx_c, Hpp_inv, W, bp, m, cost, free_cam):
    """Point back-substitution + LM accept/reject for a camera step dx_c."""
    P = pts.shape[0]
    dx_c = jnp.where(jnp.isfinite(dx_c), dx_c, 0.0)
    # back-substitute points: dx_p = Hpp^-1 (bp - W^T dx_c)
    wtx = _seg_sum(jnp.einsum("eij,ei->ej", W, dx_c[p.e_cam]), p.e_pt, P)
    dx_p = jnp.einsum("pij,pj->pi", Hpp_inv, bp - wtx)
    pt_has_edges = _seg_sum(m, p.e_pt, P) > 0
    dx_p = jnp.where((p.pt_valid & pt_has_edges)[:, None], dx_p, 0.0)
    dx_p = jnp.where(jnp.isfinite(dx_p), dx_p, 0.0)

    cam_T_new = se3.retract(cam_T, dx_c * free_cam)
    pts_new = pts + dx_p
    _, _, _, _, cost_new, _, _ = _edge_terms(
        p, cam_T_new, pts_new, e_active, fx, fy, cx, cy, bf, robust)

    accept = cost_new < cost
    cam_T = jnp.where(accept, cam_T_new, cam_T)
    pts = jnp.where(accept, pts_new, pts)
    lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-8), jnp.minimum(lam * 4.0, 1e6))
    return cam_T, pts, lam, jnp.minimum(cost_new, cost)


def _classify(p: BAProblem, cam_T, pts, fx, fy, cx, cy, bf):
    res, _, _, _, _, chi2, z = _edge_terms(
        p, cam_T, pts, p.e_valid, fx, fy, cx, cy, bf, robust=False)
    th = jnp.where(p.e_stereo, BC.CHI2_STEREO, BC.CHI2_MONO)
    return p.e_valid & (chi2 <= th) & (z > MIN_DEPTH)


# [P, C, 6, 3] f32 budget for the materialized per-point camera coupling;
# above this the matrix-free CG path is used instead (512 MB @ 72 B/entry)
_DENSE_SCHUR_MAX_PC = 7_000_000


def _use_dense_schur(C: int, P: int, solver: str) -> bool:
    if solver == "dense":
        return True
    if solver == "cg":
        return False
    return P * C <= _DENSE_SCHUR_MAX_PC and 6 * C <= 4096


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "bf", "iters1", "iters2",
                     "cg_iters", "solver"),
)
def ba_solve(p: BAProblem, fx: float, fy: float, cx: float, cy: float,
             bf: float, iters1: int = 5, iters2: int = 10,
             cg_iters: int = 24, solver: str = "auto") -> BAResult:
    """Two-phase LM Schur BA (reference schedule: 5 iters, outlier cut,
    10 iters — src/Optimizer.cpp:790-841). Huber robust in phase 1,
    plain in phase 2 (outliers excluded instead).

    solver: "dense" materializes the reduced camera system and solves by
    Cholesky (fastest on one device), "cg" is the matrix-free
    preconditioned-CG path (the distributed/sharded formulation), "auto"
    picks dense when the [P, C] coupling tensor fits."""
    cam_T, pts = p.cam_T, p.pts
    lam = jnp.float32(1e-4)
    cost = jnp.float32(0.0)
    dense = _use_dense_schur(cam_T.shape[0], pts.shape[0], solver)

    def phase(cam_T, pts, lam, e_active, robust, n):
        def body(carry, _):
            cam_T, pts, lam, _ = carry
            cam_T, pts, lam, cost = _lm_iteration(
                p, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf, robust,
                cg_iters, dense_schur=dense)
            return (cam_T, pts, lam, cost), None

        (cam_T, pts, lam, cost), _ = jax.lax.scan(
            body, (cam_T, pts, lam, jnp.float32(jnp.inf)), None, length=n)
        return cam_T, pts, lam, cost

    cam_T, pts, lam, cost = phase(cam_T, pts, lam, p.e_valid, True, iters1)
    inlier = _classify(p, cam_T, pts, fx, fy, cx, cy, bf)
    cam_T, pts, lam, cost = phase(cam_T, pts, lam, inlier, False, iters2)
    inlier = _classify(p, cam_T, pts, fx, fy, cx, cy, bf)
    return BAResult(cam_T=cam_T, pts=pts, e_inlier=inlier, cost=cost)
