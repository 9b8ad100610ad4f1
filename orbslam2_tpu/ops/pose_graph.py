"""Sim(3) pose-graph optimization (the essential-graph solver).

JAX-native redesign of Optimizer::OptimizeEssentialGraph
(src/Optimizer.cpp:944-1280): g2o's BlockSolver_7_3 Levenberg over Sim3
vertices becomes a batched Gauss-Newton on [K, 7] tangent updates:

- residual per edge: r = log(S_meas^-1 ∘ S_i ∘ S_j^-1) in the 7-dof
  tangent (identity information, matching the reference's 7x7 identity,
  src/Optimizer.cpp:1026)
- Jacobians by vectorized central differences over the 14 basis
  perturbations (g2o also differentiates EdgeSim3 numerically — its Sim3
  edges don't implement linearizeOplus)
- normal equations solved matrix-free by block-Jacobi PCG over vertices;
  per-edge off-diagonal coupling applied by gather/segment-sum, the same
  shardable pattern as ops/ba.py
- vertices updated by left-multiplicative Sim3 retraction; fixed vertices
  (the loop keyframe, :1000) masked out
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..geometry import sim3

_EPS = 1e-4


def _vertex(svals, R, t, idx):
    return {"s": svals[idx], "R": R[idx], "t": t[idx]}


def _edge_residuals(svals, R, t, e_i, e_j, meas_inv):
    Si = _vertex(svals, R, t, e_i)
    Sj = _vertex(svals, R, t, e_j)
    rel = sim3.compose(Si, sim3.inverse(Sj))
    return sim3.log(sim3.compose(meas_inv, rel))  # [E, 7]


def _perturbed_residuals(svals, R, t, e_i, e_j, meas_inv, which_i: bool,
                         k: int, eps: float):
    """Residuals with vertex i (or j) of every edge perturbed by eps*e_k."""
    xi = jnp.zeros((7,)).at[k].set(eps)
    D = sim3.exp(xi)  # single Sim3
    idx = e_i if which_i else e_j
    Sv = _vertex(svals, R, t, idx)
    Sv = sim3.compose({"s": jnp.broadcast_to(D["s"], Sv["s"].shape),
                       "R": jnp.broadcast_to(D["R"], Sv["R"].shape),
                       "t": jnp.broadcast_to(D["t"], Sv["t"].shape)}, Sv)
    So = _vertex(svals, R, t, e_j if which_i else e_i)
    if which_i:
        rel = sim3.compose(Sv, sim3.inverse(So))
    else:
        rel = sim3.compose(So, sim3.inverse(Sv))
    return sim3.log(sim3.compose(meas_inv, rel))


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters"))
def optimize_pose_graph(svals, R, t, fixed, e_i, e_j,
                        meas_s, meas_R, meas_t, e_valid,
                        iters: int = 20, cg_iters: int = 32):
    """svals/R/t: [K], [K,3,3], [K,3] Sim3 vertices (world->kf).
    e_i/e_j: [E] vertex indices; meas_*: the measured relative Sim3
    S_meas = S_i ∘ S_j^-1 at edge creation. Returns updated (svals, R, t)."""
    K = svals.shape[0]
    meas = {"s": meas_s, "R": meas_R, "t": meas_t}
    meas_inv = sim3.inverse(meas)
    free = (~fixed).astype(jnp.float32)[:, None]
    wE = e_valid.astype(jnp.float32)

    def seg(x, idx, _K=None):
        return jax.ops.segment_sum(x, idx, num_segments=K)

    def gn_step(carry, _):
        svals, R, t = carry
        r0 = _edge_residuals(svals, R, t, e_i, e_j, meas_inv)  # [E,7]

        # numeric Jacobians via central differences, [E, 7(res), 7(param)]
        def jac(which_i):
            cols = []
            for k in range(7):
                rp = _perturbed_residuals(svals, R, t, e_i, e_j, meas_inv,
                                          which_i, k, _EPS)
                rm = _perturbed_residuals(svals, R, t, e_i, e_j, meas_inv,
                                          which_i, k, -_EPS)
                cols.append((rp - rm) / (2 * _EPS))
            return jnp.stack(cols, axis=-1)

        Ji = jac(True)
        Jj = jac(False)

        Hii = seg(jnp.einsum("eri,e,erj->eij", Ji, wE, Ji), e_i, K)
        Hjj = seg(jnp.einsum("eri,e,erj->eij", Jj, wE, Jj), e_j, K)
        Hdiag = Hii + Hjj + 1e-6 * jnp.eye(7)
        b = seg(-jnp.einsum("eri,e,er->ei", Ji, wE, r0), e_i, K) + \
            seg(-jnp.einsum("eri,e,er->ei", Jj, wE, r0), e_j, K)
        b = b * free

        Hij = jnp.einsum("eri,e,erj->eij", Ji, wE, Jj)  # per-edge coupling

        def matvec(x):
            x = x * free
            y = jnp.einsum("kij,kj->ki", Hdiag, x)
            y = y + seg(jnp.einsum("eij,ej->ei", Hij, x[e_j]), e_i, K)
            y = y + seg(jnp.einsum("eij,ei->ej", Hij, x[e_i]), e_j, K)
            return y * free

        Minv = jnp.linalg.inv(Hdiag)

        def precond(v):
            return jnp.einsum("kij,kj->ki", Minv, v) * free

        def cg_body(c, _):
            x, rr, z, p, rz = c
            Ap = matvec(p)
            den = jnp.sum(p * Ap)
            ok = den > 1e-12
            alpha = jnp.where(ok, rz / jnp.where(ok, den, 1.0), 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(rz > 1e-20, rz_new / jnp.where(rz > 1e-20, rz, 1.0), 0.0)
            p = z + beta * p
            return (x, rr, z, p, rz_new), None

        z0 = precond(b)
        (dx, *_), _ = jax.lax.scan(cg_body, (jnp.zeros_like(b), b, z0, z0,
                                             jnp.sum(b * z0)), None,
                                   length=cg_iters)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0) * free
        D = sim3.exp(dx)  # [K] batched
        S = {"s": svals, "R": R, "t": t}
        S_new = sim3.compose(D, S)
        return (S_new["s"], S_new["R"], S_new["t"]), jnp.sum(r0 * r0 * wE[:, None])

    (svals, R, t), costs = jax.lax.scan(gn_step, (svals, R, t), None, length=iters)
    return svals, R, t, costs
