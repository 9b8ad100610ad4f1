"""Sim(3) similarity-transform utilities for loop closure.

JAX-native replacement for g2o's `Sim3` Lie group
(Thirdparty/g2o/g2o/types/sim3.h). A Sim3 S = (s, R, t) acts as
x' = s * R @ x + t. Stored as a dict-of-arrays pytree; helpers broadcast over
leading batch dims.

The 7-dof tangent parameterization [v(3), w(3), sigma(1)] (sigma = log s) is
used by the pose-graph optimizer (ops/pose_graph.py), mirroring g2o::Sim3's
exp/log used by Optimizer::OptimizeEssentialGraph
(src/Optimizer.cpp:944-1260). Closed-form exp follows Ethan Eade's Lie-group
notes (public derivation), with Taylor fallbacks near sigma=0 / theta=0.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import se3

_EPS = 1e-8


def make(s, R, t):
    return {"s": jnp.asarray(s), "R": R, "t": t}


def identity(dtype=jnp.float32):
    return make(jnp.ones((), dtype), jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype))


def from_se3(T):
    return make(jnp.ones(T.shape[:-2], T.dtype), se3.rot(T), se3.trans(T))


def to_se3(S):
    """Demote to SE(3) by t / s (the reference's SE3 demotion,
    src/LoopClosing.cpp:634-645)."""
    return se3.make_T(S["R"], S["t"] / S["s"][..., None])


def apply(S, pts):
    """(..., N, 3) -> (..., N, 3): s R x + t."""
    return S["s"][..., None, None] * (pts @ jnp.swapaxes(S["R"], -1, -2)) + S["t"][..., None, :]


def compose(Sa, Sb):
    """Sa ∘ Sb: x -> Sa(Sb(x))."""
    s = Sa["s"] * Sb["s"]
    R = Sa["R"] @ Sb["R"]
    t = Sa["s"][..., None] * (Sa["R"] @ Sb["t"][..., None])[..., 0] + Sa["t"]
    return make(s, R, t)


def inverse(S):
    s_inv = 1.0 / S["s"]
    Rt = jnp.swapaxes(S["R"], -1, -2)
    t = -s_inv[..., None] * (Rt @ S["t"][..., None])[..., 0]
    return make(s_inv, Rt, t)


def _V_coeffs(w, sigma):
    """Coefficients (A, B, C) of V = A I + B W + C W^2 for Sim(3) exp.

    A = (s-1)/sigma
    B = (sigma s sin(th) + (1 - s cos(th)) th) / (th (sigma^2 + th^2))
    C = (A - ((s cos(th) - 1) sigma + s sin(th) th) / (sigma^2 + th^2)) / th^2
    with Taylor limits at sigma->0 and th->0 (W ~ 0 there, so B, C precision
    barely matters in the th->0 branch).
    """
    s = jnp.exp(sigma)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    small_sig = jnp.abs(sigma) < 1e-5
    small_th = theta2 < 1e-8

    sig_safe = jnp.where(small_sig, 1.0, sigma)
    A = jnp.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig_safe)

    th_safe = jnp.where(small_th, 1.0, theta)
    denom = sigma * sigma + theta2
    denom_safe = jnp.where(denom < _EPS, 1.0, denom)
    sc, ss = s * jnp.cos(theta), s * jnp.sin(theta)

    B_gen = (sigma * ss + (1.0 - sc) * th_safe) / (th_safe * denom_safe)
    B_sm = jnp.where(small_sig, 0.5 + sigma / 3.0, (sigma * s - s + 1.0) / (sig_safe * sig_safe))
    B = jnp.where(small_th, B_sm, B_gen)

    C_gen = (A - ((sc - 1.0) * sigma + ss * th_safe) / denom_safe) / jnp.where(small_th, 1.0, theta2)
    C = jnp.where(small_th, 1.0 / 6.0 + sigma / 8.0, C_gen)
    return A, B, C


def _V_matrix(w, sigma, dtype):
    A, B, C = _V_coeffs(w, sigma)
    W = se3.hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), W.shape)
    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2


def exp(xi):
    """(..., 7) [v, w, sigma] -> Sim3."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = se3.so3_exp(w)
    V = _V_matrix(w, sigma, xi.dtype)
    t = (V @ v[..., None])[..., 0]
    return make(s, R, t)


def log(S):
    """Sim3 -> (..., 7) [v, w, sigma], inverse of exp (solve V v = t)."""
    sigma = jnp.log(S["s"])
    w = se3.so3_log(S["R"])
    V = _V_matrix(w, sigma, S["t"].dtype)
    v = jnp.linalg.solve(V, S["t"][..., None])[..., 0]
    return jnp.concatenate([v, w, sigma[..., None]], axis=-1)


def retract(S, xi):
    """Left-multiplicative update exp(xi) ∘ S (pose-graph parameterization)."""
    return compose(exp(xi), S)
