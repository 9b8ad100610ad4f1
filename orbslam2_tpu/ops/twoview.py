"""Two-view monocular initialization: batched H/F RANSAC + reconstruction.

JAX-native redesign of src/Initializer.cpp. The reference runs 200 sequential
RANSAC iterations for H and F in two std::threads (:134-136); here both model
sweeps are a single vmapped device program over all hypotheses at once:

- `Initialize` (:55)         -> `initialize_two_view`
- `ComputeH21/ComputeF21` (:319/:372, DLT + SVD)
                             -> batched 8-point DLT (jnp.linalg.svd)
- `CheckHomography/CheckFundamental` (:395/:503, symmetric transfer scoring)
                             -> dense masked scoring over all matches
- `ReconstructF` (:607, E = K^T F K, DecomposeE + 4-way cheirality)
- `ReconstructH` (:725, Faugeras decomposition, 8 motions)
- `Triangulate` (:951, 4x4 DLT SVD) -> `triangulate_dlt` (batched)
- `Normalize` (:981, Hartley conditioning)

Same gates and constants as the reference: sigma=1.0, chi2 th 5.991 (H) /
3.841+5.991 (F), RH = SH/(SH+SF) > 0.40 picks H (:144-151), cheirality with
parallax and 4*sigma^2 reprojection bounds (CheckRT :1038).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

N_HYPOTHESES = 200
SIGMA = 1.0
TH_H = 5.991
TH_F_LINE = 3.841
TH_F_SCORE = 5.991
MIN_PARALLAX_DEG = 1.0


def _normalize(xy, w):
    """Hartley conditioning (Initializer::Normalize, src/Initializer.cpp:981).
    Returns normalized coords and the 3x3 similarity T with xn = T x."""
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(xy * w[:, None], axis=0) / wsum
    d = jnp.abs(xy - mean) * w[:, None]
    mean_dev = jnp.sum(d, axis=0) / wsum
    s = 1.0 / jnp.maximum(mean_dev, 1e-8)
    xn = (xy - mean) * s
    T = jnp.array(
        [[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]], [0.0, 0.0, 1.0]]
    )
    return xn, T


def _homog(xy):
    return jnp.concatenate([xy, jnp.ones_like(xy[..., :1])], axis=-1)


def _null9(A):
    """Null vector of a thin [r, 9] DLT system as the smallest eigenvector
    of AᵀA. A batched 9x9 eigh works on the fixed 9x9 Gram matrix instead
    of the batched rectangular SVD it replaces; the squared conditioning is
    harmless here because these fits only SELECT hypotheses — the chosen
    model is refit from all inliers via the full SVD path below."""
    ata = A.T @ A
    _, V = jnp.linalg.eigh(ata)
    return V[:, 0]


def _dlt_F(x1, x2):
    """8-point fundamental from [8, 2] correspondences (normalized).

    Hypothesis-sweep variant: no rank-2 projection — epipolar-distance
    scoring is well-defined for the unconstrained 8-point solution, and
    the winning model is refit (and rank-2 enforced) by _dlt_F_masked.
    Dropping it removes 200 batched 3x3 SVDs per init attempt."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, jnp.ones_like(u1)],
        axis=-1,
    )  # [8, 9]
    return _null9(A).reshape(3, 3)


def _dlt_H(x1, x2):
    """4+-point homography from [8, 2] correspondences (normalized),
    x2 ~ H x1."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    r1 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], axis=-1)
    r2 = jnp.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)  # [16, 9]
    return _null9(A).reshape(3, 3)


def _score_H(H, xy1, xy2, w):
    """Symmetric transfer score (CheckHomography, src/Initializer.cpp:395)."""
    Hinv = jnp.linalg.inv(H)
    p1, p2 = _homog(xy1), _homog(xy2)

    def transfer(M, src, dst):
        proj = src @ M.T
        proj = proj[:, :2] / jnp.where(jnp.abs(proj[:, 2:]) > 1e-12, proj[:, 2:], 1e-12)
        return jnp.sum((proj - dst[:, :2]) ** 2, axis=-1) / (SIGMA * SIGMA)

    chi12 = transfer(H, p1, p2)
    chi21 = transfer(Hinv, p2, p1)
    ok = (chi12 < TH_H) & (chi21 < TH_H) & w
    score = jnp.sum(jnp.where(ok, (TH_H - chi12) + (TH_H - chi21), 0.0))
    return score, ok


def _score_F(F, xy1, xy2, w):
    """Epipolar line distance score (CheckFundamental, src/Initializer.cpp:503)."""
    p1, p2 = _homog(xy1), _homog(xy2)
    l2 = p1 @ F.T  # line in image 2
    l1 = p2 @ F    # line in image 1

    def line_chi2(l, p):
        num = jnp.sum(l * p, axis=-1) ** 2
        den = l[:, 0] ** 2 + l[:, 1] ** 2
        return num / jnp.maximum(den, 1e-12) / (SIGMA * SIGMA)

    chi2_2 = line_chi2(l2, p2)
    chi2_1 = line_chi2(l1, p1)
    ok = (chi2_2 < TH_F_LINE) & (chi2_1 < TH_F_LINE) & w
    score = jnp.sum(
        jnp.where(ok, (TH_F_SCORE - chi2_2) + (TH_F_SCORE - chi2_1), 0.0)
    )
    return score, ok


def _dlt_F_masked(xy1, xy2, w):
    """Fundamental DLT over all masked correspondences (inlier refit).
    Rows of invalid matches are zeroed — they add no constraint."""
    xn1, T1 = _normalize(xy1, w)
    xn2, T2 = _normalize(xy2, w)
    u1, v1 = xn1[:, 0], xn1[:, 1]
    u2, v2 = xn2[:, 0], xn2[:, 1]
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, jnp.ones_like(u1)],
        axis=-1,
    ) * w[:, None]
    # tall-thin null vector via the 9x9 Gram eigh (see _null9); rank-2
    # enforcement stays on the exact 3x3 SVD — that one is cheap
    Fh = _null9(A).reshape(3, 3)
    uf, sf, vtf = jnp.linalg.svd(Fh)
    Fn = uf @ jnp.diag(sf.at[2].set(0.0)) @ vtf
    return T2.T @ Fn @ T1


def _dlt_H_masked(xy1, xy2, w):
    """Homography DLT over all masked correspondences (inlier refit)."""
    xn1, T1 = _normalize(xy1, w)
    xn2, T2 = _normalize(xy2, w)
    u1, v1 = xn1[:, 0], xn1[:, 1]
    u2, v2 = xn2[:, 0], xn2[:, 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    r1 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], axis=-1)
    r2 = jnp.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], axis=-1)
    A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)
    Hn = _null9(A).reshape(3, 3)
    return jnp.linalg.inv(T2) @ Hn @ T1


def triangulate_dlt(P1, P2, xy1, xy2):
    """Linear triangulation (Initializer::Triangulate, src/Initializer.cpp:951).
    P1, P2: [3, 4] projections (pixel or normalized), xy: [N, 2]. -> [N, 3].

    Closed-form inhomogeneous DLT seed + 2 Gauss-Newton iterations on the
    reprojection residuals, instead of the null vector of the [N, 4, 4]
    system by SVD — the reference's per-point cv::SVD becomes, vectorized,
    a batched rectangular SVD over 12 motion hypotheses x every match.

    Why the GN polish is load-bearing and not an embellishment: the normal
    equations square the conditioning, and at depth/baseline ratios of
    ~100 (corridor scenes; the mono neighbor gate allows up to 100,
    src/LocalMapping.cpp:359) the f32 closed form alone loses the answer —
    an endurance run collapsed at frame ~150 on exactly this. The GN steps
    work on pixel-scale residuals (condition ~depth/baseline, not its
    square) and restore SVD-grade accuracy for a few fused multiplies.
    Points at infinity (w ≈ 0) still come out huge and are culled by the
    callers' parallax/cheirality gates."""
    rows = []
    for P, xy in ((P1, xy1), (P2, xy2)):
        rows.append(xy[:, 0:1] * P[2][None] - P[0][None])
        rows.append(xy[:, 1:2] * P[2][None] - P[1][None])
    A = jnp.stack(rows, axis=1)  # [N, 4, 4]
    B, c = A[:, :, :3], A[:, :, 3]
    G = jnp.einsum("nri,nrj->nij", B, B)          # [N, 3, 3]
    rhs = -jnp.einsum("nri,nr->ni", B, c)         # [N, 3]
    det = jnp.linalg.det(G)
    X = jnp.einsum("nij,nj->ni", _adj3(G), rhs) / jnp.where(
        jnp.abs(det) > 1e-20, det, 1e-20)[:, None]
    return _triangulate_gn(X, (P1, P2), (xy1, xy2))


def _triangulate_gn(X, Ps, xys, iters: int = 2, damp: float = 1e-6):
    """Batched Gauss-Newton refinement of [N, 3] points against their
    reprojections in each [3, 4] view of Ps. Pure arithmetic (3x3 adjugate
    solves), no iterative decompositions."""
    for _ in range(iters):
        H = jnp.zeros(X.shape[:1] + (3, 3), X.dtype)
        g = jnp.zeros_like(X)
        for P, xy in zip(Ps, xys):
            h = X @ P[:, :3].T + P[:, 3]            # [N, 3]
            z = jnp.where(jnp.abs(h[:, 2:]) > 1e-9, h[:, 2:], 1e-9)
            r = h[:, :2] / z - xy                    # [N, 2]
            # J = d(h01/h2)/dX = (P01*h2 - h01*P2) / h2^2   [N, 2, 3]
            J = (P[None, :2, :3] * z[..., None]
                 - h[:, :2, None] * P[None, 2, :3]) / (z ** 2)[..., None]
            H = H + jnp.einsum("nri,nrj->nij", J, J)
            g = g + jnp.einsum("nri,nr->ni", J, r)
        H = H + damp * jnp.eye(3, dtype=X.dtype)
        det = jnp.linalg.det(H)
        step = jnp.einsum("nij,nj->ni", _adj3(H), g) / jnp.where(
            jnp.abs(det) > 1e-20, det, 1e-20)[:, None]
        # keep the (huge, gate-culled) degenerate points finite
        X = X - jnp.where(jnp.isfinite(step), step, 0.0)
    return X


def _adj3(G):
    """Batched adjugate of [N, 3, 3] (transpose of the cofactor matrix)."""
    a, b, c = G[:, 0, 0], G[:, 0, 1], G[:, 0, 2]
    d, e, f = G[:, 1, 0], G[:, 1, 1], G[:, 1, 2]
    g, h, i = G[:, 2, 0], G[:, 2, 1], G[:, 2, 2]
    return jnp.stack([
        jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], axis=1)


def _check_rt(R, t, xy1, xy2, w, K, th2: float = 4.0 * SIGMA * SIGMA):
    """Cheirality + parallax + reprojection gating of one (R, t) motion
    hypothesis (Initializer::CheckRT, src/Initializer.cpp:1038).

    Returns (n_good, parallax_deg, pts3d [N, 3], good mask)."""
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    P2 = K @ jnp.concatenate([R, t[:, None]], axis=1)
    X = triangulate_dlt(P1, P2, xy1, xy2)

    finite = jnp.all(jnp.isfinite(X), axis=-1)
    O2 = -R.T @ t
    n1 = X
    n2 = X - O2[None]
    cos_par = jnp.sum(n1 * n2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(n1, axis=-1) * jnp.linalg.norm(n2, axis=-1), 1e-12
    )
    z1 = X[:, 2]
    Xc2 = X @ R.T + t[None]
    z2 = Xc2[:, 2]
    depth_ok = (z1 > 0) & (z2 > 0) | (cos_par >= 0.99998)
    # reference: allow negative depth only when parallax ~ 0 (those are
    # counted out anyway); replicate by requiring depth>0 unless degenerate
    depth_ok = (z1 > 0) & (z2 > 0)

    def reproj_err(Xc, xy, fxy):
        uv = Xc[:, :2] / jnp.where(jnp.abs(Xc[:, 2:]) > 1e-12, Xc[:, 2:], 1e-12)
        uv = uv * fxy[0] + fxy[1]
        return jnp.sum((uv - xy) ** 2, axis=-1)

    fxy = (jnp.array([K[0, 0], K[1, 1]]), jnp.array([K[0, 2], K[1, 2]]))
    e1 = reproj_err(X, xy1, fxy)
    e2 = reproj_err(Xc2, xy2, fxy)
    good = w & finite & depth_ok & (e1 < th2) & (e2 < th2) & (cos_par < 0.99998)
    n_good = jnp.sum(good)
    # parallax at the 50th-best point (reference takes min(50, n)-th)
    cos_sorted = jnp.sort(jnp.where(good, cos_par, 1.0))
    take = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
    parallax = jnp.degrees(jnp.arccos(jnp.clip(cos_sorted[take], -1.0, 1.0)))
    return n_good, parallax, X, good


def _decompose_E(E):
    """4 motion hypotheses from an essential matrix
    (Initializer::DecomposeE, src/Initializer.cpp:1185)."""
    u, _, vt = jnp.linalg.svd(E)
    t = u[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _decompose_H(H, K):
    """Faugeras SVD-based homography decomposition, 8 motions
    (Initializer::ReconstructH, src/Initializer.cpp:725-950)."""
    A = jnp.linalg.inv(K) @ H @ K
    U, d, Vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    # x1, x3 combinations
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])

    # case d' > 0 (n'=+): R' rotation about y by theta
    aux_st = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 + d3) * d2, 1e-12
    )
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    sts = jnp.array([aux_st, -aux_st, -aux_st, aux_st])

    def rt_pos(i):
        st, x1, x3 = sts[i], x1s[i], x3s[i]
        Rp = jnp.array([[ct, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct]])
        R = s * U @ Rp @ Vt
        tp = (d1 - d3) * jnp.array([x1, 0.0, -x3])
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # case d' < 0: rotation by phi with reflection
    aux_sp = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 - d3) * d2, 1e-12
    )
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sps = jnp.array([aux_sp, -aux_sp, -aux_sp, aux_sp])

    def rt_neg(i):
        sp, x1, x3 = sps[i], x1s[i], x3s[i]
        Rp = jnp.array([[cp, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cp]])
        R = s * U @ Rp @ Vt
        tp = (d1 + d3) * jnp.array([x1, 0.0, x3])
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = rt_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = rt_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


class TwoViewResult(NamedTuple):
    success: jnp.ndarray       # bool scalar
    used_homography: jnp.ndarray
    R: jnp.ndarray             # [3, 3] camera2-from-camera1
    t: jnp.ndarray             # [3] unit-norm
    points3d: jnp.ndarray      # [N, 3] in camera1 frame
    good: jnp.ndarray          # [N] bool triangulated-point mask
    n_inliers: jnp.ndarray


def _ransac_model(key, xy1, xy2, w, dlt_fn, score_fn, n_hyp: int):
    n = xy1.shape[0]
    xn1, T1 = _normalize(xy1, w)
    xn2, T2 = _normalize(xy2, w)
    probs = w.astype(jnp.float32) / jnp.maximum(jnp.sum(w), 1.0)
    keys = jax.random.split(key, n_hyp)

    def one(k):
        idx = jax.random.choice(k, n, (8,), replace=False, p=probs)
        return dlt_fn(xn1[idx], xn2[idx])

    models_n = jax.vmap(one)(keys)  # [Hyp, 3, 3] in normalized coords
    # denormalize: F = T2^T Fn T1 ; H = T2^-1 Hn T1
    return models_n, T1, T2


@jax.jit
def initialize_two_view(key, xy1, xy2, w, K) -> TwoViewResult:
    """Full two-view bootstrap (Initializer::Initialize, src/Initializer.cpp:55).

    xy1/xy2: [N, 2] undistorted pixel coords of matched features, w: [N] bool
    match validity, K: [3, 3] intrinsics. N is static; invalid rows ignored.

    jit at def-site: this runs on the host once per mono-init attempt; eager
    execution would dispatch the 200-hypothesis H+F sweeps op-by-op, with
    tiny compiles that never reach the persistent cache. As one program it
    compiles once and lands in the persistent cache.
    """
    kH, kF = jax.random.split(key)

    # --- homography sweep ---
    Hn, T1, T2 = _ransac_model(kH, xy1, xy2, w, _dlt_H, _score_H, N_HYPOTHESES)
    T2inv = jnp.linalg.inv(T2)
    Hs = jnp.einsum("ij,njk,kl->nil", T2inv, Hn, T1)
    scoresH, masksH = jax.vmap(lambda H: _score_H(H, xy1, xy2, w))(Hs)
    bestH = jnp.argmax(scoresH)
    H = Hs[bestH]
    inH = masksH[bestH]
    # refit on inliers (2 rounds) — recovers the precision a single f32
    # 8-point fit lacks; re-score to refresh the inlier set
    for _ in range(2):
        H = _dlt_H_masked(xy1, xy2, w & inH)
        SH, inH = _score_H(H, xy1, xy2, w)

    # --- fundamental sweep ---
    Fn, T1f, T2f = _ransac_model(kF, xy1, xy2, w, _dlt_F, _score_F, N_HYPOTHESES)
    Fs = jnp.einsum("ji,njk,kl->nil", T2f, Fn, T1f)  # T2^T Fn T1
    scoresF, masksF = jax.vmap(lambda F: _score_F(F, xy1, xy2, w))(Fs)
    bestF = jnp.argmax(scoresF)
    F = Fs[bestF]
    inF = masksF[bestF]
    for _ in range(2):
        F = _dlt_F_masked(xy1, xy2, w & inF)
        SF, inF = _score_F(F, xy1, xy2, w)

    RH = SH / jnp.maximum(SH + SF, 1e-12)
    use_H = RH > 0.40  # src/Initializer.cpp:150-153

    # --- reconstruct both, select at the end (both cheap, keeps jit static) ---
    E = K.T @ F @ K
    Rs_f, ts_f = _decompose_E(E)
    Rs_h, ts_h = _decompose_H(H, K)
    Rs = jnp.concatenate([Rs_f, Rs_h])     # [12, 3, 3]
    ts = jnp.concatenate([ts_f, ts_h])
    from_H = jnp.arange(12) >= 4
    w_model = jnp.where(use_H, w & inH, w & inF)

    n_goods, parallaxes, Xs, goods = jax.vmap(
        lambda R, t: _check_rt(R, t, xy1, xy2, w_model, K)
    )(Rs, ts)
    # mask out hypotheses of the non-selected model
    cand_ok = jnp.where(use_H, from_H, ~from_H)
    n_goods = jnp.where(cand_ok, n_goods, -1)
    best = jnp.argmax(n_goods)
    n_best = n_goods[best]

    n_candidates = jnp.sum(w_model)
    min_good = jnp.maximum(jnp.int32(0.9 * n_candidates), 50)
    # "clear winner": no other hypothesis within 0.7x (ReconstructF :648-707)
    second = jnp.sort(n_goods)[-2]
    clear = second.astype(jnp.float32) < 0.75 * n_best.astype(jnp.float32)
    ok = (n_best >= min_good) & clear & (parallaxes[best] > MIN_PARALLAX_DEG)

    return TwoViewResult(
        success=ok,
        used_homography=use_H,
        R=Rs[best],
        t=ts[best],
        points3d=Xs[best],
        good=goods[best],
        n_inliers=n_best,
    )
