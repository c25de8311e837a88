"""Batched geometric solvers: triangulation, PnP, E/F/H estimation, Umeyama.

Re-designs src/estimators/* (absolute_pose, essential_matrix, fundamental_matrix,
homography_matrix, triangulation, similarity_transform — ~12.5k LoC of
per-sample C++) as fixed-shape batched JAX functions, built to be vmapped over
thousands of RANSAC hypotheses at once (ops/ransac.py): hypothesis generation is
one big batched SVD/eigh instead of a sequential loop.

Notes vs the reference:
  * PnP minimal solver is a 6-point DLT (+ orthogonal Procrustes projection)
    rather than Kneip P3P (estimators/absolute_pose.h:52): quartic
    root-finding needs non-symmetric eigensolves that XLA does not lower
    for accelerators (jnp.linalg.eig is CPU-only); a P6P sample
    costs more RANSAC trials, which the batched hypothesis bank absorbs.
    EPnP (absolute_pose.h:97) is provided for non-minimal refits.
  * Essential matrix: Nister 5-point (up to 10 solutions per sample) with the
    degree-10 polynomial rooted by the batched Durand-Kerner of
    ops/polynomial (companion-matrix eig is CPU-only in XLA); 8-point +
    manifold projection serves as the non-minimal LO refit.
  * Fundamental: 7-point minimal (closed-form cubic) + 8-point LO refit.
All solvers operate on normalized or pixel coordinates as documented per-fn.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import se3

Array = jax.Array


# ---------------------------------------------------------------------------
# triangulation (reference: src/base/triangulation.cc, estimators/triangulation.cc)


def triangulate_dlt(proj1: Array, proj2: Array, uv1: Array, uv2: Array) -> Array:
    """DLT triangulation from two 3x4 projection matrices; uv in normalized or
    pixel coords matching the projection matrices. Batched over leading dims."""
    rows = jnp.stack(
        [
            uv1[..., 0, None] * proj1[..., 2, :] - proj1[..., 0, :],
            uv1[..., 1, None] * proj1[..., 2, :] - proj1[..., 1, :],
            uv2[..., 0, None] * proj2[..., 2, :] - proj2[..., 0, :],
            uv2[..., 1, None] * proj2[..., 2, :] - proj2[..., 1, :],
        ],
        axis=-2,
    )  # [...,4,4]
    # nullspace via eigh of the 4x4 Gram matrix: a symmetric 4x4 eigh is
    # cheaper than a batched SVD, and this runs per-point inside pose recovery
    M = jnp.einsum("...ri,...rj->...ij", rows, rows)
    _, V = jnp.linalg.eigh(M)
    X = V[..., :, 0]  # smallest-eigenvalue eigenvector
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def proj_matrix(q: Array, t: Array) -> Array:
    """[R|t] 3x4 from pose, batched."""
    R = se3.quat_to_rotmat(q)
    return jnp.concatenate([R, t[..., :, None]], axis=-1)


def triangulate_multiview(qs: Array, ts: Array, uvs: Array, mask: Array) -> Array:
    """N-view DLT: qs [T,4], ts [T,3], uvs [T,2] normalized camera coords,
    mask [T]. Rows of invalid views are zeroed (they do not constrain)."""
    P = proj_matrix(qs, ts)  # [T,3,4]
    r1 = uvs[:, 0, None] * P[:, 2, :] - P[:, 0, :]
    r2 = uvs[:, 1, None] * P[:, 2, :] - P[:, 1, :]
    A = jnp.concatenate([r1, r2], axis=0) * jnp.concatenate([mask, mask])[:, None]
    X = nullspace_vecs(A, 1)[0]
    w = jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, X[3])
    return X[:3] / w


def triangulation_angle(center1: Array, center2: Array, X: Array) -> Array:
    """Angle at X subtended by the two camera centers (radians)."""
    v1 = center1 - X
    v2 = center2 - X
    c = jnp.sum(v1 * v2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(v1, axis=-1) * jnp.linalg.norm(v2, axis=-1), 1e-12
    )
    return jnp.arccos(jnp.clip(c, -1.0, 1.0))


# ---------------------------------------------------------------------------
# absolute pose (PnP)


def p6p_dlt(uv: Array, X: Array) -> tuple[Array, Array]:
    """Direct linear P6P for calibrated cameras.

    uv [6,2] normalized camera coords (x/z, y/z); X [6,3] world points.
    Returns (q, t) with R projected to SO(3) by Procrustes and sign fixed by
    cheirality (majority of points in front). Works for any n >= 6 rows.
    """
    n = uv.shape[0]
    Xh = jnp.concatenate([X, jnp.ones((n, 1), X.dtype)], axis=-1)  # [n,4]
    z = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, z, -uv[:, 0:1] * Xh], axis=-1)  # [n,12]
    r2 = jnp.concatenate([z, Xh, -uv[:, 1:2] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)  # [2n,12]
    P = nullspace_vecs(A, 1)[0].reshape(3, 4)
    M = P[:, :3]
    # scale & sign: det(R) > 0
    s = jnp.sign(jnp.linalg.det(M))
    s = jnp.where(s == 0, 1.0, s)
    M = M * s
    tt = P[:, 3] * s
    scale = jnp.exp(jnp.log(jnp.maximum(jnp.abs(jnp.linalg.det(M)), 1e-30)) / 3.0)
    M = M / scale
    tt = tt / scale
    # project to SO(3); if the majority of depths come out negative the
    # hypothesis is bogus and gets scored out by RANSAC.
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    d = jnp.where(d == 0, 1.0, d)
    one = jnp.ones((), M.dtype)
    R = U @ jnp.diag(jnp.stack([one, one, d])) @ Vt
    q = se3.rotmat_to_quat(R)
    return q, tt


def p3p(uv: Array, X: Array) -> tuple[Array, Array, Array]:
    """Quartic P3P (Gao's complete-classification form — the variant the
    reference ships): up to 4 world->camera poses from 3 2D-3D matches.

    uv [3,2] normalized camera coords, X [3,3] world points. Returns
    (qs [4,4], ts [4,3], valid [4]). reference:
    estimators/absolute_pose.cc:47-172 (P3PEstimator::Estimate).

    Device re-design: the quartic in the distance ratio x = |PA|/|PC| is
    rooted with the batched Durand-Kerner of ops/polynomial (companion-matrix
    eig is CPU-only in XLA), y = |PB|/|PC| follows in closed form, and the rigid
    world->camera alignment is the existing umeyama (Kabsch) — all
    branch-free and vmappable, so one fused dispatch solves a whole RANSAC
    bank's minimal samples.
    """
    from . import polynomial as poly_ops

    f = jnp.concatenate([uv, jnp.ones((3, 1), uv.dtype)], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)  # bearing vectors
    u, v, w = f[0], f[1], f[2]
    cos_uv = jnp.dot(u, v)
    cos_uw = jnp.dot(u, w)
    cos_vw = jnp.dot(v, w)
    AB2 = jnp.sum((X[0] - X[1]) ** 2)
    AC2 = jnp.sum((X[0] - X[2]) ** 2)
    BC2 = jnp.sum((X[1] - X[2]) ** 2)
    ab2 = jnp.maximum(AB2, 1e-12)
    dist_AB = jnp.sqrt(ab2)
    a = BC2 / ab2
    b = AC2 / ab2
    p = 2.0 * cos_vw
    q = 2.0 * cos_uw
    r = 2.0 * cos_uv
    a2, b2 = a * a, b * b
    p2, q2, r2 = p * p, q * q, r * r
    p3_, r3 = p2 * p, r2 * r
    r4, r5 = r3 * r, r3 * r2

    # quartic in x (coefficients highest-degree first)
    c4 = -2 * b + b2 + a2 + 1 + a * b * (2 - r2) - 2 * a
    c3 = (
        -2 * q * a2 - r * p * b2 + 4 * q * a + (2 * q + p * r) * b
        + (r2 * q - 2 * q + r * p) * a * b - 2 * q
    )
    c2 = (
        (2 + q2) * a2 + (p2 + r2 - 2) * b2 - (4 + 2 * q2) * a
        - (p * q * r + p2) * b - (p * q * r + r2) * a * b + q2 + 2
    )
    c1 = (
        -2 * q * a2 - r * p * b2 + 4 * q * a
        + (p * r + q * p2 - 2 * q) * b + (r * p + 2 * q) * a * b - 2 * q
    )
    c0 = a2 + b2 - 2 * a + (2 - p2) * b - 2 * a * b + 1
    roots, rvalid = poly_ops.real_roots(jnp.stack([c4, c3, c2, c1, c0]))

    bb1 = (p2 - p * q * r + r2) * a + (p2 - r2) * b - p2 + p * q * r - r2
    b1 = b * bb1 * bb1
    b1_ok = jnp.abs(b1) > 1e-10
    b1_safe = jnp.where(b1_ok, b1, 1.0)

    def one(x, okroot):
        ok = okroot & (x > 0.0) & b1_ok
        x2 = x * x
        x3 = x2 * x
        b0 = ((1 - a - b) * x2 + (a - 1) * q * x - a + b + 1) * (
            r3 * (a2 + b2 - 2 * a - 2 * b + (2 - r2) * a * b + 1) * x3
            + r2 * (
                p + p * a2 - 2 * r * q * a * b + 2 * r * q * b - 2 * r * q
                - 2 * p * a - 2 * p * b + p * r2 * b + 4 * r * q * a
                + q * r3 * a * b - 2 * r * q * a2 + 2 * p * a * b + p * b2
                - r2 * p * b2
            ) * x2
            + (
                r5 * (b2 - a * b) - r4 * p * q * b
                + r3 * (q2 - 4 * a - 2 * q2 * a + q2 * a2 + 2 * a2 - 2 * b2 + 2)
                + r2 * (
                    4 * p * q * a - 2 * p * q * a * b + 2 * p * q * b
                    - 2 * p * q - 2 * p * q * a2
                )
                + r * (
                    p2 * b2 - 2 * p2 * b + 2 * p2 * a * b - 2 * p2 * a + p2
                    + p2 * a2
                )
            ) * x
            + (2 * p * r2 - 2 * r3 * q + p3_ - 2 * p2 * q * r + p * q2 * r2) * a2
            + (p3_ - 2 * p * r2) * b2
            + (
                4 * q * r3 - 4 * p * r2 - 2 * p3_ + 4 * p2 * q * r
                - 2 * p * q2 * r2
            ) * a
            + (-2 * q * r3 + p * r4 + 2 * p2 * q * r - 2 * p3_) * b
            + (2 * p3_ + 2 * q * r3 - 2 * p2 * q * r) * a * b
            + p * q2 * r2 - 2 * p2 * q * r + 2 * p * r2 + p3_ - 2 * r3 * q
        )
        y = b0 / b1_safe

        # f32 rescue: the quartic/b0/b1 expressions are high-order and lose
        # several digits in f32, so polish (x, y) with Newton on the two
        # law-of-cosines constraints themselves (normalized by |PC|^2):
        #   g1 = y^2 + 1 - p*y - a*nu,  g2 = x^2 + 1 - q*x - b*nu,
        #   nu = x^2 + y^2 - r*x*y   — these are quadratic and
        # well-conditioned where the quartic is not.
        def newton(xy, _):
            xx, yy = xy
            nu_ = xx * xx + yy * yy - r * xx * yy
            g1 = yy * yy + 1.0 - p * yy - a * nu_
            g2 = xx * xx + 1.0 - q * xx - b * nu_
            dnx = 2.0 * xx - r * yy
            dny = 2.0 * yy - r * xx
            j11 = -a * dnx
            j12 = 2.0 * yy - p - a * dny
            j21 = 2.0 * xx - q - b * dnx
            j22 = -b * dny
            det = j11 * j22 - j12 * j21
            dsgn = jnp.where(det < 0.0, -1.0, 1.0)  # sign-preserving floor
            det = dsgn * jnp.maximum(jnp.abs(det), 1e-12)
            dx = (g1 * j22 - g2 * j12) / det
            dy = (g2 * j11 - g1 * j21) / det
            return (xx - dx, yy - dy), None

        (x, y), _ = jax.lax.scan(newton, (x, y), None, length=3)
        nu = x * x + y * y - 2 * x * y * cos_uv
        ok = ok & (nu > 1e-12) & (x > 0.0) & (y > 0.0)
        dist_PC = dist_AB / jnp.sqrt(jnp.maximum(nu, 1e-12))
        Xc = jnp.stack([u * (x * dist_PC), v * (y * dist_PC), w * dist_PC])
        qq, tt, _ = umeyama(X, Xc, with_scale=False)
        ok = ok & jnp.all(jnp.isfinite(qq)) & jnp.all(jnp.isfinite(tt))
        ident = jnp.asarray([1.0, 0.0, 0.0, 0.0], uv.dtype)
        return jnp.where(ok, qq, ident), jnp.where(ok, tt, 0.0), ok

    qs, ts, vs = jax.vmap(one)(roots, rvalid)
    return qs, ts, vs


def epnp(uv: Array, X: Array, mask: Array | None = None) -> tuple[Array, Array]:
    """EPnP (N=1 nullspace case) + Procrustes, for non-minimal refits.

    uv [n,2] normalized coords, X [n,3], optional mask [n]. reference:
    estimators/absolute_pose.h:97 (EPNPEstimator).
    """
    n = uv.shape[0]
    m = jnp.ones((n,), X.dtype) if mask is None else mask
    wsum = jnp.maximum(jnp.sum(m), 1.0)
    centroid = jnp.sum(X * m[:, None], axis=0) / wsum
    Xc = (X - centroid) * m[:, None]
    cov = Xc.T @ Xc / wsum
    eigval, eigvec = jnp.linalg.eigh(cov)
    # control points: centroid + principal axes scaled
    axes = eigvec.T * jnp.sqrt(jnp.maximum(eigval, 1e-12))[:, None]  # [3,3]
    C = jnp.concatenate([centroid[None, :], centroid[None, :] + axes], axis=0)  # [4,3]
    # barycentric coords: X = alpha @ C with sum(alpha)=1
    Ch = jnp.concatenate([C.T, jnp.ones((1, 4))], axis=0)  # [4,4]
    Xh = jnp.concatenate([X.T, jnp.ones((1, n))], axis=0)  # [4,n]
    alpha = jnp.linalg.solve(Ch, Xh).T  # [n,4]
    # M matrix [2n, 12]
    a = alpha
    u, v = uv[:, 0], uv[:, 1]
    z4 = jnp.zeros((n, 4))
    r1 = jnp.concatenate([a, z4, -u[:, None] * a], axis=-1)
    r2 = jnp.concatenate([z4, a, -v[:, None] * a], axis=-1)
    Mm = jnp.concatenate([r1 * m[:, None], r2 * m[:, None]], axis=0)  # [2n,12]
    MtM = Mm.T @ Mm
    w, vvec = jnp.linalg.eigh(MtM)
    x = vvec[:, 0].reshape(3, 4)  # control points in camera frame (up to scale)
    Cc = x.T  # [4,3]
    # fix sign: depths positive
    sign = jnp.sign(jnp.sum(alpha @ Cc[:, 2]))
    sign = jnp.where(sign == 0, 1.0, sign)
    Cc = Cc * sign
    # similarity alignment world control pts -> camera control pts. The EPnP
    # nullspace determines camera control points only up to a global scale
    # beta: Cc_est = beta (R C + t). Umeyama gives s = beta and t_u = beta t,
    # so the rigid translation is t_u / s.
    q, t_u, s = umeyama(C, Cc, with_scale=True)
    return q, t_u / jnp.maximum(s, 1e-12)


def umeyama(src: Array, dst: Array, with_scale: bool = False, mask: Array | None = None):
    """Least-squares similarity/rigid transform src -> dst.

    Returns (q, t, s) with dst ~ s * R(q) @ src + t; optional per-row weight
    mask [n] restricts the fit to a subset (RANSAC LO refits). reference:
    base/similarity_transform.cc (Umeyama).
    """
    if mask is None:
        w = jnp.ones(src.shape[0], src.dtype)
    else:
        w = jnp.asarray(mask, src.dtype)
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    mu_s = jnp.sum(src * w[:, None], axis=0) / wsum
    mu_d = jnp.sum(dst * w[:, None], axis=0) / wsum
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc / wsum
    U, S, Vt = jnp.linalg.svd(cov)
    d = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    d = jnp.where(d == 0, 1.0, d)
    Dm = jnp.diag(jnp.stack([jnp.float32(1.0), jnp.float32(1.0), d]))
    R = U @ Dm @ Vt
    if with_scale:
        var_s = jnp.sum(jnp.sum(sc * sc, axis=-1) * w) / wsum
        s = jnp.sum(S * jnp.diagonal(Dm)) / jnp.maximum(var_s, 1e-12)
    else:
        s = jnp.float32(1.0)
    t = mu_d - s * (R @ mu_s)
    return se3.rotmat_to_quat(R), t, s


# ---------------------------------------------------------------------------
# epipolar geometry


def _normalize_points(uv: Array, mask: Array | None = None) -> tuple[Array, Array]:
    """Hartley normalization: returns (uv_norm, T 3x3) with T @ uv_h = uv_norm_h.

    With a mask, mean/rms come from the masked rows only — an LO refit on an
    inlier subset must not let outlier coordinates skew the conditioning."""
    if mask is None:
        mean = jnp.mean(uv, axis=0)
        rms = jnp.sqrt(jnp.mean(jnp.sum((uv - mean) ** 2, axis=-1)))
    else:
        w = mask / jnp.maximum(jnp.sum(mask), 1.0)
        mean = jnp.sum(uv * w[:, None], axis=0)
        rms = jnp.sqrt(jnp.sum(jnp.sum((uv - mean) ** 2, axis=-1) * w))
    s = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-12)
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    T = T.at[0, 0].set(s).at[1, 1].set(s).at[0, 2].set(-s * mean[0]).at[1, 2].set(-s * mean[1])
    return (uv - mean) * s, T



def nullspace_vecs(A: Array, k: int) -> Array:
    """Last-k right singular vectors of A ([n,d]) as rows [k,d], ordered most
    -null first — via eigh of the d x d Gram matrix instead of a full SVD.

    jnp.linalg.svd(A, full_matrices=True) materializes the n x n U factor:
    for the LO refits that re-solve on all (padded) correspondences n is the
    2048-point cap, so each refit built a 2048x2048 U it never read — once
    the dominant cost of the fused EFH verification program. The
    d x d (<= 9 here) symmetric eigendecomposition gives the same nullspace
    basis at O(n d^2) + O(d^3); inputs are Hartley-normalized so the squared
    conditioning of the Gram matrix is benign at f32.
    """
    M = A.T @ A
    _, V = jnp.linalg.eigh(M)  # ascending eigenvalues
    return V[:, :k].T


def eight_point(uv1: Array, uv2: Array, mask: Array | None = None, essential: bool = False) -> Array:
    """8-point algorithm for F (or E with manifold projection).

    uv1/uv2 [n,2] (n >= 8); for E pass normalized camera coords. Returns 3x3.
    reference: estimators/fundamental_matrix.h:93, essential_matrix.h:53
    (5-point replaced; see module docstring).
    """
    n = uv1.shape[0]
    m = jnp.ones((n,), uv1.dtype) if mask is None else mask
    n1, T1 = _normalize_points(uv1, m)
    n2, T2 = _normalize_points(uv2, m)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)], axis=-1
    ) * m[:, None]
    F = nullspace_vecs(A, 1)[0].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    if essential:
        S2 = jnp.array([1.0, 1.0, 0.0])
    else:
        S2 = S.at[2].set(0.0)
    F = U @ jnp.diag(S2) @ Vt
    F = T2.T @ F @ T1
    norm = jnp.linalg.norm(F)
    return F / jnp.where(norm < 1e-12, 1e-12, norm)


def seven_point(uv1: Array, uv2: Array) -> tuple[Array, Array]:
    """7-point fundamental matrix: up to 3 solutions.

    Returns (Fs [3,3,3], valid [3]). The nullspace of the 7x9 system is
    span{F1, F2}; det(F1 + t F2) = 0 is a cubic solved in closed form
    (Cardano/trigonometric — all-real case handled; complex roots marked
    invalid). reference: estimators/fundamental_matrix.h:53
    (SevenPointEstimator).
    """
    n1, T1 = _normalize_points(uv1)
    n2, T2 = _normalize_points(uv2)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)], axis=-1
    )
    ns = nullspace_vecs(A, 2)
    F1 = ns[0].reshape(3, 3)
    F2 = ns[1].reshape(3, 3)

    # det(F1 + t F2) = c3 t^3 + c2 t^2 + c1 t + c0 via 4-point interpolation
    def det_at(t):
        return jnp.linalg.det(F1 + t * F2)

    d0 = det_at(0.0)
    d1 = det_at(1.0)
    dm1 = det_at(-1.0)
    d2 = det_at(2.0)
    c0 = d0
    # solve small linear system for c1..c3 from samples
    # d(t) = c3 t^3 + c2 t^2 + c1 t + c0
    M = jnp.asarray([[1.0, 1.0, 1.0], [-1.0, 1.0, -1.0], [8.0, 4.0, 2.0]])  # rows t=1,-1,2 of [t^3,t^2,t]
    rhs = jnp.stack([d1 - c0, dm1 - c0, d2 - c0])
    c3, c2, c1 = jnp.linalg.solve(M, rhs)

    # cubic roots (depressed + trigonometric), degenerate-degree guarded
    a = jnp.where(jnp.abs(c3) < 1e-12, 1e-12, c3)
    b, c, d = c2 / a, c1 / a, c0 / a
    p = c - b * b / 3.0
    q = 2.0 * b**3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    # three-real-root branch
    pm = jnp.minimum(p, -1e-12)
    m = 2.0 * jnp.sqrt(-pm / 3.0)
    arg = jnp.clip(3.0 * q / (pm * m), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    k = jnp.arange(3)
    roots3 = m * jnp.cos(theta - 2.0 * jnp.pi * k / 3.0) - b / 3.0
    # single-real-root branch (Cardano)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    root1 = u + v - b / 3.0
    three_real = disc <= 0
    roots = jnp.where(three_real, roots3, jnp.stack([root1, root1, root1]))
    valid = jnp.where(three_real, jnp.ones(3, bool), jnp.asarray([True, False, False]))

    def build(t):
        F = F1 + t * F2
        F = T2.T @ F @ T1
        nrm = jnp.linalg.norm(F)
        return F / jnp.where(nrm < 1e-12, 1e-12, nrm)

    Fs = jax.vmap(build)(roots)
    return Fs, valid


def _five_point_poly(uv1: Array, uv2: Array):
    """Nister reduction: returns (det10 [11] z-polynomial highest-first,
    rows — the three (px [4], py [4], pc [5]) B(z)-row polynomials — and the
    nullspace basis Eb [4,3,3])."""
    x1, y1 = uv1[:, 0], uv1[:, 1]
    x2, y2 = uv2[:, 0], uv2[:, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)],
        axis=-1,
    )  # [5,9], rows of x2^T E x1 = 0 with E row-major
    Eb = nullspace_vecs(A, 4)[::-1].reshape(4, 3, 3)  # E = x Eb[0] + y Eb[1] + z Eb[2] + Eb[3]

    # --- trace-time symbolic polynomials over monomials x^i y^j z^k --------
    def pmul(p, q):
        r = {}
        for a, ca in p.items():
            for b, cb in q.items():
                k = (a[0] + b[0], a[1] + b[1], a[2] + b[2])
                r[k] = r[k] + ca * cb if k in r else ca * cb
        return r

    def padd(p, q, s=1.0):
        r = dict(p)
        for k, c in q.items():
            r[k] = r[k] + s * c if k in r else s * c
        return r

    E = [
        [
            {
                (1, 0, 0): Eb[0, i, j],
                (0, 1, 0): Eb[1, i, j],
                (0, 0, 1): Eb[2, i, j],
                (0, 0, 0): Eb[3, i, j],
            }
            for j in range(3)
        ]
        for i in range(3)
    ]

    def minor(i0, i1, j0, j1):
        return padd(pmul(E[i0][j0], E[i1][j1]), pmul(E[i0][j1], E[i1][j0]), -1.0)

    detE = padd(
        padd(pmul(E[0][0], minor(1, 2, 1, 2)), pmul(E[0][1], minor(1, 2, 0, 2)), -1.0),
        pmul(E[0][2], minor(1, 2, 0, 1)),
    )

    EEt = [
        [
            padd(
                padd(pmul(E[i][0], E[k][0]), pmul(E[i][1], E[k][1])),
                pmul(E[i][2], E[k][2]),
            )
            for k in range(3)
        ]
        for i in range(3)
    ]
    tr = padd(padd(EEt[0][0], EEt[1][1]), EEt[2][2])

    eqs = [detE]
    for i in range(3):
        for j in range(3):
            cij = {}
            for k in range(3):
                cij = padd(cij, pmul(EEt[i][k], E[k][j]), 2.0)
            cij = padd(cij, pmul(tr, E[i][j]), -1.0)
            eqs.append(cij)

    # Nister monomial order: first 10 eliminate, last 10 = [xz^2, xz, x,
    # yz^2, yz, y, z^3, z^2, z, 1]
    MON = [
        (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
        (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
        (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
        (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
    ]
    zero = jnp.zeros(())
    M = jnp.stack([
        jnp.stack([eq.get(m, zero) for m in MON]) for eq in eqs
    ])  # [10,20]

    # Gauss-Jordan: first10 = -C @ last10-monomials
    C = jnp.linalg.solve(M[:, :10], M[:, 10:])  # [10,10]

    # B rows from z*(row of x^2) - (row of x^2 z), etc. Row pair (r1=degree+z,
    # r2=degree): coefficients over n are d_j(z) = z C[r2,j] - C[r1,j], which
    # collect into per-row z-polynomials in x (deg 3), y (deg 3), 1 (deg 4).
    def brow(r1, r2):
        px = jnp.stack([
            C[r2, 0], C[r2, 1] - C[r1, 0], C[r2, 2] - C[r1, 1], -C[r1, 2]
        ])
        py = jnp.stack([
            C[r2, 3], C[r2, 4] - C[r1, 3], C[r2, 5] - C[r1, 4], -C[r1, 5]
        ])
        pc = jnp.stack([
            C[r2, 6], C[r2, 7] - C[r1, 6], C[r2, 8] - C[r1, 7],
            C[r2, 9] - C[r1, 8], -C[r1, 9]
        ])
        return px, py, pc

    rows = [brow(4, 5), brow(6, 7), brow(8, 9)]

    def conv(a, b):
        return jnp.convolve(a, b)

    (px0, py0, pc0), (px1, py1, pc1), (px2, py2, pc2) = rows
    m12_yc = conv(py1, pc2) - conv(py2, pc1)  # deg 7
    m12_xc = conv(px1, pc2) - conv(px2, pc1)  # deg 7
    m12_xy = conv(px1, py2) - conv(px2, py1)  # deg 6
    det10 = (
        conv(px0, m12_yc) - conv(py0, m12_xc)
        + conv(pc0, jnp.pad(m12_xy, (0, 0)))
    )  # [11], degree 10, highest first
    return det10, rows, Eb


def five_point(uv1: Array, uv2: Array) -> tuple[Array, Array]:
    """Nister 5-point essential matrix: up to 10 solutions.

    uv1/uv2 [5,2] normalized camera coordinates. Returns (Es [10,3,3],
    valid [10]). reference: estimators/essential_matrix.h
    (EssentialMatrixFivePointEstimator) + base/polynomial.cc root finding.

    Device re-design: instead of the reference's Eigen Gauss-Jordan + companion
    matrix (non-symmetric eig, CPU-only in XLA), the ten cubic constraints
    (det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0) are expanded symbolically at
    trace time into the 20-monomial basis, reduced with one 10x10 solve, and
    the degree-10 det B(z) polynomial is rooted with the batched
    Durand-Kerner of ops/polynomial — the whole bank of RANSAC samples runs
    as one vmapped dispatch.
    """
    from . import polynomial as poly_ops

    det10, rows, Eb = _five_point_poly(uv1, uv2)
    (px0, py0, pc0), (px1, py1, pc1), (px2, py2, pc2) = rows

    roots, rvalid = poly_ops.real_roots(det10)

    def build(z, ok):
        pxv = jnp.stack([poly_ops.polyval(px0, z), poly_ops.polyval(px1, z), poly_ops.polyval(px2, z)])
        pyv = jnp.stack([poly_ops.polyval(py0, z), poly_ops.polyval(py1, z), poly_ops.polyval(py2, z)])
        pcv = jnp.stack([poly_ops.polyval(pc0, z), poly_ops.polyval(pc1, z), poly_ops.polyval(pc2, z)])
        # solve the best-conditioned 2x2 row pair of B(z) [x,y,1]^T = 0
        pairs = jnp.asarray([[0, 1], [0, 2], [1, 2]])
        d2 = pxv[pairs[:, 0]] * pyv[pairs[:, 1]] - pxv[pairs[:, 1]] * pyv[pairs[:, 0]]
        k = jnp.argmax(jnp.abs(d2))
        a, b = pairs[k, 0], pairs[k, 1]
        # sign-preserving floor: replacing a tiny NEGATIVE determinant with
        # +1e-12 would flip the sign of (x, y) and emit a sign-corrupted E
        # that wastes a hypothesis-bank slot; keep the sign and mark the root
        # invalid when even the best row pair is degenerate.
        sgn = jnp.where(d2[k] < 0.0, -1.0, 1.0)
        det2 = sgn * jnp.maximum(jnp.abs(d2[k]), 1e-12)
        ok = ok & (jnp.abs(d2[k]) >= 1e-12)
        x = (-pcv[a] * pyv[b] + pcv[b] * pyv[a]) / det2
        y = (pcv[a] * pxv[b] - pcv[b] * pxv[a]) / det2
        Ez = x * Eb[0] + y * Eb[1] + z * Eb[2] + Eb[3]
        nrm = jnp.linalg.norm(Ez)
        Ez = Ez / jnp.where(nrm < 1e-12, 1e-12, nrm)
        ok = ok & jnp.all(jnp.isfinite(Ez))
        return jnp.where(ok, Ez, jnp.eye(3)), ok

    Es, valid = jax.vmap(build)(roots, rvalid)
    return Es, valid


def sampson_error(F: Array, uv1: Array, uv2: Array) -> Array:
    """Squared Sampson distance (reference: base/essential_matrix.cc /
    cost_functions.h:563-627 RelativePoseCostFunction)."""
    x1 = jnp.concatenate([uv1, jnp.ones_like(uv1[..., :1])], axis=-1)
    x2 = jnp.concatenate([uv2, jnp.ones_like(uv2[..., :1])], axis=-1)
    Fx1 = x1 @ F.T
    Ftx2 = x2 @ F
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def decompose_essential(E: Array, uv1: Array, uv2: Array, mask: Array) -> tuple[Array, Array]:
    """Pick the (R, t) from E maximizing cheirality over the given points.

    uv normalized camera coords of cam1/cam2 (cam1 at identity). Returns the
    world-to-cam2 pose (q, t) with |t| = 1. reference: base/pose.cc
    PoseFromEssentialMatrix / essential_matrix.cc DecomposeEssentialMatrix.
    """
    U, _, Vt = jnp.linalg.svd(E)
    # ensure rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tvec = U[:, 2]

    def count_front(R, t):
        q = se3.rotmat_to_quat(R)
        q1 = jnp.array([1.0, 0.0, 0.0, 0.0])
        t1 = jnp.zeros(3)
        P1 = proj_matrix(q1, t1)
        P2 = proj_matrix(q, t)
        X = triangulate_dlt(
            jnp.broadcast_to(P1, uv1.shape[:1] + (3, 4)),
            jnp.broadcast_to(P2, uv1.shape[:1] + (3, 4)),
            uv1,
            uv2,
        )
        z1 = X[:, 2]
        z2 = (X @ R.T + t)[:, 2]
        # also reject points near infinity
        good = (z1 > 0) & (z2 > 0) & (jnp.abs(z1) < 1e3) & mask.astype(bool)
        return jnp.sum(good), q

    cands = [
        count_front(R1, tvec),
        count_front(R1, -tvec),
        count_front(R2, tvec),
        count_front(R2, -tvec),
    ]
    counts = jnp.stack([c[0] for c in cands])
    qs = jnp.stack([c[1] for c in cands])
    ts = jnp.stack([tvec, -tvec, tvec, -tvec])
    best = jnp.argmax(counts)
    return qs[best], ts[best]


# ---------------------------------------------------------------------------
# homography


def homography_dlt(uv1: Array, uv2: Array, mask: Array | None = None) -> Array:
    """4+ point homography via normalized DLT (estimators/homography_matrix.h)."""
    n = uv1.shape[0]
    m = jnp.ones((n,), uv1.dtype) if mask is None else mask
    n1, T1 = _normalize_points(uv1, m)
    n2, T2 = _normalize_points(uv2, m)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], axis=-1)
    r2 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    A = jnp.concatenate([r1 * m[:, None], r2 * m[:, None]], axis=0)
    H = nullspace_vecs(A, 1)[0].reshape(3, 3)
    Hn = jnp.linalg.solve(T2, H @ T1)
    return Hn / jnp.where(jnp.abs(Hn[2, 2]) < 1e-12, 1e-12, Hn[2, 2])


def homography_transfer_error(H: Array, uv1: Array, uv2: Array) -> Array:
    """Squared symmetric-free forward transfer error |H x1 - x2|^2."""
    x1 = jnp.concatenate([uv1, jnp.ones_like(uv1[..., :1])], axis=-1)
    y = x1 @ H.T
    w = jnp.where(jnp.abs(y[..., 2:3]) < 1e-12, 1e-12, y[..., 2:3])
    p = y[..., :2] / w
    return jnp.sum((p - uv2) ** 2, axis=-1)


def gp6p_dlt(rays_o: Array, rays_d: Array, X: Array, mask: Array | None = None) -> tuple[Array, Array]:
    """Generalized absolute pose (world -> rig) from >= 6 ray/point matches.

    Re-design of the reference's GP3P minimal solver
    (src/estimators/generalized_absolute_pose.{h,cc}): instead of Kneip's
    degree-8 polynomial (complex roots — hostile to batched XLA), use the
    linear generalized-DLT constraint

        (R X_i + t - o_i) x d_i = 0,

    3 equations (rank 2) per correspondence, linear in [vec(R); t]. A batched
    least-squares solve + SO(3) projection + linear re-solve of t given R.
    rays_o/rays_d [n,3]: ray origins/unit directions in the RIG frame;
    X [n,3] world points; optional weight mask [n].
    """
    n = X.shape[0]
    w = jnp.ones((n,), X.dtype) if mask is None else mask
    # cross-product matrix rows of d: [d]_x (R X + t) = [d]_x o
    zero = jnp.zeros((n,), X.dtype)
    dx, dy, dz = rays_d[:, 0], rays_d[:, 1], rays_d[:, 2]
    Dx = jnp.stack(
        [
            jnp.stack([zero, -dz, dy], -1),
            jnp.stack([dz, zero, -dx], -1),
            jnp.stack([-dy, dx, zero], -1),
        ],
        axis=1,
    )  # [n,3,3]
    # unknown x = [r row-major (9); t (3)]; [d]_x R X = ([d]_x) @ (X kron I) ...
    # row blocks: A_i = [ [d]_x * kron(X_i^T), [d]_x ], b_i = [d]_x o_i
    kron = jnp.einsum("nab,nc->nabc", Dx, X).reshape(n, 3, 9)  # d/dR entries
    A = jnp.concatenate([kron, Dx], axis=-1)  # [n,3,12]
    b = jnp.einsum("nab,nb->na", Dx, rays_o)  # [n,3]
    ws = jnp.sqrt(jnp.maximum(w, 0.0))[:, None, None]
    A = (A * ws).reshape(3 * n, 12)
    bf = (b * ws[:, :, 0]).reshape(3 * n)
    # least squares via normal equations (12x12, tiny)
    AtA = A.T @ A + 1e-9 * jnp.eye(12, dtype=A.dtype)
    Atb = A.T @ bf
    x = jnp.linalg.solve(AtA, Atb)
    M = x[:9].reshape(3, 3)
    t_raw = x[9:]
    # project to SO(3) (det +1), preserving the least-squares scale for t
    U, sv, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    d = jnp.where(d == 0, 1.0, d)
    one = jnp.ones((), M.dtype)
    R = U @ jnp.diag(jnp.stack([one, one, d])) @ Vt
    # re-solve t linearly with R fixed: [d]_x t = [d]_x (o - R X)
    rhs = jnp.einsum("nab,nb->na", Dx, rays_o - X @ R.T)  # [n,3]
    Dw = Dx * ws
    T_A = Dw.reshape(3 * n, 3)
    T_b = (rhs * ws[:, :, 0]).reshape(3 * n)
    TtT = T_A.T @ T_A + 1e-9 * jnp.eye(3, dtype=A.dtype)
    t = jnp.linalg.solve(TtT, T_A.T @ T_b)
    return se3.rotmat_to_quat(R), t


# ---------------------------------------------------------------------------
# generalized relative pose (rig vs rig)


def _gr6p_G(cayley: Array, f1: Array, c1: Array, f2: Array, c2: Array, w: Array) -> Array:
    """4x4 PSD system of the generalized epipolar constraint at rotation
    `cayley` (Cayley parameters): each ray pair contributes g = [a; b] with

        a = (R f1) x f2,   b = (R c1 - c2) . a,

    so that the constraint reads a.t + b = 0 for the true translation t
    (rays meet <=> (R f1), f2, and the baseline are coplanar). G = sum w g g^T;
    the true (R, t) makes [t; 1] the nullvector of G.

    Direct O(n) evaluation per iteration replaces the reference's precomputed
    9x9 contraction tensors (estimators/generalized_relative_pose.cc:325-478,
    a CPU-side caching scheme) — on the device the einsum over n rays is cheaper
    than materializing the tensor algebra, and it keeps the cost function a
    plain function of (cayley, data) so jax.grad gives the EXACT gradient the
    reference approximates by finite differences (:392-414)."""
    cx, cy, cz = cayley[0], cayley[1], cayley[2]
    s = 1.0 + cx * cx + cy * cy + cz * cz
    R = (
        jnp.asarray(
            [
                [1 + cx * cx - cy * cy - cz * cz, 2 * (cx * cy - cz), 2 * (cx * cz + cy)],
                [2 * (cx * cy + cz), 1 - cx * cx + cy * cy - cz * cz, 2 * (cy * cz - cx)],
                [2 * (cx * cz - cy), 2 * (cy * cz + cx), 1 - cx * cx - cy * cy + cz * cz],
            ]
        )
        / s
    )
    Rf1 = f1 @ R.T
    a = jnp.cross(Rf1, f2)  # [n,3]
    b = jnp.sum((c1 @ R.T - c2) * a, axis=-1)  # [n]
    g = jnp.concatenate([a, b[:, None]], axis=-1)  # [n,4]
    return jnp.einsum("n,ni,nj->ij", w, g, g)


def cayley_to_quat(cayley: Array) -> Array:
    """Cayley -> unit quaternion (w, x, y, z): q = (1, c)/sqrt(1+|c|^2)."""
    q = jnp.concatenate([jnp.ones((1,), cayley.dtype), cayley])
    return q / jnp.linalg.norm(q)


def gr6p(
    f1: Array,  # [n,3] unit bearing vectors in rig-1 frame
    c1: Array,  # [n,3] ray origins (camera centers) in rig-1 frame
    f2: Array,  # [n,3] unit bearings in rig-2 frame
    c2: Array,  # [n,3] ray origins in rig-2 frame
    mask: Array | None = None,
    key: Array | None = None,
    num_restarts: int = 4,
    num_iters: int = 48,
    cayley0: Array | None = None,
) -> tuple[Array, Array, Array]:
    """Generalized (multi-camera) relative pose from >= 6 ray correspondences.

    Re-design of the reference's GR6P estimator
    (src/estimators/generalized_relative_pose.{h,cc}, Kneip & Li CVPR'14
    "Efficient Computation of Relative Pose for Multi-Camera Systems"): find
    (R, t) with x_rig2 = R x_rig1 + t by minimizing the smallest eigenvalue
    of the 4x4 generalized-epipolar system G(R) over the Cayley rotation
    manifold, then reading the translation off G's eigenvectors.

    Differences from the reference (all for fixed-shape device execution):
      * exact gradients via jax.grad through eigvalsh instead of
        finite-difference jacobians (:392-414);
      * backtracking gradient descent as a fixed-length lax.scan (the
        reference's adaptive loop :483-560, made compile-friendly);
      * restarts batched with vmap instead of sequential random trials;
      * G(R) evaluated directly from the rays (see _gr6p_G).

    Returns (qvec [4], ts [4,3], t_valid [4]): one rotation, with up to four
    translation candidates (all eigenvectors of G, hnormalized — the
    reference also returns 4 models, :583-594); feed all four into a RANSAC
    bank and let scoring pick."""
    n = f1.shape[0]
    w = jnp.ones((n,), f1.dtype) if mask is None else mask

    def cost(cayley):
        G = _gr6p_G(cayley, f1, c1, f2, c2, w)
        return jnp.linalg.eigvalsh(G)[0]

    grad = jax.grad(cost)

    # init: Kabsch on the (centered) bearing clouds — same role as the
    # reference's ComputeRotationBetweenPoints (:118-146)
    if cayley0 is None:
        q0, _, _ = umeyama(f1, f2, with_scale=False, mask=w)
        R0 = se3.quat_to_rotmat(q0)
        # rotmat -> cayley: C = (R - I)(R + I)^-1, c = (-C12, C02, -C01)
        C = (R0 - jnp.eye(3)) @ jnp.linalg.inv(R0 + jnp.eye(3) + 1e-12 * jnp.eye(3))
        cayley0 = jnp.stack([-C[1, 2], C[0, 2], -C[0, 1]])

    if key is None:
        key = jax.random.PRNGKey(0)
    # restart bank: unperturbed init + jittered copies (reference random
    # trials :490-506, batched)
    perturb = jax.random.uniform(
        key, (num_restarts, 3), f1.dtype, -0.3, 0.3
    ).at[0].set(0.0)
    starts = cayley0[None, :] + perturb

    def descend(c0):
        def step(carry, _):
            cay, lam, cur = carry
            gvec = grad(cay)
            gn = gvec / jnp.maximum(jnp.linalg.norm(gvec), 1e-12)
            cand = cay - lam * gn
            cnew = cost(cand)
            better = cnew < cur
            cay = jnp.where(better, cand, cay)
            cur = jnp.where(better, cnew, cur)
            lam = jnp.where(better, lam * 1.5, lam * 0.5)
            return (cay, lam, cur), None

        (cay, _, cur), _ = jax.lax.scan(
            step, (c0, jnp.asarray(0.01, f1.dtype), cost(c0)), None, length=num_iters
        )
        return cay, cur

    cays, costs = jax.vmap(descend)(starts)
    best = jnp.argmin(costs)
    cay = cays[best]

    G = _gr6p_G(cay, f1, c1, f2, c2, w)
    evals, evecs = jnp.linalg.eigh(G)  # ascending; v[:,0] = best nullvector
    vh = evecs.T  # [4,4] rows = eigenvectors
    denom = vh[:, 3]
    t_valid = jnp.abs(denom) > 1e-8
    ts = vh[:, :3] / jnp.where(jnp.abs(denom[:, None]) < 1e-8, 1e-8, denom[:, None])
    return cayley_to_quat(cay), ts, t_valid


def generalized_sampson_error(
    q: Array, t: Array, f1: Array, c1: Array, f2: Array, c2: Array
) -> Array:
    """First-order (Sampson-style) squared error of the generalized epipolar
    constraint on Plücker rays, the scoring residual for GR6P banks. The
    algebraic residual r = ((R f1) x f2).t + (R c1 - c2).((R f1) x f2) is
    normalized by its gradient w.r.t. both bearing directions, giving an
    angular-unit error comparable to the normalized-coordinate Sampson error
    the reference scores with (generalized_relative_pose.cc:596-617)."""
    R = se3.quat_to_rotmat(q)
    Rf1 = f1 @ R.T
    a = jnp.cross(Rf1, f2)
    base = c1 @ R.T - c2
    r = a @ t + jnp.sum(base * a, axis=-1)
    # dr/df1 = R^T ((t + base) x f2 contributions): r = det[t+base, Rf1, f2]
    # with u = t + base: r = u . (Rf1 x f2)
    u = base + t[None, :]
    dr_df1 = jnp.cross(f2, u) @ R  # d/d(f1): (f2 x u) . R df1
    dr_df2 = jnp.cross(u, Rf1)
    denom = jnp.sum(dr_df1**2, axis=-1) + jnp.sum(dr_df2**2, axis=-1)
    return r * r / jnp.maximum(denom, 1e-12)
