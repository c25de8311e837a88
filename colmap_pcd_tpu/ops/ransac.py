"""Batched RANSAC / LO-RANSAC: hypotheses as one vmapped bank, not a loop.

Re-designs src/optim/ransac.h, loransac.h, support_measurement.{h,cc} and the
samplers: on an accelerator the hypothesize-and-verify loop becomes

  1. draw H minimal samples at once (categorical over the valid mask),
  2. solve all H minimal problems in one batched SVD/eigh (ops/solvers.py),
  3. score all H x N residuals in one pass (inlier count, then total
     truncated residual as tie-break — MSAC-flavored support, matching the
     reference's InlierSupportMeasurer ordering),
  4. local optimization: refit a non-minimal solver on the best inliers and
     rescore, a fixed small number of rounds (LORANSAC semantics).

There is no SPRT (optim/sprt.{h,cc}): it exists to cut sequential iterations
early, which is meaningless when all hypotheses evaluate in parallel anyway —
the batched bank IS the preemption. PROSAC (progressive_sampler.cc) survives
as quality-ordered sampling: when a per-row quality is given, hypothesis i of
the bank draws from the top-m_i rows with m_i growing across the bank, so the
front of the bank concentrates on high-quality matches (progressive batches)
while the tail stays uniform (the RANSAC fallback PROSAC converges to).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import se3, solvers

Array = jax.Array


class RansacOptions(NamedTuple):
    max_error: float = 4.0  # inlier threshold on the residual (units per-fn)
    num_hypotheses: int = 2048
    lo_rounds: int = 3  # local-optimization refit rounds
    min_inlier_ratio: float = 0.0


def _draw_samples(
    key, valid: Array, num: int, k: int, quality: Array | None = None
) -> Array:
    """[num, k] indices drawn from the valid mask (with replacement).

    With a quality vector [N] (higher = better, e.g. negative descriptor
    distance), sampling is progressive: hypothesis i draws uniformly from the
    top-m_i valid rows by quality, m_i ramping from 2k to all N across the
    bank (PROSAC semantics, optim/progressive_sampler.cc, batched)."""
    if quality is None:
        logits = jnp.where(valid > 0, 0.0, -1e30)
        return jax.random.categorical(key, logits, shape=(num, k))
    N = valid.shape[0]
    # rank rows: best quality first (invalid rows last)
    order = jnp.argsort(jnp.where(valid > 0, -quality, jnp.inf))
    rank = jnp.argsort(order)  # rank[n] = position of row n
    n_valid = jnp.maximum(jnp.sum(valid > 0), 1.0)
    # per-hypothesis pool size: geometric ramp 2k -> n_valid
    i = jnp.arange(num, dtype=jnp.float32) / max(num - 1, 1)
    m = jnp.minimum(jnp.ceil(2.0 * k * (n_valid / (2.0 * k)) ** i), n_valid)
    logits = jnp.where(
        (rank[None, :] < m[:, None]) & (valid[None, :] > 0), 0.0, -1e30
    )  # [num, N]
    return jax.vmap(lambda kk, lg: jax.random.categorical(kk, lg, shape=(k,)))(
        jax.random.split(key, num), logits
    )


def _score(err: Array, valid: Array, thr: float):
    """(num_inliers, score) per hypothesis; score orders by inliers then
    truncated residual sum. err [H,N], valid [N]."""
    ok = (err < thr) & (valid > 0)
    n_in = jnp.sum(ok, axis=-1)
    trunc = jnp.sum(jnp.minimum(err, thr) * valid, axis=-1)
    # maximize inliers, minimize truncated cost
    score = n_in.astype(jnp.float32) - trunc / (thr * jnp.maximum(jnp.sum(valid), 1.0))
    return n_in, score


class PnPResult(NamedTuple):
    q: Array
    t: Array
    inlier_mask: Array
    num_inliers: Array


@functools.partial(jax.jit, static_argnames=("opts", "refine_iters"))
def ransac_pnp(
    uv: Array,  # [N,2] normalized camera coords
    X: Array,  # [N,3]
    valid: Array,  # [N]
    key: Array,
    opts: RansacOptions = RansacOptions(),
    refine_iters: int = 0,
    max_error=None,  # traced scalar override of opts.max_error — per-camera
    # focal-scaled thresholds must NOT be part of the jit key (each distinct
    # float would be its own compile)
) -> PnPResult:
    """Absolute pose from 2D-3D matches (EstimateAbsolutePose parity,
    estimators/pose.cc): P3P minimal hypotheses (quartic Gao solver, up to 4
    poses per 3-point sample — P3PEstimator parity) + EPnP local
    optimization, plus an optional fused Cauchy-GN pose polish
    (refine_iters > 0) replacing the separate RefineAbsolutePose dispatch.
    max_error is in normalized-coordinate units (divide pixel threshold by
    focal length, as the reference does via camera.ImageToWorldThreshold)."""
    N = uv.shape[0]
    H = opts.num_hypotheses
    # 3-point minimal samples, up to 4 poses each -> an H-hypothesis bank
    # from H/4 samples. Minimal samples maximize the all-inlier probability
    # per hypothesis (vs the former 6-point DLT substitution).
    ns = max(H // 4, 1)
    idx = _draw_samples(key, valid, ns, 3)
    qs, ts, hvalid = jax.vmap(lambda ii: solvers.p3p(uv[ii], X[ii]))(idx)
    qs = qs.reshape(-1, 4)  # [H,4]
    ts = ts.reshape(-1, 3)  # [H,3]
    hvalid = hvalid.reshape(-1)  # [H]

    def resid(q, t):
        xc = se3.se3_apply(q, t, X)
        z = xc[:, 2]
        zok = z > 1e-6
        p = xc[:, :2] / jnp.where(jnp.abs(z[:, None]) < 1e-6, 1e-6, z[:, None])
        e = jnp.sum((p - uv) ** 2, axis=-1)
        return jnp.where(zok, e, 1e12)

    errs = jax.vmap(resid)(qs, ts)  # [H,N]
    errs = jnp.where(hvalid[:, None], errs, 1e12)  # degenerate samples
    thr2 = (opts.max_error if max_error is None else max_error) ** 2
    n_in, score = _score(errs, valid, thr2)
    score = jnp.where(hvalid, score, -jnp.inf)
    best = jnp.argmax(score)
    q_b, t_b = qs[best], ts[best]

    def lo_round(carry, _):
        q_b, t_b, best_in = carry
        e = resid(q_b, t_b)
        inl = ((e < thr2) & (valid > 0)).astype(jnp.float32)
        q_n, t_n = solvers.epnp(uv, X, inl)
        e_n = resid(q_n, t_n)
        n_n = jnp.sum((e_n < thr2) & (valid > 0))
        better = n_n >= best_in
        q_b = jnp.where(better, q_n, q_b)
        t_b = jnp.where(better, t_n, t_b)
        best_in = jnp.maximum(n_n, best_in)
        return (q_b, t_b, best_in), None

    (q_b, t_b, n_best), _ = jax.lax.scan(
        lo_round, (q_b, t_b, n_in[best]), None, length=opts.lo_rounds
    )
    e = resid(q_b, t_b)
    mask = (e < thr2) & (valid > 0)

    if refine_iters > 0:
        # fused pose polish (RefineAbsolutePose, estimators/pose.cc:220-270):
        # Cauchy-weighted Gauss-Newton on (so3, t) over the inlier set, in the
        # SAME device program as the RANSAC — the reference runs a separate
        # Ceres solve; a second dispatch would add a launch and a host sync.
        c2 = thr2 / 9.0  # Cauchy scale = max_error/3, squared

        def gn_step(carry, _):
            q, t = carry
            xc = se3.se3_apply(q, t, X)  # [N,3]
            z = jnp.where(jnp.abs(xc[:, 2]) < 1e-6, 1e-6, xc[:, 2])
            p = xc[:, :2] / z[:, None]
            r = p - uv  # [N,2]
            s = jnp.sum(r * r, axis=-1)
            w = mask.astype(jnp.float32) / (1.0 + s / c2)  # IRLS Cauchy
            # dp/dxc [N,2,3]
            zi = 1.0 / z
            dp = jnp.stack(
                [
                    jnp.stack([zi, jnp.zeros_like(zi), -xc[:, 0] * zi * zi], -1),
                    jnp.stack([jnp.zeros_like(zi), zi, -xc[:, 1] * zi * zi], -1),
                ],
                axis=1,
            )
            # dxc/d(w,t): left-perturbation xc' = exp(dw) xc + dt
            # => dxc/dw = -[xc]x, dxc/dt = I
            px, py, pz = xc[:, 0], xc[:, 1], xc[:, 2]
            zr = jnp.zeros_like(px)
            skew = jnp.stack(
                [
                    jnp.stack([zr, -pz, py], -1),
                    jnp.stack([pz, zr, -px], -1),
                    jnp.stack([-py, px, zr], -1),
                ],
                axis=1,
            )  # [N,3,3] = [xc]x
            Jw = -jnp.einsum("nij,njk->nik", dp, skew)  # [N,2,3]
            J = jnp.concatenate([Jw, dp], axis=-1)  # [N,2,6]
            JtJ = jnp.einsum("nia,nib,n->ab", J, J, w) + 1e-6 * jnp.eye(6)
            Jtr = jnp.einsum("nia,ni,n->a", J, r, w)
            delta = -jnp.linalg.solve(JtJ, Jtr)
            q_n = se3.quat_mul(se3.so3_exp_quat(delta[:3]), q)
            q_n = q_n / jnp.maximum(jnp.linalg.norm(q_n), 1e-12)
            t_n = t + delta[3:]
            # robust-cost guard: keep the step only if the Cauchy cost drops
            def cost(qq, tt):
                xcc = se3.se3_apply(qq, tt, X)
                zz = jnp.where(jnp.abs(xcc[:, 2]) < 1e-6, 1e-6, xcc[:, 2])
                rr = xcc[:, :2] / zz[:, None] - uv
                ss = jnp.sum(rr * rr, axis=-1)
                rho = c2 * jnp.log1p(ss / c2)
                return jnp.sum(jnp.where(mask, jnp.where(xcc[:, 2] > 1e-6, rho, c2 * 20.0), 0.0))

            better = cost(q_n, t_n) <= cost(q, t)
            q = jnp.where(better, q_n, q)
            t = jnp.where(better, t_n, t)
            return (q, t), None

        (q_b, t_b), _ = jax.lax.scan(gn_step, (q_b, t_b), None, length=refine_iters)
        e = resid(q_b, t_b)
        mask = (e < thr2) & (valid > 0)
    return PnPResult(q_b, t_b, mask, jnp.sum(mask))


class TwoViewResult(NamedTuple):
    model: Array  # 3x3 (E, F, or H)
    inlier_mask: Array
    num_inliers: Array


def _ransac_two_view(uv1, uv2, valid, key, opts, solver, resid, sample_k,
                     quality=None, max_error=None, minimal_solver=None,
                     models_per_sample=1):
    """minimal_solver (optional) hypothesizes from minimal samples and may
    return several candidate models per sample as ([m,3,3], [m] valid bool);
    `solver` is the non-minimal LO refit. Default: solver plays both roles
    with one model per sample (the m=1 case)."""
    H = opts.num_hypotheses
    n_samples = max(1, H // models_per_sample)
    idx = _draw_samples(key, valid, n_samples, sample_k, quality)

    if minimal_solver is None:
        def solve_one(ii):
            return solver(uv1[ii], uv2[ii], None)[None], jnp.ones((1,), bool)
    else:
        def solve_one(ii):
            return minimal_solver(uv1[ii], uv2[ii])

    models, model_ok = jax.vmap(solve_one)(idx)  # [S,m,3,3],[S,m]
    models = models.reshape(-1, 3, 3)
    model_ok = model_ok.reshape(-1)
    errs = jax.vmap(lambda M: resid(M, uv1, uv2))(models)
    errs = jnp.where(model_ok[:, None], errs, 1e12)  # invalid roots never win
    # max_error may be a traced scalar (per-pair focal-scaled thresholds in
    # batched verification); opts.max_error is the static default
    thr2 = (opts.max_error if max_error is None else max_error) ** 2
    n_in, score = _score(errs, valid, thr2)
    best = jnp.argmax(score)
    M_b = models[best]

    def lo_round(carry, _):
        M_b, best_in = carry
        e = resid(M_b, uv1, uv2)
        inl = ((e < thr2) & (valid > 0)).astype(jnp.float32)
        M_n = solver(uv1, uv2, inl)
        e_n = resid(M_n, uv1, uv2)
        n_n = jnp.sum((e_n < thr2) & (valid > 0))
        better = n_n >= best_in
        M_b = jnp.where(better, M_n, M_b)
        best_in = jnp.maximum(n_n, best_in)
        return (M_b, best_in), None

    (M_b, _), _ = jax.lax.scan(lo_round, (M_b, n_in[best]), None, length=opts.lo_rounds)
    e = resid(M_b, uv1, uv2)
    mask = (e < thr2) & (valid > 0)
    return TwoViewResult(M_b, mask, jnp.sum(mask))


@functools.partial(jax.jit, static_argnames=("opts",))
def ransac_fundamental(uv1, uv2, valid, key, opts: RansacOptions = RansacOptions(), quality=None):
    """F from pixel coords; max_error in pixels (Sampson).

    Hypothesizes with the 7-point minimal solver (up to 3 roots per sample)
    and LO-refits with 8-point on the inliers, matching the reference's
    F-LORANSAC (estimators/two_view_geometry.cc:271-273,392:
    FundamentalMatrixSevenPointEstimator minimal +
    FundamentalMatrixEightPointEstimator local)."""
    return _ransac_two_view(
        uv1, uv2, valid, key, opts,
        lambda a, b, m: solvers.eight_point(a, b, m, essential=False),
        solvers.sampson_error, 7, quality,
        minimal_solver=solvers.seven_point, models_per_sample=3,
    )


@functools.partial(jax.jit, static_argnames=("opts",))
def ransac_essential(uv1, uv2, valid, key, opts: RansacOptions = RansacOptions(),
                     quality=None, max_error=None):
    """E from normalized camera coords; max_error in normalized units
    (opts.max_error, or the traced `max_error` scalar when given).

    Hypothesizes with the Nister 5-point minimal solver (up to 10 essential
    matrices per sample, Durand-Kerner rooted on device) and LO-refits with
    8-point + manifold projection on the inliers — the minimal/non-minimal
    split of the reference's E-LORANSAC (estimators/two_view_geometry.cc:
    EssentialMatrixFivePointEstimator; 5-point needs (1-eps)^5 instead of
    (1-eps)^8 per clean sample, a ~3x hypothesis saving at 30% outliers)."""
    return _ransac_two_view(
        uv1, uv2, valid, key, opts,
        lambda a, b, m: solvers.eight_point(a, b, m, essential=True),
        solvers.sampson_error, 5, quality, max_error,
        minimal_solver=solvers.five_point, models_per_sample=10,
    )


class SimilarityResult(NamedTuple):
    q: Array
    t: Array
    s: Array
    inlier_mask: Array
    num_inliers: Array


@functools.partial(jax.jit, static_argnames=("opts",))
def ransac_similarity(
    src: Array,  # [N,3]
    dst: Array,  # [N,3]
    valid: Array,  # [N]
    key: Array,
    opts: RansacOptions = RansacOptions(),
) -> SimilarityResult:
    """Robust 3D similarity (sim3) from point correspondences: minimal-3
    Umeyama hypothesis bank + Umeyama LO refit on inliers. max_error is the
    Euclidean residual in destination units. Mirrors the reference's
    Reconstruction::AlignRobust (base/reconstruction.cc, RANSAC over
    SimilarityTransformEstimator<3,true> on projection centers, used by
    exe/model.cc RunModelAligner robust_alignment)."""
    H = opts.num_hypotheses
    idx = _draw_samples(key, valid, H, 3)

    def solve_one(ii):
        return solvers.umeyama(src[ii], dst[ii], with_scale=True)

    qs, ts, ss = jax.vmap(solve_one)(idx)

    def resid(q, t, s):
        pred = s * se3.quat_rotate(q, src) + t
        return jnp.sum((pred - dst) ** 2, axis=-1)

    errs = jax.vmap(resid)(qs, ts, ss)
    thr2 = opts.max_error**2
    n_in, score = _score(errs, valid, thr2)
    best = jnp.argmax(score)
    q_b, t_b, s_b = qs[best], ts[best], ss[best]

    def lo_round(carry, _):
        q_b, t_b, s_b, best_in = carry
        e = resid(q_b, t_b, s_b)
        inl = ((e < thr2) & (valid > 0)).astype(jnp.float32)
        q_n, t_n, s_n = solvers.umeyama(src, dst, mask=inl, with_scale=True)
        n_n = jnp.sum((resid(q_n, t_n, s_n) < thr2) & (valid > 0))
        better = n_n >= best_in
        q_b = jnp.where(better, q_n, q_b)
        t_b = jnp.where(better, t_n, t_b)
        s_b = jnp.where(better, s_n, s_b)
        return (q_b, t_b, s_b, jnp.maximum(n_n, best_in)), None

    (q_b, t_b, s_b, _), _ = jax.lax.scan(
        lo_round, (q_b, t_b, s_b, n_in[best]), None, length=opts.lo_rounds
    )
    e = resid(q_b, t_b, s_b)
    mask = (e < thr2) & (valid > 0)
    return SimilarityResult(q_b, t_b, s_b, mask, jnp.sum(mask))


@functools.partial(jax.jit, static_argnames=("opts",))
def ransac_homography(uv1, uv2, valid, key, opts: RansacOptions = RansacOptions(), quality=None):
    """H from pixel coords; max_error in pixels (transfer error)."""
    return _ransac_two_view(
        uv1, uv2, valid, key, opts,
        solvers.homography_dlt,
        solvers.homography_transfer_error, 4, quality,
    )


class GenRelPoseResult(NamedTuple):
    q: Array
    t: Array
    inlier_mask: Array
    num_inliers: Array


@functools.partial(jax.jit, static_argnames=("opts",))
def ransac_generalized_relative_pose(
    f1: Array,  # [N,3] unit bearings in rig-1 frame
    c1: Array,  # [N,3] ray origins in rig-1 frame
    f2: Array,  # [N,3] unit bearings in rig-2 frame
    c2: Array,  # [N,3] ray origins in rig-2 frame
    valid: Array,  # [N]
    key: Array,
    opts: RansacOptions = RansacOptions(num_hypotheses=256),
) -> GenRelPoseResult:
    """Rig-vs-rig relative pose: GR6P hypothesis bank + GR6P LO refit.

    The minimal-estimation path for generalized two-view geometry the
    reference runs as LORANSAC<GR6PEstimator, GR6PEstimator>
    (estimators/generalized_relative_pose_test.cc:108): 8-ray samples (Kneip's
    stability choice, generalized_relative_pose.h:76), four translation
    candidates per sample (the eigenvector fan), scored with the generalized
    Sampson error (angular units — use max_error = pixel_threshold / focal).
    Degenerate for pure translation and single-camera samples, as upstream
    documents; callers fall back to the monocular 5-point path when the rig
    has one camera."""
    H = opts.num_hypotheses
    n_samples = max(1, H // 4)
    idx = _draw_samples(key, valid, n_samples, 8)

    def solve_one(ii, k):
        q, ts, t_ok = solvers.gr6p(
            f1[ii], c1[ii], f2[ii], c2[ii], key=k, num_restarts=2, num_iters=20
        )
        return q, ts, t_ok

    qs, ts, t_ok = jax.vmap(solve_one)(idx, jax.random.split(key, n_samples))
    qs = jnp.repeat(qs, 4, axis=0)  # [H,4] one rotation per 4 translations
    ts = ts.reshape(-1, 3)
    t_ok = t_ok.reshape(-1)

    def resid(q, t):
        return solvers.generalized_sampson_error(q, t, f1, c1, f2, c2)

    errs = jax.vmap(resid)(qs, ts)
    errs = jnp.where(t_ok[:, None], errs, 1e12)
    thr2 = opts.max_error**2
    n_in, score = _score(errs, valid, thr2)
    best = jnp.argmax(score)
    q_b, t_b = qs[best], ts[best]

    def lo_round(carry, k):
        q_b, t_b, best_in = carry
        e = resid(q_b, t_b)
        inl = ((e < thr2) & (valid > 0)).astype(f1.dtype)
        # warm-start the non-minimal refit from the incumbent rotation
        cay = q_b[1:] / jnp.where(jnp.abs(q_b[0]) < 1e-8, 1e-8, q_b[0])
        q_n, ts_n, tok_n = solvers.gr6p(
            f1, c1, f2, c2, mask=inl, key=k, num_restarts=1, num_iters=32,
            cayley0=cay,
        )
        e_n = jax.vmap(lambda t: resid(q_n, t))(ts_n)
        e_n = jnp.where(tok_n[:, None], e_n, 1e12)
        n_n = jnp.sum((e_n < thr2) & (valid > 0)[None, :], axis=-1)
        k_best = jnp.argmax(n_n)
        better = n_n[k_best] >= best_in
        q_b = jnp.where(better, q_n, q_b)
        t_b = jnp.where(better, ts_n[k_best], t_b)
        best_in = jnp.maximum(n_n[k_best], best_in)
        return (q_b, t_b, best_in), None

    (q_b, t_b, _), _ = jax.lax.scan(
        lo_round, (q_b, t_b, n_in[best]), jax.random.split(key, opts.lo_rounds)
    )
    e = resid(q_b, t_b)
    mask = (e < thr2) & (valid > 0)
    return GenRelPoseResult(q_b, t_b, mask, jnp.sum(mask))
