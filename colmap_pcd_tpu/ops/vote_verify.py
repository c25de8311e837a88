"""Vote-and-verify spatial re-ranking for retrieval candidates.

Re-design of src/retrieval/vote_and_verify.{h,cc} (Schönberger et al.,
ACCV 2016 "A Vote-and-Verify Strategy for Fast Spatial Verification in Image
Retrieval"): score a candidate image pair by the effective inlier count of a
similarity/affine transform voted from quantized feature matches — the piece
that suppresses false loop closures on repetitive structure, where raw global
-descriptor similarity (VLAD here, Hamming-embedded BoW upstream) ranks
look-alike but geometrically inconsistent images highly.

Device re-formulation (one fused jit per candidate pair, vmappable over the
candidate list):
  * match candidates come from shared visual words (the VLAD codebook cell
    doubles as the word, retrieval.py) — per query feature, a bounded number
    of same-word partners found via sort + searchsorted instead of inverted
    file walks;
  * the reference's 6-level hash-map voting histogram (vote_and_verify.cc:
    228-288) becomes a dense 4D scatter-add histogram + factor-2 sum-pooling
    per level (a multi-resolution pyramid as tensor ops);
  * the top-K bins are verified as a BANK (two-way transfer + scale checks as
    one [K, P] tensor op) instead of sequentially with confidence-based
    early abort (:339-346) — the batched bank is the preemption, same
    argument as dropping SPRT in ops/ransac.py;
  * local optimization refits an affine transform by weighted least squares
    on the best bin's inliers (AffineTransformEstimator analog, solved as a
    3x3 normal system per image axis);
  * the returned score is the reference's effective inlier count: occupancy
    of inlier query features over a 16x16 grid of their bounding box
    (ComputeEffectiveInlierCount, :181-205), which de-weights bursty
    repeated texture.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class VoteVerifyOptions(NamedTuple):
    num_transformations: int = 8  # top-K voted transforms to verify
    num_trans_bins: int = 32  # translation bins per axis (ref: 64)
    num_scale_bins: int = 16  # log2-scale bins (ref: 32)
    num_angle_bins: int = 8
    num_levels: int = 4  # multi-resolution pyramid depth (ref: 6)
    max_image_size: float = 4096.0  # translation vote range bound
    max_log_scale: float = np.log2(10.0)
    max_transfer_error: float = 100.0**2  # squared px, two-way sum
    max_scale_error: float = 2.0
    min_num_votes: int = 1
    partners: int = 4  # same-word partners per query feature
    eff_bins: int = 16  # effective-count occupancy grid


def _pair_transforms(g1, g2):
    """Similarity transform (s, angle, tx, ty) mapping feature 1's frame to
    feature 2's, per pair (FeatureGeometry::TransformFromMatch)."""
    s = g2[:, 2] / jnp.maximum(g1[:, 2], 1e-8)
    a = g2[:, 3] - g1[:, 3]
    a = jnp.mod(a + jnp.pi, 2 * jnp.pi) - jnp.pi  # wrap to [-pi, pi)
    ca, sa = jnp.cos(a), jnp.sin(a)
    tx = g2[:, 0] - s * (ca * g1[:, 0] - sa * g1[:, 1])
    ty = g2[:, 1] - s * (sa * g1[:, 0] + ca * g1[:, 1])
    return s, a, tx, ty


@functools.partial(jax.jit, static_argnames=("opts",))
def vote_and_verify(
    geom1: Array,  # [N1,4] (x, y, scale, orientation) of the query image
    word1: Array,  # [N1] codebook cell per feature
    valid1: Array,  # [N1]
    geom2: Array,  # [N2,4] candidate image
    word2: Array,  # [N2]
    valid2: Array,  # [N2]
    opts: VoteVerifyOptions = VoteVerifyOptions(),
) -> Array:
    """Effective inlier count of the best voted transform (int32 scalar)."""
    N1 = geom1.shape[0]
    M = opts.partners

    # ---- 1. candidate matches by shared visual word (sort + searchsorted)
    w2 = jnp.where(valid2 > 0, word2, jnp.iinfo(jnp.int32).max)
    order2 = jnp.argsort(w2)
    w2s = w2[order2]
    starts = jnp.searchsorted(w2s, word1)  # [N1]
    offs = jnp.arange(M)
    cand = jnp.clip(starts[:, None] + offs[None, :], 0, geom2.shape[0] - 1)
    j = order2[cand]  # [N1,M] partner indices
    ok = (
        (valid1[:, None] > 0)
        & (starts[:, None] + offs[None, :] < geom2.shape[0])
        & (w2s[cand] == word1[:, None])
    )
    i = jnp.broadcast_to(jnp.arange(N1)[:, None], (N1, M))
    P = N1 * M
    i = i.reshape(P)
    j = j.reshape(P)
    pvalid = ok.reshape(P)
    g1 = geom1[i]
    g2 = geom2[j]

    # ---- 2. per-pair similarity transform votes
    s, a, tx, ty = _pair_transforms(g1, g2)
    ls = jnp.log2(jnp.maximum(s, 1e-8))
    in_range = (
        (jnp.abs(tx) <= opts.max_image_size)
        & (jnp.abs(ty) <= opts.max_image_size)
        & (jnp.abs(ls) <= opts.max_log_scale)
    )
    w = (pvalid & in_range).astype(jnp.float32)

    nt, ns, na = opts.num_trans_bins, opts.num_scale_bins, opts.num_angle_bins
    bx = jnp.clip(((tx / opts.max_image_size + 1) * 0.5 * nt).astype(jnp.int32), 0, nt - 1)
    by = jnp.clip(((ty / opts.max_image_size + 1) * 0.5 * nt).astype(jnp.int32), 0, nt - 1)
    bs = jnp.clip(((ls / opts.max_log_scale + 1) * 0.5 * ns).astype(jnp.int32), 0, ns - 1)
    ba = jnp.clip(((a / jnp.pi + 1) * 0.5 * na).astype(jnp.int32), 0, na - 1)
    flat = ((by * nt + bx) * ns + bs) * na + ba
    nbins = nt * nt * ns * na

    counts = jnp.zeros(nbins, jnp.float32).at[flat].add(w)
    sums = jnp.zeros((nbins, 4), jnp.float32).at[flat].add(
        w[:, None] * jnp.stack([s, a, tx, ty], -1)
    )

    # ---- 3. multi-resolution score: factor-2 sum pooling per level,
    # broadcast back to base bins (replaces the 6 hash-map levels)
    score = counts
    base = counts.reshape(nt, nt, ns, na)
    lw = 0.5
    for level in range(1, opts.num_levels):
        f = 2**level
        dims = []
        shape = []
        for d in (nt, nt, ns, na):
            blk = min(f, d)
            dims.append(d // blk)
            shape.extend([d // blk, blk])
        pooled = base.reshape(shape).sum(axis=(1, 3, 5, 7))  # [dims]
        up = pooled
        for ax, (d, pd) in enumerate(zip((nt, nt, ns, na), dims)):
            up = jnp.repeat(up, d // pd, axis=ax)
        score = score + lw * up.reshape(-1)
        lw *= 0.5
    score = jnp.where(counts >= opts.min_num_votes, score, -jnp.inf)

    # ---- 4. top-K bins -> mean transforms
    K = opts.num_transformations
    top_score, top_bin = jax.lax.top_k(score, K)
    mean = sums[top_bin] / jnp.maximum(counts[top_bin][:, None], 1.0)  # [K,4]
    k_ok = jnp.isfinite(top_score)

    # ---- 5. bank verification: two-way transfer + scale error, [K,P]
    def count_inliers_sim(m):
        s_k, a_k, tx_k, ty_k = m[0], m[1], m[2], m[3]
        ca, sa = jnp.cos(a_k), jnp.sin(a_k)
        A = s_k * jnp.asarray([[ca, -sa], [sa, ca]])
        t = jnp.stack([tx_k, ty_k])
        return _two_way_inliers(A, t, g1, g2, w, opts)

    inl_k = jax.vmap(count_inliers_sim)(mean)  # [K,P] float masks
    n_k = jnp.where(k_ok, jnp.sum(inl_k, axis=-1), -1.0)
    best = jnp.argmax(n_k)
    best_mask = inl_k[best]

    # ---- 6. LO: weighted LSQ affine refit on the best inliers, recount
    A_lo, t_lo = _fit_affine(g1[:, :2], g2[:, :2], best_mask)
    lo_mask = _two_way_inliers(A_lo, t_lo, g1, g2, w, opts)
    use_lo = jnp.sum(lo_mask) > jnp.sum(best_mask)
    final_mask = jnp.where(use_lo, lo_mask, best_mask)

    # ---- 7. effective inlier count: per-query-feature any-inlier, 16x16
    # occupancy over the inlier bounding box
    per_feat = jnp.zeros(N1, jnp.float32).at[i].max(final_mask)
    xy = geom1[:, :2]
    big = 1e12
    mn = jnp.min(jnp.where(per_feat[:, None] > 0, xy, big), axis=0)
    mx = jnp.max(jnp.where(per_feat[:, None] > 0, xy, -big), axis=0)
    span = jnp.maximum(mx - mn, 1e-6)
    nb = opts.eff_bins
    cells = jnp.clip(((xy - mn) / span * nb).astype(jnp.int32), 0, nb - 1)
    cflat = cells[:, 0] * nb + cells[:, 1]
    occ = jnp.zeros(nb * nb, jnp.float32).at[cflat].max(per_feat)
    eff = jnp.sum(occ).astype(jnp.int32)
    return jnp.where(jnp.any(per_feat > 0), eff, 0)


def _two_way_inliers(A, t, g1, g2, w, opts):
    """Per-pair inlier mask under affine A,t: forward+backward transfer error
    and feature scale-consistency (ComputeScaleError/ComputeTransferError)."""
    xy1, xy2 = g1[:, :2], g2[:, :2]
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    Ainv = jnp.asarray([[A[1, 1], -A[0, 1]], [-A[1, 0], A[0, 0]]]) / det
    tinv = -Ainv @ t
    e12 = jnp.sum((xy2 - xy1 @ A.T - t) ** 2, axis=-1)
    e21 = jnp.sum((xy1 - xy2 @ Ainv.T - tinv) ** 2, axis=-1)
    # feature area ratio under the transform (similarity: |det|*scale1^2)
    area_t = jnp.abs(det) * g1[:, 2] ** 2
    area_m = jnp.maximum(g2[:, 2] ** 2, 1e-12)
    ratio = jnp.maximum(area_t / area_m, area_m / jnp.maximum(area_t, 1e-12))
    return (
        w
        * (e12 + e21 <= opts.max_transfer_error).astype(jnp.float32)
        * (ratio <= opts.max_scale_error**2).astype(jnp.float32)
    )


def _fit_affine(xy1, xy2, w):
    """Weighted least-squares affine xy2 ~ A xy1 + t (two 3x3 normal systems,
    AffineTransformEstimator::Estimate analog)."""
    ones = jnp.ones_like(xy1[:, :1])
    X = jnp.concatenate([xy1, ones], axis=-1)  # [P,3]
    XtX = X.T @ (X * w[:, None]) + 1e-6 * jnp.eye(3)
    sol = jnp.linalg.solve(XtX, X.T @ (xy2 * w[:, None]))  # [3,2]
    A = sol[:2].T
    t = sol[2]
    return A, t


@functools.partial(jax.jit, static_argnames=("opts",))
def vote_and_verify_batch(
    geom1, word1, valid1, geom2_b, word2_b, valid2_b,
    opts: VoteVerifyOptions = VoteVerifyOptions(),
) -> Array:
    """vmapped vote_and_verify over a candidate bank (leading axis C):
    re-ranking a query's retrieval shortlist is ONE device dispatch."""
    return jax.vmap(
        lambda g2, w2, v2: vote_and_verify(geom1, word1, valid1, g2, w2, v2, opts)
    )(geom2_b, word2_b, valid2_b)
