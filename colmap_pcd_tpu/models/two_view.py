"""Two-view geometry estimation + configuration classification.

Parity with src/estimators/two_view_geometry.{h,cc}: estimate E, F and H with
(LO-)RANSAC, classify the pair configuration from relative inlier support, and
recover the relative pose for calibrated pairs. The three RANSAC banks run as
three batched device programs (ops/ransac.py).

Configurations (two_view_geometry.h:48-66):
  DEGENERATE, CALIBRATED, UNCALIBRATED, PLANAR, PANORAMIC,
  PLANAR_OR_PANORAMIC, WATERMARK (border translation heuristic,
  DetectWatermark), MULTIPLE (iterative multi-geometry extraction,
  EstimateMultiple).
"""

from __future__ import annotations

import functools

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import camera_models as cm
from ..ops import ransac as ransac_ops
from ..ops import se3, solvers

DEGENERATE = 0
CALIBRATED = 1
UNCALIBRATED = 2
PLANAR = 3
PANORAMIC = 4
PLANAR_OR_PANORAMIC = 5
WATERMARK = 6
MULTIPLE = 7


@dataclass
class TwoViewOptions:
    min_num_inliers: int = 15
    max_error: float = 4.0  # px
    num_hypotheses: int = 2048
    # H inlier ratio above which the pair is planar/panoramic
    max_H_inlier_ratio: float = 0.8
    # E must explain nearly as many inliers as F to call it calibrated
    min_E_F_inlier_ratio: float = 0.95
    compute_relative_pose: bool = True
    # watermark detection (two_view_geometry.h:93-102): a pure 2D translation
    # among border inliers marks a watermark-induced degenerate pair
    detect_watermark: bool = True
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1
    # iterative multi-model extraction (EstimateMultiple)
    multiple_models: bool = False


@dataclass
class TwoViewGeometry:
    config: int = DEGENERATE
    E: Optional[np.ndarray] = None
    F: Optional[np.ndarray] = None
    H: Optional[np.ndarray] = None
    inlier_matches: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int32))
    # relative pose (world = cam1 frame), |t| = 1
    qvec: Optional[np.ndarray] = None
    tvec: Optional[np.ndarray] = None
    tri_angle: float = 0.0


def detect_watermark(
    uv1: np.ndarray,
    uv2: np.ndarray,
    inlier_mask: np.ndarray,
    size1: tuple[int, int],
    size2: tuple[int, int],
    opts: TwoViewOptions = TwoViewOptions(),
) -> bool:
    """Watermark heuristic (two_view_geometry.cc DetectWatermark): if most
    inliers sit in the image borders of BOTH images and are explained by a
    pure 2D translation, the geometry is a watermark artifact. The
    translation-RANSAC is one vectorized all-pairs count (every inlier's
    displacement is a hypothesis) instead of a sequential sampler."""
    sel = np.nonzero(inlier_mask)[0]
    m = sel.size
    if m == 0:
        return False
    w1, h1 = size1
    w2, h2 = size2
    b1 = opts.watermark_border_size * float(np.hypot(w1, h1))
    b2 = opts.watermark_border_size * float(np.hypot(w2, h2))
    p1, p2 = uv1[sel], uv2[sel]

    def outside(p, b, w, h):
        return (p[:, 0] < b) | (p[:, 0] > w - b) | (p[:, 1] < b) | (p[:, 1] > h - b)

    in_border = outside(p1, b1, w1, h1) & outside(p2, b2, w2, h2)
    if in_border.sum() / m < opts.watermark_min_inlier_ratio:
        return False
    t = p2 - p1  # [m,2] candidate translations
    # all-pairs translation consensus (bounded to 512 hypotheses)
    hyp = t if m <= 512 else t[np.linspace(0, m - 1, 512).astype(int)]
    d2 = np.sum((t[None, :, :] - hyp[:, None, :]) ** 2, axis=-1)  # [H,m]
    counts = (d2 <= opts.max_error**2).sum(axis=1)
    return counts.max() / m >= opts.watermark_min_inlier_ratio


def estimate_two_view_geometry_multiple(
    uv1, uv2, params1, params2, model_id1, model_id2,
    opts: TwoViewOptions = TwoViewOptions(), seed: int = 0,
) -> TwoViewGeometry:
    """EstimateMultiple (two_view_geometry.cc): iteratively estimate a
    geometry, carve out its inliers, repeat; >1 sufficiently supported
    geometries -> config MULTIPLE with the union of inliers."""
    remaining = np.arange(uv1.shape[0])
    geometries: list[TwoViewGeometry] = []
    sub_opts = TwoViewOptions(**{**opts.__dict__, "multiple_models": False, "detect_watermark": False})
    while remaining.size >= 8:
        g = estimate_two_view_geometry(
            uv1[remaining], uv2[remaining], params1, params2,
            model_id1, model_id2, sub_opts, seed=seed + len(geometries),
        )
        if g.config == DEGENERATE or len(g.inlier_matches) < opts.min_num_inliers:
            break
        g.inlier_matches = np.stack(
            [remaining[g.inlier_matches[:, 0]]] * 2, axis=-1
        ).astype(np.int32)
        geometries.append(g)
        keep = np.ones(remaining.size, bool)
        keep[np.isin(remaining, g.inlier_matches[:, 0])] = False
        remaining = remaining[keep]
    if not geometries:
        return TwoViewGeometry()
    if len(geometries) == 1:
        return geometries[0]
    out = geometries[0]
    out.config = MULTIPLE
    out.inlier_matches = np.concatenate([g.inlier_matches for g in geometries])
    return out


def estimate_two_view_geometry(
    uv1: np.ndarray,  # [N,2] pixel coords of matched features in image 1
    uv2: np.ndarray,  # [N,2] matched coords in image 2 (row-aligned with uv1)
    params1: np.ndarray,
    params2: np.ndarray,
    model_id1: int,
    model_id2: int,
    opts: TwoViewOptions = TwoViewOptions(),
    seed: int = 0,
    size1: tuple[int, int] | None = None,  # (width, height) for watermark test
    size2: tuple[int, int] | None = None,
    quality: np.ndarray | None = None,  # [N] match quality for PROSAC sampling
) -> TwoViewGeometry:
    """uv1[i] <-> uv2[i] are matched pairs (from ops/matching)."""
    if opts.multiple_models:
        return estimate_two_view_geometry_multiple(
            uv1, uv2, params1, params2, model_id1, model_id2, opts, seed
        )
    N = uv1.shape[0]
    out = TwoViewGeometry()
    if N < 8:
        return out
    from ..ops import np_geom

    # pad the match count to a power-of-TWO bucket (128/256/512/1024/2048):
    # per-pair match counts vary freely, each distinct cap compiles the fused
    # E/F/H program once (cached + prewarmed), and the LO refits/verification
    # scale with the padded count — the old power-of-4 ladder made a
    # 600-match pair pay the 2048 cap
    import math as _math

    cap = 128 * 2 ** max(0, _math.ceil(_math.log2(max(N, 1) / 128)))
    uv1p = np.concatenate([uv1, np.zeros((cap - N, 2))]) if cap > N else uv1
    uv2p = np.concatenate([uv2, np.zeros((cap - N, 2))]) if cap > N else uv2
    valid = jnp.asarray(np.arange(cap) < N, jnp.float32)
    qual = None
    if quality is not None:
        qual = jnp.asarray(
            np.concatenate([quality, np.full(cap - N, -np.inf)]), jnp.float32
        )
    uv1j = jnp.asarray(uv1p, jnp.float32)
    uv2j = jnp.asarray(uv2p, jnp.float32)
    # normalized coords for E (host-side undistortion: no device round-trips)
    n1 = jnp.asarray(np_geom.image_to_world(model_id1, params1, uv1p), jnp.float32)
    n2 = jnp.asarray(np_geom.image_to_world(model_id2, params2, uv2p), jnp.float32)
    p1 = np.asarray(params1)
    p2 = np.asarray(params2)
    fi1 = cm._FOCAL_IDX[model_id1]
    fi2 = cm._FOCAL_IDX[model_id2]
    f_mean = float(np.mean([p1[fi1[0]], p1[fi1[1]], p2[fi2[0]], p2[fi2[1]]]))

    ro = ransac_ops.RansacOptions(max_error=opts.max_error, num_hypotheses=opts.num_hypotheses)
    # one fused device program for all three geometries: every dispatch
    # costs a launch and each int() forces a host sync — three separate
    # RANSAC calls triple that per image pair. The E bank's
    # normalized-unit threshold rides along as a traced scalar so one
    # compiled program serves every focal length.
    resE, resF, resH = _ransac_efh(
        n1, n2, uv1j, uv2j, valid, jnp.asarray(seed, jnp.uint32), ro,
        jnp.asarray(opts.max_error / f_mean, jnp.float32), qual,
    )
    nE, nF, nH = int(resE.num_inliers), int(resF.num_inliers), int(resH.num_inliers)

    out.E = np.asarray(resE.model)
    out.F = np.asarray(resF.model)
    out.H = np.asarray(resH.model)

    if max(nE, nF) < opts.min_num_inliers:
        out.config = DEGENERATE
        return out

    if nE >= opts.min_E_F_inlier_ratio * nF and nE >= opts.min_num_inliers:
        config = CALIBRATED
        best_mask = np.asarray(resE.inlier_mask)[:N]
        n_best = nE
    else:
        config = UNCALIBRATED
        best_mask = np.asarray(resF.inlier_mask)[:N]
        n_best = nF

    if nH > opts.max_H_inlier_ratio * n_best:
        config = PLANAR_OR_PANORAMIC

    rows = np.nonzero(best_mask)[0]
    out.inlier_matches = np.stack([rows, rows], axis=-1).astype(np.int32)
    out.config = config

    if (
        opts.detect_watermark
        and size1 is not None
        and size2 is not None
        and detect_watermark(np.asarray(uv1), np.asarray(uv2), best_mask, size1, size2, opts)
    ):
        out.config = WATERMARK
        return out

    if opts.compute_relative_pose and config == CALIBRATED:
        mask_p = np.zeros(cap, np.float32)
        mask_p[:N] = best_mask
        q, t, ang, z1, z2 = _pose_recovery(
            jnp.asarray(out.E, jnp.float32), n1, n2, jnp.asarray(mask_p)
        )
        out.qvec = np.asarray(q)
        out.tvec = np.asarray(t)
        ang, z1, z2 = np.asarray(ang)[:N], np.asarray(z1)[:N], np.asarray(z2)[:N]
        ok = best_mask & (z1 > 0) & (z2 > 0)
        if ok.sum() > 0:
            out.tri_angle = float(np.median(ang[ok]))
    return out


@functools.partial(jax.jit, static_argnames=("ro",))
def _ransac_efh(n1, n2, uv1, uv2, valid, seed, ro, e_max_error, qual):
    """E + F + H RANSAC banks as ONE compiled program (single dispatch).
    e_max_error is the E bank's normalized-unit threshold (traced scalar —
    max_error / mean focal, per pair)."""
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    resE = ransac_ops.ransac_essential(n1, n2, valid, k1, ro, qual, e_max_error)
    resF = ransac_ops.ransac_fundamental(uv1, uv2, valid, k2, ro, qual)
    resH = ransac_ops.ransac_homography(uv1, uv2, valid, k3, ro, qual)
    return resE, resF, resH


@functools.partial(jax.jit, static_argnames=("ro", "cls"))
def _ransac_efh_batch(n1, n2, uv1, uv2, valid, seeds, ro, e_max_errors, quals,
                      cls=(15, 0.95, 0.8)):
    """vmapped fused E/F/H + pose recovery + CLASSIFICATION over a batch of
    pairs (leading axis B): verifying an image-pair block is ONE device
    dispatch instead of B, and the output is the SLIM per-pair verdict —
    config code, models, best inlier mask, pose, median tri-angle — not the
    raw per-point bank outputs. e_max_errors [B] carries each pair's
    focal-scaled E threshold as traced data; cls = (min_num_inliers,
    min_E_F_inlier_ratio, max_H_inlier_ratio), static.

    Classifying on device keeps the device->host fetch small: the raw
    outputs (three [B,cap] masks + three [B,cap] pose arrays) are ~0.5 MB
    per chunk; the verdict is ~40 KB."""
    min_inl, ef_ratio, h_ratio = cls

    def one(n1, n2, uv1, uv2, valid, seed, e_err, qual):
        key = jax.random.PRNGKey(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        resE = ransac_ops.ransac_essential(n1, n2, valid, k1, ro, qual, e_err)
        resF = ransac_ops.ransac_fundamental(uv1, uv2, valid, k2, ro, qual)
        resH = ransac_ops.ransac_homography(uv1, uv2, valid, k3, ro, qual)
        q, t, ang, z1, z2 = _pose_recovery(
            resE.model, n1, n2, resE.inlier_mask.astype(jnp.float32)
        )
        nE, nF, nH = resE.num_inliers, resF.num_inliers, resH.num_inliers
        calibrated = (nE >= ef_ratio * nF) & (nE >= min_inl)
        degenerate = jnp.maximum(nE, nF) < min_inl
        best_mask = jnp.where(calibrated, resE.inlier_mask, resF.inlier_mask)
        n_best = jnp.where(calibrated, nE, nF)
        planar = nH > h_ratio * n_best
        config = jnp.where(
            degenerate, DEGENERATE,
            jnp.where(planar, PLANAR_OR_PANORAMIC,
                      jnp.where(calibrated, CALIBRATED, UNCALIBRATED)),
        ).astype(jnp.int32)
        # median triangulation angle over cheirality-positive best inliers
        ok = best_mask & (z1 > 0) & (z2 > 0)
        n_ok = jnp.sum(ok)
        srt = jnp.sort(jnp.where(ok, ang, jnp.inf))
        tri = jnp.where(n_ok > 0, srt[jnp.maximum(n_ok - 1, 0) // 2], 0.0)
        return dict(
            config=config, E=resE.model, F=resF.model, H=resH.model,
            best_mask=best_mask, n_best=n_best, q=q, t=t, tri_angle=tri,
        )

    return jax.vmap(one)(n1, n2, uv1, uv2, valid, seeds, e_max_errors, quals)


def two_view_verify_dispatch(
    items: list[dict],
    opts: TwoViewOptions = TwoViewOptions(),
):
    """Device half of batched two-view verification: pad the item block,
    upload, and dispatch the fused EFH+pose program WITHOUT fetching.

    Returns (handles, ctx) where `handles` is the program's output pytree
    (device arrays — hand to jax.device_get inside a device section) and
    `ctx` the host metadata `two_view_verify_classify` needs. Splitting
    dispatch from classification lets the matcher pipeline chunks: chunk k's
    EFH computes on-device while chunk k-1 classifies and chunk k+1 matches.

    Each item: dict(uv1 [N,2], uv2 [N,2], params1, params2, model_id1,
    model_id2, seed, size1, size2, quality) — N may differ per item; all pad
    to the largest item's power-of-four cap.
    """
    from ..ops import np_geom

    idxs = [k for k, it in enumerate(items) if it["uv1"].shape[0] >= 8]

    import math as _math

    if not idxs:
        return None, {"idxs": [], "n_items": len(items)}
    Nmax = max(items[k]["uv1"].shape[0] for k in idxs)
    cap = 128 * 2 ** max(0, _math.ceil(_math.log2(max(Nmax, 1) / 128)))
    B = len(idxs)
    uv1 = np.zeros((B, cap, 2), np.float32)
    uv2 = np.zeros((B, cap, 2), np.float32)
    n1 = np.zeros((B, cap, 2), np.float32)
    n2 = np.zeros((B, cap, 2), np.float32)
    valid = np.zeros((B, cap), np.float32)
    quals = np.full((B, cap), -np.inf, np.float32)
    seeds = np.zeros(B, np.uint32)
    e_errs = np.zeros(B, np.float32)
    ns = []
    for b, k in enumerate(idxs):
        it = items[k]
        N = it["uv1"].shape[0]
        ns.append(N)
        uv1[b, :N] = it["uv1"]
        uv2[b, :N] = it["uv2"]
        n1[b, :N] = np_geom.image_to_world(it["model_id1"], it["params1"], it["uv1"])
        n2[b, :N] = np_geom.image_to_world(it["model_id2"], it["params2"], it["uv2"])
        valid[b, :N] = 1.0
        q = it.get("quality")
        if q is not None:
            quals[b, :N] = q
        seeds[b] = it.get("seed", 0) & 0xFFFFFFFF
        p1 = np.asarray(it["params1"])
        p2 = np.asarray(it["params2"])
        fi1 = cm._FOCAL_IDX[it["model_id1"]]
        fi2 = cm._FOCAL_IDX[it["model_id2"]]
        e_errs[b] = opts.max_error / float(
            np.mean([p1[fi1[0]], p1[fi1[1]], p2[fi2[0]], p2[fi2[1]]])
        )

    ro = ransac_ops.RansacOptions(
        max_error=opts.max_error, num_hypotheses=opts.num_hypotheses
    )
    from ..utils import prewarm

    cls = (opts.min_num_inliers, opts.min_E_F_inlier_ratio, opts.max_H_inlier_ratio)
    prewarm.record("efh", B=B, cap=int(cap), opts=ro._asdict(), cls=list(cls))
    handles = _ransac_efh_batch(
        jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(valid), jnp.asarray(seeds), ro, jnp.asarray(e_errs),
        jnp.asarray(quals), cls,
    )
    ctx = {"idxs": idxs, "ns": ns, "n_items": len(items)}
    return handles, ctx


def two_view_verify_classify(
    fetched,
    ctx: dict,
    items: list[dict],
    opts: TwoViewOptions = TwoViewOptions(),
) -> list[TwoViewGeometry]:
    """Host half of batched two-view verification: classify each pair's
    configuration from the fetched EFH+pose numpy arrays (pure numpy — safe
    off the device thread)."""
    out = [TwoViewGeometry() for _ in range(ctx["n_items"])]
    if not ctx["idxs"]:
        return out
    for b, k in enumerate(ctx["idxs"]):
        g = out[k]
        N = ctx["ns"][b]
        g.E, g.F, g.H = fetched["E"][b], fetched["F"][b], fetched["H"][b]
        g.config = int(fetched["config"][b])
        if g.config == DEGENERATE:
            continue
        best_mask = fetched["best_mask"][b, :N]
        rows = np.nonzero(best_mask)[0]
        g.inlier_matches = np.stack([rows, rows], axis=-1).astype(np.int32)
        it = items[k]
        if (
            opts.detect_watermark
            and it.get("size1") is not None
            and it.get("size2") is not None
            and detect_watermark(
                np.asarray(it["uv1"]), np.asarray(it["uv2"]), best_mask,
                it["size1"], it["size2"], opts,
            )
        ):
            g.config = WATERMARK
            continue
        if opts.compute_relative_pose and g.config == CALIBRATED:
            g.qvec = fetched["q"][b]
            g.tvec = fetched["t"][b]
            g.tri_angle = float(fetched["tri_angle"][b])
    return out


def estimate_two_view_geometry_batch(
    items: list[dict],
    opts: TwoViewOptions = TwoViewOptions(),
) -> list[TwoViewGeometry]:
    """Batched estimate_two_view_geometry: ONE fused EFH+pose dispatch for a
    whole image-pair block (dispatch + classify halves run back to back; the
    overlapped matcher calls the halves separately to pipeline chunks).
    Multiple-model extraction falls back to the scalar path per item."""
    if opts.multiple_models:
        return [
            estimate_two_view_geometry(
                it["uv1"], it["uv2"], it["params1"], it["params2"],
                it["model_id1"], it["model_id2"], opts, seed=it.get("seed", 0),
                size1=it.get("size1"), size2=it.get("size2"),
                quality=it.get("quality"),
            )
            if it["uv1"].shape[0] >= 8 else TwoViewGeometry()
            for it in items
        ]
    handles, ctx = two_view_verify_dispatch(items, opts)
    fetched = jax.device_get(handles) if handles is not None else None
    return two_view_verify_classify(fetched, ctx, items, opts)


@jax.jit
def _pose_recovery(E, n1, n2, mask):
    """Pose from E + per-match triangulation angles, one compiled program
    (median tri angle gates init pairs, two_view_geometry.cc tail)."""
    N = n1.shape[0]
    q, t = solvers.decompose_essential(E, n1, n2, mask)
    P1 = solvers.proj_matrix(jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3))
    P2 = solvers.proj_matrix(q, t)
    X = solvers.triangulate_dlt(
        jnp.broadcast_to(P1, (N, 3, 4)), jnp.broadcast_to(P2, (N, 3, 4)), n1, n2
    )
    c2 = se3.projection_center(q, t)
    ang = solvers.triangulation_angle(jnp.zeros(3), c2, X)
    z2 = se3.se3_apply(q, t, X)[:, 2]
    return q, t, ang, X[:, 2], z2
