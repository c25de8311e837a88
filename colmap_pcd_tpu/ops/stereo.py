"""Dense multi-view stereo: plane-sweep NCC cost volumes + consistency fusion.

Replaces the reference's CUDA PatchMatch stereo (src/mvs/patch_match_cuda.cu,
1,772 LoC — red/black checkerboard propagation with bilateral NCC) and
StereoFusion (src/mvs/fusion.{h,cc}). PatchMatch's sequential spatial
propagation serializes what a wide vector machine wants in parallel; the
data-parallel formulation of the same problem is a plane sweep:

  * a bank of D fronto-parallel depth hypotheses per reference view,
  * every source image homography-warped onto the reference for every
    hypothesis (dense gathers),
  * windowed zero-mean NCC computed with box-filter sums (pure elementwise math,
    no data-dependent control flow),
  * per-pixel cost aggregated over sources (mean of best-K sources — the
    analog of PatchMatch's per-pixel view selection),
  * depth = parabola-refined argmin over the sweep; normals from the local
    depth-gradient plane fit,
  * photometric + left/right (cross-view depth reprojection) consistency
    masks, then multi-view fusion into a colored, normal-carrying cloud
    (fusion.h:108 semantics).

All shapes static: [D, H, W] cost volumes stream through a lax.scan over
depth chunks so memory stays bounded.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


def _mm(a: Array, b: Array) -> Array:
    """f32-exact matmul: HIGHEST is true fp32 on the H100 (CUDA cores, not
    the tensor cores). A reduced-precision default (TF32's 10-bit mantissa)
    shifts projected pixel coordinates by a sizeable fraction of a pixel at
    3x3-projection scale — fatal for sub-pixel stereo — and these matmuls
    are tiny (3xHW), so reduced precision would save nothing."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class StereoOptions(NamedTuple):
    num_depths: int = 64
    window_radius: int = 3  # NCC window = (2r+1)^2
    top_k: int = 2  # best-K source aggregation
    min_ncc: float = 0.1  # photometric gate (cost = 1 - ncc)
    depth_chunk: int = 8
    min_consistent: int = 2  # views that must agree in fusion
    max_depth_error: float = 0.01  # relative depth agreement for consistency
    max_normal_error_deg: float = 25.0
    # Bilaterally weighted NCC (patch_match.h:81-83): window pixels weighted
    # by spatial distance and color similarity to the window center.
    # sigma_color <= 0 disables (falls back to box-filter NCC).
    sigma_spatial: float = -1.0  # <=0 -> window_radius
    sigma_color: float = 0.2  # images in [0,1]
    # Geometric-consistency term (patch_match.h:101-111): forward-backward
    # reprojection error against prior source depth maps, capped and added
    # to the photometric cost with this relative weight.
    geom_regularizer: float = 0.3
    geom_max_cost: float = 3.0  # pixels


def _box_sum(x: Array, r: int) -> Array:
    """Windowed sum via reduce_window (fused by XLA)."""
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (2 * r + 1, 2 * r + 1), (1, 1), "SAME"
    )


def _warp_coords(Hm: Array, H: int, W: int) -> tuple[Array, Array]:
    """Per-ref-pixel source coordinates under a 3x3 homography."""
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32), indexing="ij")
    ones = jnp.ones_like(xx)
    p = jnp.stack([xx, yy, ones], 0).reshape(3, -1)  # [3, HW]
    q = _mm(Hm, p)
    w = jnp.where(jnp.abs(q[2]) < 1e-8, 1e-8, q[2])
    sx = (q[0] / w).reshape(H, W)
    sy = (q[1] / w).reshape(H, W)
    return sx, sy


def _sample(src: Array, sx: Array, sy: Array) -> tuple[Array, Array]:
    """Bilinear sample src [Hs,Ws] at (sx, sy); returns (values, valid)."""
    Hs, Ws = src.shape
    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, Ws - 1)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, Hs - 1)
    x1 = jnp.clip(x0 + 1, 0, Ws - 1)
    y1 = jnp.clip(y0 + 1, 0, Hs - 1)
    fx = jnp.clip(sx - x0, 0.0, 1.0)
    fy = jnp.clip(sy - y0, 0.0, 1.0)
    v = (
        src[y0, x0] * (1 - fx) * (1 - fy)
        + src[y0, x1] * fx * (1 - fy)
        + src[y1, x0] * (1 - fx) * fy
        + src[y1, x1] * fx * fy
    )
    valid = (sx >= 0) & (sx <= Ws - 1) & (sy >= 0) & (sy <= Hs - 1)
    return v, valid.astype(jnp.float32)


def _warp_source(src: Array, Hm: Array, H: int, W: int) -> tuple[Array, Array]:
    """Warp src [Hs,Ws] by 3x3 homography (ref pixel -> src pixel)."""
    sx, sy = _warp_coords(Hm, H, W)
    return _sample(src, sx, sy)


def _plane_homography(K_ref_inv: Array, K_src: Array, R_rel: Array, t_rel: Array, depth: Array) -> Array:
    """Homography ref->src for the fronto-parallel plane at `depth` in the
    reference frame: H = K_src (R + t n^T / d) K_ref^-1 with n = (0,0,-1)...
    using plane z = depth => x_src = R x_ref + t, x_ref = depth * K^-1 p."""
    n_over_d = jnp.asarray([0.0, 0.0, 1.0]) / depth
    M = R_rel + t_rel[:, None] * n_over_d[None, :]
    return _mm(K_src, _mm(M, K_ref_inv))


def _shift(x: Array, dy: int, dx: int, r: int) -> Array:
    """Edge-clamped static shift: value of x at (y+dy, x+dx)."""
    H, W = x.shape
    xp = jnp.pad(x, r, mode="edge")
    return jax.lax.dynamic_slice(xp, (r + dy, r + dx), (H, W))


def _bilateral_ref_terms(ref: Array, opts: StereoOptions):
    """Precompute the reference-only pieces of bilaterally weighted NCC.

    Weight of window pixel at offset o from the center (patch_match.h:81-83,
    patch_match_cuda.cu bilateral weighting):
        w_o = exp(-|o|^2 / (2 sigma_spatial^2)
                  - (I(p) - I(p+o))^2 / (2 sigma_color^2))
    Weights depend only on the reference image, so the weighted sums over
    ref can be computed once per view and reused for every (depth, source).
    Returns (offsets, w [K,H,W], ref_sh [K,H,W], Wsum, mu_r, var_r).
    """
    r = opts.window_radius
    ss = opts.sigma_spatial if opts.sigma_spatial > 0 else float(r)
    sc = opts.sigma_color
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    ws, rsh = [], []
    for dy, dx in offs:
        sref = _shift(ref, dy, dx, r)
        w = jnp.exp(
            -(dy * dy + dx * dx) / (2.0 * ss * ss)
            - (ref - sref) ** 2 / (2.0 * sc * sc)
        )
        ws.append(w)
        rsh.append(sref)
    w = jnp.stack(ws)  # [K,H,W]
    ref_sh = jnp.stack(rsh)
    Wsum = jnp.maximum(jnp.sum(w, 0), 1e-8)
    mu_r = jnp.sum(w * ref_sh, 0) / Wsum
    var_r = jnp.maximum(jnp.sum(w * ref_sh * ref_sh, 0) / Wsum - mu_r * mu_r, 1e-8)
    return offs, w, ref_sh, Wsum, mu_r, var_r


def _bilateral_ncc_cost(
    warped: Array, wvalid: Array, bil, r: int
) -> Array:
    """1 - bilaterally weighted zero-mean NCC. Invalid -> cost 2."""
    offs, w, ref_sh, Wsum, mu_r, var_r = bil
    Ww = jnp.zeros_like(Wsum)
    Www = jnp.zeros_like(Wsum)
    Wrw = jnp.zeros_like(Wsum)
    Wv = jnp.zeros_like(Wsum)
    for k, (dy, dx) in enumerate(offs):
        sw = _shift(warped, dy, dx, r)
        sv = _shift(wvalid, dy, dx, r)
        Ww = Ww + w[k] * sw
        Www = Www + w[k] * sw * sw
        Wrw = Wrw + w[k] * ref_sh[k] * sw
        Wv = Wv + w[k] * sv
    mu_w = Ww / Wsum
    var_w = jnp.maximum(Www / Wsum - mu_w * mu_w, 1e-8)
    cov = Wrw / Wsum - mu_r * mu_w
    ncc = cov / jnp.sqrt(var_r * var_w)
    cost = 1.0 - jnp.clip(ncc, -1.0, 1.0)
    ok = Wv > 0.8 * Wsum
    return jnp.where(ok, cost, 2.0)


def _ncc_cost(ref: Array, warped: Array, wvalid: Array, r: int) -> Array:
    """1 - zero-mean NCC over (2r+1)^2 windows. Invalid -> cost 2."""
    n = (2 * r + 1) ** 2
    s_r = _box_sum(ref, r) / n
    s_w = _box_sum(warped, r) / n
    s_rr = _box_sum(ref * ref, r) / n
    s_ww = _box_sum(warped * warped, r) / n
    s_rw = _box_sum(ref * warped, r) / n
    var_r = jnp.maximum(s_rr - s_r * s_r, 1e-8)
    var_w = jnp.maximum(s_ww - s_w * s_w, 1e-8)
    ncc = (s_rw - s_r * s_w) / jnp.sqrt(var_r * var_w)
    cost = 1.0 - jnp.clip(ncc, -1.0, 1.0)
    ok = _box_sum(wvalid, r) > 0.8 * n
    return jnp.where(ok, cost, 2.0)


@functools.partial(jax.jit, static_argnames=("opts", "use_geom"))
def plane_sweep(
    ref: Array,  # [H,W] grayscale
    srcs: Array,  # [S,Hs,Ws]
    K_ref: Array,  # [3,3]
    K_srcs: Array,  # [S,3,3]
    R_rel: Array,  # [S,3,3] ref-cam -> src-cam rotation
    t_rel: Array,  # [S,3]
    depths: Array,  # [D] hypothesis bank (e.g. inverse-depth spaced)
    opts: StereoOptions = StereoOptions(),
    src_depths: Array | None = None,  # [S,Hs,Ws] prior source depth maps
    use_geom: bool = False,
):
    """Returns (depth_map [H,W], cost_map [H,W], normal_map [H,W,3]).

    Normals are in the reference camera frame, unit, pointing toward the
    camera (negative z), from a finite-difference plane fit of the depth map.

    With use_geom=True and src_depths given, adds the reference's regularized
    geometric-consistency term (patch_match.h:101-111): the forward-backward
    reprojection error of each depth hypothesis against the source view's own
    depth map, capped at geom_max_cost px, weighted by geom_regularizer.
    """
    H, W = ref.shape
    S = srcs.shape[0]
    D = depths.shape[0]
    K_ref_inv = jnp.linalg.inv(K_ref)
    r = opts.window_radius
    bilateral = opts.sigma_color > 0
    bil = _bilateral_ref_terms(ref, opts) if bilateral else None
    yy, xx = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32), indexing="ij"
    )

    def geom_cost(s, d, sx, sy):
        """Forward-backward reprojection error vs the source depth map."""
        d_s, dvalid = _sample(src_depths[s], sx, sy)
        # back-project the source pixel at its own depth, map to ref frame
        p_s = jnp.stack([sx, sy, jnp.ones_like(sx)], -1)  # [H,W,3]
        y_src = _mm(p_s, jnp.linalg.inv(K_srcs[s]).T) * d_s[..., None]
        y_ref = _mm(y_src - t_rel[s], R_rel[s])  # R^T (y - t)
        q = _mm(y_ref, K_ref.T)
        qz = jnp.where(jnp.abs(q[..., 2]) < 1e-8, 1e-8, q[..., 2])
        err = jnp.sqrt((q[..., 0] / qz - xx) ** 2 + (q[..., 1] / qz - yy) ** 2)
        ok = (dvalid > 0) & (d_s > 0) & (y_ref[..., 2] > 0)
        return jnp.where(ok, jnp.minimum(err, opts.geom_max_cost), opts.geom_max_cost)

    def depth_cost(d):
        costs, photos = [], []
        for s in range(S):
            Hm = _plane_homography(K_ref_inv, K_srcs[s], R_rel[s], t_rel[s], d)
            sx, sy = _warp_coords(Hm, H, W)
            warped, wv = _sample(srcs[s], sx, sy)
            if bilateral:
                p = _bilateral_ncc_cost(warped, wv, bil, r)
            else:
                p = _ncc_cost(ref, warped, wv, r)
            c = p
            if use_geom and src_depths is not None:
                c = c + opts.geom_regularizer * geom_cost(s, d, sx, sy)
            costs.append(c)
            photos.append(p)
        c = jnp.stack(costs)  # [S,H,W]
        p = jnp.stack(photos)
        k = min(opts.top_k, S)
        # select best-k sources by TOTAL cost; report the photometric part of
        # the same selection so downstream min_ncc gating keeps its meaning
        neg_top, idx = jax.lax.top_k(-c.reshape(S, -1).T, k)  # [HW,k]
        photo_sel = jnp.take_along_axis(p.reshape(S, -1).T, idx, axis=1)
        total = jnp.mean(-neg_top, axis=-1).reshape(H, W)
        photo = jnp.mean(photo_sel, axis=-1).reshape(H, W)
        return total, photo

    geom_slack = opts.geom_regularizer * opts.geom_max_cost

    def one(carry, d):
        best_cost, best_photo, best_depth = carry
        c, p = depth_cost(d)
        upd = c < best_cost
        best_cost = jnp.where(upd, c, best_cost)
        best_photo = jnp.where(upd, p, best_photo)
        best_depth = jnp.where(upd, d, best_depth)
        return (best_cost, best_photo, best_depth), None

    big = jnp.full((H, W), 2.0 + (geom_slack if use_geom else 0.0) + 1e-3)
    init = (big, jnp.full((H, W), 2.0), jnp.full((H, W), depths[0]))
    (_, best_cost, best_depth), _ = jax.lax.scan(one, init, depths)

    # normals from depth gradients: z(x, y) plane fit in camera coords
    fx = K_ref[0, 0]
    fy = K_ref[1, 1]
    dzdx = (jnp.roll(best_depth, -1, 1) - jnp.roll(best_depth, 1, 1)) * 0.5
    dzdy = (jnp.roll(best_depth, -1, 0) - jnp.roll(best_depth, 1, 0)) * 0.5
    # surface tangents in camera frame: t_x ~ (z/fx, 0, dzdx), t_y ~ (0, z/fy, dzdy)
    z = best_depth
    n = jnp.stack([-dzdx * fx / jnp.maximum(z, 1e-6), -dzdy * fy / jnp.maximum(z, 1e-6), jnp.ones_like(z)], -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    n = -n  # point toward the camera (-z)
    return best_depth, best_cost, n


@functools.partial(jax.jit, static_argnames=("opts",))
def consistency_mask(
    depth_ref: Array,  # [H,W]
    cost_ref: Array,
    depths_other: Array,  # [V,H,W] other views' depth maps
    K: Array,  # [3,3] shared intrinsics (undistorted workspace)
    R_to_other: Array,  # [V,3,3] ref-cam -> other-cam
    t_to_other: Array,  # [V,3]
    opts: StereoOptions = StereoOptions(),
) -> Array:
    """Geometric consistency: a ref depth is kept if >= min_consistent other
    views see a compatible depth at the reprojected pixel (fusion semantics,
    mvs/fusion.cc)."""
    H, W = depth_ref.shape
    V = depths_other.shape[0]
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32), indexing="ij")
    Kinv = jnp.linalg.inv(K)
    p = jnp.stack([xx, yy, jnp.ones_like(xx)], -1)  # [H,W,3]
    x_ref = _mm(p, Kinv.T) * depth_ref[..., None]  # ref-camera coords

    count = jnp.zeros((H, W), jnp.int32)
    for v in range(V):
        x_o = _mm(x_ref, R_to_other[v].T) + t_to_other[v]
        z_o = x_o[..., 2]
        uv = _mm(x_o, K.T)
        w = jnp.where(jnp.abs(uv[..., 2]) < 1e-8, 1e-8, uv[..., 2])
        u = uv[..., 0] / w
        vv = uv[..., 1] / w
        ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, W - 1)
        vi = jnp.clip(jnp.round(vv).astype(jnp.int32), 0, H - 1)
        d_o = depths_other[v][vi, ui]
        rel = jnp.abs(d_o - z_o) / jnp.maximum(z_o, 1e-6)
        ok = (
            (z_o > 0)
            & (u >= 0) & (u <= W - 1) & (vv >= 0) & (vv <= H - 1)
            & (rel < opts.max_depth_error * 10)
        )
        count = count + ok.astype(jnp.int32)
    photometric = cost_ref < (1.0 - opts.min_ncc)
    return (count >= opts.min_consistent) & photometric
