"""SIFT feature extraction as batched XLA ops.

Replaces lib/VLFeat's CPU SIFT (35.9k LoC of C+SSE) and lib/SiftGPU
(src/feature/sift.cc ExtractSiftFeaturesCPU/GPU): the classic pipeline —
Gaussian scale-space, DoG extrema, edge/peak gates, subpixel refinement,
orientation histogram, 4x4x8 gradient descriptor — reformulated so every
stage is a dense fixed-shape tensor op:

  * scale space: separable depthwise convs (XLA fuses + tiles these well)
  * extrema: 3x3x3 max/min pooling over the DoG stack, compared to center
  * candidate selection: top-k over the masked |DoG| score map (fixed K per
    octave — no dynamic shapes anywhere)
  * subpixel refine: batched 3x3 solves from gathered finite differences
  * orientation: 36-bin histograms via one-hot matmul over gathered patches
  * descriptor: 16x16 sample grid, rotated, trilinearly binned into 4x4x8,
    normalized with the L1_ROOT convention (sift.h:108 Normalization)

Options mirror SiftExtractionOptions (src/feature/sift.h:44-114).
Keypoints are (x, y, scale, orientation) in original-image pixel coords,
COLMAP convention (upper-left pixel center at (0.5, 0.5) is NOT applied —
we use array indexing coords consistently end to end).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class SiftOptions(NamedTuple):
    max_num_features: int = 8192
    num_octaves: int = 4
    octave_resolution: int = 3  # S: DoG levels per octave used for detection
    first_octave: int = -1  # -1 = 2x upsample (VLFeat/COLMAP default)
    peak_threshold: float = 0.02 / 3.0  # on DoG values (sift.h:73)
    edge_threshold: float = 10.0
    sigma0: float = 1.6
    init_blur: float = 0.5  # assumed camera blur
    max_per_octave: int = 4096
    upright: bool = False
    l1_root: bool = True  # L1_ROOT descriptor normalization (COLMAP default)
    # DSP-SIFT domain-size pooling (sift.h:102-113; default off as in COLMAP)
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    # affine shape adaptation (sift.h:98-100 estimate_affine_shape; VLFeat
    # covariant detector): iterate the gradient second-moment matrix to an
    # isotropic frame, then sample orientation + descriptor through the
    # affine transform. Default off as in COLMAP.
    estimate_affine_shape: bool = False
    affine_iterations: int = 3


def _gauss_kernel(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: Array, sigma: float) -> Array:
    """Separable Gaussian blur, [H,W] -> [H,W] (zero boundary).

    Written as a static shift-and-add stencil (pad + slices, fused by XLA)
    rather than conv_general_dilated: a 1-channel, 1-filter conv gives a
    matrix unit almost nothing to multiply, while the fused stencil is plain
    elementwise work at memory speed. Kept until a GPU profile compares the
    two."""
    if sigma < 1e-6:
        return img
    k = _gauss_kernel(sigma)  # numpy: taps become compile-time scalars
    r = len(k) // 2
    H, W = img.shape[-2:]
    nd = img.ndim
    xp = jnp.pad(img, [(0, 0)] * (nd - 2) + [(0, 0), (r, r)])
    x = sum(float(k[t]) * xp[..., t : t + W] for t in range(len(k)))
    xp = jnp.pad(x, [(0, 0)] * (nd - 2) + [(r, r), (0, 0)])
    return sum(float(k[t]) * xp[..., t : t + H, :] for t in range(len(k)))


def _downsample2(img: Array) -> Array:
    return img[::2, ::2]


def _upsample2(img: Array) -> Array:
    H, W = img.shape
    return jax.image.resize(img, (2 * H, 2 * W), method="bilinear")


def _bilinear(img: Array, xy: Array, lidx: Array | None = None, wh=None) -> Array:
    """Bilinear sample at xy [...,2] (x, y) coords; zero outside.

    img is [H,W], or a level stack [L,H,W] with lidx giving the per-leading-
    index level to sample (the keypoint's own gaussian level — the fix for
    the round-1 fixed-mid-level descriptor shortcut). wh, when given, is a
    (wlim, hlim) pair of per-leading-index valid extents (exclusive of
    padding) for sampling from octave planes padded to a common shape."""
    H, W = img.shape[-2:]
    x = xy[..., 0]
    y = xy[..., 1]
    if wh is None:
        wmax = W - 1
        hmax = H - 1
    else:
        wlim, hlim = wh
        wmax = jnp.reshape(wlim, wlim.shape + (1,) * (x.ndim - wlim.ndim))
        hmax = jnp.reshape(hlim, hlim.shape + (1,) * (x.ndim - hlim.ndim))
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, wmax)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, hmax)
    x1i = jnp.clip(x0i + 1, 0, wmax)
    y1i = jnp.clip(y0i + 1, 0, hmax)
    inb = (x >= 0) & (x <= wmax) & (y >= 0) & (y <= hmax)
    if img.ndim == 2:
        def at(yi, xi):
            return img[yi, xi]
    else:
        li = jnp.broadcast_to(
            jnp.reshape(lidx, lidx.shape + (1,) * (x.ndim - lidx.ndim)), x.shape
        )

        def at(yi, xi):
            return img[li, yi, xi]

    v00 = at(y0i, x0i)
    v01 = at(y0i, x1i)
    v10 = at(y1i, x0i)
    v11 = at(y1i, x1i)
    v = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    return v * inb


def _pack_bilinear_table(mag: Array, ang: Array) -> Array:
    """[L,H,W] mag/ang -> packed [L,H,W,8] corner table with rows
    [m00,a00,m01,a01,m10,a10,m11,a11] (01 = x+1 shift, 10 = y+1 shift,
    zero beyond the edge), so one bilinear sample is ONE contiguous 32-byte
    row gather instead of 16 scalar gathers (the former extraction
    bottleneck: ~67M scalar gathers per batch of 8)."""
    # bfloat16 storage: the table is 4x the HBM of the mag/ang planes it
    # replaces (advisor r4) — bf16 halves that, and descriptor binning
    # tolerates the ~0.4% relative error (8 orientation bins of width pi/4;
    # weights recompute in f32 at sample time)
    F = jnp.stack([mag, ang], -1).astype(jnp.bfloat16)  # [L,H,W,2]
    Fx = jnp.pad(F, ((0, 0), (0, 0), (0, 1), (0, 0)))[:, :, 1:, :]
    F4 = jnp.concatenate([F, Fx], -1)  # [L,H,W,4]
    Fy = jnp.pad(F4, ((0, 0), (0, 1), (0, 0), (0, 0)))[:, 1:, :, :]
    return jnp.concatenate([F4, Fy], -1)  # [L,H,W,8]


def _bilinear_ma(F8: Array, xy: Array, lidx: Array, wh) -> tuple[Array, Array]:
    """Bilinear (mag, ang) from the packed corner table; zero outside.

    Exactly _bilinear's math: corner x1/y1 reads beyond a keypoint's valid
    extent only ever carry zero weight (fx/fy = 0 at the boundary, inb = 0
    outside), so the packed zero-padded neighbors match the former clamped
    re-reads wherever the weight is nonzero."""
    L, H, W, _ = F8.shape
    # int32 flat-index headroom (advisor r4): a 2x-upsampled first octave of
    # a very large input could overflow (li*H + y)*W + x past 2^31 and gather
    # garbage rows; these are trace-time Python ints, so assert here
    assert L * H * W < 2**31, (L, H, W)
    x = xy[..., 0]
    y = xy[..., 1]
    wlim, hlim = wh
    wmax = jnp.reshape(wlim, wlim.shape + (1,) * (x.ndim - wlim.ndim))
    hmax = jnp.reshape(hlim, hlim.shape + (1,) * (x.ndim - hlim.ndim))
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, wmax)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, hmax)
    inb = (x >= 0) & (x <= wmax) & (y >= 0) & (y <= hmax)
    li = jnp.broadcast_to(
        jnp.reshape(lidx, lidx.shape + (1,) * (x.ndim - lidx.ndim)), x.shape
    )
    rows = F8.reshape(L * H * W, 8)[(li * H + y0i) * W + x0i].astype(
        jnp.float32
    )  # [...,8]
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    m = (
        rows[..., 0] * w00 + rows[..., 2] * w01
        + rows[..., 4] * w10 + rows[..., 6] * w11
    )
    a = (
        rows[..., 1] * w00 + rows[..., 3] * w01
        + rows[..., 5] * w10 + rows[..., 7] * w11
    )
    return m * inb, a * inb


def _shift2d(x: Array, dy: int, dx: int) -> Array:
    """out[..., y, x] = x[..., y+dy, x+dx], zeros outside — pad+slice, never
    jnp.roll (roll lowers to concatenate, which XLA materializes as
    tile-padded batch-minor copies of the whole stack under vmap)."""
    H, W = x.shape[-2], x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)])
    return xp[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]


def _extrema_candidates(dog: Array, opts: SiftOptions):
    """dog [S+2, H, W] -> per-level extrema score map [S, H, W] (0 = not)."""
    Sp2, H, W = dog.shape
    # 3x3x3 max/min pools
    mx = jax.lax.reduce_window(
        dog, -jnp.inf, jax.lax.max, (3, 3, 3), (1, 1, 1), "SAME"
    )
    mn = jax.lax.reduce_window(
        dog, jnp.inf, jax.lax.min, (3, 3, 3), (1, 1, 1), "SAME"
    )
    center = dog[1:-1]
    is_max = (center >= mx[1:-1]) & (center > opts.peak_threshold)
    is_min = (center <= mn[1:-1]) & (center < -opts.peak_threshold)

    # edge response gate on the spatial Hessian (borders are excluded by the
    # margin below, so the zero boundary of _shift2d is inert)
    dxx = _shift2d(center, 0, 1) + _shift2d(center, 0, -1) - 2 * center
    dyy = _shift2d(center, 1, 0) + _shift2d(center, -1, 0) - 2 * center
    dxy = 0.25 * (
        _shift2d(center, 1, 1)
        + _shift2d(center, -1, -1)
        - _shift2d(center, 1, -1)
        - _shift2d(center, -1, 1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = opts.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    # exclude the image border
    ys = jnp.arange(H)[None, :, None]
    xs = jnp.arange(W)[None, None, :]
    b = 5
    inb = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)

    score = jnp.abs(center) * ((is_max | is_min) & edge_ok & inb)
    return score


def _affine_shape(gx_st, gy_st, kx, ky, sigma_rel, opts, lidx, wh):
    """Affine shape adaptation: per-keypoint 2x2 transform A (det 1) that
    isotropizes the local gradient second-moment matrix (VLFeat covariant
    frames backing sift.cc:650 ExtractCovariantSiftFeaturesCPU). Fixed
    iteration count, batched over keypoints."""
    K = kx.shape[0]
    P = 12
    lin = jnp.linspace(-1.0, 1.0, P)
    gxg, gyg = jnp.meshgrid(lin, lin)
    offs = jnp.stack([gxg.ravel(), gyg.ravel()], -1)  # [P*P,2]
    d2 = jnp.sum(offs * offs, -1)[None, :]
    w = jnp.exp(-d2 / (2 * 0.5**2)) * (d2 <= 1.0)  # [1,P*P]
    win_r = 3.0 * 1.5 * sigma_rel  # [K]
    A = jnp.broadcast_to(jnp.eye(2), (K, 2, 2))

    for _ in range(opts.affine_iterations):
        world = jnp.einsum("kij,pj->kpi", A, offs) * win_r[:, None, None]
        coords = jnp.stack([kx, ky], -1)[:, None, :] + world
        gxs = _bilinear(gx_st, coords, lidx, wh)  # [K,P*P]
        gys = _bilinear(gy_st, coords, lidx, wh)
        m00 = jnp.sum(w * gxs * gxs, -1)
        m01 = jnp.sum(w * gxs * gys, -1)
        m11 = jnp.sum(w * gys * gys, -1)
        # inverse square root of M = [[m00,m01],[m01,m11]] (closed form 2x2)
        tr = m00 + m11
        det = jnp.maximum(m00 * m11 - m01 * m01, 1e-18)
        s = jnp.sqrt(det)
        t = jnp.sqrt(jnp.maximum(tr + 2.0 * s, 1e-18))
        # sqrtm(M) = (M + s I)/t ; inv via adjugate / det(sqrtm)= s... :
        r00 = (m00 + s) / t
        r01 = m01 / t
        r11 = (m11 + s) / t
        dr = jnp.maximum(r00 * r11 - r01 * r01, 1e-18)
        i00 = r11 / dr
        i01 = -r01 / dr
        i11 = r00 / dr
        Minv_sqrt = jnp.stack(
            [jnp.stack([i00, i01], -1), jnp.stack([i01, i11], -1)], -2
        )  # [K,2,2]
        # normalize to det 1 so scale stays owned by sigma
        dd = jnp.sqrt(jnp.maximum(i00 * i11 - i01 * i01, 1e-18))
        Minv_sqrt = Minv_sqrt / dd[:, None, None]
        A = jnp.einsum("kij,kjl->kil", A, Minv_sqrt)
        # guard against degenerate windows (flat texture): keep A bounded
        norm = jnp.sqrt(jnp.sum(A * A, axis=(-2, -1), keepdims=True))
        A = jnp.where(norm > 4.0, A * (4.0 / norm), A)
    return A


def _orientation_and_descriptor(G, kx, ky, sigma_rel, opts, lidx=None, wh=None):
    """Dominant orientation and 128-d descriptor for keypoints sampled on
    their own gaussian level. G is the octave's level stack [L,H,W] with
    lidx [K] the per-keypoint level (sift.cc:418-650 semantics: VLFeat
    computes gradients on the keypoint's scale level), or a single [H,W]
    level. kx/ky [K] are octave-resolution coords, sigma_rel [K]. wh gives
    per-keypoint valid extents when G planes are padded to a common shape."""
    K = kx.shape[0]
    # gradient maps (per level — cheap elementwise ops over the stack).
    # NOTE: slice+pad central differences, NOT jnp.roll — roll lowers to a
    # concatenate of two slices, and under vmap XLA can materialize those as
    # layout-changing copies of the whole [B,L,H,W] stack. Borders get zero
    # gradient (roll wrapped around, which was wrong there anyway; detection
    # enforces a border margin).
    nd = G.ndim
    gx = jnp.pad(
        0.5 * (G[..., :, 2:] - G[..., :, :-2]),
        [(0, 0)] * (nd - 1) + [(1, 1)],
    )
    gy = jnp.pad(
        0.5 * (G[..., 2:, :] - G[..., :-2, :]),
        [(0, 0)] * (nd - 2) + [(1, 1), (0, 0)],
    )
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.arctan2(gy, gx)  # [-pi, pi]
    if G.ndim == 2:
        F8 = _pack_bilinear_table(mag[None], ang[None])
        lidx_p = jnp.zeros(kx.shape, jnp.int32)
    else:
        F8 = _pack_bilinear_table(mag, ang)
        lidx_p = lidx
    if wh is None:
        wh_p = (
            jnp.full(kx.shape, G.shape[-1] - 1, jnp.int32),
            jnp.full(kx.shape, G.shape[-2] - 1, jnp.int32),
        )
    else:
        wh_p = wh

    aff = None
    if opts.estimate_affine_shape:
        aff = _affine_shape(gx, gy, kx, ky, sigma_rel, opts, lidx, wh)

    # ---- orientation: 36-bin histogram over a radius 3*1.5*sigma window ----
    P = 16  # patch sample grid (PxP) over [-r, r]
    win_r = 3.0 * 1.5 * sigma_rel  # [K]
    lin = jnp.linspace(-1.0, 1.0, P)
    gxg, gyg = jnp.meshgrid(lin, lin)
    offs = jnp.stack([gxg.ravel(), gyg.ravel()], -1)  # [P*P, 2] in [-1,1]
    offs_k = (
        jnp.einsum("kij,pj->kpi", aff, offs) if aff is not None else offs[None, :, :]
    )
    coords = (
        jnp.stack([kx, ky], -1)[:, None, :]
        + offs_k * win_r[:, None, None]
    )  # [K, P*P, 2]
    m, a = _bilinear_ma(F8, coords, lidx_p, wh_p)
    d2 = jnp.sum(offs * offs, axis=-1)[None, :]  # normalized radius^2
    gw = jnp.exp(-d2 / (2 * 0.5**2)) * (d2 <= 1.0)
    w = m * gw
    bins = jnp.floor((a + jnp.pi) / (2 * jnp.pi) * 36).astype(jnp.int32) % 36
    onehot = jax.nn.one_hot(bins, 36, dtype=w.dtype)  # [K, P*P, 36]
    hist = jnp.einsum("kp,kpb->kb", w, onehot)
    # circular smoothing x2
    for _ in range(2):
        hist = (jnp.roll(hist, 1, -1) + hist + jnp.roll(hist, -1, -1)) / 3.0
    peak = jnp.argmax(hist, axis=-1)
    # parabolic peak interpolation
    hp = jnp.take_along_axis(hist, peak[:, None], 1)[:, 0]
    hl = jnp.take_along_axis(hist, ((peak - 1) % 36)[:, None], 1)[:, 0]
    hr = jnp.take_along_axis(hist, ((peak + 1) % 36)[:, None], 1)[:, 0]
    denom = hl - 2 * hp + hr
    dbin = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (hl - hr) / denom, 0.0)
    ori = (peak.astype(jnp.float32) + dbin + 0.5) * (2 * jnp.pi / 36) - jnp.pi
    if opts.upright:
        ori = jnp.zeros_like(ori)

    # ---- descriptor: 16x16 samples over 4x4 bins, rotated by ori -----------
    D = 16
    lin = (jnp.arange(D) + 0.5) / D * 2.0 - 1.0  # [-1,1]
    sx, sy = jnp.meshgrid(lin, lin)
    soff = jnp.stack([sx.ravel(), sy.ravel()], -1)  # [D*D, 2]
    co = jnp.cos(ori)
    si = jnp.sin(ori)
    rot = jnp.stack(
        [jnp.stack([co, -si], -1), jnp.stack([si, co], -1)], -2
    )  # [K,2,2]
    gw = jnp.exp(-jnp.sum(soff * soff, -1)[None, :] / (2 * 0.6**2))

    # trilinear binning weights: spatial (4x4) from soff, orientation (8)
    def spatial_weights(c):  # c in [-1,1] -> 4 bins at centers -0.75..0.75
        centers = jnp.asarray([-0.75, -0.25, 0.25, 0.75])
        d = jnp.abs(c[..., None] - centers) / 0.5
        return jnp.maximum(0.0, 1.0 - d)  # [..., 4]

    wxs = spatial_weights(soff[:, 0])  # [DD,4]
    wys = spatial_weights(soff[:, 1])  # [DD,4]

    samp = rot if aff is None else jnp.einsum("kij,kjl->kil", aff, rot)

    def raw_descriptor(half):
        """Unnormalized 128-d histogram sampled at window half-size `half`
        (spacing 3*sigma -> half = 2*3*sigma at scale 1)."""
        world_off = jnp.einsum("kij,pj->kpi", samp, soff) * half[:, None, None]
        coords = jnp.stack([kx, ky], -1)[:, None, :] + world_off  # [K,DD,2]
        m, a = _bilinear_ma(F8, coords, lidx_p, wh_p)
        a = a - ori[:, None]
        w = m * gw  # [K, DD]
        af = (a + jnp.pi) / (2 * jnp.pi) * 8.0
        b0 = jnp.floor(af).astype(jnp.int32) % 8
        fb = af - jnp.floor(af)
        wo = jax.nn.one_hot(b0, 8, dtype=w.dtype) * (1 - fb)[..., None] + jax.nn.one_hot(
            (b0 + 1) % 8, 8, dtype=w.dtype
        ) * fb[..., None]  # [K,DD,8]
        # desc[k, yb, xb, ob] = sum_p w * wys[p,yb] * wxs[p,xb] * wo[k,p,ob]
        return jnp.einsum("kp,py,px,kpo->kyxo", w, wys, wxs, wo).reshape(K, 128)

    base_half = 2.0 * 3.0 * sigma_rel  # [K]
    if opts.domain_size_pooling:
        # DSP-SIFT (sift.h:102-113 / sift.cc:650): pool raw descriptors over
        # a range of domain sizes before normalization
        scales = np.linspace(
            opts.dsp_min_scale, opts.dsp_max_scale, opts.dsp_num_scales
        )
        desc = jnp.mean(
            jnp.stack([raw_descriptor(base_half * float(s)) for s in scales]), 0
        )
    else:
        desc = raw_descriptor(base_half)
    # normalize: L2 -> clip 0.2 -> L2; then L1-root if configured
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-12)
    desc = jnp.minimum(desc, 0.2)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-12)
    if opts.l1_root:
        desc = jnp.sqrt(desc / jnp.maximum(jnp.sum(desc, -1, keepdims=True), 1e-12))
    return ori, desc


@functools.partial(jax.jit, static_argnames=("opts",))
def extract_batch(images: Array, opts: SiftOptions = SiftOptions()):
    """vmapped extract over a batch of same-shape images [B,H,W]: one device
    dispatch per image GROUP (the extraction pipeline batches 4) instead of
    one per image."""
    return jax.vmap(lambda im: extract(im, opts))(images)


@functools.partial(jax.jit, static_argnames=("opts",))
def extract(image: Array, opts: SiftOptions = SiftOptions()):
    """image [H,W] float32 in [0,1] -> (keypoints [K,4], descriptors [K,128],
    scores [K], valid [K] bool), K = opts.max_num_features."""
    S = opts.octave_resolution
    img = image.astype(jnp.float32)
    if image.dtype == jnp.uint8:
        # the extraction pipeline ships uint8 to the device (4x less
        # host->device transfer than f32) and normalizes here
        img = img * (1.0 / 255.0)

    if opts.first_octave < 0:
        base = _upsample2(img)
        scale0 = 0.5
        extra_blur = np.sqrt(max(opts.sigma0**2 - (2 * opts.init_blur) ** 2, 0.01))
    else:
        base = img
        scale0 = 1.0
        extra_blur = np.sqrt(max(opts.sigma0**2 - opts.init_blur**2, 0.01))
    base = _blur(base, float(extra_blur))

    # Detection runs per octave on max_per_octave candidates, but the
    # expensive part — orientation + descriptor, ~512 bilinear gathers per
    # keypoint — runs ONCE at the end, only for the globally selected
    # max_num_features keypoints, over all octaves' gaussian levels padded to
    # a common plane shape (at 2048 features vs 4 octaves x 4096 candidates
    # that's an ~8x cut in gather traffic, the extraction bottleneck).
    cand = []  # per octave dicts of candidate arrays
    Gs = []  # per octave level stacks
    octave_img = base
    H0, W0 = base.shape
    for o in range(opts.num_octaves):
        H, W = octave_img.shape
        if H < 16 or W < 16:
            break
        # gaussian levels: sigma_s = sigma0 * 2^(s/S), s = 0..S+2
        levels = [octave_img]
        for s in range(1, S + 3):
            sig_prev = opts.sigma0 * 2 ** ((s - 1) / S)
            sig_cur = opts.sigma0 * 2 ** (s / S)
            dsig = float(np.sqrt(sig_cur**2 - sig_prev**2))
            levels.append(_blur(levels[-1], dsig))
        G = jnp.stack(levels)  # [S+3, H, W]
        dog = G[1:] - G[:-1]  # [S+2, H, W]

        score = _extrema_candidates(dog, opts)  # [S, H, W]
        Ko = opts.max_per_octave
        flat = score.reshape(-1)
        top, idx = jax.lax.top_k(flat, Ko)
        valid = top > 0
        s_idx = idx // (H * W)
        rem = idx % (H * W)
        yy = (rem // W).astype(jnp.float32)
        xx = (rem % W).astype(jnp.float32)

        # subpixel refinement via gathered 3D finite differences
        si = s_idx + 1  # index into dog
        yi = rem // W
        xi = rem % W

        def at(ds, dy, dx):
            return dog[
                jnp.clip(si + ds, 0, S + 1),
                jnp.clip(yi + dy, 0, H - 1),
                jnp.clip(xi + dx, 0, W - 1),
            ]

        v = at(0, 0, 0)
        gs = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
        gy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
        gx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
        hss = at(1, 0, 0) + at(-1, 0, 0) - 2 * v
        hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * v
        hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * v
        hsy = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))
        hsx = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
        hyx = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
        Hm = jnp.stack(
            [
                jnp.stack([hss, hsy, hsx], -1),
                jnp.stack([hsy, hyy, hyx], -1),
                jnp.stack([hsx, hyx, hxx], -1),
            ],
            -2,
        )  # [Ko,3,3]
        g = jnp.stack([gs, gy, gx], -1)
        Hm = Hm + jnp.eye(3) * 1e-6
        off = -jnp.linalg.solve(Hm, g[..., None])[..., 0]  # [Ko,3] (ds, dy, dx)
        off = jnp.clip(off, -1.0, 1.0)
        ds, dy, dx = off[:, 0], off[:, 1], off[:, 2]

        kx = xx + dx
        ky = yy + dy
        sfrac = s_idx.astype(jnp.float32) + 1.0 + ds  # dog level
        sigma_rel = opts.sigma0 * 2 ** (sfrac / S)  # at octave resolution

        # each keypoint's own gaussian level: sigma(G[s]) = sigma0 * 2^(s/S)
        # so the nearest level is round(sfrac)
        lidx = jnp.clip(jnp.round(sfrac).astype(jnp.int32), 0, S + 2)

        mul = scale0 * (2.0**o)
        n = kx.shape[0]
        cand.append(dict(
            score=jnp.where(valid, top, 0.0),
            kx=kx, ky=ky, sigma_rel=sigma_rel,
            lev=jnp.asarray(o * (S + 3), jnp.int32) + lidx,
            mul=jnp.full((n,), mul, jnp.float32),
            wlim=jnp.full((n,), W - 1, jnp.int32),
            hlim=jnp.full((n,), H - 1, jnp.int32),
            valid=valid,
        ))
        Gs.append(G)

        octave_img = _downsample2(G[S])  # next octave base: level S (2x sigma0)

    def cat(key):
        return jnp.concatenate([c[key] for c in cand])

    score = cat("score")
    K = opts.max_num_features
    top, idx = jax.lax.top_k(score, min(K, score.shape[0]))
    sel_valid = cat("valid")[idx] & (top > 0)
    kx = cat("kx")[idx]
    ky = cat("ky")[idx]
    sigma_rel = cat("sigma_rel")[idx]
    lev = cat("lev")[idx]
    mul = cat("mul")[idx]
    wh = (cat("wlim")[idx], cat("hlim")[idx])

    # all octaves' levels as one padded [O*(S+3), H0, W0] stack
    Gall = jnp.concatenate([
        jnp.pad(G, ((0, 0), (0, H0 - G.shape[1]), (0, W0 - G.shape[2])))
        for G in Gs
    ])
    ori, desc = _orientation_and_descriptor(
        Gall, kx, ky, sigma_rel, opts, lidx=lev, wh=wh
    )
    sel_kp = jnp.stack([kx * mul, ky * mul, sigma_rel * mul, ori], -1)

    if sel_kp.shape[0] < K:
        pad = K - sel_kp.shape[0]
        sel_kp = jnp.pad(sel_kp, ((0, pad), (0, 0)))
        desc = jnp.pad(desc, ((0, pad), (0, 0)))
        top = jnp.pad(top, (0, pad))
        sel_valid = jnp.pad(sel_valid, (0, pad))
    return sel_kp, desc, top, sel_valid


def extract_flops(H: int, W: int, opts: SiftOptions = SiftOptions()) -> float:
    """Analytic FLOP estimate for extract() on an HxW image (MFU accounting).

    Per octave at resolution h*w: (S+2) incremental blurs of 2 separable
    ~11-tap convs (2 flops/tap), DoG + 3x3x3 extrema pooling (~60/px),
    gradient stack (~10/px/level); per keypoint slot: orientation+descriptor
    sampling (2*256 bilinear gathers * ~10) + descriptor binning einsum
    (256*4*4*8*2).
    """
    S = opts.octave_resolution
    if opts.first_octave < 0:
        H, W = 2 * H, 2 * W
    px_total = 0.0
    h, w = H, W
    for _ in range(opts.num_octaves):
        if h < 16 or w < 16:
            break
        px_total += h * w
        h, w = h // 2, w // 2
    per_px = (S + 2) * (2 * 2 * 11) + 60 + (S + 3) * 10
    per_kp = 2 * 256 * 10 + 256 * 128 * 2
    return px_total * per_px + opts.num_octaves * opts.max_per_octave * per_kp


def descriptors_to_uint8(desc: Array) -> Array:
    """COLMAP convention: float descriptor * 512, clipped to [0,255]."""
    return jnp.clip(jnp.round(desc * 512.0), 0, 255).astype(jnp.uint8)
