"""SIFT extractor tests: detection on known structure, shift covariance,
rotation invariance of descriptors (matched via the matmul matcher)."""

import jax.numpy as jnp
import numpy as np

from colmap_pcd_tpu.ops import matching, sift


def make_texture(rng, H=256, W=256, n_blobs=80):
    """Random blob texture with sharp-ish corners: good DoG food."""
    img = np.zeros((H, W), np.float32)
    ys = rng.integers(20, H - 20, n_blobs)
    xs = rng.integers(20, W - 20, n_blobs)
    amps = rng.uniform(0.3, 1.0, n_blobs)
    sig = rng.uniform(1.5, 4.0, n_blobs)
    yy, xx = np.mgrid[0:H, 0:W]
    for y, x, a, s in zip(ys, xs, amps, sig):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    img = img / img.max()
    return img.astype(np.float32)


OPTS = sift.SiftOptions(max_num_features=512, max_per_octave=512, first_octave=0, num_octaves=3)


def test_detects_blobs(rng):
    img = make_texture(rng)
    kp, desc, score, valid = sift.extract(jnp.asarray(img), OPTS)
    kp, valid = np.asarray(kp), np.asarray(valid)
    n = valid.sum()
    assert n >= 50, n
    # keypoints inside the image
    assert (kp[valid][:, 0] >= 0).all() and (kp[valid][:, 0] < 256).all()
    # descriptors normalized-ish (l1_root -> unit L2 of sqrt'd vector)
    d = np.asarray(desc)[valid]
    norms = np.linalg.norm(d, axis=1)
    assert np.all(norms < 1.5) and np.median(norms) > 0.5


def test_shift_covariance(rng):
    img = make_texture(rng)
    shift = 16
    img2 = np.roll(img, (shift, shift), axis=(0, 1))
    kp1, d1, s1, v1 = (np.asarray(a) for a in sift.extract(jnp.asarray(img), OPTS))
    kp2, d2, s2, v2 = (np.asarray(a) for a in sift.extract(jnp.asarray(img2), OPTS))
    idx, ok, _ = matching.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(v1, jnp.float32), jnp.asarray(v2, jnp.float32),
        matching.MatchingOptions(max_ratio=0.8, cross_check=True),
    )
    idx, ok = np.asarray(idx), np.asarray(ok)
    assert ok.sum() >= 30, ok.sum()
    dxy = kp2[idx[ok], :2] - kp1[ok, :2]
    err = np.abs(dxy - shift)
    frac_good = (err.max(axis=1) < 1.5).mean()
    assert frac_good > 0.8, frac_good


def test_rotation_matching(rng):
    """90-degree rotation: descriptors must still match via orientation
    normalization (exact rotation so no resampling blur)."""
    img = make_texture(rng)
    img2 = np.rot90(img).copy()
    kp1, d1, s1, v1 = (np.asarray(a) for a in sift.extract(jnp.asarray(img), OPTS))
    kp2, d2, s2, v2 = (np.asarray(a) for a in sift.extract(jnp.asarray(img2), OPTS))
    idx, ok, _ = matching.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(v1, jnp.float32), jnp.asarray(v2, jnp.float32),
        matching.MatchingOptions(max_ratio=0.85, cross_check=True),
    )
    idx, ok = np.asarray(idx), np.asarray(ok)
    assert ok.sum() >= 20, ok.sum()
    # verify matched positions against the known rotation:
    # np.rot90: img2[y2, x2] = img[x2, W-1-y2] => x1 = W-1-y2... check mapping
    H, W = img.shape
    x1, y1 = kp1[ok, 0], kp1[ok, 1]
    x2, y2 = kp2[idx[ok], 0], kp2[idx[ok], 1]
    # rot90 counter-clockwise: new[i, j] = old[j, H_new-1-i] with H_new = W
    pred_x2 = y1
    pred_y2 = W - 1 - x1
    err = np.hypot(x2 - pred_x2, y2 - pred_y2)
    assert (err < 2.0).mean() > 0.7, (err[:10], (err < 2.0).mean())


def test_uint8_roundtrip(rng):
    img = make_texture(rng)
    _, d1, _, v1 = sift.extract(jnp.asarray(img), OPTS)
    u8 = sift.descriptors_to_uint8(d1)
    assert u8.dtype == jnp.uint8
    d1n = matching.normalize_descriptors(u8)
    # uint8 quantization keeps descriptors matchable with themselves
    idx, ok, _ = matching.match_descriptors(
        d1n, matching.normalize_descriptors(jnp.asarray(d1) * 512),
        jnp.asarray(np.asarray(v1), jnp.float32), jnp.asarray(np.asarray(v1), jnp.float32),
    )
    ok = np.asarray(ok)
    idx = np.asarray(idx)
    v = np.asarray(v1)
    agree = (idx[v & ok] == np.nonzero(v & ok)[0]).mean()
    assert agree > 0.95


def test_dsp_sift_descriptors(rng):
    """DSP-SIFT (sift.h:102-113): domain-size-pooled descriptors are valid,
    normalized, and still match the plain descriptors' keypoints."""
    import jax.numpy as jnp

    from colmap_pcd_tpu.ops import sift as sift_ops

    img = make_texture(rng, H=128, W=128, n_blobs=40)
    base = sift_ops.SiftOptions(
        max_num_features=256, num_octaves=2, first_octave=0, max_per_octave=256
    )
    dsp = base._replace(domain_size_pooling=True, dsp_num_scales=5)
    kp1, d1, s1, v1 = sift_ops.extract(jnp.asarray(img), base)
    kp2, d2, s2, v2 = sift_ops.extract(jnp.asarray(img), dsp)
    v2 = np.asarray(v2)
    assert v2.sum() > 10
    # keypoints identical (pooling only changes descriptors)
    np.testing.assert_allclose(np.asarray(kp1)[v2], np.asarray(kp2)[v2], atol=1e-5)
    d2 = np.asarray(d2)[v2]
    # L1-root normalization: squared descriptors sum to ~1
    np.testing.assert_allclose((d2**2).sum(-1), 1.0, atol=1e-3)
    # pooled differs from single-scale
    assert np.abs(d2 - np.asarray(d1)[v2]).max() > 1e-3


def test_affine_shape_extraction():
    """estimate_affine_shape (sift.h:98-100): adaptation must keep the
    pipeline working and remain near-identity on isotropic texture, while
    still matching across views."""
    import jax.numpy as jnp

    from render import render_corridor
    from colmap_pcd_tpu.ops import matching

    q = np.asarray([1.0, 0, 0, 0])
    t = np.zeros(3)
    img1 = render_corridor(q, t, 320, 240, 260.0)
    img2 = render_corridor(q, np.asarray([0.0, 0, -0.4]), 320, 240, 260.0)
    opts = sift.SiftOptions(
        max_num_features=512, first_octave=0, num_octaves=3,
        estimate_affine_shape=True,
    )
    kp1, d1, s1, v1 = sift.extract(jnp.asarray(img1), opts)
    kp2, d2, s2, v2 = sift.extract(jnp.asarray(img2), opts)
    assert int(np.asarray(v1).sum()) > 100
    idx, ok, _ = matching.match_descriptors(
        matching.normalize_descriptors(d1), matching.normalize_descriptors(d2),
        jnp.asarray(np.asarray(v1), jnp.float32).astype(jnp.float32),
        jnp.asarray(np.asarray(v2), jnp.float32).astype(jnp.float32),
    )
    n = int(np.asarray(ok).sum())
    assert n > 40, n
