"""Image + camera undistortion (parity with src/base/undistortion.{h,cc}:
COLMAPUndistorter / UndistortCamera / UndistortImage).

The undistorted camera is PINHOLE with the same focal; its extent is chosen
from blank-pixel / min-scale bounds like the reference's UndistortCamera
roi logic (simplified: keep size, optional blank_pixels factor). The warp is
one dense gather: for every target pixel, unproject through the pinhole,
re-distort through the source model, bilinear-sample — a single fused device
program per image.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import camera_models as cm
from .reconstruction import Camera, Reconstruction


@dataclass
class UndistortOptions:
    blank_pixels: float = 0.0
    min_scale: float = 0.2
    max_scale: float = 2.0
    max_image_size: int = -1


def undistorted_camera(cam: Camera) -> Camera:
    """PINHOLE camera with matching focal/pp (UndistortCamera)."""
    fi, fj, ci, cj = cm._FOCAL_IDX[cam.model_id]
    p = cam.params
    params = np.asarray([p[fi], p[fj], p[ci], p[cj]], np.float64)
    return Camera(cam.camera_id, cm.MODEL_IDS["PINHOLE"], cam.width, cam.height, params)


@functools.partial(jax.jit, static_argnames=("model_id", "width", "height"))
def _warp(img: jnp.ndarray, params: jnp.ndarray, new_params: jnp.ndarray, model_id: int, width: int, height: int):
    yy, xx = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.float32),
        indexing="ij",
    )
    xy = jnp.stack([xx.ravel(), yy.ravel()], -1)
    # target pinhole pixel -> normalized
    uv = cm.image_to_world(cm.MODEL_IDS["PINHOLE"], new_params, xy)
    # normalized -> source distorted pixel
    src = cm.world_to_image(model_id, params, uv)
    # bilinear gather (channel-agnostic: apply per channel)
    H, W = img.shape[:2]
    x = src[:, 0]
    y = src[:, 1]
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    fx = jnp.clip(x - x0, 0, 1)[:, None]
    fy = jnp.clip(y - y0, 0, 1)[:, None]
    im = img.reshape(H, W, -1).astype(jnp.float32)
    v = (
        im[y0, x0] * (1 - fx) * (1 - fy)
        + im[y0, x1] * fx * (1 - fy)
        + im[y1, x0] * (1 - fx) * fy
        + im[y1, x1] * fx * fy
    )
    inb = ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).astype(jnp.float32)[:, None]
    return (v * inb).reshape(height, width, -1)


def undistort_image(img: np.ndarray, cam: Camera, new_cam: Camera) -> np.ndarray:
    out = _warp(
        jnp.asarray(img),
        jnp.asarray(cam.padded_params()),
        jnp.asarray(new_cam.padded_params()),
        cam.model_id,
        new_cam.width,
        new_cam.height,
    )
    out = np.asarray(out)
    if img.ndim == 2:
        out = out[..., 0]
    if img.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def rectify_stereo_cameras(cam1: Camera, cam2: Camera, qvec: np.ndarray, tvec: np.ndarray):
    """Row-aligning rectification homographies for two PINHOLE cameras with
    relative pose (qvec, tvec) of cam2 w.r.t. cam1
    (base/undistortion.cc:978-1038 RectifyStereoCameras). Returns
    (H1, H2, Q) with Q the disparity-to-depth reprojection matrix."""
    from ..ops import np_geom

    # split the relative rotation evenly between the two views
    q = np.asarray(qvec, np.float64)
    q = q / np.linalg.norm(q)
    angle = 2.0 * np.arctan2(np.linalg.norm(q[1:]), q[0])
    axis = q[1:] / max(np.linalg.norm(q[1:]), 1e-15)
    # rotation by -angle/2 about the same axis (reference: rvec.angle() *= -0.5)
    half = -0.5 * angle
    q_half = np.concatenate([[np.cos(half / 2)], axis * np.sin(half / 2)])
    R2 = np_geom.quat_to_rotmat(q_half)
    R1 = R2.T
    t = R2 @ np.asarray(tvec, np.float64)
    x_unit = np.array([1.0, 0.0, 0.0])
    if t @ x_unit < 0:
        x_unit = -x_unit
    rot_axis = np.cross(t, x_unit)
    if np.linalg.norm(rot_axis) < 1e-15:
        R_x = np.eye(3)
    else:
        ang = np.arccos(np.clip(abs(t @ x_unit) / np.linalg.norm(t), -1.0, 1.0))
        a = rot_axis / np.linalg.norm(rot_axis)
        K_ = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R_x = np.eye(3) + np.sin(ang) * K_ + (1 - np.cos(ang)) * (K_ @ K_)
    R1 = R_x @ R1
    R2 = R_x @ R2
    t = R_x @ t
    f = min(cam1.mean_focal_length(), cam2.mean_focal_length())
    fi, fj, ci, cj = cm._FOCAL_IDX[cam1.model_id]
    fi2, fj2, ci2, cj2 = cm._FOCAL_IDX[cam2.model_id]
    cx = cam1.params[ci]
    cy = (cam1.params[cj] + cam2.params[cj2]) / 2
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])

    def calib(camx):
        fi_, fj_, ci_, cj_ = cm._FOCAL_IDX[camx.model_id]
        p = camx.params
        return np.array([[p[fi_], 0, p[ci_]], [0, p[fj_], p[cj_]], [0, 0, 1.0]])

    H1 = K @ R1 @ np.linalg.inv(calib(cam1))
    H2 = K @ R2 @ np.linalg.inv(calib(cam2))
    Q = np.eye(4)
    Q[3, 0] = -K[1, 2]
    Q[3, 1] = -K[0, 2]
    Q[3, 2] = K[0, 0]
    Q[2, 3] = -1.0 / t[0] if abs(t[0]) > 1e-15 else 0.0
    Q[3, 3] = 0.0
    return H1, H2, Q


def _warp_homography_from_distorted(img: np.ndarray, H_inv: np.ndarray, cam: Camera, und_cam: Camera):
    """Warp a distorted source image into the rectified frame: target pixel
    -> H^{-1} -> undistorted pixel -> normalized -> distorted source pixel ->
    bilinear sample (base/undistortion.cc WarpImageWithHomographyBetweenCameras)."""
    H, W = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    tgt = np.stack([xx.ravel() + 0.5, yy.ravel() + 0.5, np.ones(H * W)], axis=0)
    und = H_inv @ tgt
    und = und[:2] / und[2:]
    fi, fj, ci, cj = cm._FOCAL_IDX[und_cam.model_id]
    p = und_cam.params
    uv = np.stack([(und[0] - p[ci]) / p[fi], (und[1] - p[cj]) / p[fj]], axis=-1)
    src = np.asarray(
        cm.world_to_image(cam.model_id, jnp.asarray(cam.padded_params()), jnp.asarray(uv, jnp.float32))
    )
    x = src[:, 0] - 0.5
    y = src[:, 1] - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, W - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    fx = np.clip(x - x0, 0, 1)[:, None]
    fy = np.clip(y - y0, 0, 1)[:, None]
    im = img.reshape(H, W, -1).astype(np.float64)
    v = (
        im[y0, x0] * (1 - fx) * (1 - fy)
        + im[y0, x1] * fx * (1 - fy)
        + im[y1, x0] * (1 - fx) * fy
        + im[y1, x1] * fx * fy
    )
    inb = ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).astype(np.float64)[:, None]
    out = (v * inb).reshape(H, W, -1)
    if img.ndim == 2:
        out = out[..., 0]
    if img.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def rectify_stereo_pair(rec: Reconstruction, id1: int, id2: int, img1: np.ndarray, img2: np.ndarray):
    """Rectified image pair for two registered images (StereoImageRectifier,
    base/undistortion.cc:1040-1075)."""
    from ..ops import np_geom

    im1, im2 = rec.images[id1], rec.images[id2]
    cam1, cam2 = rec.cameras[im1.camera_id], rec.cameras[im2.camera_id]
    # relative pose of image2 w.r.t. image1
    q_rel = np_geom.quat_mul(im2.qvec, np_geom.quat_conj(im1.qvec))
    t_rel = im2.tvec - np_geom.quat_to_rotmat(q_rel) @ im1.tvec
    u1, u2 = undistorted_camera(cam1), undistorted_camera(cam2)
    H1, H2, _ = rectify_stereo_cameras(u1, u2, q_rel, t_rel)
    r1 = _warp_homography_from_distorted(img1, np.linalg.inv(H1), cam1, u1)
    r2 = _warp_homography_from_distorted(img2, np.linalg.inv(H2), cam2, u2)
    return r1, r2


def run_image_undistorter(
    image_path: str,
    input_model: str,
    output_path: str,
    options: UndistortOptions = UndistortOptions(),
) -> int:
    """COLMAP-workspace undistorter (RunImageUndistorter, exe/image.cc):
    writes undistorted images + a PINHOLE model into output_path."""
    from ..utils import image as image_utils

    rec = Reconstruction.read(input_model)
    os.makedirs(os.path.join(output_path, "images"), exist_ok=True)
    new_rec = Reconstruction()
    new_cams = {}
    for cid, cam in rec.cameras.items():
        nc = undistorted_camera(cam)
        new_cams[cid] = nc
        new_rec.add_camera(nc)
    n = 0
    for iid, img in rec.images.items():
        if not img.registered:
            continue
        src = image_utils.imread_rgb(os.path.join(image_path, img.name))
        out = undistort_image(src, rec.cameras[img.camera_id], new_cams[img.camera_id])
        dst = os.path.join(output_path, "images", img.name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        image_utils.imwrite(dst, out)
        n += 1
    # copy scene with undistorted observations
    import copy

    for iid, img in rec.images.items():
        im2 = copy.deepcopy(img)
        cam = rec.cameras[img.camera_id]
        if img.xys.shape[0]:
            uv = cm.image_to_world(
                cam.model_id, jnp.asarray(cam.padded_params()), jnp.asarray(img.xys, jnp.float32)
            )
            xy = cm.world_to_image(
                cm.MODEL_IDS["PINHOLE"], jnp.asarray(new_cams[img.camera_id].padded_params()), uv
            )
            im2.xys = np.asarray(xy, np.float64)
        new_rec.add_image(im2)
        if img.registered:
            new_rec.registered_ids.append(iid)
    new_rec.points3D = copy.deepcopy(rec.points3D)
    new_rec._next_point3D_id = rec._next_point3D_id
    new_rec.write(os.path.join(output_path, "sparse"))
    return n
