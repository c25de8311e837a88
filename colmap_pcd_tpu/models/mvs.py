"""Dense reconstruction pipeline: per-view plane-sweep stereo + fusion.

Parity with src/mvs/patch_match.{h,cc} (PatchMatchController — per-reference
problem scheduling) and src/mvs/fusion.{h,cc} (StereoFusion): operates on an
undistorted workspace (models/undistortion.py output), computes depth/normal
maps per registered view with ops/stereo.plane_sweep, filters by multi-view
geometric + photometric consistency, and fuses into a colored point cloud
with normals (fused.ply). Poisson/Delaunay meshing of the fused cloud is out
of scope for v1 (SURVEY.md §2.9 — lib/PoissonRecon / CGAL territory).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..io import ply as ply_io
from ..ops import stereo as stereo_ops
from ..utils import image as image_utils
from .reconstruction import Reconstruction


@dataclass
class DenseOptions:
    max_image_size: int = 640
    num_depths: int = 64
    num_src_images: int = 4
    window_radius: int = 3
    min_consistent: int = 2
    depth_min: float = 0.0  # 0 = auto from sparse points
    depth_max: float = 0.0
    # Bilaterally weighted NCC (patch_match.h:81-83); <=0 disables.
    sigma_color: float = 0.2
    sigma_spatial: float = -1.0
    # Two-pass stereo with a geometric-consistency term in the second pass
    # (patch_match.h:101-111, PatchMatchController's geom-consistent rerun).
    geom_consistency: bool = True


def _pose(img):
    return np.asarray(img.qvec, np.float32), np.asarray(img.tvec, np.float32)


def _K_of(cam, scale):
    from ..ops import camera_models as cm

    fi, fj, ci, cj = cm._FOCAL_IDX[cam.model_id]
    p = cam.params
    return np.asarray(
        [[p[fi] * scale, 0, p[ci] * scale], [0, p[fj] * scale, p[cj] * scale], [0, 0, 1]],
        np.float32,
    )


def _select_sources(rec: Reconstruction, ref_id: int, n: int) -> list[int]:
    """Source views by shared-point covisibility (patch_match.cc source
    selection via sparse model)."""
    ref = rec.images[ref_id]
    shared: dict[int, int] = {}
    for pid in ref.point3D_ids[ref.point3D_ids >= 0]:
        p = rec.points3D.get(int(pid))
        if p is None:
            continue
        for iid, _ in p.track:
            if iid != ref_id:
                shared[iid] = shared.get(iid, 0) + 1
    ranked = sorted(shared.items(), key=lambda kv: -kv[1])
    return [i for i, _ in ranked[:n]]


def _depth_range(rec: Reconstruction, ref_id: int) -> tuple[float, float]:
    """Depth bounds from the sparse points visible in the view
    (patch_match.cc depth_min/max from sparse model)."""
    from ..ops import np_geom

    img = rec.images[ref_id]
    q, t = _pose(img)
    zs = []
    for pid in img.point3D_ids[img.point3D_ids >= 0]:
        p = rec.points3D.get(int(pid))
        if p is None:
            continue
        z = float(np_geom.se3_apply(q, t, p.xyz)[2])
        if z > 0:
            zs.append(z)
    if not zs:
        return 0.5, 50.0
    zs = np.asarray(zs)
    return float(np.percentile(zs, 2) * 0.8), float(np.percentile(zs, 98) * 1.25)


def run_patch_match_stereo(
    workspace: str,
    options: DenseOptions = DenseOptions(),
    rec: Reconstruction | None = None,
    images: dict[int, np.ndarray] | None = None,
    mesh=None,
) -> int:
    """Compute depth/normal maps for every registered view.

    workspace/sparse = undistorted model; workspace/images = undistorted
    images (run_image_undistorter layout). Writes workspace/stereo/
    {depth_maps,normal_maps,consistency}/<name>.npy.
    """
    if rec is None:
        rec = Reconstruction.read(os.path.join(workspace, "sparse"))
    sdir = os.path.join(workspace, "stereo")
    for d in ("depth_maps", "normal_maps", "cost_maps"):
        os.makedirs(os.path.join(sdir, d), exist_ok=True)

    def load_image(iid):
        if images is not None:
            img = images[iid]
        else:
            img = image_utils.imread_gray(
                os.path.join(workspace, "images", rec.images[iid].name)
            )
        img, scale = image_utils.resize_max(img, options.max_image_size)
        return img.astype(np.float32), scale

    sopts = stereo_ops.StereoOptions(
        num_depths=options.num_depths,
        window_radius=options.window_radius,
        min_consistent=options.min_consistent,
        sigma_color=options.sigma_color,
        sigma_spatial=options.sigma_spatial,
    )

    def view_problem(ref_id):
        """Assemble the static-shape per-reference problem arrays."""
        srcs = _select_sources(rec, ref_id, options.num_src_images)
        if len(srcs) < 1:
            return None
        ref_img, scale = load_image(ref_id)
        q_r, t_r = _pose(rec.images[ref_id])
        K_ref = _K_of(rec.cameras[rec.images[ref_id].camera_id], scale)
        src_imgs, K_srcs, R_rels, t_rels = [], [], [], []
        for sid in srcs:
            s_img, s_scale = load_image(sid)
            # pad/crop source to the same static shape as ref
            s_pad = np.zeros_like(ref_img)
            h = min(s_pad.shape[0], s_img.shape[0])
            w = min(s_pad.shape[1], s_img.shape[1])
            s_pad[:h, :w] = s_img[:h, :w]
            src_imgs.append(s_pad)
            from ..ops import np_geom

            q_s, t_s = _pose(rec.images[sid])
            # relative: x_src = R_rel x_ref + t_rel
            q_rel, t_rel = np_geom.se3_compose(q_s, t_s, *np_geom.se3_inverse(q_r, t_r))
            R_rels.append(np_geom.quat_to_rotmat(q_rel).astype(np.float32))
            t_rels.append(np.asarray(t_rel, np.float32))
            K_srcs.append(_K_of(rec.cameras[rec.images[sid].camera_id], s_scale))
        dmin, dmax = (options.depth_min, options.depth_max)
        if dmin <= 0 or dmax <= 0:
            dmin, dmax = _depth_range(rec, ref_id)
        # inverse-depth spacing
        depths = 1.0 / np.linspace(1.0 / dmax, 1.0 / dmin, options.num_depths)
        return (
            srcs,
            jnp.asarray(ref_img),
            jnp.asarray(np.stack(src_imgs)),
            jnp.asarray(K_ref),
            jnp.asarray(np.stack(K_srcs)),
            jnp.asarray(np.stack(R_rels)),
            jnp.asarray(np.stack(t_rels)),
            jnp.asarray(depths.astype(np.float32)),
        )

    def save_maps(ref_id, depth, cost, normal):
        name = rec.images[ref_id].name.replace("/", "_")
        np.save(os.path.join(sdir, "depth_maps", name + ".npy"), np.asarray(depth))
        np.save(os.path.join(sdir, "normal_maps", name + ".npy"), np.asarray(normal))
        np.save(os.path.join(sdir, "cost_maps", name + ".npy"), np.asarray(cost))

    problems = {}
    for ref_id in rec.registered_ids:
        prob = view_problem(ref_id)
        if prob is not None:
            problems[ref_id] = prob

    def geom_src_depths(prob, photo_depth):
        """Pad sources' pass-1 depth maps to the ref's static shape."""
        srcs = prob[0]
        ref_shape = prob[1].shape
        sd = []
        for sid in srcs:
            d = photo_depth.get(sid)
            if d is None:
                sd.append(jnp.zeros(ref_shape, jnp.float32))
                continue
            d_pad = np.zeros(ref_shape, np.float32)
            h = min(ref_shape[0], d.shape[0])
            w = min(ref_shape[1], d.shape[1])
            d_pad[:h, :w] = np.asarray(d)[:h, :w]
            sd.append(jnp.asarray(d_pad))
        return jnp.stack(sd)

    shapes = {p[1].shape for p in problems.values()}
    if mesh is not None and len(problems) > 0 and len(shapes) == 1:
        _run_patch_match_sharded(problems, sopts, options, save_maps, mesh)
        return len(problems)

    # pass 1: photometric-only sweeps (the reference's non-geom first run)
    photo_depth = {}
    for ref_id, prob in problems.items():
        depth, cost, normal = stereo_ops.plane_sweep(*prob[1:], sopts)
        photo_depth[ref_id] = depth
        save_maps(ref_id, depth, cost, normal)

    # pass 2: rerun with the geometric-consistency term against the sources'
    # pass-1 depth maps (PatchMatchController geom-consistent rerun)
    if options.geom_consistency:
        for ref_id, prob in problems.items():
            depth, cost, normal = stereo_ops.plane_sweep(
                *prob[1:], sopts,
                src_depths=geom_src_depths(prob, photo_depth), use_geom=True,
            )
            save_maps(ref_id, depth, cost, normal)
    return len(problems)


def _run_patch_match_sharded(problems, sopts, options, save_maps, mesh):
    """Fan the per-view sweeps out over the device mesh (the analog of
    PatchMatchController's ThreadPool-over-GPUs, patch_match.cc:197-213).

    Problems are stacked into one batch: S padded to the max source count by
    repeating the last source, B padded to a mesh multiple by repeating the
    last problem.
    """
    from ..parallel import dist_mvs

    ids = list(problems.keys())
    ref_shape = problems[ids[0]][1].shape
    S = max(p[2].shape[0] for p in problems.values())
    n = mesh.devices.size

    def pad_S(a, s_axis=0):
        a = np.asarray(a)
        k = S - a.shape[s_axis]
        if k <= 0:
            return a
        rep = np.repeat(np.take(a, [-1], axis=s_axis), k, axis=s_axis)
        return np.concatenate([a, rep], axis=s_axis)

    refs = np.stack([np.asarray(problems[i][1]) for i in ids])
    srcs = np.stack([pad_S(problems[i][2]) for i in ids])
    K_ref = np.stack([np.asarray(problems[i][3]) for i in ids])
    K_srcs = np.stack([pad_S(problems[i][4]) for i in ids])
    R_rel = np.stack([pad_S(problems[i][5]) for i in ids])
    t_rel = np.stack([pad_S(problems[i][6]) for i in ids])
    depths = np.stack([np.asarray(problems[i][7]) for i in ids])

    B = len(ids)
    Bp = ((B + n - 1) // n) * n
    def pad_B(a):
        if Bp == B:
            return a
        return np.concatenate([a, np.repeat(a[-1:], Bp - B, axis=0)])
    batch = tuple(map(pad_B, (refs, srcs, K_ref, K_srcs, R_rel, t_rel, depths)))

    depth_b, cost_b, normal_b = dist_mvs.plane_sweep_batch(
        *map(jnp.asarray, batch), sopts, mesh=mesh
    )
    depth_b = np.asarray(depth_b)

    if options.geom_consistency:
        # sources' pass-1 depth maps, padded like the sources themselves
        photo = {i: depth_b[k] for k, i in enumerate(ids)}
        sd = []
        for i in ids:
            srcs_i = problems[i][0]
            maps = [photo.get(s, np.zeros(ref_shape, np.float32)) for s in srcs_i]
            while len(maps) < S:
                maps.append(maps[-1])
            sd.append(np.stack(maps))
        sd = pad_B(np.stack(sd))
        depth_b, cost_b, normal_b = dist_mvs.plane_sweep_batch(
            *map(jnp.asarray, batch), sopts, mesh=mesh,
            src_depths=jnp.asarray(sd), use_geom=True,
        )
        depth_b = np.asarray(depth_b)

    cost_b = np.asarray(cost_b)
    normal_b = np.asarray(normal_b)
    for k, i in enumerate(ids):
        save_maps(i, depth_b[k], cost_b[k], normal_b[k])


def run_stereo_fusion(
    workspace: str,
    output_path: str | None = None,
    options: DenseOptions = DenseOptions(),
    rec: Reconstruction | None = None,
    images: dict[int, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse per-view depth maps into a consistent colored cloud with normals.
    Returns (points [N,3], normals [N,3], colors [N,3]); writes fused.ply."""
    if rec is None:
        rec = Reconstruction.read(os.path.join(workspace, "sparse"))
    sdir = os.path.join(workspace, "stereo")
    sopts = stereo_ops.StereoOptions(min_consistent=options.min_consistent)

    maps = {}
    for ref_id in rec.registered_ids:
        name = rec.images[ref_id].name.replace("/", "_")
        dp = os.path.join(sdir, "depth_maps", name + ".npy")
        if os.path.exists(dp):
            maps[ref_id] = (
                np.load(dp),
                np.load(os.path.join(sdir, "normal_maps", name + ".npy")),
                np.load(os.path.join(sdir, "cost_maps", name + ".npy")),
            )
    all_pts, all_nrm, all_col = [], [], []
    ids = list(maps.keys())
    for ref_id in ids:
        depth, normal, cost = maps[ref_id]
        H, W = depth.shape
        others = [i for i in ids if i != ref_id][:4]
        if not others:
            continue
        from ..ops import np_geom

        q_r, t_r = _pose(rec.images[ref_id])
        scale = 1.0
        if images is not None:
            img0 = images[ref_id]
            scale = W / img0.shape[1]
        K = _K_of(rec.cameras[rec.images[ref_id].camera_id], scale)
        R_os, t_os, d_os = [], [], []
        for oid in others:
            q_o, t_o = _pose(rec.images[oid])
            q_rel, t_rel = np_geom.se3_compose(q_o, t_o, *np_geom.se3_inverse(q_r, t_r))
            R_os.append(np_geom.quat_to_rotmat(q_rel).astype(np.float32))
            t_os.append(np.asarray(t_rel, np.float32))
            do = maps[oid][0]
            dfix = np.zeros((H, W), np.float32)
            h = min(H, do.shape[0])
            w = min(W, do.shape[1])
            dfix[:h, :w] = do[:h, :w]
            d_os.append(dfix)
        mask = np.asarray(
            stereo_ops.consistency_mask(
                jnp.asarray(depth), jnp.asarray(cost),
                jnp.asarray(np.stack(d_os)), jnp.asarray(K),
                jnp.asarray(np.stack(R_os)), jnp.asarray(np.stack(t_os)), sopts,
            )
        )
        ys, xs = np.nonzero(mask)
        if ys.size == 0:
            continue
        z = depth[ys, xs]
        Kinv = np.linalg.inv(K)
        pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32)
        x_cam = (pix @ Kinv.T) * z[:, None]
        qi, ti = np_geom.se3_inverse(q_r, t_r)
        x_w = np_geom.quat_rotate(qi, x_cam) + np_geom.projection_center(q_r, t_r)
        n_w = np_geom.quat_rotate(qi, normal[ys, xs])
        if images is not None:
            img0 = images[ref_id]
            g = (np.clip(img0[np.minimum((ys / scale).astype(int), img0.shape[0] - 1), np.minimum((xs / scale).astype(int), img0.shape[1] - 1)] * 255, 0, 255)).astype(np.uint8)
            col = np.stack([g, g, g], -1)
        else:
            col = np.full((ys.size, 3), 128, np.uint8)
        all_pts.append(x_w)
        all_nrm.append(n_w)
        all_col.append(col)
    if not all_pts:
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    pts = np.concatenate(all_pts)
    nrm = np.concatenate(all_nrm)
    col = np.concatenate(all_col)
    out = output_path or os.path.join(workspace, "fused.ply")
    ply_io.write_ply(out, pts, nrm, col)
    return pts, nrm, col
