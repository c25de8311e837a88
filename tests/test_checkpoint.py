"""Checkpoint/resume parity (SURVEY §5.4): snapshots, resume-from-model with
fixed existing poses, pose.ply round-trip, GPS conversions."""

import os

import numpy as np

from colmap_pcd_tpu.models.controllers import ControllerOptions, IncrementalMapperController
from colmap_pcd_tpu.models.incremental_mapper import MapperOptions
from colmap_pcd_tpu.models.reconstruction import (
    Reconstruction,
    load_image_poses,
    save_image_poses,
)

from synthetic import ate_rmse, make_world


def test_pose_ply_roundtrip(rng, tmp_path):
    rec, graph, lmap, gt = make_world(rng, n_images=5, n_points=200)
    for i, (q, t) in enumerate(gt, 1):
        rec.images[i].qvec = q
        rec.images[i].tvec = t
        if i != 3:  # leave one unregistered -> nan row
            rec.register_image(i)
    path = str(tmp_path / "pose_test.ply")
    save_image_poses(path, rec)
    loaded = load_image_poses(path)
    assert 3 not in loaded  # nan row skipped
    for i in (1, 2, 4, 5):
        q, t = loaded[i]
        from colmap_pcd_tpu.ops import np_geom

        assert float(np_geom.angle_between(q, gt[i - 1][0])) < 1e-3
        np.testing.assert_allclose(t, gt[i - 1][1], atol=1e-3)


def test_pose_ply_reference_convention(tmp_path):
    """A pose.ply row must import with the REFERENCE's convention
    (LoadPose, controllers/incremental_mapper.cc:953-976): R_wc =
    Ry(-yaw)Rx(-pitch)Rz(roll) in radians — exactly what
    init_pose_from_options implements for the init flags."""
    import math

    from colmap_pcd_tpu.models.incremental_mapper import IncrementalMapper, MapperOptions
    from colmap_pcd_tpu.ops import np_geom

    x, y, z = 1.5, -0.7, 0.3
    roll, pitch, yaw = 0.1, -0.25, 0.8  # radians
    path = str(tmp_path / "pose.ply")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 1\n")
        for prop in ("x", "y", "z", "roll", "pitch", "yaw"):
            f.write(f"property float {prop}\n")
        f.write("end_header\n")
        f.write(f"{x} {y} {z} {roll} {pitch} {yaw}\n")
    q, t = load_image_poses(path)[1]

    # emulate the reference LoadPose math independently
    def rot(axis, a):
        c, s = math.cos(a), math.sin(a)
        if axis == "x":
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == "y":
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R_wc = rot("y", -yaw) @ rot("x", -pitch) @ rot("z", roll)
    t_wc = np.array([-y, -z, x])
    R_cw = R_wc.T
    np.testing.assert_allclose(np_geom.quat_to_rotmat(q), R_cw, atol=1e-9)
    np.testing.assert_allclose(t, -R_cw @ t_wc, atol=1e-9)

    # init flags with the same (degree-converted) values give the same pose
    opts = MapperOptions(
        init_image_x=x, init_image_y=y, init_image_z=z,
        init_image_roll=math.degrees(roll),
        init_image_pitch=math.degrees(pitch),
        init_image_yaw=math.degrees(yaw),
    )
    rec = Reconstruction()
    mapper = IncrementalMapper.__new__(IncrementalMapper)
    q2, t2 = IncrementalMapper.init_pose_from_options(mapper, opts)
    assert float(np_geom.angle_between(q, q2)) < 1e-6
    np.testing.assert_allclose(t, t2, atol=1e-9)

    # save -> load round-trip preserves the pose exactly
    x2, y2, z2, r2, p2, yw2 = np_geom.cam_pose_to_lidar(q, t)
    q3, t3 = np_geom.lidar_pose_to_cam(x2, y2, z2, r2, p2, yw2)
    assert float(np_geom.angle_between(q, q3)) < 1e-9
    np.testing.assert_allclose(t, t3, atol=1e-9)


def test_snapshot_and_resume(rng, tmp_path):
    """Reconstruct partially, write the model, reload it, and continue
    (mapper --input_path semantics)."""
    rec, graph, lmap, gt = make_world(rng, n_images=8, n_points=600, noise_px=0.3)
    opts = MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
        abs_pose_min_num_inliers=15, init_min_num_inliers=50,
        num_ransac_hypotheses=1024,
    )
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=False),
        lidar_map=lmap, pose_priors={1: gt[0]},
    )
    assert ctl.initialize()
    # register two more images then snapshot
    for _ in range(2):
        nxt = ctl.mapper.find_next_images(opts)
        assert nxt
        assert ctl.mapper.register_next_image(opts, nxt[0])
        from colmap_pcd_tpu.models.triangulator import TriangulatorOptions

        ctl.mapper.triangulator.triangulate_image(TriangulatorOptions(), nxt[0])
        ctl.iterative_local_refinement(nxt[0])
    snap = str(tmp_path / "snap")
    rec.write(snap)
    n_before = rec.num_reg_images
    assert n_before >= 4

    # resume: fresh reconstruction from the snapshot + the same graph
    rec2 = Reconstruction.read(snap)
    # re-attach unregistered images (snapshot stores registered only)
    for iid, img in rec.images.items():
        if iid not in rec2.images:
            img2 = type(img)(iid, img.name, img.camera_id, xys=img.xys.copy())
            rec2.add_image(img2)
        else:
            rec2.images[iid].xys = img.xys.copy()
    ctl2 = IncrementalMapperController(
        rec2, graph, opts, ControllerOptions(verbose=False),
        lidar_map=lmap, pose_priors={1: gt[0]},
    )
    ok = ctl2.reconstruct()
    assert ok
    assert rec2.num_reg_images > n_before
    assert ate_rmse(rec2, gt) < 0.12


def test_gps_conversions():
    from colmap_pcd_tpu.utils.gps import lla_to_ecef, lla_to_enu

    # equator/prime meridian sanity
    ecef = lla_to_ecef(0.0, 0.0, 0.0)
    np.testing.assert_allclose(ecef, [6378137.0, 0, 0], atol=1e-3)
    # small northward offset ~ 111m per 0.001 degree latitude
    enu = lla_to_enu(0.001, 0.0, 0.0, 0.0, 0.0, 0.0)
    assert abs(enu[1] - 110.57) < 1.0, enu
    assert abs(enu[0]) < 1e-6
    # eastward
    enu = lla_to_enu(0.0, 0.001, 0.0, 0.0, 0.0, 0.0)
    assert abs(enu[0] - 111.3) < 1.0, enu
    # up
    enu = lla_to_enu(0.0, 0.0, 5.0, 0.0, 0.0, 0.0)
    np.testing.assert_allclose(enu[2], 5.0, atol=1e-6)
