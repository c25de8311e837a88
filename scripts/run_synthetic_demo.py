#!/usr/bin/env python
"""End-to-end demo on the synthetic corridor world: sparse lidar-constrained
mapping -> model export (+ pose.ply) -> analysis. Mirrors the Smith Hall
quick-start flow of the reference on generated data (no dataset egress here).

Usage: python scripts/run_synthetic_demo.py [out_dir] [n_images]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))

import numpy as np


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="colmap_pcd_demo_")
    n_images = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    os.makedirs(out, exist_ok=True)

    from synthetic import ate_rmse, make_world

    from colmap_pcd_tpu.io import ply as ply_io
    from colmap_pcd_tpu.models.controllers import (
        ControllerOptions,
        IncrementalMapperController,
    )
    from colmap_pcd_tpu.models.incremental_mapper import MapperOptions
    from colmap_pcd_tpu.models.reconstruction import save_image_poses

    rng = np.random.default_rng(7)
    rec, graph, lmap, gt = make_world(rng, n_images=n_images, n_points=800)
    ply_io.write_ply(os.path.join(out, "map.ply"), lmap.points, lmap.normals)

    opts = MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
        abs_pose_min_num_inliers=15, init_min_num_inliers=50,
        num_ransac_hypotheses=2048,
    )
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=True),
        lidar_map=lmap, pose_priors={1: gt[0]},
    )
    t0 = time.time()
    ctl.reconstruct()
    dt = time.time() - t0

    model_dir = os.path.join(out, "sparse", "0")
    rec.write(model_dir)
    save_image_poses(os.path.join(out, "pose.ply"), rec)
    ate = ate_rmse(rec, gt)
    print(f"\nregistered {rec.num_reg_images}/{n_images} images in {dt:.1f}s "
          f"({rec.num_reg_images/dt:.2f} frames/s)")
    print(f"points3D: {len(rec.points3D)}, mean track {rec.mean_track_length():.2f}")
    print(f"ATE vs ground truth: {ate*100:.2f} cm")
    print(f"model: {model_dir}  poses: {out}/pose.ply")


if __name__ == "__main__":
    main()
