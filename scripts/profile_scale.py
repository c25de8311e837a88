#!/usr/bin/env python
"""Profile per-image registration cost growth at scale.

Runs the synthetic-keypoints mapping path at N images and prints the
per-image wall time curve plus the phase breakdown, so growth terms
(host loops / growing problem sizes) can be identified and fixed.

Usage: python scripts/profile_scale.py [n_images] [--cprofile]
(JAX_PLATFORMS=cpu profiles the host-side growth terms without a GPU.)
"""

import os
import sys
import time

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, "tests")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n_images = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    use_cprofile = "--cprofile" in sys.argv

    from synthetic import ate_rmse, make_world

    from colmap_pcd_tpu.models.controllers import (
        PHASES,
        ControllerOptions,
        IncrementalMapperController,
    )
    from colmap_pcd_tpu.models.incremental_mapper import MapperOptions

    rng = np.random.default_rng(11)
    t0 = time.time()
    rec, graph, lmap, gt = make_world(
        rng, n_images=n_images, n_points=int(1000 * max(1, n_images / 12)), noise_px=0.3
    )
    print(f"world built in {time.time()-t0:.1f}s: {len(rec.images)} images, "
          f"{sum(len(i.xys) for i in rec.images.values())} keypoints")

    opts = MapperOptions(
        if_add_lidar_constraint=True,
        init_image_id1=1,
        init_image_id2=2,
        abs_pose_min_num_inliers=15,
        init_min_num_inliers=50,
        num_ransac_hypotheses=2048,
    )
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=True),
        lidar_map=lmap, pose_priors={1: gt[0]},
    )

    prof = None
    if use_cprofile:
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
    t0 = time.time()
    ok = ctl.reconstruct()
    dt = time.time() - t0
    if prof is not None:
        prof.disable()
        import pstats
        pstats.Stats(prof).sort_stats("cumulative").print_stats(40)

    print(f"\nreconstruct: ok={ok} {rec.num_reg_images}/{n_images} images "
          f"in {dt:.1f}s = {rec.num_reg_images/dt:.3f} reg/s  "
          f"ate={ate_rmse(rec, gt):.4f} m")
    print("phase breakdown:\n" + PHASES.report())


if __name__ == "__main__":
    main()
