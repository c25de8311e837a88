#!/usr/bin/env python
"""End-to-end benchmark on the GPU: pixels -> SIFT -> matching ->
lidar-constrained incremental mapping, at the 100+ image regime.

The published Smith Hall / NSH datasets (450 images + lidar map) are not
fetchable in this zero-egress environment, so the workload mirrors their
structure: a prior lidar map with normals, pose-prior seeding of the first
image, and a forward trajectory — but with ray-cast rendered imagery of the
same world, so the FULL production path runs (SIFT extraction on device,
matmul descriptor matching, LORANSAC verification, PnP registration,
lidar-constrained local/spherical-global BA) with exact ground truth.

Headline metric: steady-state frames registered per second — the mean rate
over the SECOND HALF of the run, after one-time XLA compilations and bucket
growth have settled. Compiled programs persist in the compile cache
(utils/compile_cache.py), so repeat runs on the same machine start hot. The
JSON also carries the per-image rate curve so flatness at scale is checkable,
the phase breakdown, and an estimated MFU against the device's published
TF32 peak (utils/flops.py; a device with no published peak is an error, so
the bench fails without the GPU instead of timing the CPU).

vs_baseline: the reference publishes no numbers (BASELINE.md); the only
documented guidance is "a few minutes for tens of images" on CPU+CUDA
(doc/tutorial.rst:354), i.e. 25 images / 180 s ~= 0.139 frames/s. The
reference itself is unbuildable here (Ceres/PCL/Qt/CUDA deps, zero egress),
so this labeled derivation stands in for a measured baseline.

Prints ONE JSON line.
"""

import faulthandler
import json
import os
import signal
import sys
import tempfile
import time

# kill -USR1 <pid> dumps every thread's Python stack to stderr: the run is
# five cooperating threads, and this shows where a silent one is
faulthandler.register(signal.SIGUSR1, all_threads=True)

sys.path.insert(0, "tests")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REFERENCE_FPS = 25.0 / 180.0  # doc/tutorial.rst:354 ("few minutes for tens")
# BENCH_REF_SCALE=1 runs at the reference's default feature scale
# (sift.h:60,66: max_image_size 3200 / 8192 features — here image size is the
# render size, 1280x960, comfortably above the 640 light config) so the
# vs_baseline label is defensible at reference feature counts.
REF_SCALE = os.environ.get("BENCH_REF_SCALE", "0") != "0"
if REF_SCALE:
    W, H, F = 1280, 960, 1000.0
    MAX_FEATURES, N_OCTAVES = 8192, 4
else:
    W, H, F = 640, 480, 500.0
    MAX_FEATURES, N_OCTAVES = 2048, 3
PINHOLE = 1


def make_gt(n_images, step=0.8):
    from colmap_pcd_tpu.ops import np_geom

    gt = []
    for i in range(n_images):
        c = np.asarray([0.5 * np.sin(i * 0.6), 0.25 * np.cos(i * 0.4), i * step])
        yaw = 0.03 * np.sin(i * 0.9)
        q_wc = np.asarray([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        q_cw = np_geom.quat_conj(q_wc)
        t_cw = -np_geom.quat_to_rotmat(q_cw) @ c
        gt.append((q_cw, t_cw))
    return gt


def render_dataset(img_dir, gt, log):
    """Ray-cast the corridor world for every pose (threaded over images)."""
    from concurrent.futures import ThreadPoolExecutor

    from colmap_pcd_tpu.utils.image import write_png
    from render import render_corridor

    def one(i):
        q, t = gt[i]
        im = render_corridor(q, t, W, H, F)
        write_png(os.path.join(img_dir, f"v{i:04d}.png"), (im * 255).astype(np.uint8))

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(one, range(len(gt))))
    log(f"rendered {len(gt)} images in {time.time()-t0:.1f}s")


def main():
    from colmap_pcd_tpu.utils import compile_cache

    compile_cache.enable()
    n_images = int(os.environ.get("BENCH_N_IMAGES", "100"))
    step = 0.8
    verbose = os.environ.get("BENCH_VERBOSE", "1") != "0"

    def log(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    import jax

    from colmap_pcd_tpu.models.controllers import (
        PHASES,
        ControllerOptions,
        IncrementalMapperController,
    )
    from colmap_pcd_tpu.models.correspondence_graph import CorrespondenceGraph
    from colmap_pcd_tpu.models.database import Database
    from colmap_pcd_tpu.models.feature_pipeline import (
        run_feature_extractor,
        run_sequential_matcher,
    )
    from colmap_pcd_tpu.models.incremental_mapper import MapperOptions
    from colmap_pcd_tpu.models.lidar_map import LidarMap
    from colmap_pcd_tpu.models.reconstruction import Camera, Image, Reconstruction
    from colmap_pcd_tpu.ops import pointcloud as pc_ops
    from colmap_pcd_tpu.utils.config import SiftExtractionConfig, SiftMatchingConfig
    from colmap_pcd_tpu.utils.flops import FLOPS, peak_flops_per_s
    from synthetic import ate_rmse, build_corridor_map

    dev = jax.devices()[0]
    peak = peak_flops_per_s(dev)  # raises for a device with no published peak
    log(f"device: {dev.device_kind} ({dev.platform})")
    FLOPS.reset()

    # background-compile the recorded shape ladder while rendering/extraction
    # occupies the wall clock (utils/prewarm.py; kills the r2 mid-run stalls)
    from colmap_pcd_tpu.utils import prewarm

    prewarm.replay()

    gt = make_gt(n_images, step)
    tmp = tempfile.mkdtemp(prefix="bench_")
    img_dir = os.path.join(tmp, "imgs")
    os.makedirs(img_dir)
    render_dataset(img_dir, gt, log)

    overlapped = os.environ.get("BENCH_OVERLAP", "1") != "0"
    extract_cfg = SiftExtractionConfig(
        max_num_features=MAX_FEATURES, first_octave=0, num_octaves=N_OCTAVES,
        max_image_size=W,
    )
    match_cfg = SiftMatchingConfig(min_num_inliers=15)
    opts = MapperOptions(
        if_add_lidar_constraint=True,
        init_image_id1=1, init_image_id2=2,
        init_min_num_inliers=40,
        abs_pose_min_num_inliers=12,
        abs_pose_min_inlier_ratio=0.15,
        num_ransac_hypotheses=2048,
        filter_max_reproj_error=6.0,
    )

    wall_t0 = time.time()
    dbp = os.path.join(tmp, "db.db")
    feed = None
    if overlapped:
        # ---- overlapped: extraction + matching + mapping concurrently ----
        from colmap_pcd_tpu.models.overlap import run_overlapped_frontend

        feed, t_extract, t_match = run_overlapped_frontend(
            dbp, img_dir, extract_cfg, match_cfg, overlap=5, quadratic_overlap=False
        )
        rec = Reconstruction()
        rec.add_camera(Camera(1, PINHOLE, W, H, np.asarray([F, F, W / 2, H / 2])))
        graph = CorrespondenceGraph()
        # lidar map builds while extraction streams
        map_pts, map_nrm = build_corridor_map(
            np.random.default_rng(0), length=n_images * step + 25
        )
        lmap = LidarMap.from_arrays(map_pts, map_nrm, pc_ops.ProjOptions())
    else:
        t0 = time.time()
        run_feature_extractor(dbp, img_dir, extract_cfg)
        extract_s = time.time() - t0
        log(f"extraction: {n_images} images in {extract_s:.1f}s "
            f"({n_images/extract_s:.2f} img/s)")
        t0 = time.time()
        n_pairs = run_sequential_matcher(
            dbp, match_cfg, overlap=5, quadratic_overlap=False
        )
        match_s = time.time() - t0
        log(f"matching: {n_pairs} verified pairs in {match_s:.1f}s "
            f"({n_pairs/max(match_s,1e-9):.2f} pairs/s)")
        db = Database(dbp)
        rec = Reconstruction()
        rec.add_camera(Camera(1, PINHOLE, W, H, np.asarray([F, F, W / 2, H / 2])))
        for iid, im in sorted(db.images().items()):
            kp = db.read_keypoints(iid)
            rec.add_image(Image(iid, im["name"], 1, xys=kp[:, :2].astype(np.float64)))
        graph = CorrespondenceGraph()
        for i, j in db.all_two_view_pair_ids():
            g = db.read_two_view_geometry(i, j)
            if g is not None and len(g["inlier_matches"]) >= 15:
                graph.add_matches(i, j, g["inlier_matches"].astype(np.int32))
        db.close()
        map_pts, map_nrm = build_corridor_map(
            np.random.default_rng(0), length=n_images * step + 25
        )
        lmap = LidarMap.from_arrays(map_pts, map_nrm, pc_ops.ProjOptions())

    # ---- incremental mapping ----------------------------------------------
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=verbose, image_path=img_dir),
        lidar_map=lmap, pose_priors={1: gt[0]}, pair_feed=feed,
    )
    reg_times = []  # (num_reg_images, wall time since mapping start)
    map_t0 = [0.0]

    def on_reg(image_id):
        reg_times.append((rec.num_reg_images, time.time() - map_t0[0]))

    ctl.callbacks.append(on_reg)
    map_t0[0] = time.time()
    ok = ctl.reconstruct()
    map_s = time.time() - map_t0[0]
    wall_all = time.time() - wall_t0
    if overlapped:
        t_extract.join(timeout=60)
        t_match.join(timeout=60)
        extract_s = feed.extract_s or 1e-9
        match_s = feed.match_s or 1e-9
        n_pairs = feed.n_pairs_verified
        log(f"extraction thread: {n_images} images in {extract_s:.1f}s "
            f"({n_images/extract_s:.2f} img/s, overlapped)")
        busy = feed.match_busy_s or match_s
        log(f"matching thread: {n_pairs} verified pairs in {match_s:.1f}s wall "
            f"/ {busy:.1f}s busy ({n_pairs/max(busy,1e-9):.2f} pairs/s busy, "
            f"overlapped with extraction + mapping)")
    ate = ate_rmse(rec, gt) if ok else float("inf")
    # per-image error profile (drift diagnosis: where does ATE accumulate?)
    from colmap_pcd_tpu.ops import np_geom as _npg
    errs_i = []
    for i, (q, t) in enumerate(gt, start=1):
        img = rec.images.get(i)
        if img is not None and img.registered:
            e = float(np.linalg.norm(img.projection_center() - _npg.projection_center(q, t)))
            errs_i.append((i, e))
    if errs_i:
        es = np.asarray([e for _, e in errs_i])
        log(f"ATE profile: p50 {np.median(es)*1000:.1f} p90 "
            f"{np.percentile(es, 90)*1000:.1f} max {es.max()*1000:.1f} mm "
            f"(argmax image {errs_i[int(np.argmax(es))][0]})")
    log(f"mapping: {rec.num_reg_images}/{n_images} images in {map_s:.1f}s, "
        f"ATE {ate*1000:.1f} mm")
    log("phase breakdown:\n" + PHASES.report())

    # ---- rates ------------------------------------------------------------
    # steady = second half of registrations (compiles + bucket growth settled)
    n_reg = rec.num_reg_images
    curve = []
    if len(reg_times) >= 4:
        # rate over a sliding window of 10 registrations
        for k in range(1, len(reg_times)):
            k0 = max(0, k - 10)
            dn = reg_times[k][0] - reg_times[k0][0]
            dt = reg_times[k][1] - reg_times[k0][1]
            curve.append(round(dn / dt, 3) if dt > 0 else 0.0)
        mid = len(reg_times) // 2
        dn = reg_times[-1][0] - reg_times[mid][0]
        dt = reg_times[-1][1] - reg_times[mid][1]
        steady_fps = dn / dt if dt > 0 else 0.0
        dn1 = reg_times[mid][0] - reg_times[0][0]
        dt1 = reg_times[mid][1] - reg_times[0][1]
        first_half_fps = dn1 / dt1 if dt1 > 0 else 0.0
    else:
        steady_fps = n_reg / map_s if map_s > 0 else 0.0
        first_half_fps = steady_fps

    prewarm.save()  # journal this run's shape ladder for future prewarms
    mfu = FLOPS.total / max(wall_all, 1e-9) / peak
    log(f"model flops: {FLOPS.total/1e12:.3f} TF "
        f"({ {k: round(v/1e12,3) for k, v in FLOPS.by_tag.items()} }) "
        f"-> MFU {mfu*100:.4f}% of {peak/1e12:.0f} TF/s TF32 peak")

    print(json.dumps({
        "metric": "frames_registered_per_s",
        "value": round(steady_fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(steady_fps / REFERENCE_FPS, 2),
        "baseline_source": "doc/tutorial.rst:354 guidance 25 img/180 s (reference unbuildable here: zero egress, no Ceres/PCL/Qt)",
        "n_images": n_images,
        "registered": n_reg,
        "ate_m": round(ate, 4),
        "ate_profile_mm": {
            "p50": round(float(np.median(es)) * 1000, 1),
            "p90": round(float(np.percentile(es, 90)) * 1000, 1),
            "max": round(float(es.max()) * 1000, 1),
        } if errs_i else None,
        "err_curve_mm": [round(float(e) * 1000, 1) for _, e in errs_i[:: max(1, len(errs_i) // 40)]],
        "first_half_fps": round(first_half_fps, 4),
        "reg_s_curve": curve[:: max(1, len(curve) // 40)],
        "extract_img_per_s": round(n_images / extract_s, 3),
        "match_pairs_per_s": round(n_pairs / max(match_s, 1e-9), 3),
        "match_pairs_per_s_busy": round(
            n_pairs / max(getattr(feed, "match_busy_s", 0) or match_s, 1e-9), 3
        ) if feed is not None else round(n_pairs / max(match_s, 1e-9), 3),
        "match_wall_s": round(match_s, 2),
        "mapping_wall_s": round(map_s, 2),
        "e2e_wall_s": round(wall_all, 2),
        "mfu": round(mfu, 6),
        "model_tflops": round(FLOPS.total / 1e12, 3),
        "device": dev.device_kind,
        "feature_scale": {
            "max_num_features": MAX_FEATURES, "image_wh": [W, H],
            "ref_scale": REF_SCALE,
        },
    }))


if __name__ == "__main__":
    main()
