"""Multi-device scaling curves on the virtual device mesh.

Times the three distributed kernels — dist_matching (pair-sharded descriptor
matching), dist_ba (point-sharded Schur BA, camera system psum-reduced), and
dist_mvs (view-sharded plane sweeps) — at n ∈ {1,2,4,8} devices with a FIXED
total workload, and prints the wall-clock table as one JSON line.

The mesh is XLA's virtual host-platform device mesh
(xla_force_host_platform_device_count), so "devices" are host threads and
wall-clock speedup is capped by the host's physical cores. The curve shows
that the sharded programs compile, execute, and scale work-per-device down;
it is not a measurement of any accelerator.

Usage: python scripts/multichip_scaling.py
"""

import json
import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

jax.config.update("jax_default_device", jax.devices("cpu")[0])

from colmap_pcd_tpu.ops import ba as ba_ops
from colmap_pcd_tpu.ops import camera_models as cm
from colmap_pcd_tpu.parallel import dist_ba, dist_matching, dist_mvs
from colmap_pcd_tpu.parallel import mesh as mesh_lib

REPS = 3


def _time(fn):
    fn()  # warm-up / compile
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _matching_workload():
    """64 images of 1024x128 descriptors, 64 sequential overlap pairs."""
    rng = np.random.default_rng(0)
    I, N, D = 64, 1024, 128
    descs = {i: rng.normal(size=(N, D)).astype(np.float32) for i in range(I)}
    pairs = [(i, (i + 1) % I) for i in range(I)]
    return descs, pairs


def bench_matching(mesh, n):
    """Fixed total: replicated descriptor pool, pair INDICES sharded
    (MatchPool — the r5 redesign; the old stacked path re-shipped ~34 MB of
    descriptors per batch and anti-scaled)."""
    descs, pairs = _matching_workload()
    pool = dist_matching.MatchPool(descs, mesh=mesh, axis="work", cap=1024)

    def run():
        idx, ok = pool.match_pairs(pairs)

    return _time(run)


def bench_matching_local(n=None):
    """Single-device baseline: same pool workload, no mesh."""
    descs, pairs = _matching_workload()
    pool = dist_matching.MatchPool(descs, mesh=None, cap=1024)

    def run():
        idx, ok = pool.match_pairs(pairs)

    return _time(run)


def _corridor(n_cams=128, n_pts=16384):
    rng = np.random.default_rng(1)
    pts = np.stack(
        [rng.uniform(0, n_cams, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(8, 12, n_pts)],
        axis=-1,
    ).astype(np.float32)
    f, cx, cy = 500.0, 320.0, 240.0
    intr = np.asarray(cm.pad_params([f, f, cx, cy], 1))
    qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_cams, 1))
    ts = np.stack([-np.arange(n_cams, dtype=np.float32), np.zeros(n_cams, np.float32), np.zeros(n_cams, np.float32)], -1)
    cam_x = np.arange(n_cams, dtype=np.float32)
    vis = np.abs(pts[None, :, 0] - cam_x[:, None]) < 3.0
    oc, op = np.nonzero(vis)
    xc = pts[op] + ts[oc]
    ouv = np.stack([f * xc[:, 0] / xc[:, 2] + cx, f * xc[:, 1] / xc[:, 2] + cy], -1)
    pose_fixed = np.zeros(n_cams, np.float32)
    pose_fixed[:2] = 1.0
    ts_n = ts.copy()
    ts_n[2:] += rng.normal(0, 0.02, ts_n[2:].shape).astype(np.float32)
    return ba_ops.make_problem(
        qs, ts_n, intr, pts + rng.normal(0, 0.02, pts.shape).astype(np.float32),
        oc.astype(np.int32), op.astype(np.int32), ouv.astype(np.float32),
        pose_fixed=pose_fixed, track_len=8,
    )


def bench_ba(mesh, n, prob):
    """Fixed total: 64-camera / 4096-point corridor BA, points sharded."""
    cfg = ba_ops.BAConfig(model_id=1, max_iterations=8)

    if mesh is None:
        def run():
            res = ba_ops.solve(prob, cfg)
            jax.block_until_ready(res.final_cost)
            return res
    else:
        def run():
            res = dist_ba.solve_distributed(prob, cfg, mesh, axis="work")
            jax.block_until_ready(res.final_cost)
            return res

    return _time(run)


def bench_mvs(mesh, n):
    """Fixed total: 8 reference views of 128x160, 4 sources, 32 depths."""
    rng = np.random.default_rng(2)
    V, S, H, W, D = 8, 4, 128, 160, 32
    refs = rng.uniform(0, 1, (V, H, W)).astype(np.float32)
    srcs = rng.uniform(0, 1, (V, S, H, W)).astype(np.float32)
    K = np.tile(np.asarray([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32), (V, 1, 1))
    Ks = np.tile(K[:, None], (1, S, 1, 1))
    R = np.tile(np.eye(3, dtype=np.float32), (V, S, 1, 1))
    t = rng.normal(0, 0.1, (V, S, 3)).astype(np.float32)
    depths = np.tile(np.linspace(2.0, 8.0, D, dtype=np.float32), (V, 1))

    def run():
        dm, cmap, nm = dist_mvs.plane_sweep_batch(refs, srcs, K, Ks, R, t, depths, mesh=mesh)
        jax.block_until_ready(dm)

    return _time(run)


def bench_mvs_local(n=None):
    return bench_mvs(None, 1)


def main():
    devs = jax.devices("cpu")
    prob = _corridor()
    table = []
    for n in (1, 2, 4, 8):
        # n=1 baseline = the plain local single-device path (no mesh),
        # exactly what a single-chip run executes
        mesh = None if n == 1 else mesh_lib.make_mesh(n, axis="work", devices=devs[:n])
        row = {
            "n_devices": n,
            "matching_s": round(
                (bench_matching_local() if mesh is None else bench_matching(mesh, n)), 4
            ),
            "dist_ba_s": round(bench_ba(mesh, n, prob), 4),
            "mvs_s": round(bench_mvs(mesh, n), 4),
        }
        table.append(row)
        print(row, flush=True)
    base = table[0]
    for row in table:
        row["speedup_matching"] = round(base["matching_s"] / row["matching_s"], 2)
        row["speedup_ba"] = round(base["dist_ba_s"] / row["dist_ba_s"], 2)
        row["speedup_mvs"] = round(base["mvs_s"] / row["mvs_s"], 2)
    out = {
        "workloads": {
            "matching": "64 pairs over a 64-image replicated pool of 1024x128 descriptors (pair indices sharded, MatchPool)",
            "dist_ba": "128 cams / 16384 pts corridor, 8 LM iters (point-sharded, psum-reduced camera system)",
            "mvs": "8 views 128x160, 4 srcs, 32 depths (view-sharded)",
        },
        "host": {
            "physical_cores": os.cpu_count(),
            "note": "virtual host-platform mesh: devices are host threads; wall-clock speedup is capped by physical cores, and n above the core count measures thread contention",
        },
        "table": table,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
