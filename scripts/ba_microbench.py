#!/usr/bin/env python
"""Micro-benchmark of the BA solver at the real shape ladder on the chip.

Times ba_ops.solve warm (post-compile) at the global/local shapes the 100-
image bench actually records (see the shape journal), so Schur-assembly
changes can be judged in seconds-per-solve before paying for a full bench
run. Run alone: one JAX process per card.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from colmap_pcd_tpu.utils import compile_cache

compile_cache.enable()

from colmap_pcd_tpu.ops import ba as ba_ops

SHAPES = [
    # (C, P, N, T, npblocks, iters) — the bench ladder's hot entries
    (16, 2048, 8192, 16, 0, 25),
    (64, 2048, 8192, 32, 16, 25),
    (64, 8192, 16384, 32, 0, 50),
    (64, 8192, 32768, 64, 0, 50),
    (256, 8192, 32768, 64, 64, 50),
    (256, 8192, 65536, 64, 0, 50),
]


def synth_problem(rng, C, P, N, T, npblocks):
    """A consistent corridor-ish problem: real poses, real points, real
    observations (so LM runs a realistic number of accepted iterations)."""
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 2] = -np.arange(C) * 0.5
    cam_q = np.zeros((C, 4), np.float32)
    cam_q[:, 0] = 1.0
    pts = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0, C * 0.5 + 10, P)
    obs_pt = rng.integers(0, P, N)
    # observations spread over nearby cameras
    obs_cam = np.clip(
        (pts[obs_pt, 2] / 0.5).astype(np.int64) + rng.integers(-3, 4, N), 0, C - 1
    ).astype(np.int32)
    xc = pts[obs_pt] - cam_t[obs_cam] * np.array([0, 0, -1], np.float32)
    z = np.maximum(pts[obs_pt, 2] + cam_t[obs_cam, 2] * -1.0, 0.5)
    uv = pts[obs_pt, :2] / z[:, None] + rng.normal(0, 2e-3, (N, 2))
    # cap per-point track length at T
    order = np.argsort(obs_pt, kind="stable")
    obs_pt_s = obs_pt[order]
    keep = np.ones(N, bool)
    run = 0
    for k in range(N):
        run = run + 1 if k and obs_pt_s[k] == obs_pt_s[k - 1] else 1
        if run > T:
            keep[order[k]] = False
    valid = keep.astype(np.float32)
    pose_fixed = np.zeros(C, np.float32)
    pose_fixed[0] = 1.0
    if npblocks:
        cam_blk = np.zeros(C, np.int32)
        nvar = 0
        for k in range(C):
            if pose_fixed[k] == 0.0 and nvar < npblocks:
                cam_blk[k] = nvar
                nvar += 1
            elif pose_fixed[k] == 0.0:
                pose_fixed[k] = 1.0  # overflow: freeze
    else:
        cam_blk = np.arange(C, dtype=np.int32)
    prob = ba_ops.make_problem(
        cam_q, cam_t, np.ones((1, 12), np.float32), pts,
        obs_cam, obs_pt.astype(np.int32), uv.astype(np.float32),
        cam_k=np.zeros(C, np.int32), cam_model=np.zeros(1, np.int32),
        cam_blk=cam_blk, obs_valid=valid, track_len=T,
        lidar_plane=np.zeros((P, 4), np.float32),
        lidar_w=np.zeros(P, np.float32),
        pose_fixed=pose_fixed, tvec_fixed=np.zeros((C, 3), np.float32),
        point_fixed=np.zeros(P, np.float32),
    )
    return prob


def main():
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind}")
    rng = np.random.default_rng(0)
    for C, P, N, T, npb, iters in SHAPES:
        prob = synth_problem(rng, C, P, N, T, npb)
        nb = npb if npb else C
        point_chunk = int(np.clip((1 << 24) // max(T * nb, 1), 32, 4096))
        cfg = ba_ops.BAConfig(
            max_iterations=iters, num_pose_blocks=npb, track_len=T,
            point_chunk=point_chunk,
        )
        t0 = time.time()
        out = ba_ops.solve(prob, cfg)
        jax.block_until_ready(out.points)
        compile_s = time.time() - t0
        times = []
        for _ in range(3):
            t0 = time.time()
            out = ba_ops.solve(prob, cfg)
            jax.block_until_ready(out.points)
            times.append(time.time() - t0)
        i0, c0, c1 = (
            int(out.iterations), float(out.initial_cost), float(out.final_cost)
        )
        print(
            f"C={C:4d} P={P:5d} N={N:6d} T={T:2d} npb={npb:3d} chunk={point_chunk:5d}"
            f" | compile {compile_s:6.1f}s warm {min(times)*1000:8.1f} ms"
            f" | iters {i0:3d} cost {c0:.3e}->{c1:.3e}"
        )


if __name__ == "__main__":
    main()
