#!/usr/bin/env python
"""Device time of the two XLA programs that do the work fused top-2 matching
and fused 1-NN kernels would do, beside the card's published bandwidth and
FLOP/s: the roofline of the work itself (inputs, outputs, FLOPs) and the
cost of one write + one read of the intermediate matrix, if XLA materializes
it.

    python scripts/xla_kernel_times.py [--out DIR]

  * models/feature_pipeline._match_descriptors_batch, B=16 pairs, caps 2048
    and 8192 (the [B, N, N] similarity matrix is materialised by XLA);
  * ops/pointcloud.nn_query, 4096 queries against the 105 m corridor map
    padded as LidarMap pads it (the [Q, block] distance matrix per block).

Device time is the busy union of the GPU plane's events in a profiler trace
of REPS calls, divided by REPS. Needs a GPU (utils/flops has no peak for
other devices); prints one JSON line last.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

REPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def _busy_ns(xplane_path: str) -> float:
    """Union of all event intervals on the GPU device planes."""
    from jax.profiler import ProfileData

    iv = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            iv += [(ev.start_ns, ev.start_ns + ev.duration_ns) for ev in line.events]
    busy, end = 0.0, -1.0
    for s, e in sorted(iv):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def device_time(fn, args, trace_dir: str) -> tuple[float, float]:
    """(device busy seconds per call, host wall seconds per call)."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(REPS):
        jax.block_until_ready(fn(*args))
    wall = (time.perf_counter() - t0) / REPS
    with jax.profiler.trace(trace_dir):
        for _ in range(REPS):
            jax.block_until_ready(fn(*args))
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    return _busy_ns(path) / REPS / 1e9, wall


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for the profiler traces")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from colmap_pcd_tpu.models.feature_pipeline import _match_descriptors_batch
    from colmap_pcd_tpu.models.lidar_map import LidarMap
    from colmap_pcd_tpu.ops import matching as matching_ops
    from colmap_pcd_tpu.ops import pointcloud as pc_ops
    from colmap_pcd_tpu.utils import compile_cache
    from colmap_pcd_tpu.utils.flops import peak_flops_per_s
    from synthetic import build_corridor_map

    compile_cache.enable()
    dev = jax.devices()[0]
    tf32 = peak_flops_per_s(dev, "tf32")  # raises off the GPU
    fp32 = peak_flops_per_s(dev, "fp32")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    out_root = args.out or tempfile.mkdtemp(prefix="xla_kernel_times_")
    rows = []
    rng = np.random.default_rng(0)

    for cap in (2048, 8192):
        B = 16
        d = np.abs(rng.standard_normal((2, B, cap, 128))).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        v = np.ones((B, cap), np.float32)
        a = [jnp.asarray(d[0]), jnp.asarray(d[1]), jnp.asarray(v), jnp.asarray(v)]
        mopts = matching_ops.MatchingOptions()
        fn = jax.jit(lambda d1, d2, v1, v2: _match_descriptors_batch(d1, d2, v1, v2, mopts))
        dt, wall = device_time(fn, a, os.path.join(out_root, f"match_{cap}"))
        sim_bytes = B * cap * cap * 4
        rows.append(dict(
            program="_match_descriptors_batch", B=B, cap=cap, device_s=dt, wall_s=wall,
            io_bytes=B * cap * (2 * 128 * 4 + 2 * 4 + 2 + 1 + 2),  # d1,d2,v1,v2 in; idx,ok,sim out
            flops=2.0 * B * cap * cap * 128, peak_flops=tf32,  # DEFAULT = TF32 here
            matrix_bytes=sim_bytes,
        ))

    pts, nrm = build_corridor_map(np.random.default_rng(0), length=105.0)
    m = LidarMap.from_arrays(pts, nrm)
    mp, _, mv = m._map_padded()
    Q = 4096
    q = jnp.asarray((m.points[rng.integers(0, m.num_points, Q)]
                     + rng.normal(0, 0.1, (Q, 3))).astype(np.float32))
    dt, wall = device_time(pc_ops.nn_query, [q, mp, mv], os.path.join(out_root, "nn"))
    M = int(mp.shape[0])
    rows.append(dict(
        program="pointcloud.nn_query", Q=Q, M=M, map_points=m.num_points,
        device_s=dt, wall_s=wall, io_bytes=M * 16 + Q * 20,  # map+valid in; queries in, idx+dist out
        flops=8.0 * Q * M, peak_flops=fp32,  # 3 sub + 3 mul + 2 add per pair, fp32
        matrix_bytes=Q * M * 4,
    ))
    # what plain XLA reaches on this card: a large bf16 GEMM and a large copy
    x = jnp.ones((8192, 8192), jnp.bfloat16)
    dt, _ = device_time(jax.jit(lambda a: a @ a), [x], os.path.join(out_root, "gemm"))
    gemm_flops_per_s = 2.0 * 8192**3 / dt
    y = jnp.ones((1 << 30,), jnp.float32)  # 4 GiB
    dt, _ = device_time(jax.jit(lambda a: a + 1.0), [y], os.path.join(out_root, "copy"))
    copy_bytes_per_s = 2.0 * y.size * 4 / dt
    print(f"plain XLA on {card}: bf16 8192^3 GEMM {gemm_flops_per_s / 1e12:.1f} TFLOP/s, "
          f"4 GiB read+write {copy_bytes_per_s / 1e12:.3f} TB/s", flush=True)
    for r in rows:
        bound = max(r["io_bytes"] / HBM_BYTES_PER_S, r["flops"] / r["peak_flops"])
        r["roofline_s"] = bound
        r["roofline_share"] = bound / r["device_s"]
        r["matrix_write_read_s"] = 2 * r["matrix_bytes"] / HBM_BYTES_PER_S
        print(f"{r['program']} {({k: r[k] for k in ('B', 'cap', 'Q', 'M') if k in r})}: "
              f"device {r['device_s'] * 1e3:.3f} ms/call (wall {r['wall_s'] * 1e3:.3f} ms); "
              f"roofline {bound * 1e3:.3f} ms (share {r['roofline_share']:.3f}); one write+read "
              f"of the {r['matrix_bytes'] / 1e9:.2f} GB intermediate matrix "
              f"{r['matrix_write_read_s'] * 1e3:.3f} ms; on {card}", flush=True)
    print(json.dumps({"card": card, "device_kind": dev.device_kind, "rows": rows,
                      "bf16_gemm_flops_per_s": gemm_flops_per_s,
                      "copy_bytes_per_s": copy_bytes_per_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
