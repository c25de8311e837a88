#!/usr/bin/env python
"""Smoke test of the main path on one GPU.

    python chip_smoke.py

One process, one card. Phases, in order:

  device      JAX's default backend must be a GPU (there is no CPU
              fallback); prints the card's name and power limit and whether
              the native host library (cpp/libnative.so) built and loaded.
  parity      every device program of the main path on the card against a
              plain reference at real widths — the same jitted program run on
              the host CPU in this process, or a numpy/scipy float64
              reference. Each line prints the observed error, the bound and
              the matmul precision in force.
  main        the CLI, in-process through colmap_pcd_tpu.cli.main:
              feature_extractor -> sequential_matcher -> mapper with a lidar
              map and a pose prior, on 40 rendered 640x480 views; the model
              read back must register >= 39 views at ATE <= 0.05 m.
  overlapped  bench.py's path (overlapped extraction + matching feeding the
              mapper controller) on the same views, same bounds.
  ref_scale   feature_extractor + sequential_matcher on six 1280x960 views
              with up to 8192 features (upsampled first octave and low SIFT
              thresholds, so every view keeps > 4096 and matching runs
              16-pair batches at cap 8192); >= 5 pairs must verify.

Every phase runs even after an earlier one failed, so one run reports all
faults; any failure exits non-zero and the final line is not printed. The
last line of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tests"))  # render.py, synthetic.py
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

# bench light config (bench.py) and the reference-scale one
W, H, F = 640, 480, 500.0
N_VIEWS = 40
STEP = 0.8
RS_W, RS_H, RS_F, RS_VIEWS = 1280, 960, 1000.0, 6
PINHOLE = 1


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


class CheckFailed(AssertionError):
    pass


def check(name: str, value, bound, ok: bool, precision: str = "") -> None:
    """One printed parity/acceptance line; raises when the bound is missed."""
    prec = f"  precision={precision}" if precision else ""
    log(f"{'PASS' if ok else 'FAIL'} {name}: {value} (bound {bound}){prec}")
    if not ok:
        raise CheckFailed(f"{name}: {value} misses {bound}")


# ---------------------------------------------------------------------------
# device


def check_device():
    """The default backend's devices; exits non-zero unless they are GPUs."""
    import jax

    devs = jax.devices()  # raises if the requested platform has no device
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"[smoke] no GPU: JAX's default backend is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this smoke never falls back to the CPU"
        )
    return devs


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out or not out[0].strip():
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def phase_device(ctx):
    devs = check_device()
    ctx["card"] = card_name_and_power()
    log(f"card: {ctx['card']}")
    log(f"jax devices: {len(devs)} x {devs[0].device_kind} ({devs[0].platform})")
    from colmap_pcd_tpu.utils import native

    lib = native.get_lib()
    log(f"native host library (cpp/libnative.so): "
        f"{'built and loaded' if lib is not None else 'NOT available: ' + str(native.build_error)}"
        " -> LidarMap.nn_query('auto') uses the "
        f"{'host kd-tree' if lib is not None else 'device scan'}")


# ---------------------------------------------------------------------------
# parity helpers


def _on(dev, fn, *args):
    """Run fn with its array inputs committed to `dev`; numpy out."""
    import jax

    args = jax.device_put(args, dev)
    with jax.default_device(dev):
        return jax.device_get(fn(*args))


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _render(gt, w, h, f):
    from concurrent.futures import ThreadPoolExecutor

    from render import render_corridor

    def one(qt):
        return (render_corridor(qt[0], qt[1], w, h, f) * 255).astype(np.uint8)

    with ThreadPoolExecutor(max_workers=8) as ex:
        return list(ex.map(one, gt))


def make_gt(n_images, step=STEP):
    from bench import make_gt as bench_gt

    return bench_gt(n_images, step)


def precision_probe():
    """What each matmul precision computes for f32 operands on this card:
    error of a 1024^3 product against float64, and the dot's algorithm in the
    compiled HLO."""
    import re

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    for p in ("DEFAULT", "HIGH", "HIGHEST"):
        fn = jax.jit(lambda x, y, p=p: jnp.dot(x, y, precision=getattr(jax.lax.Precision, p)))
        err = float(np.abs(np.asarray(fn(a, b)) - ref).max() / np.abs(ref).max())
        hlo = fn.lower(a, b).compile().as_text()
        alg = sorted(set(re.findall(r'"algorithm":"?([A-Z0-9_]+)', hlo)))
        target = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
        log(f"precision {p}: max rel err {err:.3e} vs float64; "
            f"HLO dot algorithm {alg or ['(none)']}, targets {target or ['(fused)']}")


def parity_sift(imgs):
    """SIFT on the card vs the same program on the CPU."""
    from scipy.spatial import cKDTree

    from colmap_pcd_tpu.ops import sift as sift_ops

    opts = sift_ops.SiftOptions(max_num_features=2048, num_octaves=3, first_octave=0)

    def fn(x):
        return sift_ops.extract_batch(x, opts)

    kg, dg, _, vg = _on(None, fn, imgs)
    kc, dc, _, vc = _on(_cpu(), fn, imgs)
    n_cpu = n_near = 0
    dists = []
    for b in range(imgs.shape[0]):
        pc, pg = kc[b][vc[b]], kg[b][vg[b]]
        qc = dc[b][vc[b]] / np.maximum(np.linalg.norm(dc[b][vc[b]], axis=1, keepdims=True), 1e-12)
        qg = dg[b][vg[b]] / np.maximum(np.linalg.norm(dg[b][vg[b]], axis=1, keepdims=True), 1e-12)
        n_cpu += len(pc)
        if not len(pc) or not len(pg):
            continue
        d, j = cKDTree(pg[:, :2]).query(pc[:, :2])
        near = d <= 0.5
        n_near += int(near.sum())
        dists.append(np.linalg.norm(qc[near] - qg[j[near]], axis=1))
    dists = np.concatenate(dists) if dists else np.zeros(0)
    frac = n_near / max(n_cpu, 1)
    check("sift keypoints: CPU keypoints with a GPU keypoint within 0.5 px",
          f"{frac:.4f} of {n_cpu}", ">= 0.95", frac >= 0.95, "HIGHEST (package default)")
    over = float(np.mean(dists > 0.05)) if dists.size else 1.0
    log(f"sift descriptors: L2 after normalisation over {dists.size} matched "
        f"keypoints: median {np.median(dists):.2e}, p99 {np.percentile(dists, 99):.2e}, "
        f"max {dists.max():.2e}, share > 0.05: {over:.4f}")
    check("sift descriptors: share of matched keypoints with L2 > 0.05",
          f"{over:.4f}", "<= 0.01", over <= 0.01, "HIGHEST (package default)")


def _match_reference(d1, d2, v1, v2, max_ratio=0.8, max_distance=0.7):
    """numpy float64 top-2 + ratio + cross-check (ops/matching semantics),
    plus each row's distance to its nearest decision boundary in similarity
    units."""
    sim = d1.astype(np.float64) @ d2.astype(np.float64).T
    sm = np.where(v2[None, :] > 0, sim, -2.0)
    idx = np.argmax(sm, axis=1)
    rows = np.arange(len(d1))
    s1 = sm[rows, idx]
    sm2 = sm.copy()
    sm2[rows, idx] = -2.0
    s2 = sm2.max(axis=1)
    dist1 = np.arccos(np.clip(s1, -1, 1))
    dist2 = np.arccos(np.clip(s2, -1, 1))
    ok = (v1 > 0) & (dist1 < max_distance) & (dist1 < max_ratio * dist2)
    smT = np.where(v1[:, None] > 0, sim, -2.0)
    back = np.argmax(smT, axis=0)
    ok &= back[idx] == rows
    # margins: to the distance threshold, to the ratio boundary, to the row's
    # runner-up, and to the column's runner-up (cross-check)
    colbest = np.sort(smT, axis=0)[-2:, :]
    margin = np.minimum.reduce([
        np.abs(s1 - np.cos(max_distance)),
        np.abs(s1 - np.cos(max_ratio * dist2)),
        s1 - s2,
        (colbest[1] - colbest[0])[idx],
    ])
    return idx, ok, margin


def parity_matcher(N, seed=0):
    from colmap_pcd_tpu.ops import matching

    rng = np.random.default_rng(seed)
    base = np.abs(rng.standard_normal((N, 128))).astype(np.float32)
    perm = rng.permutation(N)
    d2 = base[perm] + 0.35 * np.abs(rng.standard_normal((N, 128))).astype(np.float32)
    fresh = rng.random(N) < 0.3  # 30% of rows have no true partner
    d2[fresh] = np.abs(rng.standard_normal((int(fresh.sum()), 128)))
    d1 = base / np.linalg.norm(base, axis=1, keepdims=True)
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    v1 = (rng.random(N) > 0.03).astype(np.float32)
    v2 = (rng.random(N) > 0.03).astype(np.float32)
    idx, ok, _ = _on(None, matching.match_descriptors, d1, d2, v1, v2)
    ridx, rok, margin = _match_reference(d1, d2, v1, v2)
    bad = (ok != rok) | (ok & rok & (idx != ridx))
    frac = float(bad.mean())
    near = bool(np.all(margin[bad] < 1e-3))
    log(f"matcher N={N}: {int(rok.sum())} reference matches, {int(bad.sum())} "
        f"rows disagree, max margin among them {margin[bad].max() if bad.any() else 0:.2e}")
    check(f"matcher N={N}: rows whose ok/idx disagree with float64",
          f"{frac:.5f}", "<= 0.005, all within 1e-3 of a threshold or tie",
          frac <= 0.005 and near, "DEFAULT (ops/matching)")


def parity_nn(pts, nrm, n_queries=4096):
    import jax
    from scipy.spatial import cKDTree

    from colmap_pcd_tpu.models.lidar_map import LidarMap

    m = LidarMap.from_arrays(pts, nrm)
    rng = np.random.default_rng(1)
    q = (m.points[rng.integers(0, m.num_points, n_queries)]
         + rng.normal(0, 0.1, (n_queries, 3))).astype(np.float32)
    t0 = time.time()
    got_pts, _, got_d = m.nn_query(q, backend="device")
    log(f"1-NN device scan: {n_queries} queries x {m.num_points} points "
        f"in {time.time() - t0:.2f}s (first call, compile included)")
    ref_d, ref_i = cKDTree(m.points.astype(np.float64)).query(q.astype(np.float64))
    got_true_d = np.linalg.norm(got_pts.astype(np.float64) - q.astype(np.float64), axis=1)
    idx_bad = np.any(got_pts != m.points[ref_i], axis=1) & (got_true_d - ref_d > 1e-6)
    d_err = float(np.abs(got_d - ref_d).max())
    if idx_bad.any():  # separate the card from the formulation
        with jax.default_device(_cpu()):
            mc = LidarMap.from_arrays(pts, nrm, device=_cpu())
            cpu_pts, _, _ = mc.nn_query(q, backend="device")
        log(f"1-NN: CPU run of the same program picks a different point than "
            f"float64 on {int(np.any(cpu_pts != m.points[ref_i], axis=1).sum())} rows")
    check("1-NN vs float64 kd-tree: non-tie index mismatches", int(idx_bad.sum()),
          "== 0", not idx_bad.any(), "HIGHEST (difference formulation)")
    check("1-NN vs float64 kd-tree: max distance error [m]", f"{d_err:.2e}", "<= 1e-4",
          d_err <= 1e-4, "HIGHEST")


def parity_depth_projection(pts, nrm, feat_xy, q, t):
    import jax

    from colmap_pcd_tpu.models.lidar_map import LidarMap
    from colmap_pcd_tpu.ops import np_geom

    params = np_geom.pad_params([F, F, W / 2, H / 2], PINHOLE)
    mg = LidarMap.from_arrays(pts, nrm)
    g = mg.project_to_image(feat_xy, q, t, params, PINHOLE, W, H)
    with jax.default_device(_cpu()):
        mc = LidarMap.from_arrays(pts, nrm, device=_cpu())
        c = mc.project_to_image(feat_xy, q, t, params, PINHOLE, W, H)
    found_bad = g["found"] != c["found"]
    both = g["found"] & c["found"]
    pt_bad = both & np.any(g["lidar_pt"] != c["lidar_pt"], axis=1)
    R = np_geom.quat_to_rotmat(np.asarray(q, np.float64))

    def cam_dist(p):
        return np.linalg.norm(p.astype(np.float64) @ R.T + np.asarray(t), axis=1)

    tie = np.abs(cam_dist(g["lidar_pt"]) - cam_dist(c["lidar_pt"])) <= 1e-3 * cam_dist(c["lidar_pt"])
    n_bad = int(found_bad.sum() + pt_bad.sum())
    log(f"depth projection: {int(c['found'].sum())}/{len(feat_xy)} found on CPU; "
        f"found differs on {int(found_bad.sum())}, chosen point on {int(pt_bad.sum())} "
        f"({int((pt_bad & ~tie).sum())} not a distance tie)")
    check("depth projection: features whose association differs from the CPU",
          f"{n_bad / len(feat_xy):.4f}", "<= 0.005, chosen-point changes only at ties",
          n_bad <= 0.005 * len(feat_xy) and not (pt_bad & ~tie).any(), "HIGHEST")


def _two_view_items(B=16, N=2048, seed=0):
    """B synthetic pairs: general 3D scenes and planar ones, 0.5 px noise, 25%
    outliers — so the bank has to choose between E, F and H."""
    from colmap_pcd_tpu.ops import np_geom

    rng = np.random.default_rng(seed)
    params = np_geom.pad_params([F, F, W / 2, H / 2], PINHOLE)
    K = np.asarray([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    items = []
    for b in range(B):
        planar = b % 4 == 3
        X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                      np.full(N, 8.0) if planar else rng.uniform(5, 15, N)], 1)
        w = rng.normal(0, 0.05, 3)
        R2 = _rotvec(w)
        t2 = np.asarray([1.0, 0.1 * rng.standard_normal(), 0.2 * rng.standard_normal()])
        x1 = X @ K.T
        x2 = (X @ R2.T + t2) @ K.T
        uv1 = x1[:, :2] / x1[:, 2:] + rng.normal(0, 0.5, (N, 2))
        uv2 = x2[:, :2] / x2[:, 2:] + rng.normal(0, 0.5, (N, 2))
        out = rng.random(N) < 0.25
        uv2[out] = rng.uniform([0, 0], [W, H], (int(out.sum()), 2))
        items.append(dict(
            uv1=uv1.astype(np.float32), uv2=uv2.astype(np.float32),
            params1=params, params2=params, model_id1=PINHOLE, model_id2=PINHOLE,
            size1=(W, H), size2=(W, H), seed=b,
            quality=rng.random(N).astype(np.float32), R_true=R2,
        ))
    return items


def _rotvec(w):
    from colmap_pcd_tpu.ops import np_geom

    return np_geom.quat_to_rotmat(np_geom.so3_exp_quat(w))


def _rot_angle_deg(qa, qb) -> float:
    from colmap_pcd_tpu.ops import np_geom

    return float(np.degrees(np_geom.angle_between(
        np.asarray(qa, np.float64), np.asarray(qb, np.float64))))


def parity_efh():
    import jax

    from colmap_pcd_tpu.models import two_view
    from colmap_pcd_tpu.ops import np_geom

    items = _two_view_items()
    opts = two_view.TwoViewOptions()
    g = two_view.estimate_two_view_geometry_batch(items, opts)
    with jax.default_device(_cpu()):
        c = two_view.estimate_two_view_geometry_batch(items, opts)
        # the same CPU program with every coordinate moved by one ulp, up and
        # down: how far a last-bit change of the input moves this bank's pose
        pert = [two_view.estimate_two_view_geometry_batch(
            [dict(it, uv1=np.nextafter(it["uv1"], np.float32(d)),
                  uv2=np.nextafter(it["uv2"], np.float32(d))) for it in items], opts)
            for d in (np.inf, -np.inf)]
    cfg_bad = sum(a.config != b.config for a, b in zip(g, c))
    n_rel = max(abs(len(a.inlier_matches) - len(b.inlier_matches))
                / max(len(b.inlier_matches), 1) for a, b in zip(g, c))
    posed = [k for k in range(len(items)) if c[k].qvec is not None and g[k].qvec is not None
             and all(r[k].qvec is not None for r in pert)]

    def err(r, k):  # rotation error against the truth [deg]
        return _rot_angle_deg(r.qvec, np_geom.rotmat_to_quat(items[k]["R_true"]))

    d_gpu = np.asarray([abs(err(g[k], k) - err(c[k], k)) for k in posed])
    d_ulp = np.asarray([[abs(err(r[k], k) - err(c[k], k)) for k in posed] for r in pert])
    rot_gpu = [_rot_angle_deg(g[k].qvec, c[k].qvec) for k in posed]
    rot_ulp = [max(_rot_angle_deg(r[k].qvec, c[k].qvec) for r in pert) for k in posed]
    log(f"E/F/H bank B=16 cap 2048: configs GPU {[a.config for a in g]} / "
        f"CPU {[b.config for b in c]}")
    log(f"E/F/H rotation GPU vs CPU per posed pair [deg]: {np.round(rot_gpu, 4).tolist()}")
    log(f"E/F/H rotation CPU vs CPU with inputs moved 1 ulp [deg]: "
        f"{np.round(rot_ulp, 4).tolist()}")
    check("E/F/H: pairs whose configuration differs", cfg_bad, "== 0", cfg_bad == 0,
          "HIGHEST")
    check("E/F/H: max relative inlier-count difference", f"{n_rel:.4f}", "<= 0.02",
          n_rel <= 0.02, "HIGHEST")
    # A pose within 0.1 deg of the CPU's holds where the bank is stable. Where
    # a last-bit change flips the winning hypothesis, a 1-ulp move of the
    # input shifts the CPU's own pose by up to ~1 deg, so each pair's error
    # against the truth may move on the card by 0.1 deg plus the largest
    # shift the 1-ulp runs show.
    bound = 0.1 + float(d_ulp.max()) if d_ulp.size else 0.1
    worst = float(d_gpu.max()) if d_gpu.size else 0.0
    check("E/F/H: per-pair |GPU - CPU| rotation error vs truth, max [deg]",
          f"{worst:.4f} over {len(posed)} poses",
          f"<= 0.1 + 1-ulp CPU shift {bound - 0.1:.4f} = {bound:.4f}",
          worst <= bound, "HIGHEST")


def parity_pnp(N=4096, seed=0):
    import jax
    import jax.numpy as jnp

    from colmap_pcd_tpu.ops import np_geom
    from colmap_pcd_tpu.ops import ransac as ransac_ops

    rng = np.random.default_rng(seed)
    n = 3000
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(4, 20, n)], 1)
    R = _rotvec(rng.normal(0, 0.05, 3))
    tv = np.asarray([0.2, -0.1, 0.5])
    pc = X @ R.T + tv
    uv = pc[:, :2] / pc[:, 2:] + rng.normal(0, 0.5 / F, (n, 2))
    out = rng.random(n) < 0.3
    uv[out] = rng.uniform(-0.6, 0.6, (int(out.sum()), 2))
    uvp = np.zeros((N, 2), np.float32)
    Xp = np.zeros((N, 3), np.float32)
    vp = np.zeros(N, np.float32)
    uvp[:n], Xp[:n], vp[:n] = uv, X, 1.0
    ro = ransac_ops.RansacOptions(num_hypotheses=4096)

    def fn(a, b, c, key):
        r = ransac_ops.ransac_pnp(a, b, c, key, ro, refine_iters=10,
                                  max_error=jnp.float32(24.0 / F))
        return r.num_inliers, r.q

    key = jax.random.PRNGKey(0)
    ng, qg = _on(None, fn, uvp, Xp, vp, key)
    nc, qc = _on(_cpu(), fn, uvp, Xp, vp, key)
    rel = abs(int(ng) - int(nc)) / max(int(nc), 1)
    ang = _rot_angle_deg(qg, qc)
    log(f"PnP bank N={N}: inliers GPU {int(ng)} / CPU {int(nc)}; truth "
        f"{int((~out).sum())} inliers, rotation error vs truth "
        f"{_rot_angle_deg(qg, np_geom.rotmat_to_quat(R)):.4f} deg")
    check("PnP: relative inlier-count difference", f"{rel:.4f}", "<= 0.02", rel <= 0.02,
          "HIGHEST")
    check("PnP: rotation difference [deg]", f"{ang:.4f}", "<= 0.1", ang <= 0.1, "HIGHEST")


def _ba_problem(n_cams=20, n_pts=5000, track=6, seed=0):
    """Local-BA-sized problem with lidar planes, built like
    __graft_entry__._toy_problem but with track length `track`."""
    from colmap_pcd_tpu.ops import ba, np_geom

    rng = np.random.default_rng(seed)
    qs, ts, Rs = [], [], []
    for i in range(n_cams):
        R = _rotvec(rng.normal(0, 0.02, 3))
        c = np.asarray([0.3 * np.sin(i), 0.1 * np.cos(i), 0.5 * i])
        Rs.append(R)
        qs.append(np_geom.rotmat_to_quat(R))
        ts.append(-R @ c)
    span = n_cams - track + 1
    first = np.arange(n_pts) % span
    X = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts),
                  0.5 * (first + track) + rng.uniform(3, 9, n_pts)], 1)
    obs_cam, obs_pt, obs_uv = [], [], []
    for j in range(n_pts):
        for i in range(first[j], first[j] + track):
            pc = Rs[i] @ X[j] + ts[i]
            obs_cam.append(i)
            obs_pt.append(j)
            obs_uv.append(F * pc[:2] / pc[2] + [W / 2, H / 2] + rng.normal(0, 0.5, 2))
    nrm = rng.standard_normal((n_pts, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = np.concatenate([nrm, -np.sum(nrm * X, 1, keepdims=True)], 1)
    lidar_w = np.where(rng.random(n_pts) < 0.5, 10.0, 0.0)
    pose_fixed = np.zeros(n_cams, np.float32)
    pose_fixed[0] = 1.0
    q_noisy = np.stack(qs) + rng.normal(0, 2e-3, (n_cams, 4)) * (1 - pose_fixed[:, None])
    q_noisy /= np.linalg.norm(q_noisy, axis=1, keepdims=True)
    t_noisy = np.stack(ts) + rng.normal(0, 0.02, (n_cams, 3)) * (1 - pose_fixed[:, None])
    intr = np.zeros(12, np.float32)
    intr[:4] = [F, F, W / 2, H / 2]
    return ba.make_problem(
        q_noisy.astype(np.float32), t_noisy.astype(np.float32), intr,
        (X + rng.normal(0, 0.05, X.shape)).astype(np.float32),
        np.asarray(obs_cam, np.int32), np.asarray(obs_pt, np.int32),
        np.asarray(obs_uv, np.float32), pose_fixed=pose_fixed,
        lidar_plane=planes.astype(np.float32), lidar_w=lidar_w.astype(np.float32),
        track_len=track,
    )


def parity_ba():
    from colmap_pcd_tpu.ops import ba, np_geom

    prob = _ba_problem()
    cfg = ba.BAConfig(model_id=PINHOLE, track_len=6)

    def fn(p):
        return ba.solve(p, cfg)

    rg = _on(None, fn, prob)
    rc = _on(_cpu(), fn, prob)
    rel = abs(float(rg.final_cost) - float(rc.final_cost)) / max(float(rc.final_cost), 1e-30)
    cg = np.stack([np_geom.projection_center(q, t) for q, t in zip(rg.cam_q, rg.cam_t)])
    cc = np.stack([np_geom.projection_center(q, t) for q, t in zip(rc.cam_q, rc.cam_t)])
    dc = float(np.linalg.norm(cg - cc, axis=1).max())
    log(f"BA 20 cams / 5000 pts / track 6: cost {float(rc.initial_cost):.4g} -> GPU "
        f"{float(rg.final_cost):.6g} in {int(rg.iterations)} it, CPU "
        f"{float(rc.final_cost):.6g} in {int(rc.iterations)} it")
    check("BA: final cost relative difference", f"{rel:.2e}", "<= 1e-3", rel <= 1e-3,
          "HIGH (ops/ba einsums) / HIGHEST")
    check("BA: max camera-centre difference [m]", f"{dc:.2e}", "<= 1e-3", dc <= 1e-3,
          "HIGH / HIGHEST")


def _view_keypoints(img):
    """Pixel coordinates of one view's valid SIFT keypoints."""
    import jax

    from colmap_pcd_tpu.ops import sift as sift_ops

    kp, _, _, valid = jax.device_get(sift_ops.extract(
        jax.numpy.asarray(img),
        sift_ops.SiftOptions(max_num_features=2048, num_octaves=3, first_octave=0)))
    return kp[valid][:, :2].astype(np.float32)


def phase_parity(ctx):
    from synthetic import build_corridor_map

    precision_probe()
    gt = make_gt(8)
    imgs = np.stack(_render(gt, W, H, F))
    pts, nrm = build_corridor_map(np.random.default_rng(0), length=105.0)  # ~500k points
    failures = []
    steps = [
        ("sift", lambda: parity_sift(imgs)),
        ("matcher 2048", lambda: parity_matcher(2048)),
        ("matcher 8192", lambda: parity_matcher(8192, seed=1)),
        ("1-NN", lambda: parity_nn(pts, nrm)),
        ("E/F/H", parity_efh),
        ("PnP", parity_pnp),
        ("BA", parity_ba),
        ("depth projection", lambda: parity_depth_projection(
            pts, nrm, _view_keypoints(imgs[0]), gt[0][0], gt[0][1])),
    ]
    for name, step in steps:
        failures += _run_step(name, step)
    if failures:
        raise CheckFailed("; ".join(failures))


def _run_step(name, fn) -> list[str]:
    try:
        fn()
        return []
    except Exception as e:
        traceback.print_exc()
        log(f"FAIL {name}: {type(e).__name__}: {e}")
        return [f"{name}: {e}"]


# ---------------------------------------------------------------------------
# main path


def _write_inputs(root, n_views, w, h, f, with_map=True):
    from colmap_pcd_tpu.io import ply as ply_io
    from colmap_pcd_tpu.models.lidar_map import camera_to_lidar_frame
    from colmap_pcd_tpu.models.reconstruction import (
        Camera, Image, Reconstruction, save_image_poses,
    )
    from colmap_pcd_tpu.utils.image import write_png
    from synthetic import build_corridor_map

    gt = make_gt(n_views)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    t0 = time.time()
    for i, im in enumerate(_render(gt, w, h, f)):
        write_png(os.path.join(img_dir, f"v{i:04d}.png"), im)
    log(f"rendered {n_views} {w}x{h} views in {time.time() - t0:.1f}s")
    paths = {"images": img_dir, "db": os.path.join(root, "db.db"), "gt": gt}
    if with_map:
        pts, nrm = build_corridor_map(np.random.default_rng(0), length=n_views * STEP + 25)
        paths["map"] = os.path.join(root, "map.ply")
        ply_io.write_ply(paths["map"], camera_to_lidar_frame(pts), camera_to_lidar_frame(nrm))
        rec = Reconstruction()
        rec.add_camera(Camera(1, PINHOLE, w, h, np.asarray([f, f, w / 2, h / 2])))
        rec.add_image(Image(1, "v0000.png", 1, qvec=np.asarray(gt[0][0], np.float64),
                            tvec=np.asarray(gt[0][1], np.float64), registered=True))
        paths["pose"] = os.path.join(root, "pose.ply")
        save_image_poses(paths["pose"], rec)
        paths["map_arrays"] = (pts, nrm)
    return paths


def _ate_by_name(rec, gt) -> tuple[int, float]:
    from colmap_pcd_tpu.ops import np_geom

    errs = []
    for img in rec.images.values():
        if not img.registered:
            continue
        i = int(os.path.splitext(os.path.basename(img.name))[0][1:])
        c_gt = np_geom.projection_center(*gt[i])
        errs.append(np.sum((img.projection_center() - c_gt) ** 2))
    return len(errs), float(np.sqrt(np.mean(errs))) if errs else float("inf")


def _cli(*argv):
    from colmap_pcd_tpu import cli

    t0 = time.time()
    rc = cli.main(list(argv))
    dt = time.time() - t0
    if rc != 0:
        raise CheckFailed(f"cli {argv[0]} returned {rc}")
    return dt


def _count_verified(db_path, min_inliers=15) -> int:
    from colmap_pcd_tpu.models.database import Database

    db = Database(db_path)
    n = 0
    for i, j in db.all_two_view_pair_ids():
        g = db.read_two_view_geometry(i, j)
        n += g is not None and len(g["inlier_matches"]) >= min_inliers
    db.close()
    return n


def _reader_flags(w, h, f):
    return ["--ImageReader.camera_model", "PINHOLE", "--ImageReader.single_camera", "1",
            "--ImageReader.camera_params", f"{f},{f},{w / 2},{h / 2}"]


MAPPER_FLAGS = [  # bench.py's mapper thresholds
    "--Mapper.init_image_id1", "1", "--Mapper.init_image_id2", "2",
    "--Mapper.init_min_num_inliers", "40",
    "--Mapper.abs_pose_min_num_inliers", "12",
    "--Mapper.abs_pose_min_inlier_ratio", "0.15",
    "--Mapper.filter_max_reproj_error", "6.0",
]


def phase_main(ctx):
    from colmap_pcd_tpu.models.reconstruction import Reconstruction

    root = ctx["work"]
    p = _write_inputs(os.path.join(root, "main"), N_VIEWS, W, H, F)
    ctx["main_inputs"] = p
    t_ext = _cli("feature_extractor", "--database_path", p["db"], "--image_path", p["images"],
                 *_reader_flags(W, H, F),
                 "--SiftExtraction.max_num_features", "2048",
                 "--SiftExtraction.num_octaves", "3", "--SiftExtraction.first_octave", "0",
                 "--SiftExtraction.max_image_size", str(W))
    t_match = _cli("sequential_matcher", "--database_path", p["db"],
                   "--SequentialMatching.overlap", "5")
    n_pairs = _count_verified(p["db"])
    out = os.path.join(root, "main", "sparse")
    t_map = _cli("mapper", "--database_path", p["db"], "--image_path", p["images"],
                 "--output_path", out,
                 "--Mapper.if_add_lidar_constraint", "1",
                 "--Mapper.lidar_pointcloud_path", p["map"],
                 "--Mapper.if_import_pose_prior", "1",
                 "--Mapper.image_pose_prior_path", p["pose"], *MAPPER_FLAGS)
    rec = Reconstruction.read(os.path.join(out, "0"))
    n_reg, ate = _ate_by_name(rec, p["gt"])
    card = ctx.get("card", "?")
    log(f"main: extraction {N_VIEWS / t_ext:.3f} img/s ({t_ext:.1f}s), matching "
        f"{n_pairs / t_match:.3f} verified pairs/s ({n_pairs} pairs, {t_match:.1f}s), "
        f"mapping wall {t_map:.1f}s — cold compile included, on {card}")
    check("main: registered views", f"{n_reg}/{N_VIEWS}", f">= {N_VIEWS - 1}",
          n_reg >= N_VIEWS - 1)
    check("main: ATE [m]", f"{ate:.4f}", "<= 0.05", ate <= 0.05)


def phase_overlapped(ctx):
    from colmap_pcd_tpu.models.controllers import ControllerOptions, IncrementalMapperController
    from colmap_pcd_tpu.models.correspondence_graph import CorrespondenceGraph
    from colmap_pcd_tpu.models.incremental_mapper import MapperOptions
    from colmap_pcd_tpu.models.lidar_map import LidarMap
    from colmap_pcd_tpu.models.overlap import run_overlapped_frontend
    from colmap_pcd_tpu.models.reconstruction import Camera, Reconstruction
    from colmap_pcd_tpu.ops import pointcloud as pc_ops
    from colmap_pcd_tpu.utils.config import SiftExtractionConfig, SiftMatchingConfig

    p = ctx.get("main_inputs") or _write_inputs(
        os.path.join(ctx["work"], "main"), N_VIEWS, W, H, F)
    dbp = os.path.join(ctx["work"], "overlapped.db")
    t0 = time.time()
    feed, t_extract, t_match = run_overlapped_frontend(
        dbp, p["images"],
        SiftExtractionConfig(max_num_features=2048, first_octave=0, num_octaves=3,
                             max_image_size=W),
        SiftMatchingConfig(min_num_inliers=15), overlap=5, quadratic_overlap=False,
    )
    rec = Reconstruction()
    rec.add_camera(Camera(1, PINHOLE, W, H, np.asarray([F, F, W / 2, H / 2])))
    lmap = LidarMap.from_arrays(*p["map_arrays"], pc_ops.ProjOptions())
    opts = MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
        init_min_num_inliers=40, abs_pose_min_num_inliers=12,
        abs_pose_min_inlier_ratio=0.15, num_ransac_hypotheses=2048,
        filter_max_reproj_error=6.0,
    )
    ctl = IncrementalMapperController(
        rec, CorrespondenceGraph(), opts, ControllerOptions(verbose=False),
        lidar_map=lmap, pose_priors={1: p["gt"][0]}, pair_feed=feed,
    )
    ok = ctl.reconstruct()
    t_extract.join(timeout=120)
    t_match.join(timeout=120)
    wall = time.time() - t0
    if not ok:
        raise CheckFailed("overlapped: mapper controller did not reconstruct")
    n_reg, ate = _ate_by_name(rec, p["gt"])
    log(f"overlapped: extraction thread {N_VIEWS / max(feed.extract_s or 1e-9, 1e-9):.3f} "
        f"img/s, {feed.n_pairs_verified} verified pairs, wall {wall:.1f}s on "
        f"{ctx.get('card', '?')}")
    check("overlapped: registered views", f"{n_reg}/{N_VIEWS}", f">= {N_VIEWS - 1}",
          n_reg >= N_VIEWS - 1)
    check("overlapped: ATE [m]", f"{ate:.4f}", "<= 0.05", ate <= 0.05)


def phase_ref_scale(ctx):
    from colmap_pcd_tpu.models.database import Database

    p = _write_inputs(os.path.join(ctx["work"], "ref_scale"), RS_VIEWS, RS_W, RS_H, RS_F,
                      with_map=False)
    # COLMAP's upsampled first octave and low peak / high edge thresholds give
    # the rendered views 7-8k features, so matching runs at cap 8192
    t_ext = _cli("feature_extractor", "--database_path", p["db"], "--image_path", p["images"],
                 *_reader_flags(RS_W, RS_H, RS_F),
                 "--SiftExtraction.max_num_features", "8192",
                 "--SiftExtraction.num_octaves", "4", "--SiftExtraction.first_octave", "-1",
                 "--SiftExtraction.peak_threshold", "0.001",
                 "--SiftExtraction.edge_threshold", "20",
                 "--SiftExtraction.max_image_size", str(RS_W))
    db = Database(p["db"])
    n_feat = [len(db.read_keypoints(i)) for i in sorted(db.images())]
    db.close()
    log(f"ref_scale: features per view {n_feat}; extraction {t_ext:.1f}s on "
        f"{ctx.get('card', '?')}")
    check("ref_scale: fewest features in a view (cap 8192 needs > 4096)",
          min(n_feat), "> 4096", min(n_feat) > 4096)
    t_match = _cli("sequential_matcher", "--database_path", p["db"],
                   "--SequentialMatching.overlap", "5")
    n = _count_verified(p["db"])
    log(f"ref_scale: matching {t_match:.1f}s for {RS_VIEWS * (RS_VIEWS - 1) // 2} pairs "
        f"at cap 8192 on {ctx.get('card', '?')}")
    check("ref_scale: verified pairs", n, ">= 5", n >= 5)


# ---------------------------------------------------------------------------


def main() -> int:
    import jax

    from colmap_pcd_tpu.utils import compile_cache

    t_all = time.time()
    ctx = {}
    phase_device(ctx)  # no GPU -> SystemExit before anything else runs
    log(f"compile cache: {compile_cache.enable()}")
    failures = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        ctx["work"] = work
        for name, fn in (("parity", phase_parity), ("main", phase_main),
                         ("overlapped", phase_overlapped), ("ref_scale", phase_ref_scale)):
            t0 = time.time()
            log(f"--- phase {name}")
            try:
                fn(ctx)
                log(f"phase {name} passed in {time.time() - t0:.1f}s")
            except Exception as e:
                traceback.print_exc()
                log(f"phase {name} FAILED after {time.time() - t0:.1f}s: {e}")
                failures.append(name)
    from colmap_pcd_tpu.utils import prewarm

    prewarm.stop()  # no compile may still run when the runtime tears down
    log(f"card: {card_name_and_power()}")
    log(f"wall {time.time() - t_all:.1f}s")
    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
