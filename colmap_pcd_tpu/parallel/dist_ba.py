"""Distributed bundle adjustment: Schur complement reduced over the mesh.

The north-star scale-out design (SURVEY.md §5.8 / BASELINE.md): 3D points and
their observations are partitioned into per-device blocks; every device
assembles the camera-side normal equations for its block, the dense reduced
camera system is psum-reduced across devices, each device solves the (replicated)
reduced system, and back-substitutes its own point block locally. Camera
parameters are replicated; per-iteration communication is one [D,D] + [D]
psum — independent of the number of points.

The LM loop runs inside shard_map: the accept/reject decisions use the
psum'd global cost, so all devices stay in lockstep without further control
traffic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops import ba as ba_ops

# BAProblem fields sharded by point/observation; the rest are replicated.
_SHARDED_FIELDS = {
    "points", "obs_cam", "obs_pt", "obs_uv", "obs_valid",
    "pt_obs", "lidar_plane", "lidar_w", "point_fixed",
}


def shard_problem(problem: ba_ops.BAProblem, n_shards: int) -> ba_ops.BAProblem:
    """Partition a BAProblem into n contiguous point blocks.

    Returns a BAProblem whose sharded fields carry a leading [n_shards] axis
    (equal-size blocks; the host builder already padded points, and
    observations are re-packed per shard so every point's track is local to
    its owner — the "owner computes" rule of the spherical-BA windowing).
    """
    pts = np.asarray(problem.points)
    Pn = pts.shape[0]
    assert Pn % n_shards == 0, f"point slots {Pn} not divisible by {n_shards}"
    blk = Pn // n_shards

    obs_pt = np.asarray(problem.obs_pt)
    obs_cam = np.asarray(problem.obs_cam)
    obs_uv = np.asarray(problem.obs_uv)
    obs_valid = np.asarray(problem.obs_valid)
    owner = obs_pt // blk
    # per-shard obs capacity: max over shards, padded
    counts = [int(((owner == s) & (obs_valid > 0)).sum()) for s in range(n_shards)]
    ncap = max(1, 1 << int(np.ceil(np.log2(max(max(counts), 1)))))

    T = problem.pt_obs.shape[1]
    s_obs_cam = np.zeros((n_shards, ncap), np.int32)
    s_obs_pt = np.zeros((n_shards, ncap), np.int32)
    s_obs_uv = np.zeros((n_shards, ncap, 2), np.float32)
    s_obs_valid = np.zeros((n_shards, ncap), np.float32)
    s_pt_obs = -np.ones((n_shards, blk, T), np.int32)
    for s in range(n_shards):
        sel = np.nonzero((owner == s) & (obs_valid > 0))[0]
        n = sel.size
        s_obs_cam[s, :n] = obs_cam[sel]
        s_obs_pt[s, :n] = obs_pt[sel] - s * blk  # local point slot
        s_obs_uv[s, :n] = obs_uv[sel]
        s_obs_valid[s, :n] = 1.0
        if n == 0:
            continue
        pv = s_obs_pt[s, :n]
        order = np.argsort(pv, kind="stable")
        ps = pv[order]
        _, starts, cnts = np.unique(ps, return_index=True, return_counts=True)
        # a sharded solve must optimize the SAME objective as the local one:
        # refuse (loudly) rather than silently drop observations beyond T
        assert cnts.max() <= T, (
            f"track with {cnts.max()} observations exceeds pt_obs capacity "
            f"T={T}; rebuild the problem with track_len >= {cnts.max()}"
        )
        rank = np.arange(ps.size) - np.repeat(starts, cnts)
        s_pt_obs[s, ps, rank] = order

    def split(x):
        return np.asarray(x).reshape((n_shards, blk) + np.asarray(x).shape[1:])

    rep = lambda x: jnp.asarray(x)
    return ba_ops.BAProblem(
        cam_blk=rep(problem.cam_blk),
        cam_q=rep(problem.cam_q),
        cam_t=rep(problem.cam_t),
        cam_k=rep(problem.cam_k),
        intr=rep(problem.intr),
        cam_model=rep(problem.cam_model),
        points=jnp.asarray(split(problem.points)),
        obs_cam=jnp.asarray(s_obs_cam),
        obs_pt=jnp.asarray(s_obs_pt),
        obs_uv=jnp.asarray(s_obs_uv),
        obs_valid=jnp.asarray(s_obs_valid),
        pt_obs=jnp.asarray(s_pt_obs),
        lidar_plane=jnp.asarray(split(problem.lidar_plane)),
        lidar_w=jnp.asarray(split(problem.lidar_w)),
        pose_fixed=rep(problem.pose_fixed),
        tvec_fixed=rep(problem.tvec_fixed),
        point_fixed=jnp.asarray(split(problem.point_fixed)),
        intr_fixed=rep(problem.intr_fixed),
        num_cams=rep(problem.num_cams),
        num_points=rep(problem.num_points),
    )


@functools.lru_cache(maxsize=16)
def _dist_runner(mesh: jax.sharding.Mesh, axis: str, cfg: ba_ops.BAConfig):
    """Memoized jitted shard_map runner: keyed on (mesh, axis, cfg) so
    repeated solves reuse the compiled program instead of re-tracing a fresh
    closure per call (jax.jit caches per wrapper object — per-shape caching
    only works if the wrapper itself survives between calls)."""
    specs = ba_ops.BAProblem(
        cam_blk=P(), cam_q=P(), cam_t=P(), cam_k=P(), intr=P(), cam_model=P(),
        points=P(axis),
        obs_cam=P(axis), obs_pt=P(axis), obs_uv=P(axis), obs_valid=P(axis),
        pt_obs=P(axis), lidar_plane=P(axis), lidar_w=P(axis),
        pose_fixed=P(), tvec_fixed=P(), point_fixed=P(axis),
        intr_fixed=P(), num_cams=P(), num_points=P(),
    )
    out_specs = ba_ops.BAResult(
        cam_q=P(), cam_t=P(), intr=P(), points=P(axis),
        initial_cost=P(), final_cost=P(), iterations=P(),
    )

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(specs,), out_specs=out_specs,
        check_vma=False,
    )
    def run(local):
        # shard_map passes blocks without the leading shard axis
        local = local._replace(
            **{
                f: getattr(local, f)[0]
                for f in _SHARDED_FIELDS
            }
        )
        return ba_ops.solve_inner(local, cfg, psum_axis=axis)

    return jax.jit(run)


def solve_distributed(
    problem: ba_ops.BAProblem,
    cfg: ba_ops.BAConfig,
    mesh: jax.sharding.Mesh,
    axis: str = "work",
) -> ba_ops.BAResult:
    """Solve a (host-side) BAProblem across all devices of the mesh."""
    n = mesh.devices.size
    sp = shard_problem(problem, n)
    res = _dist_runner(mesh, axis, cfg)(sp)
    # stitch sharded points back to the flat layout
    pts = np.asarray(res.points).reshape(-1, 3)
    return ba_ops.BAResult(
        cam_q=res.cam_q if res.cam_q.ndim == 2 else res.cam_q[0],
        cam_t=res.cam_t if res.cam_t.ndim == 2 else res.cam_t[0],
        intr=res.intr if res.intr.ndim == 2 else res.intr[0],
        points=jnp.asarray(pts),
        initial_cost=res.initial_cost.reshape(()) if res.initial_cost.ndim else res.initial_cost,
        final_cost=res.final_cost.reshape(()) if res.final_cost.ndim else res.final_cost,
        iterations=res.iterations.reshape(()) if res.iterations.ndim else res.iterations,
    )
