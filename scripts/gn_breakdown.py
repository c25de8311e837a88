#!/usr/bin/env python
"""Time the pieces of one GN step at the bench's hot shapes: jacobian build,
Schur chunk scan, dense Cholesky — so optimization lands where the ms are."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from colmap_pcd_tpu.utils import compile_cache

compile_cache.enable()

from colmap_pcd_tpu.ops import ba as ba_ops
from ba_microbench import synth_problem, SHAPES


def timeit(fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.time()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.time() - t0)
    return min(ts) * 1000


def main():
    rng = np.random.default_rng(0)
    for C, P, N, T, npb, iters in SHAPES[1:]:
        prob = synth_problem(rng, C, P, N, T, npb)
        nb = npb if npb else C
        point_chunk = int(np.clip((1 << 24) // max(T * nb, 1), 32, 4096))
        cfg = ba_ops.BAConfig(
            max_iterations=iters, num_pose_blocks=npb, track_len=T,
            point_chunk=point_chunk,
        )

        @jax.jit
        def jac_only(prob):
            r, Jc, Jp, Jk = ba_ops._obs_jacobians(
                prob, cfg, prob.cam_q, prob.cam_t, prob.intr, prob.points
            )
            return r.sum() + Jc.sum() + Jp.sum()

        @jax.jit
        def gn_once(prob):
            dxc, dxp = ba_ops._gn_system(
                prob, cfg, prob.cam_q, prob.cam_t, prob.intr, prob.points,
                jnp.float32(1e-4),
            )
            return dxc.sum() + dxp.sum()

        @jax.jit
        def cost_only(prob):
            return ba_ops.total_cost(
                prob.cam_q, prob.cam_t, prob.intr, prob.points, prob, cfg
            )

        D = 6 * nb
        A = np.asarray(rng.normal(size=(D, D)), np.float32)
        S = jnp.asarray(A @ A.T + np.eye(D, dtype=np.float32) * D)
        bvec = jnp.asarray(rng.normal(size=(D,)).astype(np.float32))

        @jax.jit
        def chol_only(S, b):
            L, low = jax.scipy.linalg.cho_factor(S, lower=True)
            return jax.scipy.linalg.cho_solve((L, low), b).sum()

        t_jac = timeit(jac_only, prob)
        t_gn = timeit(gn_once, prob)
        t_cost = timeit(cost_only, prob)
        t_chol = timeit(chol_only, S, bvec)
        print(
            f"C={C:4d} P={P:5d} N={N:6d} T={T:2d} nb={nb:3d} chunk={point_chunk}"
            f" | jac {t_jac:7.2f} ms | gn_full {t_gn:7.2f} ms"
            f" | cost {t_cost:6.2f} ms | chol(D={D}) {t_chol:6.2f} ms"
        )


if __name__ == "__main__":
    main()
