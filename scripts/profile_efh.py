#!/usr/bin/env python
"""Time the fused E/F/H verification program's pieces on the real chip:
per-bank cost (E 5pt / F 7pt / H DLT), scaling with hypothesis count, and
the solver-vs-verify split — to target the matching-throughput work."""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from colmap_pcd_tpu.utils import compile_cache

compile_cache.enable()

from colmap_pcd_tpu.ops import ransac as ransac_ops

B, CAP = 16, 512
rng = np.random.default_rng(0)
n1 = jnp.asarray(rng.normal(size=(B, CAP, 2)), jnp.float32)
n2 = jnp.asarray(rng.normal(size=(B, CAP, 2)), jnp.float32)
uv1 = jnp.asarray(rng.uniform(0, 640, size=(B, CAP, 2)), jnp.float32)
uv2 = jnp.asarray(rng.uniform(0, 640, size=(B, CAP, 2)), jnp.float32)
valid = jnp.ones((B, CAP), jnp.float32)
seeds = jnp.arange(B, dtype=jnp.uint32)
e_errs = jnp.full((B,), 4.0 / 500.0, jnp.float32)
quals = jnp.zeros((B, CAP), jnp.float32)


def timeit(name, fn, *args, reps=3):
    fn(*args)  # warm/compile
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn(*args)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / reps
    print(f"  {name:28s} {dt*1000:8.1f} ms", flush=True)
    return dt


for nh in (512, 1024, 2048):
    ro = ransac_ops.RansacOptions(max_error=4.0, num_hypotheses=nh)
    print(f"H={nh}:")

    @functools.partial(jax.jit, static_argnames=())
    def bankE(n1, n2, valid, seeds, quals, e_errs):
        def one(a, b, v, s, q, ee):
            return ransac_ops.ransac_essential(
                a, b, v, jax.random.PRNGKey(s), ro, q, ee).num_inliers
        return jax.vmap(one)(n1, n2, valid, seeds, quals, e_errs)

    @jax.jit
    def bankF(uv1, uv2, valid, seeds, quals):
        def one(a, b, v, s, q):
            return ransac_ops.ransac_fundamental(
                a, b, v, jax.random.PRNGKey(s), ro, q).num_inliers
        return jax.vmap(one)(uv1, uv2, valid, seeds, quals)

    @jax.jit
    def bankH(uv1, uv2, valid, seeds, quals):
        def one(a, b, v, s, q):
            return ransac_ops.ransac_homography(
                a, b, v, jax.random.PRNGKey(s), ro, q).num_inliers
        return jax.vmap(one)(uv1, uv2, valid, seeds, quals)

    timeit("E bank (5pt)", bankE, n1, n2, valid, seeds, quals, e_errs)
    timeit("F bank (7pt)", bankF, uv1, uv2, valid, seeds, quals)
    timeit("H bank (DLT)", bankH, uv1, uv2, valid, seeds, quals)
