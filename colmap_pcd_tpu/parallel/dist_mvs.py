"""Multi-device dense stereo: per-reference-view plane sweeps sharded over the
device mesh.

The reference fans per-reference PatchMatch problems out over a ThreadPool,
round-robin over GPUs (src/mvs/patch_match.cc:197-213). The JAX analog
stacks B reference-view problems into one batch and shards the batch axis
over the mesh: every device runs the identical plane-sweep program on its
shard — embarrassingly parallel, zero collectives, linear scaling in devices.

All problems in a batch share static shapes (same resized image size, same
source count S, same depth-bank size D); views with fewer than S sources are
padded by repeating their last source (a duplicate source only re-votes in
the best-K aggregation — it cannot introduce wrong evidence).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import stereo as stereo_ops


def plane_sweep_batch(
    refs: jnp.ndarray,  # [B, H, W]
    srcs: jnp.ndarray,  # [B, S, H, W]
    K_ref: jnp.ndarray,  # [B, 3, 3]
    K_srcs: jnp.ndarray,  # [B, S, 3, 3]
    R_rel: jnp.ndarray,  # [B, S, 3, 3]
    t_rel: jnp.ndarray,  # [B, S, 3]
    depths: jnp.ndarray,  # [B, D]
    opts: stereo_ops.StereoOptions = stereo_ops.StereoOptions(),
    mesh: jax.sharding.Mesh | None = None,
    axis: str = "work",
    src_depths: jnp.ndarray | None = None,  # [B, S, H, W]
    use_geom: bool = False,
):
    """Sweep B reference views at once; with a mesh, B shards across devices.

    Returns (depth [B,H,W], cost [B,H,W], normal [B,H,W,3]). B must be a
    multiple of the mesh size when a mesh is given.
    """

    with_geom = use_geom and src_depths is not None
    if with_geom:
        args = (refs, srcs, K_ref, K_srcs, R_rel, t_rel, depths, src_depths)
    else:
        args = (refs, srcs, K_ref, K_srcs, R_rel, t_rel, depths)

    if mesh is None:
        run, _ = _runner(None, axis, opts, with_geom)
        return run(*args)

    B = refs.shape[0]
    n = mesh.devices.size
    assert B % n == 0, f"batch {B} not divisible by mesh size {n}"
    run, shardings = _runner(mesh, axis, opts, with_geom)
    args = tuple(jax.device_put(a, s) for a, s in zip(args, shardings))
    return run(*args)


@functools.lru_cache(maxsize=16)
def _runner(mesh, axis: str, opts: stereo_ops.StereoOptions, with_geom: bool):
    """Memoized jitted (and optionally sharded) sweep runner — a fresh
    closure per call would sidestep jax.jit's compile cache and recompile
    on every invocation."""
    if with_geom:
        def one(r, s, kr, ks, R, t, d, sd):
            return stereo_ops.plane_sweep(
                r, s, kr, ks, R, t, d, opts, src_depths=sd, use_geom=True
            )
        ndims = (3, 4, 3, 4, 4, 3, 2, 4)
    else:
        def one(r, s, kr, ks, R, t, d):
            return stereo_ops.plane_sweep(r, s, kr, ks, R, t, d, opts)
        ndims = (3, 4, 3, 4, 4, 3, 2)
    if mesh is None:
        return jax.jit(jax.vmap(one)), None
    shardings = tuple(
        NamedSharding(mesh, P(axis, *([None] * (nd - 1)))) for nd in ndims
    )
    out_sh = (
        NamedSharding(mesh, P(axis, None, None)),
        NamedSharding(mesh, P(axis, None, None)),
        NamedSharding(mesh, P(axis, None, None, None)),
    )
    return (
        jax.jit(jax.vmap(one), in_shardings=shardings, out_shardings=out_sh),
        shardings,
    )
