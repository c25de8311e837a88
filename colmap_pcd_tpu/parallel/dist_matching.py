"""Multi-device pairwise matching: image-pair batches sharded over the mesh.

The reference data-parallels matching with CPU worker threads over pair
blocks (feature/matching.h:222-345). The device analog shards a batch of
pairs over the device mesh: descriptors for B pairs are stacked [B, N, D] and
each device matches its shard with the same program — embarrassingly
parallel, zero collectives, linear scaling in devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import matching as matching_ops


def match_pairs_batch(
    d1: jnp.ndarray,  # [B, N1, D] L2-normalized (padded rows zero)
    d2: jnp.ndarray,  # [B, N2, D]
    v1: jnp.ndarray,  # [B, N1]
    v2: jnp.ndarray,  # [B, N2]
    mesh: jax.sharding.Mesh | None = None,
    axis: str = "work",
    opts: matching_ops.MatchingOptions = matching_ops.MatchingOptions(),
):
    """Match B descriptor pairs at once; with a mesh, B shards across devices.

    Returns (idx [B,N1], ok [B,N1]). B must be a multiple of the mesh size.
    """

    if mesh is not None:
        B = d1.shape[0]
        n = mesh.devices.size
        assert B % n == 0, f"batch {B} not divisible by mesh size {n}"
        run_sharded, sh3, sh2 = _sharded_runner(mesh, axis, opts)
        d1 = jax.device_put(d1, sh3)
        d2 = jax.device_put(d2, sh3)
        v1 = jax.device_put(v1, sh2)
        v2 = jax.device_put(v2, sh2)
        return run_sharded(d1, d2, v1, v2)
    return _local_runner(opts)(d1, d2, v1, v2)


@functools.lru_cache(maxsize=16)
def _local_runner(opts: matching_ops.MatchingOptions):
    """Memoized jitted batch matcher (fresh closures per call would defeat
    jax.jit's per-wrapper compile cache and recompile every invocation)."""
    return jax.jit(
        lambda a, b, va, vb: jax.vmap(
            lambda x, y, vx, vy: matching_ops.match_descriptors(x, y, vx, vy, opts)[:2]
        )(a, b, va, vb)
    )


@functools.lru_cache(maxsize=16)
def _sharded_runner(mesh, axis: str, opts: matching_ops.MatchingOptions):
    """Memoized sharded matcher + its shardings, keyed on (mesh, axis, opts)."""
    sh3 = NamedSharding(mesh, P(axis, None, None))
    sh2 = NamedSharding(mesh, P(axis, None))
    fn = jax.jit(
        lambda a, b, va, vb: jax.vmap(
            lambda x, y, vx, vy: matching_ops.match_descriptors(x, y, vx, vy, opts)[:2]
        )(a, b, va, vb),
        in_shardings=(sh3, sh3, sh2, sh2),
        out_shardings=(sh2, sh2),
    )
    return fn, sh3, sh2


def match_pair_list(
    descs: dict[int, np.ndarray],
    pairs: list[tuple[int, int]],
    mesh: jax.sharding.Mesh | None = None,
    cap: int = 2048,
    opts: matching_ops.MatchingOptions = matching_ops.MatchingOptions(),
) -> dict[tuple[int, int], np.ndarray]:
    """Host convenience: normalize/pad per-image descriptors, batch the pair
    list (padding the batch to the mesh size), return per-pair [M,2] matches."""
    norm: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for iid, d in descs.items():
        d = np.asarray(d, np.float32)
        n = min(len(d), cap)
        dp = np.zeros((cap, d.shape[1] if d.size else 128), np.float32)
        if n:
            dn = d[:n] / np.maximum(np.linalg.norm(d[:n], axis=1, keepdims=True), 1e-8)
            dp[:n] = dn
        v = np.zeros(cap, np.float32)
        v[:n] = 1.0
        norm[iid] = (dp, v)

    B = len(pairs)
    nd = mesh.devices.size if mesh is not None else 1
    Bp = -(-B // nd) * nd
    d1 = np.zeros((Bp, cap, 128), np.float32)
    d2 = np.zeros((Bp, cap, 128), np.float32)
    v1 = np.zeros((Bp, cap), np.float32)
    v2 = np.zeros((Bp, cap), np.float32)
    for k, (i, j) in enumerate(pairs):
        d1[k], v1[k] = norm[i]
        d2[k], v2[k] = norm[j]
    idx, ok = match_pairs_batch(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2), mesh=mesh, opts=opts
    )
    idx = np.asarray(idx)
    ok = np.asarray(ok)
    out = {}
    for k, (i, j) in enumerate(pairs):
        rows = np.nonzero(ok[k])[0]
        out[(i, j)] = np.stack([rows, idx[k][rows]], -1).astype(np.int32)
    return out


class MatchPool:
    """Replicated descriptor pool + sharded pair-index matching.

    The stacked [B, N, D] pair-batch path above re-uploads every image's
    descriptors once PER PAIR it appears in (sequential overlap-5 matching
    re-ships each image ~10x), and the upload sits inside the dispatch path —
    the r3 scaling table showed matching at 0.59x on 8 devices because the
    per-batch host->device traffic grew with the mesh. This pool keeps ONE
    normalized copy of every image's descriptors replicated on all devices
    and ships only int32 pair indices per batch (sharded over the mesh); each
    device gathers its shard's pairs from the local pool replica — zero
    collectives, per-batch traffic B*8 bytes instead of B*2*N*D*4.
    """

    def __init__(
        self,
        descs: dict[int, np.ndarray],
        mesh: jax.sharding.Mesh | None = None,
        axis: str = "work",
        cap: int = 2048,
        opts: matching_ops.MatchingOptions = matching_ops.MatchingOptions(),
    ):
        self.mesh = mesh
        self.axis = axis
        self.opts = opts
        self.ids = sorted(descs.keys())
        self.row_of = {iid: r for r, iid in enumerate(self.ids)}
        I = len(self.ids)
        pool = np.zeros((I, cap, 128), np.float32)
        valid = np.zeros((I, cap), np.float32)
        for r, iid in enumerate(self.ids):
            d = np.asarray(descs[iid], np.float32)
            n = min(len(d), cap)
            if n:
                pool[r, :n] = d[:n] / np.maximum(
                    np.linalg.norm(d[:n], axis=1, keepdims=True), 1e-8
                )
                valid[r, :n] = 1.0
        if mesh is not None:
            rep = NamedSharding(mesh, P())  # replicated once, reused per batch
            self.pool = jax.device_put(jnp.asarray(pool), rep)
            self.valid = jax.device_put(jnp.asarray(valid), rep)
        else:
            self.pool = jnp.asarray(pool)
            self.valid = jnp.asarray(valid)

    def match_pairs(self, pairs: list[tuple[int, int]]):
        """[(i, j)] image-id pairs -> (idx [B,cap], ok [B,cap]) numpy."""
        B = len(pairs)
        nd = self.mesh.devices.size if self.mesh is not None else 1
        Bp = -(-B // nd) * nd
        ii = np.zeros(Bp, np.int32)
        jj = np.zeros(Bp, np.int32)
        for k, (i, j) in enumerate(pairs):
            ii[k] = self.row_of[i]
            jj[k] = self.row_of[j]
        fn = _pool_runner(self.mesh, self.axis, self.opts)
        idx, ok = fn(self.pool, self.valid, jnp.asarray(ii), jnp.asarray(jj))
        return np.asarray(idx)[:B], np.asarray(ok)[:B]


@functools.lru_cache(maxsize=16)
def _pool_runner(mesh, axis: str, opts: matching_ops.MatchingOptions):
    def run(pool, valid, ii, jj):
        def one(i, j):
            return matching_ops.match_descriptors(
                pool[i], pool[j], valid[i], valid[j], opts
            )[:2]

        return jax.vmap(one)(ii, jj)

    if mesh is None:
        return jax.jit(run)
    rep = NamedSharding(mesh, P())
    sh1 = NamedSharding(mesh, P(axis))
    return jax.jit(
        run,
        in_shardings=(rep, rep, sh1, sh1),
        out_shardings=(sh1, sh1),
    )
