"""Descriptor matching as one matmul: dot-product similarity + ratio/cross checks.

Replaces SiftMatchGPU (lib/SiftGPU) and the CPU matcher
(src/feature/sift.cc MatchSiftFeaturesCPU / ComputeSiftDistanceMatrix): the
whole N1 x N2 distance matrix is one [N1,128]x[128,N2] matmul — a
tensor-core shape — followed by top-2 / ratio / cross-check reductions. Distances follow the reference's convention: descriptors are
L2-normalized, similarity = dot product, distance = arccos(similarity)
(sift.cc:142-165), ratio test on arccos distances, optional cross check and
guided (epipolar-masked) variant (feature/matching.h:277-310).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class MatchingOptions(NamedTuple):
    max_ratio: float = 0.8  # SiftMatchingOptions.max_ratio
    max_distance: float = 0.7  # SiftMatchingOptions.max_distance (arccos units)
    cross_check: bool = True
    guided_max_error: float = 4.0  # px, for guided matching


@jax.jit
def normalize_descriptors(d: Array) -> Array:
    """L2-normalize rows (uint8 COLMAP descriptors or raw floats)."""
    d = d.astype(jnp.float32)
    return d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)


def _best2(sim: Array, valid2: Array) -> tuple[Array, Array, Array]:
    """Top-2 similarities along axis 1 with invalid columns masked.

    Two max/argmax reduction passes, NOT jax.lax.top_k(k=2): the passes are
    plain reductions XLA fuses, while top_k may lower to a per-row sort."""
    sim = jnp.where(valid2[None, :] > 0, sim, -2.0)
    idx = jnp.argmax(sim, axis=1)
    s1 = jnp.max(sim, axis=1)
    cols = jnp.arange(sim.shape[1])
    s2 = jnp.max(jnp.where(cols[None, :] == idx[:, None], -2.0, sim), axis=1)
    return s1, s2, idx


@functools.partial(jax.jit, static_argnames=("opts",))
def match_descriptors(
    d1: Array,  # [N1,D] L2-normalized
    d2: Array,  # [N2,D]
    valid1: Array,  # [N1]
    valid2: Array,  # [N2]
    opts: MatchingOptions = MatchingOptions(),
) -> tuple[Array, Array, Array]:
    """Returns (match_idx [N1] into d2, ok [N1] bool, sim [N1] best cosine
    similarity — the match quality PROSAC-ordered verification consumes)."""
    # unit-normalized operands, decisions tolerate ~1e-3 similarity error:
    # Precision.DEFAULT overrides the package-wide "highest" here, and XLA
    # runs it on the H100 as a TF32 cuBLAS GEMM (3.3e-4 max relative error
    # on a 1024^3 product); the ok masks still agree with float64 on every
    # row at N=2048 and N=8192 (chip_smoke parity, PERF.md)
    sim = jnp.dot(d1, d2.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.DEFAULT)  # [N1,N2]
    s1, s2, idx = _best2(sim, valid2)
    dist1 = jnp.arccos(jnp.clip(s1, -1.0, 1.0))
    dist2 = jnp.arccos(jnp.clip(s2, -1.0, 1.0))
    ok = (valid1 > 0) & (dist1 < opts.max_distance)
    ok &= dist1 < opts.max_ratio * dist2
    if opts.cross_check:
        simT = jnp.where(valid1[:, None] > 0, sim, -2.0)
        back = jnp.argmax(simT, axis=0)  # [N2] best row per column
        ok &= back[idx] == jnp.arange(d1.shape[0])
    return idx, ok, s1


@functools.partial(jax.jit, static_argnames=("opts",))
def match_guided(
    d1: Array,
    d2: Array,
    uv1: Array,  # [N1,2] pixel coords
    uv2: Array,  # [N2,2]
    valid1: Array,
    valid2: Array,
    F: Array,  # 3x3 fundamental matrix (pixel frame)
    opts: MatchingOptions = MatchingOptions(),
) -> tuple[Array, Array]:
    """Guided matching: candidates restricted to epipolar-consistent pairs.

    Same ratio/cross-check logic but the similarity matrix is masked where the
    pairwise epipolar (Sampson) error exceeds guided_max_error
    (feature/matching.h guided matcher semantics).
    """
    sim = jnp.dot(d1, d2.T, preferred_element_type=jnp.float32)
    # pairwise sampson error [N1,N2] computed blockwise-free (fits for 8k x 8k)
    x1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], axis=-1)  # [N1,3]
    x2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], axis=-1)  # [N2,3]
    Fx1 = x1 @ F.T  # [N1,3]
    Ftx2 = x2 @ F  # [N2,3]
    num = (Fx1 @ x2.T) ** 2  # [N1,N2]
    den = (
        (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2)[:, None]
        + (Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)[None, :]
    )
    err = num / jnp.maximum(den, 1e-12)
    sim = jnp.where(err < opts.guided_max_error**2, sim, -2.0)
    s1, s2, idx = _best2(sim, valid2)
    dist1 = jnp.arccos(jnp.clip(s1, -1.0, 1.0))
    dist2 = jnp.arccos(jnp.clip(s2, -1.0, 1.0))
    ok = (valid1 > 0) & (s1 > -1.5) & (dist1 < opts.max_distance)
    ok &= dist1 < opts.max_ratio * dist2
    if opts.cross_check:
        simT = jnp.where(valid1[:, None] > 0, sim, -2.0)
        back = jnp.argmax(simT, axis=0)
        ok &= back[idx] == jnp.arange(d1.shape[0])
    return idx, ok


def matches_to_pairs(idx: Array, ok: Array) -> Array:
    """[M,2] (i1, i2) padded with -1 (host-side convenience)."""
    import numpy as np

    idx = np.asarray(idx)
    ok = np.asarray(ok)
    rows = np.nonzero(ok)[0]
    return np.stack([rows, idx[rows]], axis=-1).astype(np.int32)
