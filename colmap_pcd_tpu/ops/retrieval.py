"""Image retrieval: VLAD global descriptors over a k-means vocabulary.

Replaces src/retrieval/ (VisualIndex + FLANN vocab tree + inverted files with
Hamming embedding, 2.8k LoC): on a matrix machine the natural formulation is a
small k-means vocabulary (Lloyd iterations = one assignment matmul + segment
sums) and VLAD aggregation; querying the index is a single [Q, k*128] x
[k*128, N] matmul instead of an inverted-file walk. Used by vocab-tree-style
matching and sequential loop detection (feature_pipeline.py).

Precision: the descriptor/centroid/VLAD matmuls pass Precision.DEFAULT,
overriding the package-wide "highest"; on the H100 XLA runs them as TF32 on
the tensor cores. Operands are ~unit-norm and assignment/ranking decisions
tolerate ~1e-3 similarity error.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(desc: Array, key: Array, k: int = 64, iters: int = 10) -> Array:
    """Lloyd k-means on [N,D] -> centroids [k,D]. Assignment is a matmul."""
    N, D = desc.shape
    idx = jax.random.choice(key, N, (k,), replace=False)
    cent = desc[idx]

    def step(cent, _):
        # nearest centroid by dot products (descriptors ~unit norm)
        d2 = (
            jnp.sum(desc**2, 1)[:, None]
            - 2 * jnp.matmul(desc, cent.T, precision=jax.lax.Precision.DEFAULT)
            + jnp.sum(cent**2, 1)[None, :]
        )
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=desc.dtype)  # [N,k]
        sums = jnp.matmul(onehot.T, desc, precision=jax.lax.Precision.DEFAULT)  # [k,D]
        counts = jnp.sum(onehot, axis=0)[:, None]
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), cent)
        return new, None

    cent, _ = jax.lax.scan(step, cent, None, length=iters)
    return cent


@jax.jit
def vlad(desc: Array, valid: Array, centroids: Array) -> Array:
    """VLAD aggregation: [N,D] + [k,D] -> [k*D], power + L2 normalized."""
    k, D = centroids.shape
    d2 = (
        jnp.sum(desc**2, 1)[:, None]
        - 2 * jnp.matmul(desc, centroids.T, precision=jax.lax.Precision.DEFAULT)
        + jnp.sum(centroids**2, 1)[None, :]
    )
    assign = jnp.argmin(d2, axis=1)
    onehot = jax.nn.one_hot(assign, k, dtype=desc.dtype) * valid[:, None]  # [N,k]
    resid = desc[:, None, :] - centroids[None, :, :]  # [N,k,D]
    v = jnp.einsum("nk,nkd->kd", onehot, resid).reshape(-1)
    # power normalization then L2
    v = jnp.sign(v) * jnp.sqrt(jnp.abs(v))
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-12)


@jax.jit
def assign_words(desc: Array, centroids: Array) -> Array:
    """Nearest-centroid assignment [N] — the VLAD codebook cell doubles as
    the visual word for vote-and-verify spatial re-ranking."""
    d2 = (
        jnp.sum(desc**2, 1)[:, None]
        - 2 * jnp.matmul(desc, centroids.T, precision=jax.lax.Precision.DEFAULT)
        + jnp.sum(centroids**2, 1)[None, :]
    )
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


@dataclass
class RetrievalIndex:
    ids: list
    vlads: np.ndarray  # [n_images, k*D]
    centroids: np.ndarray
    # optional spatial-verification side tables (vote_and_verify re-ranking)
    geoms: np.ndarray | None = None  # [n_images, cap, 4] (x, y, scale, ori)
    words: np.ndarray | None = None  # [n_images, cap] codebook cells
    valids: np.ndarray | None = None  # [n_images, cap]


def build_index(
    descs_by_image: dict[int, np.ndarray],
    k: int = 64,
    max_train: int = 50000,
    seed: int = 0,
    geoms_by_image: dict[int, np.ndarray] | None = None,
) -> RetrievalIndex:
    """VLAD index; pass geoms_by_image (keypoint [N,>=4] (x, y, scale, ori)
    per image) to enable vote-and-verify spatial re-ranking at query time
    (the VisualIndex::Query + VoteAndVerify path, retrieval/visual_index.h)."""
    ids = sorted(descs_by_image.keys())
    all_desc = [d for i in ids for d in [descs_by_image[i]] if d.size]
    if not all_desc:
        return RetrievalIndex(ids, np.zeros((len(ids), k * 128), np.float32), np.zeros((k, 128), np.float32))
    train = np.concatenate(all_desc)[:max_train].astype(np.float32)
    train = train / np.maximum(np.linalg.norm(train, axis=1, keepdims=True), 1e-8)
    kk = min(k, train.shape[0])
    cent = np.asarray(kmeans(jnp.asarray(train), jax.random.PRNGKey(seed), k=kk))
    D = train.shape[1]
    vlads = np.zeros((len(ids), kk * D), np.float32)
    cap = 1 << int(np.ceil(np.log2(max(max(d.shape[0] for d in all_desc), 1))))
    want_geom = geoms_by_image is not None
    geoms = np.zeros((len(ids), cap, 4), np.float32) if want_geom else None
    words = np.zeros((len(ids), cap), np.int32) if want_geom else None
    valids = np.zeros((len(ids), cap), np.float32) if want_geom else None
    for n, i in enumerate(ids):
        d = descs_by_image[i].astype(np.float32)
        if d.size == 0:
            continue
        d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-8)
        dp = np.zeros((cap, D), np.float32)
        dp[: d.shape[0]] = d
        v = np.zeros(cap, np.float32)
        v[: d.shape[0]] = 1.0
        dj = jnp.asarray(dp)
        vlads[n] = np.asarray(vlad(dj, jnp.asarray(v), jnp.asarray(cent)))
        if want_geom:
            g = np.asarray(geoms_by_image.get(i, np.zeros((0, 4))), np.float32)
            m = min(g.shape[0], cap, d.shape[0])
            if g.shape[1] < 4:  # pad missing scale/orientation columns
                g = np.concatenate(
                    [g, np.ones((g.shape[0], 4 - g.shape[1]), np.float32)], axis=1
                )
            geoms[n, :m] = g[:m, :4]
            words[n] = np.asarray(assign_words(dj, jnp.asarray(cent)))
            valids[n, :m] = 1.0
    return RetrievalIndex(ids, vlads, cent, geoms, words, valids)


def query(
    index: RetrievalIndex,
    image_id,
    num: int,
    rerank: bool = False,
    num_verify: int = 20,
    vv_opts=None,
) -> list:
    """Ranked most-similar image ids (excluding the query itself).

    With rerank=True (and an index built with geometries) the top num_verify
    VLAD candidates are re-scored by vote_and_verify effective inlier count
    and reordered (score desc, VLAD sim as tie-break) before the tail — the
    reference's spatial-verification retrieval mode
    (retrieval/visual_index.h Query + vote_and_verify.cc)."""
    try:
        qi = index.ids.index(image_id)
    except ValueError:
        return []
    sims = np.asarray(
        jnp.matmul(index.vlads, index.vlads[qi], precision=jax.lax.Precision.DEFAULT)
    )
    order = [int(o) for o in np.argsort(-sims) if index.ids[int(o)] != image_id]
    if rerank and index.geoms is not None and order:
        from . import vote_verify as vv

        opts = vv_opts or vv.VoteVerifyOptions()
        short = order[:num_verify]
        scores = np.asarray(
            vv.vote_and_verify_batch(
                jnp.asarray(index.geoms[qi]),
                jnp.asarray(index.words[qi]),
                jnp.asarray(index.valids[qi]),
                jnp.asarray(index.geoms[short]),
                jnp.asarray(index.words[short]),
                jnp.asarray(index.valids[short]),
                opts,
            )
        )
        # stable: effective inliers desc, VLAD similarity breaks ties
        short = [short[r] for r in np.argsort(-scores, kind="stable")]
        order = short + order[num_verify:]
    return [index.ids[o] for o in order[:num]]
