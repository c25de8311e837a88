#!/usr/bin/env python
"""Micro-profile the pair-matching chunk path on the real chip.

Renders a short corridor sequence, extracts SIFT, then times every segment of
_MatchWorker._match_pairs_chunk (feature fetch, match dispatch, device_get,
host assembly, EFH dispatch, classification/pose, sqlite writes) so the
matching-throughput work targets the measured wall, not a guess.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from colmap_pcd_tpu.utils import compile_cache

compile_cache.enable()

from colmap_pcd_tpu.models.database import Database
from colmap_pcd_tpu.models.feature_pipeline import (
    _MatchWorker,
    run_feature_extractor,
    sequential_pair_list,
)
from colmap_pcd_tpu.utils.config import SiftExtractionConfig, SiftMatchingConfig

W, H, F = 640, 480, 500.0
N_IMAGES = int(os.environ.get("PROF_N_IMAGES", "24"))
CHUNK = int(os.environ.get("PROF_CHUNK", "16"))


def main():
    from render import render_corridor
    from bench import make_gt
    from colmap_pcd_tpu.utils import image as image_utils

    tmp = tempfile.mkdtemp(prefix="profmatch_")
    img_dir = os.path.join(tmp, "imgs")
    os.makedirs(img_dir)
    gt = make_gt(N_IMAGES)
    t0 = time.time()
    for i, (q, t) in enumerate(gt):
        im = render_corridor(q, t, W, H, F)
        image_utils.write_png(os.path.join(img_dir, f"v{i:04d}.png"), (im * 255).astype(np.uint8))
    print(f"rendered {N_IMAGES} in {time.time()-t0:.1f}s", flush=True)

    dbp = os.path.join(tmp, "db.db")
    t0 = time.time()
    run_feature_extractor(
        dbp, img_dir,
        SiftExtractionConfig(max_num_features=2048, first_octave=0,
                             num_octaves=3, max_image_size=640),
    )
    print(f"extracted in {time.time()-t0:.1f}s", flush=True)

    db = Database(dbp)
    w = _MatchWorker(db, SiftMatchingConfig(min_num_inliers=15))
    ids = sorted(db.images().keys())
    pair_list = sequential_pair_list(ids, 5, False)
    print(f"{len(pair_list)} pairs, chunk={CHUNK}", flush=True)

    # warm one chunk (compiles)
    t0 = time.time()
    w.match_pairs(pair_list[:CHUNK], chunk=CHUNK)
    print(f"warm chunk: {time.time()-t0:.1f}s", flush=True)

    # timed stages: wrap the worker's stage methods
    seg = {}

    def timed(name, fn):
        def wrap(*a, **k):
            t = time.perf_counter()
            r = fn(*a, **k)
            seg[name] = seg.get(name, 0.0) + time.perf_counter() - t
            return r
        return wrap

    w._dev_match = timed("dev_match(section)", w._dev_match)
    w._dev_verify = timed("dev_verify(section)", w._dev_verify)
    w._prep = timed("prep(host+sqlite)", w._prep)
    w._assemble_pure = timed("assemble(host)", w._assemble_pure)
    w._classify_pure = timed("classify(host)", w._classify_pure)

    rest = pair_list[CHUNK:]
    n_chunks = len(rest) // CHUNK
    rest = rest[: n_chunks * CHUNK]
    t0 = time.time()
    n_ok = w.match_pairs(rest, chunk=CHUNK)
    wall = time.time() - t0

    print(f"\n{len(rest)} pairs in {wall:.2f}s = {len(rest)/wall:.2f} pairs/s "
          f"({n_ok} verified)")
    acc = 0.0
    for k, v in sorted(seg.items(), key=lambda kv: -kv[1]):
        print(f"  {k:20s} {v:7.2f}s  {v/wall*100:5.1f}%")
        acc += v
    print(f"  {'(unattributed host)':20s} {wall-acc:7.2f}s  {(wall-acc)/wall*100:5.1f}%")


if __name__ == "__main__":
    main()
