#!/usr/bin/env python
"""Break extraction throughput into produce / dispatch / fetch / write on the
GPU (run alone: one JAX process per card). Renders a small
corridor set, then times each stage of the extraction pipeline separately —
the overlapped bench only reports the aggregate img/s."""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax
import jax.numpy as jnp
import numpy as np

from colmap_pcd_tpu.utils import compile_cache

compile_cache.enable()

N_IMG = int(os.environ.get("N_IMG", "40"))
W, H, F = 640, 480, 500.0


def main():
    from bench import make_gt
    from colmap_pcd_tpu.ops import sift as sift_ops
    from colmap_pcd_tpu.utils import image as image_utils
    from render import render_corridor

    print(f"device: {jax.devices()[0].device_kind}")
    gt = make_gt(N_IMG)
    tmp = tempfile.mkdtemp(prefix="profext_")
    t0 = time.time()
    for i in range(N_IMG):
        q, t = gt[i]
        im = render_corridor(q, t, W, H, F)
        image_utils.write_png(os.path.join(tmp, f"v{i:04d}.png"), (im * 255).astype(np.uint8))
    print(f"render+save: {time.time()-t0:.2f}s")

    names = sorted(os.listdir(tmp))
    opts = sift_ops.SiftOptions(
        max_num_features=2048, num_octaves=3, octave_resolution=3, first_octave=0
    )

    # stage 1: decode+resize (host)
    t0 = time.time()
    imgs = []
    for n in names:
        img = image_utils.imread_gray(os.path.join(tmp, n))
        img, scale = image_utils.resize_max(img, 640)
        imgs.append(img)
    t_produce = time.time() - t0
    print(f"produce (decode+resize) {N_IMG} imgs: {t_produce:.2f}s "
          f"({N_IMG/t_produce:.1f} img/s)")

    # stage 2: device extract_batch, batch of B
    for B in (4, 8, 16):
        stacks = [
            np.stack(imgs[i : i + B] + [imgs[0]] * max(0, B - (N_IMG - i)))
            for i in range(0, N_IMG, B)
        ]
        # warm compile
        out = sift_ops.extract_batch(jnp.asarray(stacks[0]), opts)
        jax.block_until_ready(out[0])
        t0 = time.time()
        tot_fetch = 0.0
        for s in stacks:
            kp, desc, score, valid = sift_ops.extract_batch(jnp.asarray(s), opts)
            t1 = time.time()
            kp, desc, valid = jax.device_get(
                (kp, sift_ops.descriptors_to_uint8(desc), valid)
            )
            tot_fetch += time.time() - t1
        dt = time.time() - t0
        print(f"extract_batch B={B}: {dt:.2f}s for {len(stacks)} batches "
              f"-> {N_IMG/dt:.1f} img/s (fetch {tot_fetch:.2f}s)")


if __name__ == "__main__":
    main()
