#!/usr/bin/env python
"""Image decoding cost on the extraction path: Pillow against the built-in
numpy + zlib PNG reader (utils/image.py), on PNGs written by Pillow
(adaptive per-row filters, mostly Paeth) and by utils.image.write_png (Sub).

    python scripts/png_read_times.py [--views 40]

Renders the corridor views at 640x480, writes both PNG sets, then times
(1) decoding alone, ms per image, and (2) `feature_extractor` through the
CLI, img/s, with Pillow and with Pillow hidden. The first extractor run only
compiles. Needs Pillow, to write the adaptive set; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

W, H, F = 640, 480, 500.0


def _extract(image_dir: str, db: str) -> float:
    from colmap_pcd_tpu import cli

    t0 = time.time()
    rc = cli.main(["feature_extractor", "--database_path", db, "--image_path", image_dir,
                   "--ImageReader.camera_model", "PINHOLE", "--ImageReader.single_camera", "1",
                   "--ImageReader.camera_params", f"{F},{F},{W / 2},{H / 2}",
                   "--SiftExtraction.max_num_features", "2048",
                   "--SiftExtraction.num_octaves", "3", "--SiftExtraction.first_octave", "0",
                   "--SiftExtraction.max_image_size", str(W)])
    if rc != 0:
        raise RuntimeError(f"feature_extractor returned {rc}")
    return time.time() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=40)
    args = ap.parse_args()

    from PIL import Image as PILImage

    from bench import make_gt
    from colmap_pcd_tpu.utils import compile_cache
    from colmap_pcd_tpu.utils import image as iu
    from render import render_corridor

    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    gt = make_gt(args.views, 0.8)
    with ThreadPoolExecutor(8) as ex:
        imgs = list(ex.map(
            lambda qt: (render_corridor(qt[0], qt[1], W, H, F) * 255).astype(np.uint8), gt))
    work = tempfile.mkdtemp(prefix="png_read_times_")
    sets = {"pillow-written": os.path.join(work, "pillow"),
            "write_png": os.path.join(work, "builtin")}
    for d in sets.values():
        os.makedirs(d)
    for i, im in enumerate(imgs):
        PILImage.fromarray(im).save(os.path.join(sets["pillow-written"], f"v{i:04d}.png"))
        iu.write_png(os.path.join(sets["write_png"], f"v{i:04d}.png"), im)

    _extract(sets["write_png"], os.path.join(work, "warm.db"))  # compile
    out = {"card": card, "views": args.views}
    for reader in ("pillow", "built-in"):
        if reader == "built-in":
            sys.modules["PIL"] = None  # what a machine without Pillow sees
        for name, d in sets.items():
            files = sorted(os.listdir(d))
            t0 = time.perf_counter()
            for f in files:
                iu.imread_gray_u8(os.path.join(d, f))
            dec_ms = (time.perf_counter() - t0) / len(files) * 1e3
            dt = _extract(d, os.path.join(work, f"{reader}_{name}.db"))
            out[f"{reader} reading {name}"] = {"decode_ms_per_image": dec_ms,
                                               "extraction_img_per_s": args.views / dt}
            print(f"{reader} reader, {name} PNGs: decode {dec_ms:.3f} ms/image, "
                  f"feature_extractor {args.views / dt:.3f} img/s ({dt:.2f}s) on {card}",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
