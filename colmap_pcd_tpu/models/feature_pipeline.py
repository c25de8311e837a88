"""Feature extraction + matching controllers over the database.

Parity with src/feature/extraction.{h,cc} (SiftFeatureExtractor staged
pipeline) and src/feature/matching.{h,cc} (the matcher controller family:
Exhaustive / Sequential / Spatial / Transitive / ImagePairs / VocabTree):

  * extraction: IO-threaded read+resize -> single device SIFT stream ->
    single SQLite writer (utils/threading_utils.pipeline_map — the same
    resizer/extractor/writer topology as extraction.h:50-148, with the GPU
    boundary now one batched JAX program).
  * matching: each controller enumerates candidate pairs its own way, then a
    shared worker matches descriptors in one batched matmul program,
    verifies two-view geometry
    (LO-RANSAC banks), optionally re-matches guided by F, and writes
    matches + two_view_geometries (matching.h:401-550 semantics).
  * retrieval-based matching (VocabTree analog) uses ops/retrieval VLAD
    global descriptors — one matmul against the index instead of an
    inverted-file walk.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops import camera_models as cm
from ..ops import matching as matching_ops
from ..ops import np_geom
from ..ops import sift as sift_ops
from ..utils import device_lock
from ..utils import image as image_utils
from ..utils import prewarm
from ..utils.config import SiftExtractionConfig, SiftMatchingConfig
from ..utils.threading_utils import pipeline_map
from .database import Database
from . import two_view as two_view_mod

import functools

import jax


# extraction device batch size (a constant: each distinct B is one compile)
_EXTRACT_BATCH = 8


@functools.partial(jax.jit, static_argnames=("mopts",))
def _match_descriptors_batch(d1, d2, v1, v2, mopts):
    """vmapped descriptor matching over a pair block [B,N,128]. Outputs are
    narrowed on device (idx int16 — caps are <= 2^15 —, similarity f16),
    halving the device->host fetch."""
    idx, ok, sim = jax.vmap(
        lambda a, b, va, vb: matching_ops.match_descriptors(a, b, va, vb, mopts)
    )(d1, d2, v1, v2)
    return idx.astype(jnp.int16), ok, sim.astype(jnp.float16)


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm")


@dataclass
class ImageReaderConfig:
    camera_model: str = "OPENCV"
    single_camera: bool = True
    camera_params: str = ""  # comma-separated; empty = default from EXIF-less prior
    default_focal_factor: float = 1.2


def list_images(image_path: str) -> list[str]:
    names = []
    for root, _, files in os.walk(image_path):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                names.append(os.path.relpath(os.path.join(root, f), image_path))
    return sorted(names)


def run_feature_extractor(
    database_path: str,
    image_path: str,
    extraction: SiftExtractionConfig = SiftExtractionConfig(),
    reader: ImageReaderConfig = ImageReaderConfig(),
    num_io_threads: int = 4,
) -> int:
    """Extract SIFT for every image under image_path into the database.
    Returns the number of images processed (RunFeatureExtractor parity,
    exe/feature.cc:104)."""
    names = list_images(image_path)
    if not names:
        return 0
    db = Database(database_path)

    opts = sift_ops.SiftOptions(
        max_num_features=extraction.max_num_features,
        num_octaves=extraction.num_octaves,
        octave_resolution=extraction.octave_resolution,
        first_octave=extraction.first_octave,
        peak_threshold=extraction.peak_threshold,
        edge_threshold=extraction.edge_threshold,
        upright=extraction.upright,
        estimate_affine_shape=extraction.estimate_affine_shape,
        domain_size_pooling=extraction.domain_size_pooling,
        dsp_min_scale=extraction.dsp_min_scale,
        dsp_max_scale=extraction.dsp_max_scale,
        dsp_num_scales=extraction.dsp_num_scales,
    )

    camera_ids: dict[tuple, int] = {}
    model_id = cm.MODEL_IDS[reader.camera_model]

    def produce(batch):
        out = []
        for name in batch:
            path = os.path.join(image_path, name)
            img = image_utils.imread_gray_u8(path)
            H0, W0 = img.shape
            # EXIF-based focal prior (ImageReader + camera_database semantics,
            # base/image_reader.cc / util/bitmap.cc ExifFocalLength)
            exif_focal = None
            if not reader.camera_params:
                from ..utils.camera_database import exif_focal_length

                exif_focal = exif_focal_length(path, W0, H0)
            img, scale = image_utils.resize_max(img, extraction.max_image_size)
            out.append((img, scale, (W0, H0), exif_focal))
        return out

    @device_lock.locked_background
    def device_stage(batch, data):
        """Device section: upload + dispatch + ONE batched fetch, fully
        self-contained — the section returns numpy, so no device work is
        left pending across sections (utils/device_lock.py); the writer
        stage does masking/scale/SQLite on its own thread, overlapped with
        the next batch's upload+compute."""
        from ..utils.flops import FLOPS

        # same-shape groups run as ONE vmapped dispatch (extract_batch)
        shapes = {d[0].shape for d in data}
        if len(data) > 1 and len(shapes) == 1:
            stack = [d[0] for d in data]
            while len(stack) < _EXTRACT_BATCH:  # constant B: one batch shape
                stack.append(stack[-1])
            imgs = jnp.asarray(np.stack(stack))
            prewarm.record(
                "sift", B=imgs.shape[0], H=imgs.shape[1], W=imgs.shape[2],
                dtype=str(imgs.dtype), opts=opts._asdict(),
            )
            kp_b, desc_b, score_b, valid_b = sift_ops.extract_batch(imgs, opts)
            for img, _scale, _dims, _f in data:
                FLOPS.add(sift_ops.extract_flops(img.shape[0], img.shape[1], opts), "sift")
            fetched = jax.device_get(
                (kp_b, sift_ops.descriptors_to_uint8(desc_b), valid_b)
            )
            return ("batched", fetched, data)
        out = []
        for img, scale, dims, exif_focal in data:
            kp, desc, score, valid = sift_ops.extract(jnp.asarray(img), opts)
            FLOPS.add(sift_ops.extract_flops(img.shape[0], img.shape[1], opts), "sift")
            out.append(jax.device_get((kp, sift_ops.descriptors_to_uint8(desc), valid)))
        return ("scalar", out, data)

    def consume(batch, staged):
        kind, fetched, data = staged
        results = []
        if kind == "batched":
            kp_b, desc_b, valid_b = fetched
            for b, (img, scale, dims, exif_focal) in enumerate(data):
                kp = kp_b[b][valid_b[b]]
                desc = desc_b[b][valid_b[b]]
                if scale != 1.0:
                    kp = kp.copy()
                    kp[:, :3] /= scale
                results.append((kp, desc, dims, exif_focal))
        else:
            for (kp, desc, valid), (img, scale, dims, exif_focal) in zip(fetched, data):
                kp = kp[valid.astype(bool)]
                desc = desc[valid.astype(bool)]
                if scale != 1.0:
                    kp = kp.copy()
                    kp[:, :3] /= scale
                results.append((kp, desc, dims, exif_focal))
        for name, result in zip(batch, results):
            _consume_one(name, result)

    def _consume_one(name, result):
        kp, desc, (W0, H0), exif_focal = result
        key = (reader.camera_model, W0, H0) if reader.single_camera else (name,)
        if key not in camera_ids:
            prior_focal = False
            if reader.camera_params:
                params = [float(x) for x in reader.camera_params.split(",")]
                prior_focal = True
            else:
                f = exif_focal or reader.default_focal_factor * max(W0, H0)
                prior_focal = exif_focal is not None
                n = cm.NUM_PARAMS[model_id]
                fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
                params = [0.0] * n
                params[fi] = f
                params[fj] = f
                params[ci] = W0 / 2
                params[cj] = H0 / 2
            camera_ids[key] = db.add_camera(
                model_id, W0, H0, params, prior_focal=prior_focal
            )
        cid = camera_ids[key]
        iid = db.add_image(name, cid)
        db.write_keypoints(iid, kp[:, :4])
        db.write_descriptors(iid, desc)
        db.commit()

    # same-shape groups extract as one vmapped device dispatch; B=8 amortizes
    # per-dispatch latency and transfer over the batch
    batches = [
        names[i : i + _EXTRACT_BATCH]
        for i in range(0, len(names), _EXTRACT_BATCH)
    ]
    pipeline_map(batches, produce, consume, device_stage, num_io_threads=num_io_threads)
    db.close()
    return len(names)


def run_feature_importer(
    database_path: str,
    image_path: str,
    import_path: str,
    reader: ImageReaderConfig = ImageReaderConfig(),
) -> int:
    """Import pre-extracted features from COLMAP text files
    (FeatureImporter, feature/extraction.cc + exe/feature.cc:177
    RunFeatureImporter): for every image under image_path, reads
    `<import_path>/<name>.txt` with header "NUM DIM" and rows
    `x y scale orientation d1..dDIM` (uint8 descriptors). Camera assignment
    follows the same reader rules as extraction."""
    from ..ops import camera_models as cm
    from ..utils import image as image_utils

    names = list_images(image_path)
    db = Database(database_path)
    model_id = cm.MODEL_IDS[reader.camera_model]
    camera_ids: dict[tuple, int] = {}
    n_done = 0
    for name in names:
        feat_path = os.path.join(import_path, name + ".txt")
        if not os.path.exists(feat_path):
            print(f"skipping {name}: no feature file {feat_path}")
            continue
        with open(feat_path) as fh:
            header = fh.readline().split()
            num, dim = int(header[0]), int(header[1])
            rows = np.loadtxt(fh, dtype=np.float64, ndmin=2)
        if rows.size == 0:
            kp = np.zeros((0, 4), np.float32)
            desc = np.zeros((0, dim), np.uint8)
        else:
            assert rows.shape[1] == 4 + dim, (rows.shape, dim)
            kp = rows[:num, :4].astype(np.float32)
            desc = np.clip(np.round(rows[:num, 4:]), 0, 255).astype(np.uint8)
        W0, H0 = image_utils.image_size(os.path.join(image_path, name))
        key = (reader.camera_model, W0, H0) if reader.single_camera else (name,)
        if key not in camera_ids:
            if reader.camera_params:
                params = [float(x) for x in reader.camera_params.split(",")]
                prior_focal = True
            else:
                from ..utils.camera_database import exif_focal_length

                f = exif_focal_length(os.path.join(image_path, name), W0, H0)
                prior_focal = f is not None
                f = f or reader.default_focal_factor * max(W0, H0)
                n = cm.NUM_PARAMS[model_id]
                fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
                params = [0.0] * n
                params[fi] = params[fj] = f
                params[ci] = W0 / 2
                params[cj] = H0 / 2
            camera_ids[key] = db.add_camera(
                model_id, W0, H0, params, prior_focal=prior_focal
            )
        iid = db.add_image(name, camera_ids[key])
        db.write_keypoints(iid, kp)
        db.write_descriptors(iid, desc)
        db.commit()
        n_done += 1
    db.close()
    return n_done


# ---------------------------------------------------------------------------
# matching


class _MatchWorker:
    """Shared per-pair matcher + verifier + writer.

    Chunked SOFTWARE PIPELINE over the single device lane: every chunk of
    pairs passes through
        prepare (host: SQLite reads + padding, caller thread)
      -> match  (device section: upload + ONE vmapped matmul program + fetch)
      -> assemble (pure host: match extraction, EFH item build)
      -> verify (device section: ONE fused EFH+pose program + fetch)
      -> classify (pure host) -> SQLite writes (caller thread, in order)
    Chunks run on a small thread pool, so one chunk's host stages overlap
    another's device sections; the device sections are per-STAGE (two short
    sections per chunk instead of one monolith), letting the mapper's
    priority sections preempt between stages (monolithic chunk sections made
    the mapper queue behind them). Each device section is fully
    self-contained (dispatch + fetch), so no device work is left pending
    across sections (utils/device_lock.py). This is the device analog of the
    reference's matcher/verifier worker-pool topology
    (feature/matching.h:222-345): its CPU threads become pipeline stages
    around batched device programs."""

    def __init__(self, db: Database, config: SiftMatchingConfig):
        self.db = db
        self.cfg = config
        self._host_cache: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray, int]] = {}
        self._dev_cache: dict[int, tuple] = {}
        self.cameras = db.cameras()
        self.images = db.images()

    # ------------------------------------------------------------ features
    def _feats_host(self, image_id: int):
        """(kp_p, d_u8, v, N) padded host arrays (FeatureMatcherCache parity)."""
        if image_id not in self._host_cache:
            kp = self.db.read_keypoints(image_id)
            desc = self.db.read_descriptors(image_id)
            N = desc.shape[0]
            cap = 1 << max(6, int(np.ceil(np.log2(max(N, 1)))))
            kp_p = np.zeros((cap, 6), np.float32)
            kp_p[:N] = kp
            d_u8 = np.zeros((cap, desc.shape[1] if desc.size else 128), np.uint8)
            if N:
                d_u8[:N] = desc
            v = np.zeros(cap, np.float32)
            v[:N] = 1.0
            if len(self._host_cache) > 200:  # LRU-ish cap
                self._host_cache.pop(next(iter(self._host_cache)))
            self._host_cache[image_id] = (kp_p, d_u8, v, N)
        return self._host_cache[image_id]

    def _feats_dev(self, image_id: int):
        """Device-resident normalized descriptors. MUST run on the device
        thread. One 256 KB uint8 upload per image, normalized on device
        (padding rows normalize to zero)."""
        if image_id not in self._dev_cache:
            _, d_u8, v, _ = self._feats_host(image_id)
            if len(self._dev_cache) > 200:
                self._dev_cache.pop(next(iter(self._dev_cache)))
            d_dev = matching_ops.normalize_descriptors(jnp.asarray(d_u8))
            entry = (d_dev, jnp.asarray(v))
            jax.block_until_ready(entry)  # no in-flight work at return
            self._dev_cache[image_id] = entry
        return self._dev_cache[image_id]

    def _feats(self, image_id: int):
        """Legacy single-pair access: (kp_p, d_dev, v_dev, N)."""
        kp_p, _, _, N = self._feats_host(image_id)
        d_dev, v_dev = device_lock.EXECUTOR.run(self._feats_dev, (image_id,),
                                                priority=False)
        return kp_p, d_dev, v_dev, N

    # ------------------------------------------------------- pipeline stages
    def _prep(self, pairs):
        """Host: dedupe padding, pull host features, decide the chunk cap."""
        seen = set()
        uniq = []
        for p in pairs:
            dup = p in seen
            seen.add(p)
            uniq.append((p, dup))
        hfeats = [(self._feats_host(i), self._feats_host(j)) for i, j in pairs]
        cap = max(
            max(f1[1].shape[0] for f1, _ in hfeats),
            max(f2[1].shape[0] for _, f2 in hfeats),
        )
        degenerate = cap == 0 or all(
            f1[3] == 0 or f2[3] == 0 for f1, f2 in hfeats
        )
        return dict(pairs=list(pairs), uniq=uniq, hfeats=hfeats, cap=cap,
                    degenerate=degenerate)

    @device_lock.locked_background
    def _dev_match(self, prep):
        """Device section: upload any missing descriptors, dispatch the
        vmapped matcher, fetch — self-contained (see extraction's
        device_stage)."""
        pairs, cap = prep["pairs"], prep["cap"]
        B = len(pairs)

        def repad(d, v):
            k = cap - d.shape[0]
            if k == 0:
                return d, v
            return (
                jnp.concatenate([d, jnp.zeros((k, d.shape[1]), d.dtype)]),
                jnp.concatenate([v, jnp.zeros((k,), v.dtype)]),
            )

        d1s, v1s, d2s, v2s = [], [], [], []
        for i, j in pairs:
            d1, v1 = self._feats_dev(i)
            d2, v2 = self._feats_dev(j)
            d1p, v1p = repad(d1, v1)
            d2p, v2p = repad(d2, v2)
            d1s.append(d1p)
            v1s.append(v1p)
            d2s.append(d2p)
            v2s.append(v2p)
        mopts = matching_ops.MatchingOptions(
            max_ratio=self.cfg.max_ratio,
            max_distance=self.cfg.max_distance,
            cross_check=self.cfg.cross_check,
            guided_max_error=self.cfg.max_error,
        )
        prewarm.record("match", B=B, cap=int(cap), opts=mopts._asdict())
        out = _match_descriptors_batch(
            jnp.stack(d1s), jnp.stack(d2s), jnp.stack(v1s), jnp.stack(v2s), mopts
        )
        # one batched fetch: separate np.asarray calls would each be a
        # synchronizing transfer
        return jax.device_get(out)

    def _assemble_pure(self, prep, fetched):
        """Pure host (no DB): extract per-pair matches, build the EFH items.
        Returns (asm | None, match_writes)."""
        idx_b, ok_b, sim_b = fetched
        pairs, uniq, hfeats = prep["pairs"], prep["uniq"], prep["hfeats"]
        from ..utils.flops import FLOPS

        # count REAL per-pair descriptor work, not the padded bank (the
        # padded count inflated reported MFU; advisor finding r2)
        FLOPS.add(sum(2.0 * f1[3] * f2[3] * 128 for f1, f2 in hfeats), "matching")

        items, meta, match_writes = [], [], []
        for b, (id1, id2) in enumerate(pairs):
            if uniq[b][1]:  # duplicate padding row
                continue
            rows = np.nonzero(ok_b[b])[0]
            mpairs = np.stack([rows, idx_b[b][rows]], axis=-1).astype(np.int32)
            if len(mpairs) < self.cfg.min_num_inliers:
                match_writes.append((id1, id2, np.zeros((0, 2), np.uint32)))
                continue
            match_writes.append((id1, id2, mpairs))
            kp1 = hfeats[b][0][0]
            kp2 = hfeats[b][1][0]
            cam1 = self.cameras[self.images[id1]["camera_id"]]
            cam2 = self.cameras[self.images[id2]["camera_id"]]
            items.append(dict(
                uv1=kp1[mpairs[:, 0], :2],
                uv2=kp2[mpairs[:, 1], :2],
                params1=np_geom.pad_params(
                    cam1["params"][: cm.NUM_PARAMS[cam1["model_id"]]], cam1["model_id"]
                ),
                params2=np_geom.pad_params(
                    cam2["params"][: cm.NUM_PARAMS[cam2["model_id"]]], cam2["model_id"]
                ),
                model_id1=cam1["model_id"],
                model_id2=cam2["model_id"],
                size1=(cam1["width"], cam1["height"]),
                size2=(cam2["width"], cam2["height"]),
                quality=sim_b[b][mpairs[:, 0]],
            ))
            meta.append((id1, id2, mpairs))
        if not items:
            return None, match_writes
        # pad the survivor batch to the chunk size — the vmapped EFH
        # program's B must stay constant across chunks
        n_real = len(items)
        while len(items) < len(pairs):
            items.append(items[-1])
        return dict(items=items, meta=meta, n_real=n_real), match_writes

    def _tv_opts(self):
        return two_view_mod.TwoViewOptions(
            max_error=self.cfg.max_error,
            min_num_inliers=self.cfg.min_num_inliers,
            num_hypotheses=getattr(self.cfg, "num_hypotheses", 1024),
        )

    @device_lock.locked_background
    def _dev_verify(self, asm):
        """Device section: dispatch the fused EFH+pose program + fetch —
        self-contained (see _dev_match)."""
        handles, ctx = two_view_mod.two_view_verify_dispatch(
            asm["items"], self._tv_opts()
        )
        fetched = jax.device_get(handles) if handles is not None else None
        return fetched, ctx

    def _classify_pure(self, asm, vctx, vfetched):
        """Pure host: configuration classification. Returns (geom_writes,
        n_ok) with geom_writes rows (id1, id2, inliers, geom)."""
        geoms = two_view_mod.two_view_verify_classify(
            vfetched, vctx, asm["items"], self._tv_opts()
        )[: asm["n_real"]]
        n_ok = 0
        geom_writes = []
        for (id1, id2, mpairs), g in zip(asm["meta"], geoms):
            rows = g.inlier_matches[:, 0] if len(g.inlier_matches) else np.zeros(0, np.int64)
            inliers = mpairs[rows] if len(rows) else np.zeros((0, 2), np.uint32)
            geom_writes.append((id1, id2, inliers, g))
            if len(inliers) >= self.cfg.min_num_inliers:
                n_ok += 1
        return geom_writes, n_ok

    def _process_chunk(self, prep):
        """One chunk through match -> assemble -> verify -> classify; pure
        except the two device sections (safe from any thread — they execute
        on the device-executor thread). Returns (match_writes, geom_writes,
        n_ok) for the caller to flush into SQLite in submission order."""
        if prep["degenerate"]:
            return (
                [(i, j, np.zeros((0, 2), np.uint32))
                 for (i, j), (_, dup) in zip(prep["pairs"], prep["uniq"]) if not dup],
                [], 0,
            )
        fetched = self._dev_match(prep)
        asm, match_writes = self._assemble_pure(prep, fetched)
        if asm is None:
            return match_writes, [], 0
        vfetched, vctx = self._dev_verify(asm)
        geom_writes, n_ok = self._classify_pure(asm, vctx, vfetched)
        return match_writes, geom_writes, n_ok

    def match_pairs(self, pair_list, chunk: int = 16) -> int:
        """Pipelined batched pair matching + verification (see class doc):
        chunks run on a 2-thread pool so one chunk's host assembly overlaps
        the other's device sections (which serialize on the device executor
        anyway); DB reads (_prep) and all writes stay on the calling thread
        (SQLite connections are single-thread), applied in submission order.
        Returns the number of pairs with a verified geometry."""
        if self.cfg.guided_matching:
            return sum(1 if self.match_pair(i, j) else 0 for i, j in pair_list)
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        blocks = []
        for c0 in range(0, len(pair_list), chunk):
            block = list(pair_list[c0 : c0 + chunk])
            # pad the final partial chunk with repeats so the batch shape B is
            # constant (each distinct B is another compiled program); the
            # worker skips duplicates
            while 0 < len(block) < chunk:
                block.append(block[-1])
            blocks.append(block)

        n_ok = 0

        def flush(fut):
            nonlocal n_ok
            match_writes, geom_writes, ok = fut.result()
            for id1, id2, mpairs in match_writes:
                self.db.write_matches(id1, id2, mpairs)
            for id1, id2, inliers, g in geom_writes:
                self.db.write_two_view_geometry(
                    id1, id2, inliers, g.config, F=g.F, E=g.E, H=g.H,
                    qvec=g.qvec, tvec=g.tvec,
                )
            self.db.commit()
            n_ok += ok

        window: deque = deque()
        with ThreadPoolExecutor(max_workers=2) as pool:
            for block in blocks:
                prep = self._prep(block)  # caller thread: SQLite reads
                window.append(pool.submit(self._process_chunk, prep))
                while len(window) > 2:
                    flush(window.popleft())
            while window:
                flush(window.popleft())
        return n_ok

    @device_lock.locked_background
    def match_pair(self, id1: int, id2: int) -> int:
        """Match + verify + write. Returns inlier count."""
        kp1, d1, v1, n1 = self._feats(id1)
        kp2, d2, v2, n2 = self._feats(id2)
        if n1 == 0 or n2 == 0:
            return 0
        mopts = matching_ops.MatchingOptions(
            max_ratio=self.cfg.max_ratio,
            max_distance=self.cfg.max_distance,
            cross_check=self.cfg.cross_check,
            guided_max_error=self.cfg.max_error,
        )
        idx, ok, sim1 = matching_ops.match_descriptors(d1, d2, v1, v2, mopts)
        from ..utils.flops import FLOPS

        FLOPS.add(2.0 * d1.shape[0] * d2.shape[0] * 128, "matching")
        pairs = matching_ops.matches_to_pairs(idx, ok)
        if len(pairs) < self.cfg.min_num_inliers:
            self.db.write_matches(id1, id2, np.zeros((0, 2), np.uint32))
            return 0
        self.db.write_matches(id1, id2, pairs)

        cam1 = self.cameras[self.images[id1]["camera_id"]]
        cam2 = self.cameras[self.images[id2]["camera_id"]]
        uv1 = kp1[pairs[:, 0], :2]
        uv2 = kp2[pairs[:, 1], :2]
        quality = np.asarray(sim1)[pairs[:, 0]]
        g = two_view_mod.estimate_two_view_geometry(
            uv1, uv2,
            np_geom.pad_params(cam1["params"][: cm.NUM_PARAMS[cam1["model_id"]]], cam1["model_id"]),
            np_geom.pad_params(cam2["params"][: cm.NUM_PARAMS[cam2["model_id"]]], cam2["model_id"]),
            cam1["model_id"], cam2["model_id"],
            two_view_mod.TwoViewOptions(
                max_error=self.cfg.max_error,
                min_num_inliers=self.cfg.min_num_inliers,
            ),
            quality=quality,
        )
        inlier_rows = g.inlier_matches[:, 0] if len(g.inlier_matches) else np.zeros(0, np.int64)

        if self.cfg.guided_matching and g.F is not None and len(inlier_rows) >= self.cfg.min_num_inliers:
            gi, gok = matching_ops.match_guided(
                d1, d2,
                jnp.asarray(kp1[:, :2]), jnp.asarray(kp2[:, :2]),
                v1, v2, jnp.asarray(g.F, jnp.float32), mopts,
            )
            gpairs = matching_ops.matches_to_pairs(gi, gok)
            if len(gpairs) > len(inlier_rows):
                self.db.write_two_view_geometry(
                    id1, id2, gpairs, g.config,
                    F=g.F, E=g.E, H=g.H, qvec=g.qvec, tvec=g.tvec,
                )
                self.db.commit()
                return len(gpairs)

        inliers = pairs[inlier_rows] if len(inlier_rows) else np.zeros((0, 2), np.uint32)
        self.db.write_two_view_geometry(
            id1, id2, inliers, g.config, F=g.F, E=g.E, H=g.H, qvec=g.qvec, tvec=g.tvec
        )
        self.db.commit()
        return len(inliers)


def run_exhaustive_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    block_size: int = 50,
) -> int:
    """All-pairs matching in blocks (ExhaustiveFeatureMatcher,
    matching.h:401)."""
    db = Database(database_path)
    w = _MatchWorker(db, config)
    ids = sorted(db.images().keys())
    pair_list = []
    for bi in range(0, len(ids), block_size):
        for bj in range(bi, len(ids), block_size):
            for i in ids[bi : bi + block_size]:
                for j in ids[bj : bj + block_size]:
                    if j > i:
                        pair_list.append((i, j))
    n = w.match_pairs(pair_list)
    db.close()
    return n


def run_sequential_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    overlap: int = 10,
    quadratic_overlap: bool = True,
    loop_detection: bool = False,
    loop_detection_period: int = 10,
    loop_detection_num_images: int = 30,
    loop_spatial_rerank: bool = False,
) -> int:
    """Consecutive-pair matching with optional retrieval loop closure
    (SequentialFeatureMatcher, matching.h:434). loop_spatial_rerank re-ranks
    loop candidates by vote-and-verify effective inliers (the reference's
    spatial-verification retrieval mode) — the false-loop suppressor on
    repetitive structure."""
    db = Database(database_path)
    w = _MatchWorker(db, config)
    ids = sorted(db.images().keys())  # name-ordered assumed == id order
    pair_list = sequential_pair_list(ids, overlap, quadratic_overlap)
    n = w.match_pairs(pair_list)
    if loop_detection:
        from ..ops import retrieval

        index = retrieval.build_index(
            {i: np.asarray(db.read_descriptors(i), np.float32) for i in ids},
            geoms_by_image={
                i: np.asarray(db.read_keypoints(i), np.float32)[:, :4] for i in ids
            } if loop_spatial_rerank else None,
        )
        # set-based dedup, seeded with the sequential pairs so overlapping
        # loop candidates are neither re-matched nor double-counted
        seen = {(min(i, j), max(i, j)) for i, j in pair_list}
        loop_pairs = []
        for a in range(0, len(ids), loop_detection_period):
            i = ids[a]
            cand = retrieval.query(
                index, i, loop_detection_num_images,
                rerank=loop_spatial_rerank,
            )
            for j in cand:
                key = (min(i, j), max(i, j))
                if j != i and key not in seen:
                    seen.add(key)
                    loop_pairs.append(key)
        n += w.match_pairs(loop_pairs)
    db.close()
    return n


def sequential_pair_list(ids: list[int], overlap: int, quadratic_overlap: bool):
    """Deduped sequential pair list (SequentialFeatureMatcher pair policy)."""
    seen: set[tuple[int, int]] = set()
    pair_list: list[tuple[int, int]] = []
    for a, i in enumerate(ids):
        for d in range(1, overlap + 1):
            offsets = [d, (1 << d)] if quadratic_overlap else [d]
            for off in offsets:
                b = a + off
                if b < len(ids) and (i, ids[b]) not in seen:
                    seen.add((i, ids[b]))
                    pair_list.append((i, ids[b]))
    return pair_list


def run_spatial_matcher(
    database_path: str,
    locations: dict[int, np.ndarray],
    config: SiftMatchingConfig = SiftMatchingConfig(),
    max_num_neighbors: int = 50,
    max_distance: float = 100.0,
) -> int:
    """Position-prior neighbor matching (SpatialFeatureMatcher,
    matching.h:474): match each image against its nearest neighbors in space."""
    db = Database(database_path)
    w = _MatchWorker(db, config)
    ids = [i for i in sorted(db.images().keys()) if i in locations]
    locs = np.stack([locations[i] for i in ids])
    pair_list = []
    for a, i in enumerate(ids):
        d = np.linalg.norm(locs - locs[a], axis=1)
        order = np.argsort(d)
        cnt = 0
        for b in order:
            j = ids[int(b)]
            if j == i or d[b] > max_distance:
                continue
            if cnt >= max_num_neighbors:
                break
            cnt += 1
            if j > i and (i, j) not in pair_list:
                pair_list.append((i, j))
    n = w.match_pairs(pair_list)
    db.close()
    return n


def run_transitive_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    batch_size: int = 1000,
    num_iterations: int = 3,
) -> int:
    """Close the match graph transitively (TransitiveFeatureMatcher,
    matching.h:513): if A-B and B-C matched, try A-C."""
    db = Database(database_path)
    w = _MatchWorker(db, config)
    n = 0
    for _ in range(num_iterations):
        pairs = db.all_two_view_pair_ids()
        adj: dict[int, set[int]] = {}
        have = set()
        for i, j in pairs:
            adj.setdefault(i, set()).add(j)
            adj.setdefault(j, set()).add(i)
            have.add((min(i, j), max(i, j)))
        todo = []
        for b, nbrs in adj.items():
            for a in nbrs:
                for c in nbrs:
                    if a < c and (a, c) not in have:
                        todo.append((a, c))
                        have.add((a, c))
        if not todo:
            break
        n += w.match_pairs(todo[:batch_size])
    db.close()
    return n


def run_image_pairs_matcher(
    database_path: str,
    pairs: list[tuple[str, str]],
    config: SiftMatchingConfig = SiftMatchingConfig(),
) -> int:
    """Match an explicit list of image-name pairs (ImagePairsFeatureMatcher)."""
    db = Database(database_path)
    w = _MatchWorker(db, config)
    by_name = {v["name"]: k for k, v in db.images().items()}
    pair_list = []
    for n1, n2 in pairs:
        if n1 in by_name and n2 in by_name:
            i, j = by_name[n1], by_name[n2]
            if i != j and (min(i, j), max(i, j)) not in pair_list:
                pair_list.append((min(i, j), max(i, j)))
    n = w.match_pairs(pair_list)
    db.close()
    return n


def run_feature_pairs_importer(
    database_path: str,
    pairs_file: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    verify: bool = True,
) -> int:
    """Import raw feature-index matches from a text file
    (FeaturePairsFeatureMatcher, matching.h:538): blocks of
    'name1 name2' followed by 'idx1 idx2' lines, blank-line separated.
    With verify=True the imported matches get two-view verification."""
    db = Database(database_path)
    by_name = {v["name"]: k for k, v in db.images().items()}
    w = _MatchWorker(db, config)
    n = 0
    with open(pairs_file) as f:
        blocks = f.read().split("\n\n")
    for block in blocks:
        lines = [l for l in block.splitlines() if l.strip()]
        if not lines:
            continue
        n1, n2 = lines[0].split()[:2]
        if n1 not in by_name or n2 not in by_name:
            continue
        id1, id2 = by_name[n1], by_name[n2]
        m = np.asarray(
            [[int(a), int(b)] for a, b in (l.split()[:2] for l in lines[1:])],
            np.uint32,
        ).reshape(-1, 2)
        db.write_matches(id1, id2, m)
        if verify and len(m) >= config.min_num_inliers:
            kp1, _, _, _ = w._feats_host(id1)
            kp2, _, _, _ = w._feats_host(id2)
            cam1 = w.cameras[w.images[id1]["camera_id"]]
            cam2 = w.cameras[w.images[id2]["camera_id"]]
            from ..ops import camera_models as cmm

            g = two_view_mod.estimate_two_view_geometry(
                kp1[m[:, 0], :2], kp2[m[:, 1], :2],
                np_geom.pad_params(cam1["params"][: cmm.NUM_PARAMS[cam1["model_id"]]], cam1["model_id"]),
                np_geom.pad_params(cam2["params"][: cmm.NUM_PARAMS[cam2["model_id"]]], cam2["model_id"]),
                cam1["model_id"], cam2["model_id"],
            )
            inl = m[g.inlier_matches[:, 0]] if len(g.inlier_matches) else np.zeros((0, 2), np.uint32)
            db.write_two_view_geometry(id1, id2, inl, g.config, F=g.F, E=g.E, H=g.H)
        else:
            db.write_two_view_geometry(id1, id2, m, two_view_mod.CALIBRATED)
        db.commit()
        n += 1
    db.close()
    return n


def run_vocab_tree_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    num_images: int = 100,
    spatial_rerank: bool = False,
    num_verify: int = 20,
) -> int:
    """Retrieval-based matching (VocabTreeFeatureMatcher, matching.h:455):
    VLAD global descriptors instead of a FLANN vocab tree. spatial_rerank
    re-orders each query's shortlist by vote-and-verify effective inlier
    count (retrieval/vote_and_verify.cc analog, ops/vote_verify.py)."""
    from ..ops import retrieval

    db = Database(database_path)
    w = _MatchWorker(db, config)
    ids = sorted(db.images().keys())
    index = retrieval.build_index(
        {i: np.asarray(db.read_descriptors(i), np.float32) for i in ids},
        geoms_by_image={
            i: np.asarray(db.read_keypoints(i), np.float32)[:, :4] for i in ids
        } if spatial_rerank else None,
    )
    pair_list = []
    for i in ids:
        for j in retrieval.query(
            index, i, num_images, rerank=spatial_rerank, num_verify=num_verify
        ):
            if j > i and (i, j) not in pair_list:
                pair_list.append((i, j))
    n = w.match_pairs(pair_list)
    db.close()
    return n
