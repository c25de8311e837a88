"""The prior LiDAR map: loading, frame conversion, submap grid, associations.

Host-side orchestration over the device kernels in ops/pointcloud.py. Replaces
src/lidar/ply.{h,cc} (PointCloudProcess) and the host half of
src/lidar/pcd_projection.cc (PcdProj submap bookkeeping):

  * load PLY with normals, convert the lidar frame (x fwd, y left, z up) to the
    camera-convention map frame: (x,y,z) -> (-y,-z,x), same for normals,
    dropping NaNs (ply.cc:33-57 PointCloudDirectionTrans).
  * bucket the map into a cubical-cell grid (BuildSubMap, pcd_projection.cc:
    223-255) stored CSR-style (host) + as one device-resident point/normal
    array sorted by cell, so frustum-culled candidate ranges are contiguous
    gathers instead of pointer chasing.
  * project_to_image / depth-associate features (SetNewImage overloads)
  * nn_query (kd-tree replacement; exact blocked 1-NN on device)
  * voxel_downsample for display/export parity (LoadDownsizedMap, ply.cc:59).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..io import ply as ply_io
from ..ops import camera_models as cm
from ..ops import pointcloud as pc_ops

LIDAR_PROJ = 0
LIDAR_ICP = 1
LIDAR_ICP_GROUND = 2


def lidar_to_camera_frame(xyz: np.ndarray) -> np.ndarray:
    """(x fwd, y left, z up) -> camera convention (-y, -z, x)."""
    return np.stack([-xyz[:, 1], -xyz[:, 2], xyz[:, 0]], axis=-1)


def camera_to_lidar_frame(xyz: np.ndarray) -> np.ndarray:
    """Inverse of lidar_to_camera_frame: (x,y,z) -> (z, -x, -y)."""
    return np.stack([xyz[:, 2], -xyz[:, 0], -xyz[:, 1]], axis=-1)


@dataclass
class LidarMap:
    points: np.ndarray  # [N,3] camera-convention map frame
    normals: np.ndarray  # [N,3]
    cell_size: float
    # CSR grid over sorted points
    cell_keys: np.ndarray  # [n_cells, 3] int32 rounded coords
    cell_start: np.ndarray  # [n_cells]
    cell_count: np.ndarray  # [n_cells]
    # device-resident copies (sorted by cell)
    d_points: jax.Array
    d_normals: jax.Array
    d_cell_centers: jax.Array  # [n_cells,3] f32
    opts: pc_ops.ProjOptions

    # ------------------------------------------------------------------
    @classmethod
    def load(
        cls,
        path: str,
        opts: pc_ops.ProjOptions = pc_ops.ProjOptions(),
        convert_frame: bool = True,
        device=None,
    ) -> "LidarMap":
        data = ply_io.read_ply(path)
        if data.normals is None:
            raise ValueError(f"{path}: lidar map must carry per-point normals")
        xyz, nrm = data.xyz, data.normals
        if convert_frame:
            xyz = lidar_to_camera_frame(xyz)
            nrm = lidar_to_camera_frame(nrm)
        return cls.from_arrays(xyz, nrm, opts, device=device)

    @classmethod
    def from_arrays(cls, xyz, nrm, opts=pc_ops.ProjOptions(), device=None) -> "LidarMap":
        xyz = np.asarray(xyz, np.float32)
        nrm = np.asarray(nrm, np.float32)
        ok = np.all(np.isfinite(xyz), axis=1) & np.all(np.isfinite(nrm), axis=1)
        xyz, nrm = xyz[ok], nrm[ok]

        # grid bucketing: key = round(x / cell) per axis (pcd_projection.h:70-76)
        keys = np.round(xyz / opts.submap_cell).astype(np.int64)
        # lexicographic sort by (kx, ky, kz)
        order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
        xyz, nrm, keys = xyz[order], nrm[order], keys[order]
        uniq, start, count = np.unique(
            keys, axis=0, return_index=True, return_counts=True
        )
        centers = uniq.astype(np.float32) * opts.submap_cell

        put = (lambda a: jax.device_put(a, device)) if device else jnp.asarray
        return cls(
            points=xyz,
            normals=nrm,
            cell_size=opts.submap_cell,
            cell_keys=uniq.astype(np.int32),
            cell_start=start.astype(np.int64),
            cell_count=count.astype(np.int64),
            d_points=put(xyz),
            d_normals=put(nrm),
            d_cell_centers=put(centers),
            opts=opts,
        )

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    # ------------------------------------------------------------------
    def frustum_candidates(
        self, q, t, params, model_id: int, width: int, height: int, budget: int | None = None
    ):
        """Candidate point range for a view: device 5-plane cell test, host CSR
        compaction, padded contiguous gather.

        Returns (cand_idx [B] int64, valid [B] f32) where B is the padded budget.
        """
        from ..ops import np_geom

        pp = np.asarray(params)
        fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
        planes = np_geom.frustum_planes(
            np.asarray(q, np.float64), np.asarray(t, np.float64),
            pp[fi], pp[fj], pp[ci], pp[cj], width, height, self.opts.choose_meter,
        )
        # cell centers inside the frustum, with one-cell dilation via a radius
        # slack on the plane test (covers the reference's +-1-cell sweep);
        # host numpy: a few Mflop over the cell table, no device round-trips
        slack = self.cell_size * np.sqrt(3.0) * 0.5
        centers = self.cell_keys.astype(np.float64) * self.cell_size
        vals = centers @ planes[:, :3].T + planes[None, :, 3]
        mask = np.all(vals <= slack, axis=-1)
        sel = np.nonzero(mask)[0]
        if sel.size == 0:
            idx = np.zeros(0, np.int64)
        else:
            counts = self.cell_count[sel]
            total = int(counts.sum())
            # vectorized CSR expansion (no Python loop over cells)
            base = np.repeat(self.cell_start[sel], counts)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            idx = base + within
        n = idx.size
        if budget is None:
            # pad to a power-of-two bucket (min 32k): each bucket compiles
            # depth_project once EVER (the persistent compilation cache holds
            # it across processes), and tight buckets avoid streaming a
            # whole-map-sized padded candidate set through the device when the
            # frustum holds a small fraction of the map
            budget = max(32768, 1 << int(np.ceil(np.log2(max(n, 1)))))
        if n > budget:
            import logging

            logging.getLogger(__name__).warning(
                "frustum candidate set (%d) exceeds budget (%d); truncating", n, budget
            )
            idx = idx[:budget]
            n = budget
        valid = np.zeros(budget, np.float32)
        valid[:n] = 1.0
        pad = np.zeros(budget, np.int64)
        pad[:n] = idx
        return pad, valid

    # ------------------------------------------------------------------
    def project_to_image(
        self,
        feat_xy: np.ndarray,  # [F,2] full-res pixels
        q,
        t,
        params,
        model_id: int,
        width: int,
        height: int,
        feat_valid: np.ndarray | None = None,
    ):
        """Associate each feature pixel with the nearest covering lidar point.

        Returns dict with lidar_pt [F,3], lidar_nrm [F,3], found [F] bool
        (SetNewImage map-overload semantics, pcd_projection.cc:13-89).
        """
        F = feat_xy.shape[0]
        if feat_valid is None:
            feat_valid = np.ones(F, np.float32)
        # pad the feature count to a power of two (min 1024): one compiled
        # depth_project serves every image regardless of feature count
        Fp = max(1024, 1 << int(np.ceil(np.log2(max(F, 1)))))
        if Fp != F:
            feat_xy = np.concatenate([feat_xy, np.zeros((Fp - F, 2), np.float32)])
            feat_valid = np.concatenate([feat_valid, np.zeros(Fp - F, np.float32)])
        mp, mn, mv = self._map_padded()
        from ..utils import prewarm

        prewarm.record(
            "depth_proj", B=0, F=int(feat_xy.shape[0]), M=int(mp.shape[0]),
            width=width, height=height, model_id=model_id, opts=self.opts._asdict(),
        )
        lpt, lnr, found = pc_ops.depth_project(
            jnp.asarray(feat_xy, jnp.float32),
            jnp.asarray(feat_valid, jnp.float32),
            mp, mn, mv,
            jnp.asarray(q, jnp.float32),
            jnp.asarray(t, jnp.float32),
            jnp.asarray(params, jnp.float32),
            width,
            height,
            model_id,
            self.opts,
        )
        import jax

        lpt, lnr, found = jax.device_get((lpt, lnr, found))
        return {
            "lidar_pt": lpt[:F],
            "lidar_nrm": lnr[:F],
            "found": found[:F],
        }

    def _map_padded(self):
        """Padded full-map device arrays (points, normals, valid), cached.
        Projection against the FULL map needs no per-view candidate gather or
        [B,M] index upload — the projection itself culls (in-image + depth in
        [min_lidar_proj_dist, choose_meter]) and the map streams from HBM.
        Padding to a power-of-two bucket fixes the compiled shape for the
        whole run."""
        cached = getattr(self, "_d_map_pad", None)
        if cached is None:
            M = self.num_points
            Mp = max(32768, 1 << int(np.ceil(np.log2(max(M, 1)))))
            pad = Mp - M
            mp = jnp.concatenate([self.d_points, jnp.zeros((pad, 3), jnp.float32)])
            mn = jnp.concatenate([self.d_normals, jnp.zeros((pad, 3), jnp.float32)])
            mv = jnp.concatenate(
                [jnp.ones(M, jnp.float32), jnp.zeros(pad, jnp.float32)]
            )
            cached = (mp, mn, mv)
            self._d_map_pad = cached
        return cached

    # ------------------------------------------------------------------
    def project_to_images(
        self,
        feat_xy: np.ndarray,  # [B,F,2] full-res pixels (zero-padded rows ok)
        feat_valid: np.ndarray,  # [B,F]
        qs: np.ndarray,  # [B,4]
        ts: np.ndarray,  # [B,3]
        params,
        model_id: int,
        width: int,
        height: int,
    ):
        """Batched project_to_image for B views sharing one camera: one
        vmapped depth_project dispatch and one fetch instead of B (a
        local-BA round projects ~7 views).

        Returns dict with lidar_pt [B,F,3], lidar_nrm [B,F,3], found [B,F].
        """
        B0, F = feat_xy.shape[:2]
        # bucket BOTH padded dims: every distinct (B, F) pair is a separate
        # compile
        B = max(2, 1 << int(np.ceil(np.log2(max(B0, 1)))))
        Fp = max(1024, 1 << int(np.ceil(np.log2(max(F, 1)))))
        feat_xy = np.concatenate(
            [feat_xy, np.zeros((B0, Fp - F, 2), np.float32)], axis=1
        ) if Fp != F else feat_xy
        feat_valid = np.concatenate(
            [feat_valid, np.zeros((B0, Fp - F), np.float32)], axis=1
        ) if Fp != F else feat_valid
        if B != B0:
            feat_xy = np.concatenate([feat_xy, np.zeros((B - B0, Fp, 2), np.float32)])
            feat_valid = np.concatenate([feat_valid, np.zeros((B - B0, Fp), np.float32)])
            qs = np.concatenate([qs, np.tile([[1.0, 0, 0, 0]], (B - B0, 1))]).astype(np.float32)
            ts = np.concatenate([ts, np.zeros((B - B0, 3), np.float32)])
        # FULL-MAP shared candidate set: the projection culls on device, so
        # there is no per-view frustum gather and no [B,M] index upload per
        # local-BA round
        mp, mn, mv = self._map_padded()
        from ..utils import prewarm

        prewarm.record(
            "depth_proj", B=B, F=int(feat_xy.shape[1]), M=int(mp.shape[0]),
            width=width, height=height, model_id=model_id, opts=self.opts._asdict(),
        )
        lpt, lnr, found = pc_ops.depth_project_shared(
            jnp.asarray(feat_xy, jnp.float32),
            jnp.asarray(feat_valid, jnp.float32),
            mp, mn, mv,
            jnp.asarray(qs, jnp.float32),
            jnp.asarray(ts, jnp.float32),
            jnp.broadcast_to(jnp.asarray(params, jnp.float32), (B, 12)),
            width,
            height,
            model_id,
            self.opts,
        )
        import jax

        lpt, lnr, found = jax.device_get((lpt, lnr, found))
        return {
            "lidar_pt": lpt[:B0, :F],
            "lidar_nrm": lnr[:B0, :F],
            "found": found[:B0, :F],
        }

    # ------------------------------------------------------------------
    @property
    def host_tree(self):
        """Lazy native C++ kd-tree (cpp/native.cpp) — the host-side NN path.
        None when the native lib is unavailable."""
        t = getattr(self, "_host_tree", None)
        if t is None:
            from ..utils.native import NativeKdTree, get_lib

            t = NativeKdTree(self.points) if get_lib() is not None else False
            self._host_tree = t
        return t or None

    def nn_query(self, queries: np.ndarray, pad_to: int | None = None, backend: str = "auto"):
        """Exact 1-NN against the full map. Returns (points, normals, dists).

        backend: "host" = native C++ kd-tree (microseconds per query — wins
        for the mapper's small per-registration batches, which would each pay
        a device dispatch and fetch), "device" = blocked brute-force scan
        (ops/pointcloud.nn_query) over the padded map, "auto" = host when the
        native lib is built, else device. pad_to buckets the query count so
        the device program's shape repeats across calls.
        """
        Q = queries.shape[0]
        if Q == 0:
            return (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32),
            )
        if backend in ("auto", "host") and self.host_tree is not None:
            idx, dist = self.host_tree.nn(np.asarray(queries, np.float32))
            return self.points[idx], self.normals[idx], dist
        if backend == "host":
            from ..utils import native

            raise RuntimeError(
                "nn_query backend 'host' needs the native library (cpp/native.cpp), "
                f"which is not available: {native.build_error}"
            )
        if backend not in ("auto", "device"):
            raise ValueError(f"unknown nn_query backend {backend!r}")
        qarr = np.zeros((max(Q, pad_to or Q), 3), np.float32)
        qarr[:Q] = queries
        mp, _, mv = self._map_padded()
        from ..utils import prewarm

        prewarm.record("nn", Q=int(qarr.shape[0]), M=int(mp.shape[0]))
        idx, dist = jax.device_get(pc_ops.nn_query(jnp.asarray(qarr), mp, mv))
        idx = idx[:Q]
        return self.points[idx], self.normals[idx], dist[:Q]

    # ------------------------------------------------------------------
    def voxel_downsample(self, voxel: float) -> tuple[np.ndarray, np.ndarray]:
        """Centroid voxel filter for display/export (LoadDownsizedMap parity)."""
        keys = np.floor(self.points / voxel).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        n = uniq.shape[0]
        sums = np.zeros((n, 3), np.float64)
        nrms = np.zeros((n, 3), np.float64)
        cnt = np.zeros((n, 1), np.int64)
        np.add.at(sums, inv, self.points)
        np.add.at(nrms, inv, self.normals)
        np.add.at(cnt, inv, 1)
        return (sums / cnt).astype(np.float32), (nrms / cnt).astype(np.float32)
