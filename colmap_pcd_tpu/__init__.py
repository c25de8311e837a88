"""colmap_pcd_tpu — an accelerator-native image-to-point-cloud registration
framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of Colmap-PCD
(reference: github Wangshihu12/colmap-pcd): incremental Structure-from-Motion in
which bundle adjustment is augmented with point-to-plane constraints against a
prior LiDAR map, giving metric scale and drift-free trajectories.

Layer map (device-first, not a translation of the reference's C++):

  ops/       — device compute: SE3/quaternion math, camera models, SIFT,
               matmul descriptor matching, batched RANSAC + minimal
               solvers, voxel-grid nearest-neighbor search, frustum depth
               projection, and the Gauss-Newton/LM bundle adjuster with
               Schur-complement camera reduction.
  models/    — the scene data model and pipeline logic: Reconstruction,
               Database (COLMAP-compatible SQLite), correspondence graph,
               LiDAR map, incremental mapper, triangulator, controllers.
  parallel/  — multi-device scale-out: mesh construction, sharded matching,
               distributed Schur BA via shard_map/psum.
  utils/     — host runtime: options/config registry, logging, timing,
               pipeline threading, compile cache.
  io/        — PLY / COLMAP model / pose file formats.
"""

import jax as _jax

# Geometry correctness first: every default matmul runs at "highest", which on
# the H100 is true fp32 on the CUDA cores, outside the tensor cores. Reduced
# precision (TF32 keeps a 10-bit mantissa) at scene-coordinate scale (~50 m)
# turns the 3-dim contractions (point projection, Jacobian/Schur assembly,
# minimal solvers) into millimetre-to-metre errors, and none of them has a
# contraction long enough for the tensor cores to pay. The two matmul-heavy
# sinks — descriptor matching and retrieval similarity, whose operands are
# unit-normalized and whose decisions tolerate ~1e-3 similarity error — opt
# into Precision.DEFAULT at their call sites (ops/matching.py,
# ops/retrieval.py), which XLA runs as a TF32 cuBLAS GEMM on this card; so
# does HIGH (ops/ba.py). chip_smoke.py's precision probe measures all three.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
