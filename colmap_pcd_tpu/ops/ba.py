"""Bundle adjustment on the device: Levenberg-Marquardt with Schur complement.

Replaces the reference's Ceres problems (src/optim/bundle_adjustment.cc:443-1131),
PBA (lib/PBA) and the autodiff cost functors (src/base/cost_functions.h) with a
single batched JAX solver built from dense batched contractions:

  residuals  : 2D reprojection per observation (any of the 11 camera models) +
               1D weighted point-to-plane distance per 3D point against its
               associated LiDAR plane (cost_functions.h:150-241).
  robust loss: trivial / soft-L1 / Cauchy via IRLS sqrt-weighting
               (bundle_adjustment.h:80-84 loss_function_type).
  structure  : block-sparse normal equations; the point blocks (3x3) are
               eliminated per point in closed form and the reduced camera
               system (6 per pose [+ 6-padded intrinsics block per camera])
               is assembled densely and solved by Cholesky — the device
               analog of Ceres DENSE_SCHUR/SPARSE_SCHUR
               (bundle_adjustment.cc:499-512): a few-hundred-camera reduced
               system is a small dense matrix, so there is no need for
               sparsity.
  damping    : classic LM with multiplicative lambda updates inside a
               jax.lax.while_loop; the whole solve is one fused XLA program.

Everything is fixed-shape: observations, tracks, and constraints are padded
and masked, so one compiled executable serves every local-BA invocation of the
incremental mapper.

Parameterization: pose deltas are se3 tangents applied by left-multiplicative
retraction (ops/se3.py), point deltas are Euclidean, intrinsics deltas are
masked per-parameter (refine_focal / refine_principal / refine_extra mirroring
BundleAdjustmentOptions, bundle_adjustment.h:66-78).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import camera_models as cm
from . import se3

Array = jax.Array

# Schur assembly/reduction einsums run at HIGH rather than the package-wide
# HIGHEST: the GN system is a step direction, not the objective — residuals
# and costs stay exact, LM's accept test guards against a degraded step —
# and these contractions are most of the solve's FLOPs. On the H100 (JAX
# 0.9.0) XLA lowers a HIGH f32 dot to the same cuBLAS TF32 GEMM as DEFAULT
# (chip_smoke's precision probe: 3.3e-4 max relative error on a 1024^3
# product for both, 1.5e-6 at HIGHEST). In the compiled solve the Schur
# reduction and the one-hot block sums become such GEMMs: 99.8-99.97% of
# the contraction FLOPs (scripts/ba_hlo_precision.py); the few small
# per-observation blocks left as dots in fusions carry the rest. BA parity
# against the CPU holds (final cost within 1e-7 relative, camera centres
# within 0.1 mm; PERF.md).
_HI = jax.lax.Precision.HIGH


LOSS_TRIVIAL = 0
LOSS_SOFT_L1 = 1
LOSS_CAUCHY = 2


class BAConfig(NamedTuple):
    """Static solve configuration (hashable; part of the jit cache key)."""

    model_id: int = 1
    # distinct camera models present in the problem (static, part of the jit
    # key). Empty tuple = single-model problem using model_id. With several,
    # problem.cam_model[k] indexes into this tuple per intrinsics slot and the
    # residual selects the right projection per observation — mixed-model
    # scenes get exact per-camera dispatch (bundle_adjustment.cc:1047-1100).
    model_ids: tuple = ()
    loss_type: int = LOSS_TRIVIAL
    loss_scale: float = 1.0
    max_iterations: int = 25
    refine_intrinsics: bool = False  # adds one padded 6-block per camera
    refine_focal: bool = True
    refine_principal: bool = False
    refine_extra: bool = True
    point_chunk: int = 512  # points per Schur assembly chunk
    lidar_loss_robust: bool = False  # robust loss on lidar terms too
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    track_len: int = 16  # T: max observations per point in the problem
    # Ceres function_tolerance semantics: terminate on the FIRST accepted
    # step whose relative cost change is below this (f32 can't resolve much
    # below 1e-6 anyway); rejected steps get max_consecutive_rejects tries
    function_tolerance: float = 1e-6
    max_consecutive_rejects: int = 4
    # number of pose 6-blocks in the reduced camera system (0 -> one per
    # camera slot). Spherical/global problems map all FIXED cameras to block
    # 0 (their jacobians are zeroed, so they contribute nothing) and compact
    # the variable cameras into the first blocks: the Schur system then
    # scales with the VARIABLE count, not the scene's total camera count.
    num_pose_blocks: int = 0
    # camera-side solver for the reduced (Schur) system. "dense": assemble
    # S and Cholesky-factor it. "pcg": matrix-free preconditioned conjugate
    # gradients on the Schur complement with a block-Jacobi (SCHUR_JACOBI)
    # preconditioner — never forms S, memory O(blocks) instead of O(blocks^2).
    # "auto" escalates dense -> pcg above dense_max_pose_blocks variable
    # blocks, mirroring the reference's DENSE_SCHUR -> ITERATIVE_SCHUR +
    # SCHUR_JACOBI ladder at >1000 images (bundle_adjustment.cc:499-512).
    camera_solver: str = "auto"
    dense_max_pose_blocks: int = 1024
    pcg_max_iterations: int = 100
    pcg_rtol: float = 1e-6


class BAProblem(NamedTuple):
    """Padded, fixed-shape bundle adjustment problem.

    Shapes: C = image slots, K = camera (intrinsics) slots, P = point slots,
    N = observation slots, T = cfg.track_len.
    """

    cam_q: Array  # [C,4] world-to-camera quaternion (w,x,y,z)
    cam_t: Array  # [C,3]
    cam_k: Array  # [C] int32 camera(intrinsics) slot per image
    intr: Array  # [K,12] padded camera params
    cam_model: Array  # [K] int32 index into cfg.model_ids (0 if single-model)
    points: Array  # [P,3]
    obs_cam: Array  # [N] int32 image slot (0 for padding)
    obs_pt: Array  # [N] int32 point slot (0 for padding)
    obs_uv: Array  # [N,2] pixel measurements
    obs_valid: Array  # [N] f32 {0,1}
    # [P,T] int32 indices into obs arrays, -1 padded. INVARIANT: the valid
    # entries must be INJECTIVE and COMPLETE — every valid observation index
    # appears exactly once across the table (make_problem guarantees this;
    # asserted there). The Schur reduction scatters per-obs W into slots
    # keyed by pt_obs while the back-substitution sums W over ALL valid
    # observations — a duplicated or missing entry silently biases dx_p
    # against dx_cam.
    pt_obs: Array
    lidar_plane: Array  # [P,4] (a,b,c,d), |n|=1, plane through associated lidar pt
    lidar_w: Array  # [P] f32 constraint weight, 0 = none
    cam_blk: Array  # [C] int32 — pose block slot per camera (fixed -> 0 ok)
    pose_fixed: Array  # [C] f32 {0,1} — 1 freezes the full pose
    tvec_fixed: Array  # [C,3] f32 {0,1} — per-component translation freeze
    point_fixed: Array  # [P] f32 {0,1}
    intr_fixed: Array  # [K] f32 {0,1} — 1 freezes that camera's intrinsics
    num_cams: Array  # [] int32 — live image slots (<= C)
    num_points: Array  # [] int32


class BAResult(NamedTuple):
    cam_q: Array
    cam_t: Array
    intr: Array
    points: Array
    initial_cost: Array
    final_cost: Array
    iterations: Array


# ---------------------------------------------------------------------------
# residuals & robust loss


def _models(cfg: BAConfig) -> tuple:
    return cfg.model_ids if cfg.model_ids else (cfg.model_id,)


def _intr_refine_mask_for(model_id: int, cfg: BAConfig) -> list:
    fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
    n = cm.NUM_PARAMS[model_id]
    m = [0.0] * cm.MAX_PARAMS
    for i in range(n):
        if i in (fi, fj):
            m[i] = 1.0 if cfg.refine_focal else 0.0
        elif i in (ci, cj):
            m[i] = 1.0 if cfg.refine_principal else 0.0
        else:
            m[i] = 1.0 if cfg.refine_extra else 0.0
    return m


def _intr_refine_mask(cfg: BAConfig) -> jnp.ndarray:
    """[M,12] per-model mask of intrinsic params allowed to move."""
    return jnp.asarray([_intr_refine_mask_for(m, cfg) for m in _models(cfg)], jnp.float32)


def _project_dispatch(cfg: BAConfig, kparams, q, t, X, midx):
    """cm.project dispatched over the (static) set of camera models; midx
    selects per call. Single-model problems compile to a direct call."""
    models = _models(cfg)
    if len(models) == 1:
        return cm.project(models[0], kparams, q, t, X)
    outs = [cm.project(m, kparams, q, t, X) for m in models]
    onehot = jax.nn.one_hot(midx, len(models), dtype=outs[0][1].dtype)
    xy = sum(onehot[..., i, None] * outs[i][0] for i in range(len(models)))
    z = sum(onehot[..., i] * outs[i][1] for i in range(len(models)))
    return xy, z


def _sqrt_rho_deriv(sq_norm: Array, cfg: BAConfig) -> Array:
    """IRLS weight sqrt(rho'(s)) for robust losses; s = squared residual norm."""
    s = sq_norm / (cfg.loss_scale**2)
    if cfg.loss_type == LOSS_TRIVIAL:
        return jnp.ones_like(sq_norm)
    if cfg.loss_type == LOSS_SOFT_L1:
        return (1.0 + s) ** (-0.25)
    if cfg.loss_type == LOSS_CAUCHY:
        return (1.0 + s) ** (-0.5)
    raise ValueError(f"unknown loss {cfg.loss_type}")


def _rho(sq_norm: Array, cfg: BAConfig) -> Array:
    """Robust loss value rho(s)."""
    s = sq_norm / (cfg.loss_scale**2)
    c2 = cfg.loss_scale**2
    if cfg.loss_type == LOSS_TRIVIAL:
        return sq_norm
    if cfg.loss_type == LOSS_SOFT_L1:
        return 2.0 * c2 * (jnp.sqrt(1.0 + s) - 1.0)
    if cfg.loss_type == LOSS_CAUCHY:
        return c2 * jnp.log1p(s)
    raise ValueError(f"unknown loss {cfg.loss_type}")


def _reproj_residual(cfg, q, t, kparams, X, uv, midx=0):
    """2-vector reprojection residual; masked to 0 behind the camera."""
    xy, z = _project_dispatch(cfg, kparams, q, t, X, midx)
    r = xy - uv
    ok = (z > 1e-3).astype(r.dtype)
    # clamp the residual so wild outliers cannot produce inf/nan in f32
    r = jnp.clip(r, -1e4, 1e4)
    return r * ok[..., None]


def _obs_midx(problem: BAProblem) -> Array:
    """Per-observation model index into cfg.model_ids."""
    return problem.cam_model[problem.cam_k[problem.obs_cam]]


def reprojection_errors(problem: BAProblem, cfg: BAConfig) -> Array:
    """Per-observation reprojection error norms (pixels), padded entries 0."""
    q = problem.cam_q[problem.obs_cam]
    t = problem.cam_t[problem.obs_cam]
    k = problem.intr[problem.cam_k[problem.obs_cam]]
    X = problem.points[problem.obs_pt]
    r = _reproj_residual(cfg, q, t, k, X, problem.obs_uv, _obs_midx(problem))
    return jnp.linalg.norm(r, axis=-1) * problem.obs_valid


def total_cost(
    cam_q: Array,
    cam_t: Array,
    intr: Array,
    points: Array,
    problem: BAProblem,
    cfg: BAConfig,
    psum_axis: str | None = None,
) -> Array:
    q = cam_q[problem.obs_cam]
    t = cam_t[problem.obs_cam]
    k = intr[problem.cam_k[problem.obs_cam]]
    X = points[problem.obs_pt]
    r = _reproj_residual(cfg, q, t, k, X, problem.obs_uv, _obs_midx(problem))
    sq = jnp.sum(r * r, axis=-1) * problem.obs_valid
    cost = jnp.sum(_rho(sq, cfg) * problem.obs_valid)
    # lidar point-to-plane: w * (n . X + d)
    n = problem.lidar_plane[:, :3]
    d = problem.lidar_plane[:, 3]
    rl = problem.lidar_w * (jnp.sum(points * n, axis=-1) + d)
    if cfg.lidar_loss_robust:
        cost = cost + jnp.sum(_rho(rl * rl, cfg))
    else:
        cost = cost + jnp.sum(rl * rl)
    if psum_axis is not None:
        # multi-chip: every shard sees the global cost so the LM accept/reject
        # decisions stay lockstep-identical across devices
        cost = jax.lax.psum(cost, psum_axis)
    return cost


# ---------------------------------------------------------------------------
# jacobians


def _obs_jacobians(problem: BAProblem, cfg: BAConfig, cam_q, cam_t, intr, points):
    """Per-observation residuals and Jacobians at delta = 0.

    Returns r [N,2], Jc [N,2,6] (pose tangent), Jp [N,2,3] (point),
    Jk [N,2,12] (intrinsics, refine-masked), all already robust-weighted,
    frozen-parameter columns zeroed, invalid observations zeroed.
    """
    q = cam_q[problem.obs_cam]
    t = cam_t[problem.obs_cam]
    kcam = problem.cam_k[problem.obs_cam]
    k = intr[kcam]
    X = points[problem.obs_pt]
    uv = problem.obs_uv
    midx = problem.cam_model[kcam]
    kmask_per_obs = _intr_refine_mask(cfg)[midx]  # [N,12]

    def f(dc, dx, dk, q, t, k, X, uv, mi, kmask):
        # rotation: left-multiplicative quaternion update; translation: additive
        # (matches the reference's quaternion manifold + subset-manifold tvec,
        # bundle_adjustment.cc:794-803 — and makes tvec-component freezing exact)
        q2 = se3.quat_mul(se3.so3_exp_quat(dc[:3]), q)
        t2 = t + dc[3:]
        return _reproj_residual(cfg, q2, t2, k + dk * kmask, X + dx, uv, mi)

    z6 = jnp.zeros((6,), jnp.float32)
    z3 = jnp.zeros((3,), jnp.float32)
    z12 = jnp.zeros((12,), jnp.float32)

    if cfg.refine_intrinsics:

        def per_obs(q, t, k, X, uv, mi, kmask):
            r = f(z6, z3, z12, q, t, k, X, uv, mi, kmask)
            Jc, Jp, Jk = jax.jacfwd(f, argnums=(0, 1, 2))(z6, z3, z12, q, t, k, X, uv, mi, kmask)
            return r, Jc, Jp, Jk

        r, Jc, Jp, Jk = jax.vmap(per_obs)(q, t, k, X, uv, midx, kmask_per_obs)
    else:
        # intrinsics frozen: the 12 intrinsics tangents are 12 of 21 forward
        # passes — skip them entirely (every incremental-mapper solve)
        def per_obs(q, t, k, X, uv, mi, kmask):
            r = f(z6, z3, z12, q, t, k, X, uv, mi, kmask)
            Jc, Jp = jax.jacfwd(f, argnums=(0, 1))(z6, z3, z12, q, t, k, X, uv, mi, kmask)
            return r, Jc, Jp

        r, Jc, Jp = jax.vmap(per_obs)(q, t, k, X, uv, midx, kmask_per_obs)
        Jk = None

    # robust IRLS sqrt-weighting
    sq = jnp.sum(r * r, axis=-1)
    w = jnp.sqrt(jnp.maximum(_sqrt_rho_deriv(sq, cfg), 1e-12)) * problem.obs_valid
    r = r * w[:, None]
    Jc = Jc * w[:, None, None]
    Jp = Jp * w[:, None, None]

    # freeze poses / tvec components / points / intrinsics
    pf = 1.0 - problem.pose_fixed[problem.obs_cam]  # [N]
    tv = 1.0 - problem.tvec_fixed[problem.obs_cam]  # [N,3]
    cmask = jnp.concatenate([jnp.broadcast_to(pf[:, None], (pf.shape[0], 3)), tv], axis=-1)
    Jc = Jc * (pf[:, None, None] * jnp.ones((1, 1, 6))) * cmask[:, None, :]
    Jp = Jp * (1.0 - problem.point_fixed[problem.obs_pt])[:, None, None]
    if Jk is not None:
        Jk = Jk * w[:, None, None]
        Jk = Jk * (1.0 - problem.intr_fixed[kcam])[:, None, None]
    return r, Jc, Jp, Jk


# ---------------------------------------------------------------------------
# normal equations + Schur elimination


def _inv3(A: Array) -> Array:
    """Closed-form batched 3x3 inverse (adjugate / det), f32-safe."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _gn_system(problem: BAProblem, cfg: BAConfig, cam_q, cam_t, intr, points, lam, psum_axis: str | None = None):
    """Build and solve one damped GN step. Returns (dx_cam_blocks, dx_points).

    Camera-side block layout: blocks 0..C-1 are pose tangents (6 each); if
    cfg.refine_intrinsics, blocks C..C+K-1 are intrinsics (12, refine-masked,
    split into two 6-blocks: C + 2k and C + 2k + 1).
    """
    C = problem.cam_q.shape[0]
    K = problem.intr.shape[0]
    P = problem.points.shape[0]
    T = problem.pt_obs.shape[1]
    nbp = cfg.num_pose_blocks if cfg.num_pose_blocks > 0 else C
    nb = nbp + (2 * K if cfg.refine_intrinsics else 0)  # number of 6-blocks
    D = 6 * nb

    r, Jc, Jp, Jk = _obs_jacobians(problem, cfg, cam_q, cam_t, intr, points)
    N = r.shape[0]

    # ---- point blocks: H_pp and b_p, including lidar terms -----------------
    JpTJp = jnp.einsum("nri,nrj->nij", Jp, Jp, precision=_HI)  # [N,3,3]
    JpTr = jnp.einsum("nri,nr->ni", Jp, r, precision=_HI)  # [N,3]
    Hpp = jnp.zeros((P, 3, 3), jnp.float32).at[problem.obs_pt].add(JpTJp)
    b_p = jnp.zeros((P, 3), jnp.float32).at[problem.obs_pt].add(-JpTr)

    nvec = problem.lidar_plane[:, :3]
    dpl = problem.lidar_plane[:, 3]
    rl = problem.lidar_w * (jnp.sum(points * nvec, axis=-1) + dpl)  # [P]
    if cfg.lidar_loss_robust:
        wl = jnp.sqrt(jnp.maximum(_sqrt_rho_deriv(rl * rl, cfg), 1e-12))
    else:
        wl = jnp.ones_like(rl)
    Jl = (wl * problem.lidar_w)[:, None] * nvec * (1.0 - problem.point_fixed)[:, None]  # [P,3]
    Hpp = Hpp + jnp.einsum("pi,pj->pij", Jl, Jl, precision=_HI)
    b_p = b_p - Jl * (wl * rl)[:, None]

    # LM damping on point blocks + unit diagonal for empty/fixed points
    diagH = jnp.einsum("pii->pi", Hpp)
    Hpp_d = Hpp + jnp.eye(3) * (lam * diagH + 1e-8)[..., None] * jnp.eye(3)
    # ensure invertibility for untouched points
    Hpp_d = Hpp_d + jnp.eye(3) * 1e-6
    Hpp_inv = _inv3(Hpp_d)

    # ---- camera-side blocks ------------------------------------------------
    # per-obs camera-side jacobian entries: pose block (6) and 2 intr blocks.
    obs_pose_blk = problem.cam_blk[problem.obs_cam]  # block id of pose
    if cfg.refine_intrinsics:
        kid = problem.cam_k[problem.obs_cam]
        obs_intr_blk0 = nbp + 2 * kid
        obs_intr_blk1 = nbp + 2 * kid + 1
        Jk0 = Jk[:, :, :6]
        Jk1 = Jk[:, :, 6:]
        # stacked camera-side entries [3N]: (obs, blockrole)
        Jcam = jnp.concatenate([Jc, Jk0, Jk1], axis=0)  # [3N,2,6]
        blk = jnp.concatenate([obs_pose_blk, obs_intr_blk0, obs_intr_blk1], axis=0)
        r3 = jnp.concatenate([r, r, r], axis=0)
        pt3 = jnp.concatenate([problem.obs_pt] * 3, axis=0)
        Jp3 = jnp.concatenate([Jp] * 3, axis=0)
        roles = 3
    else:
        Jcam = Jc
        blk = obs_pose_blk
        r3 = r
        pt3 = problem.obs_pt
        Jp3 = Jp
        roles = 1

    # coupling W per camera-side entry: W_m = Jcam_m^T Jp_m  [6,3]
    W = jnp.einsum("mri,mrj->mij", Jcam, Jp3, precision=_HI)  # [M_ent,6,3]

    i6 = jnp.arange(6)

    # ---- Schur reduction chunk tables (shared by dense & PCG paths) --------
    # The former per-chunk W[ent] gathers of [P,Tn] 72-byte rows ran at
    # ~1.5 GB/s effective and dominated every GN step at global shapes.
    # Instead: invert pt_obs ONCE (loop-invariant — XLA hoists it out of the
    # LM while-loop) into a per-entry slot index, scatter W/blk into a packed
    # [Ppad*Tn] slot table (unique indices, zero-filled so no validity mask
    # is needed), and read each chunk back as a CONTIGUOUS dynamic slice.
    csize = min(cfg.point_chunk, P)
    Ppad = ((P + csize - 1) // csize) * csize
    if Ppad != P:
        pad = Ppad - P
        Hpp_inv_c = jnp.pad(Hpp_inv, ((0, pad), (0, 0), (0, 0)))
        b_p_c = jnp.pad(b_p, ((0, pad), (0, 0)))
    else:
        Hpp_inv_c, b_p_c = Hpp_inv, b_p
    nchunks = Ppad // csize

    pt_obs = problem.pt_obs  # [P,T], -1 padded
    T_ = pt_obs.shape[1]
    Tn = roles * T_
    flatpt = pt_obs.reshape(-1)  # entry (p,t) -> obs index or -1
    tgt = jnp.where(flatpt >= 0, flatpt, N)  # invalid -> dropped
    fidx = jnp.arange(P * T_, dtype=jnp.int32)
    if roles == 3:
        base = (fidx // T_) * Tn + (fidx % T_)  # role-0 slot of entry (p,t)
    else:
        base = fidx
    sent = jnp.int32(Ppad * Tn)  # OOB sentinel: unreferenced obs drop
    slot_of_obs = jnp.full((N,), sent, jnp.int32).at[tgt].set(base, mode="drop")
    if roles == 3:
        slot_all = jnp.concatenate(
            [slot_of_obs, slot_of_obs + T_, slot_of_obs + 2 * T_]
        )
    else:
        slot_all = slot_of_obs
    Wslots = (
        jnp.zeros((Ppad * Tn, 6, 3), jnp.float32)
        .at[slot_all].set(W, mode="drop")
        .reshape(Ppad, Tn, 6, 3)
    )
    blk_slots = (
        jnp.zeros((Ppad * Tn,), jnp.int32)
        .at[slot_all].set(blk, mode="drop")
        .reshape(Ppad, Tn)
    )

    def ent_tables(pstart):
        """Per-chunk entry tables: Wg [c,Tn,6,3] (padding rows are exact
        zeros), blkg [c,Tn] (padding -> block 0, harmless against W=0),
        Hinv [c,3,3], bp [c,3] — all contiguous slices, zero gathers."""
        Wg = jax.lax.dynamic_slice_in_dim(Wslots, pstart, csize, axis=0)
        blkg = jax.lax.dynamic_slice_in_dim(blk_slots, pstart, csize, axis=0)
        Hinv = jax.lax.dynamic_slice_in_dim(Hpp_inv_c, pstart, csize, axis=0)
        bp = jax.lax.dynamic_slice_in_dim(b_p_c, pstart, csize, axis=0)
        return Wg, blkg, Hinv, bp

    # solver-tier selection (static, from problem shapes): dense Cholesky for
    # windowed/small systems, matrix-free PCG above the block threshold
    # (the reference's DENSE_SCHUR -> ITERATIVE_SCHUR + SCHUR_JACOBI ladder,
    # bundle_adjustment.cc:499-512).
    use_pcg = cfg.camera_solver == "pcg" or (
        cfg.camera_solver == "auto" and nb > cfg.dense_max_pose_blocks
    )

    if use_pcg:
        # ---- ITERATIVE_SCHUR: preconditioned CG on S x = b without forming
        # S. Each matvec applies B (camera-side JtJ incl. cross-role
        # pose<->intr coupling) per observation and the W Hpp^-1 W^T term per
        # point chunk; memory is O(blocks + obs), never O(blocks^2).
        Jtr = jnp.einsum("mri,mr->mi", Jcam, r3, precision=_HI)  # [M,6]
        grad = jnp.zeros((nb, 6), jnp.float32).at[blk].add(-Jtr)

        # block-diagonal of B for the SCHUR_JACOBI preconditioner (same-entry
        # terms only; cross-entry same-block couplings — e.g. two obs sharing
        # an intrinsics slot — stay exact in the matvec, merely absent here)
        JtJ_aa = jnp.einsum("mri,mrj->mij", Jcam, Jcam, precision=_HI)
        Bblk = jnp.zeros((nb, 6, 6), jnp.float32).at[blk].add(JtJ_aa)

        def chunk_rhs(carry, pstart):
            grad, Sblk = carry
            Wg, blkg, Hinv, bp = ent_tables(pstart)
            Y = jnp.einsum("ctij,cjk->ctik", Wg, Hinv, precision=_HI)
            yb = jnp.einsum("ctik,ck->cti", Y, bp, precision=_HI)
            grad = grad.at[blkg.reshape(-1)].add(-yb.reshape(-1, 6))
            # per-entry Schur diagonal contribution Y_e W_e^T
            see = jnp.einsum("ctik,ctjk->ctij", Y, Wg, precision=_HI)
            Sblk = Sblk.at[blkg.reshape(-1)].add(see.reshape(-1, 6, 6))
            return (grad, Sblk), None

        (grad, Sblk), _ = jax.lax.scan(
            chunk_rhs,
            (grad, jnp.zeros((nb, 6, 6), jnp.float32)),
            jnp.arange(nchunks) * csize,
        )
        # ---- multi-device reduction: shards own disjoint point sets; the
        # gradient and preconditioner blocks sum across devices.
        if psum_axis is not None:
            grad = jax.lax.psum(grad, psum_axis)
            Bblk = jax.lax.psum(Bblk, psum_axis)
            Sblk = jax.lax.psum(Sblk, psum_axis)

        diagB = jnp.diagonal(Bblk, axis1=-2, axis2=-1)  # [nb,6]
        dead = (jnp.abs(diagB) < 1e-10).astype(jnp.float32)
        # LM damping applied to diag(B) (Ceres damps H before elimination)
        lamdiag = lam * diagB + 1e-8 + dead  # [nb,6]

        Pblkd = Bblk - Sblk + jax.vmap(jnp.diag)(lamdiag)
        # eigen-floor: the approximated block diagonal can lose SPD-ness
        evals, evecs = jnp.linalg.eigh(Pblkd)
        floor = jnp.maximum(evals[..., -1:] * 1e-7, 1e-10)
        inv_e = 1.0 / jnp.maximum(evals, floor)
        Pinv = jnp.einsum("bik,bk,bjk->bij", evecs, inv_e, evecs)

        def matvec(x):  # x [nb,6]
            xg = x[blk]  # [M,6]
            s = jnp.einsum("mri,mi->mr", Jcam, xg, precision=_HI)  # [M,r]
            # cross-role coupling: sum residual-space contributions per obs
            s_obs = s.reshape(roles, N, -1).sum(axis=0)
            y = jnp.einsum(
                "mri,mr->mi", Jcam, jnp.tile(s_obs, (roles, 1)), precision=_HI
            )
            out = jnp.zeros((nb, 6), jnp.float32).at[blk].add(y)

            def chunk_mv(acc, pstart):
                Wg, blkg, Hinv, _bp = ent_tables(pstart)
                xg2 = x[blkg]  # [c,Tn,6]
                u = jnp.einsum("ctij,cti->cj", Wg, xg2, precision=_HI)
                v = jnp.einsum("cij,cj->ci", Hinv, u, precision=_HI)
                ye = jnp.einsum("ctij,cj->cti", Wg, v, precision=_HI)
                return acc.at[blkg.reshape(-1)].add(-ye.reshape(-1, 6)), None

            out, _ = jax.lax.scan(
                chunk_mv, out, jnp.arange(nchunks) * csize
            )
            if psum_axis is not None:
                out = jax.lax.psum(out, psum_axis)
            return out + lamdiag * x

        def precond(r):
            return jnp.einsum("bij,bj->bi", Pinv, r)

        bnorm2 = jnp.sum(grad * grad)
        z0 = precond(grad)

        def cg_cond(st):
            _x, r, _p, _rz, it, done = st
            return (
                ~done
                & (it < cfg.pcg_max_iterations)
                & (jnp.sum(r * r) > cfg.pcg_rtol**2 * bnorm2)
            )

        def cg_body(st):
            x, r, p, rz, it, done = st
            Ap = matvec(p)
            pAp = jnp.sum(p * Ap)
            # negative-curvature / rounding guard (standard truncated-CG):
            # the damped Schur operator and the SPD preconditioner make
            # pAp, rz >= 0 in exact arithmetic, but f32 rounding near
            # convergence can flip them tiny-negative — a 1e-30 clamp would
            # then produce an enormous (finite) step. Stop with the current
            # iterate instead.
            bad = (pAp <= 0.0) | (rz <= 0.0)
            alpha = jnp.where(bad, 0.0, rz / jnp.where(bad, 1.0, pAp))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz2 = jnp.sum(r * z)
            beta = jnp.where(bad, 0.0, rz2 / jnp.where(bad, 1.0, rz))
            p = z + beta * p
            return x, r, p, rz2, it + 1, bad

        dx_cam, *_ = jax.lax.while_loop(
            cg_cond,
            cg_body,
            (
                jnp.zeros_like(grad),
                grad,
                z0,
                jnp.sum(grad * z0),
                jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
            ),
        )
        ok = jnp.all(jnp.isfinite(dx_cam))
        dx_cam = jnp.where(ok, dx_cam, 0.0)
    else:
        # ---- DENSE_SCHUR: assemble S and Cholesky-factor it ----------------
        # H_cam diagonal blocks and gradient (note: off-diagonal pose<->intr
        # terms of the SAME observation are part of the camera-side Hessian).
        S = jnp.zeros((D, D), jnp.float32)
        b = jnp.zeros((D,), jnp.float32)

        # Assembly strategy: XLA scatter-with-duplicates compiles (and runs)
        # as a serialized sort pass — poison for compile time and
        # throughput. When the number of block pairs nb^2 is small (local
        # BA: nb<=16 -> 256), accumulate via a one-hot segment matmul
        # instead: [M, nb^2]^T @ [M, 36] is one dense matmul, no scatters.
        # Large global problems keep scatter.
        use_onehot = nb * nb <= 4096

        def scatter_block(S, rows_blk, cols_blk, vals):
            """Accumulate [M,6,6] blocks at block coords (rows_blk, cols_blk)."""
            M = vals.shape[0]
            if use_onehot:
                flat = rows_blk * nb + cols_blk  # [M]
                onehot = jax.nn.one_hot(flat, nb * nb, dtype=vals.dtype)  # [M, nb^2]
                acc = jnp.einsum("mk,mij->kij", onehot, vals, precision=_HI)
                acc = acc.reshape(nb, nb, 6, 6).transpose(0, 2, 1, 3).reshape(D, D)
                return S + acc
            ridx = rows_blk[:, None, None] * 6 + i6[None, :, None]
            cidx = cols_blk[:, None, None] * 6 + i6[None, None, :]
            return S.at[ridx, cidx].add(vals)

        def scatter_rhs(b, blk_ids, vals6):
            """Accumulate [M,6] row vectors at 6-block ids."""
            if use_onehot:
                onehot = jax.nn.one_hot(blk_ids, nb, dtype=vals6.dtype)  # [M, nb]
                return b + jnp.einsum(
                    "mk,mi->ki", onehot, vals6, precision=_HI
                ).reshape(D)
            return b.at[blk_ids[:, None] * 6 + i6[None, :]].add(vals6)

        # camera-side JtJ: for each obs, roles x roles block outer products.
        if cfg.refine_intrinsics:
            Jroles = jnp.stack([Jc, Jk0, Jk1], axis=1)  # [N,3,2,6]
            blks = jnp.stack([obs_pose_blk, obs_intr_blk0, obs_intr_blk1], axis=1)
            JtJ = jnp.einsum("nari,nbrj->nabij", Jroles, Jroles, precision=_HI)
            M = N * roles * roles
            S = scatter_block(
                S,
                jnp.repeat(blks, roles, axis=1).reshape(M),
                jnp.tile(blks, (1, roles)).reshape(M),
                JtJ.reshape(M, 6, 6),
            )
        else:
            # single role: each observation touches only its own DIAGONAL
            # block (blk_o, blk_o) — aggregate per block with one [N, nb]
            # one-hot matmul and place on the block diagonal (a unique-index
            # scatter), instead of an [N, nb^2] one-hot or duplicate scatter.
            JtJ = jnp.einsum("nri,nrj->nij", Jc, Jc, precision=_HI)
            oh = jax.nn.one_hot(blk, nb, dtype=JtJ.dtype)  # [N, nb]
            Sdiag = jnp.einsum("mk,mij->kij", oh, JtJ, precision=_HI)  # [nb,6,6]
            dridx = jnp.arange(nb)[:, None, None] * 6 + i6[None, :, None]
            dcidx = jnp.arange(nb)[:, None, None] * 6 + i6[None, None, :]
            S = S.at[dridx, dcidx].add(Sdiag)

        Jtr = jnp.einsum("mri,mr->mi", Jcam, r3, precision=_HI)  # [3N or N, 6]
        b = scatter_rhs(b, blk, -Jtr)

        # capture diag(B) (pre-elimination camera Hessian diagonal) BEFORE the
        # point-elimination scan subtracts W Hpp^-1 W^T: LM damping uses the
        # same diagonal in both the dense and PCG tiers (Ceres convention —
        # damp H before elimination), so "auto" tier selection does not change
        # step-size behavior when a problem crosses dense_max_pose_blocks.
        diagB_dense = jnp.diagonal(S)

        def chunk_body(carry, pstart):
            S, b = carry
            Wg, blkg, Hinv, bp = ent_tables(pstart)
            # Y_a = W_a Hinv [c,Tn,6,3]. The Schur reduction
            # sum_a sum_b Y_a W_b^T scattered at block pairs (blk_a, blk_b)
            # FACTORIZES per point: with A_n = sum_{a: blk=n} Y_a and
            # B_m = sum_{b: blk=m} W_b, the contribution to block (n, m) is
            # A_n B_m^T. Aggregating first turns the former [c,Tn,Tn,6,6]
            # pair tensor + c*Tn^2-row one-hot scatter over nb^2 (~10 TF per
            # GN build at T=64, nb=64 — the dominant cost of global solves)
            # into two cheap [c,Tn,nb] one-hot matmuls and ONE O(c nb^2)
            # block einsum.
            Y = jnp.einsum("ctij,cjk->ctik", Wg, Hinv, precision=_HI)
            ohg = jax.nn.one_hot(blkg, nb, dtype=Y.dtype)  # [c,Tn,nb]
            A = jnp.einsum("ctn,ctik->cnik", ohg, Y, precision=_HI)
            Bw = jnp.einsum("ctn,ctik->cnik", ohg, Wg, precision=_HI)
            Sred = jnp.einsum("cnik,cmjk->nimj", A, Bw, precision=_HI)
            S = S - Sred.reshape(D, D)

            # rhs reduction: b -= Y_a b_p, aggregated per block
            yb = jnp.einsum("ctik,ck->cti", Y, bp, precision=_HI)  # [c,Tn,6]
            byb = jnp.einsum("ctn,cti->ni", ohg, yb, precision=_HI)  # [nb,6]
            b = b - byb.reshape(D)
            return (S, b), None

        (S, b), _ = jax.lax.scan(chunk_body, (S, b), jnp.arange(nchunks) * csize)

        # ---- multi-chip reduction ------------------------------------------
        # each shard owns a disjoint set of points (and their observations);
        # the reduced camera system is the sum of per-shard contributions.
        if psum_axis is not None:
            S = jax.lax.psum(S, psum_axis)
            b = jax.lax.psum(b, psum_axis)
            diagB_dense = jax.lax.psum(diagB_dense, psum_axis)

        # ---- damping + gauge/padding regularization ------------------------
        S = S + jnp.diag(lam * diagB_dense + 1e-8)
        # unit diagonal where a block has no residuals (padding, fixed poses)
        dead = (jnp.abs(diagB_dense) < 1e-10).astype(jnp.float32)
        S = S + jnp.diag(dead)

        # Jacobi scaling for f32 conditioning
        dscale = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
        Ss = S * dscale[:, None] * dscale[None, :]
        bs = b * dscale
        L, low = jax.scipy.linalg.cho_factor(Ss, lower=True)
        dxs = jax.scipy.linalg.cho_solve((L, low), bs)
        dx_cam = (dxs * dscale).reshape(nb, 6)

        # guard against a failed factorization (non-SPD → nans): zero the step
        ok = jnp.all(jnp.isfinite(dx_cam))
        dx_cam = jnp.where(ok, dx_cam, 0.0)

    # ---- back-substitute points -------------------------------------------
    # dx_p = Hinv (b_p - sum_entries W_e^T dx_cam[blk_e]), accumulated as a
    # per-entry scatter-add by point (invalid entries carry W = 0), instead
    # of re-gathering the [P,Tn] W table.
    xg = dx_cam[blk]  # [M,6]
    u = jnp.einsum("mij,mi->mj", W, xg)  # [M,3]
    wtd = jnp.zeros((P, 3), jnp.float32).at[pt3].add(u)
    dx_p = jnp.einsum("pij,pj->pi", Hpp_inv, b_p - wtd)
    dx_p = jnp.where(ok, dx_p, 0.0)
    return dx_cam, dx_p


def _apply_step(cfg, problem, cam_q, cam_t, intr, points, dx_cam, dx_p):
    C = problem.cam_q.shape[0]
    nbp = cfg.num_pose_blocks if cfg.num_pose_blocks > 0 else C
    # gather each camera's block; fixed cameras share block 0, so mask
    pose_dx = dx_cam[problem.cam_blk] * (1.0 - problem.pose_fixed)[:, None]
    q2 = se3.quat_normalize(se3.quat_mul(se3.so3_exp_quat(pose_dx[:, :3]), cam_q))
    t2 = cam_t + pose_dx[:, 3:]
    points2 = points + dx_p
    if cfg.refine_intrinsics:
        K = problem.intr.shape[0]
        dintr = dx_cam[nbp : nbp + 2 * K].reshape(K, 12)
        intr2 = intr + dintr * _intr_refine_mask(cfg)[problem.cam_model]
    else:
        intr2 = intr
    return q2, t2, intr2, points2


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve(problem: BAProblem, cfg: BAConfig) -> BAResult:
    return solve_inner(problem, cfg, None)


def solve_inner(problem: BAProblem, cfg: BAConfig, psum_axis: str | None = None) -> BAResult:
    """Run LM to convergence (fixed max iterations) on the given problem.

    With psum_axis set, runs as the per-shard body of a shard_map: camera
    parameters are replicated, points/observations are sharded by point, and
    the reduced camera system is psum-reduced across the mesh axis
    (the distributed Schur BA of parallel/dist_ba.py)."""

    def cost_fn(q, t, k, X):
        return total_cost(q, t, k, X, problem, cfg, psum_axis)

    init_cost = cost_fn(problem.cam_q, problem.cam_t, problem.intr, problem.points)

    def body(state):
        q, t, k, X, lam, cost, it, stall = state
        dx_cam, dx_p = _gn_system(problem, cfg, q, t, k, X, lam, psum_axis)
        q2, t2, k2, X2 = _apply_step(cfg, problem, q, t, k, X, dx_cam, dx_p)
        new_cost = cost_fn(q2, t2, k2, X2)
        accept = new_cost < cost
        q = jax.tree.map(lambda a, b: jnp.where(accept, a, b), q2, q)
        t = jnp.where(accept, t2, t)
        k = jnp.where(accept, k2, k)
        X = jnp.where(accept, X2, X)
        cost_next = jnp.where(accept, new_cost, cost)
        lam = jnp.clip(
            jnp.where(accept, lam * 0.33, lam * 8.0), cfg.min_lambda, cfg.max_lambda
        )
        rel = jnp.abs(cost - cost_next) / jnp.maximum(cost, 1e-12)
        # accepted tiny step -> converged (Ceres function_tolerance);
        # rejected step -> one more lambda try, bounded
        stall = jnp.where(
            accept,
            jnp.where(rel < cfg.function_tolerance, cfg.max_consecutive_rejects, 0),
            stall + 1,
        )
        return q, t, k, X, lam, cost_next, it + 1, stall

    def cond(state):
        *_, it, stall = state
        return (it < cfg.max_iterations) & (stall < cfg.max_consecutive_rejects)

    lam0 = jnp.asarray(cfg.initial_lambda, jnp.float32)
    state = (
        problem.cam_q,
        problem.cam_t,
        problem.intr,
        problem.points,
        lam0,
        init_cost,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    q, t, k, X, lam, cost, it, _ = jax.lax.while_loop(cond, body, state)
    return BAResult(q, t, k, X, init_cost, cost, it)


# ---------------------------------------------------------------------------
# helpers for building problems


def make_problem(
    cam_q,
    cam_t,
    intr,
    points,
    obs_cam,
    obs_pt,
    obs_uv,
    *,
    cam_k=None,
    cam_model=None,
    cam_blk=None,
    obs_valid=None,
    track_len: int = 16,
    lidar_plane=None,
    lidar_w=None,
    pose_fixed=None,
    tvec_fixed=None,
    point_fixed=None,
    intr_fixed=None,
) -> BAProblem:
    """Assemble a BAProblem from unpadded numpy/JAX arrays (host-side helper).

    Builds the per-point observation table pt_obs [P, track_len]; observations
    beyond track_len per point are dropped from the Schur coupling only in
    exact arithmetic terms (they still contribute camera-side and point-side
    Hessian), which would bias the step — so callers must pick track_len >=
    max track length in the problem. This helper asserts that.
    """
    import numpy as np

    cam_q = np.asarray(cam_q, np.float32)
    C = cam_q.shape[0]
    points = np.asarray(points, np.float32)
    P = points.shape[0]
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_pt = np.asarray(obs_pt, np.int32)
    N = obs_cam.shape[0]
    intr = np.asarray(intr, np.float32)
    if intr.ndim == 1:
        intr = intr[None, :]
    K = intr.shape[0]
    if intr.shape[1] < 12:
        intr = np.pad(intr, ((0, 0), (0, 12 - intr.shape[1])))

    if obs_valid is None:
        obs_valid = np.ones((N,), np.float32)
    obs_valid = np.asarray(obs_valid, np.float32)

    # per-point observation table (only valid observations participate) —
    # vectorized group-by: stable-sort obs by point, rank within group
    pt_obs = -np.ones((P, track_len), np.int64)
    vidx = np.nonzero(obs_valid > 0)[0]
    if vidx.size:
        pv = obs_pt[vidx]
        order = np.argsort(pv, kind="stable")
        ps, io = pv[order], vidx[order]
        _, starts, counts = np.unique(ps, return_index=True, return_counts=True)
        assert counts.max() <= track_len, (
            f"a point has {counts.max()} > track_len={track_len} observations"
        )
        rank = np.arange(ps.size) - np.repeat(starts, counts)
        pt_obs[ps, rank] = io
        # BAProblem.pt_obs invariant: injective + complete over valid obs
        # (each valid obs index appears exactly once; see field doc)
        assert np.unique(pt_obs[pt_obs >= 0]).size == vidx.size

    def default(x, shape, val=0.0):
        return np.full(shape, val, np.float32) if x is None else np.asarray(x, np.float32)

    return BAProblem(
        cam_blk=jnp.asarray(
            np.arange(C, dtype=np.int32) if cam_blk is None else np.asarray(cam_blk, np.int32)
        ),
        cam_q=jnp.asarray(cam_q),
        cam_t=jnp.asarray(cam_t, dtype=jnp.float32),
        cam_k=jnp.asarray(
            np.zeros((C,), np.int32) if cam_k is None else np.asarray(cam_k, np.int32)
        ),
        intr=jnp.asarray(intr),
        cam_model=jnp.asarray(
            np.zeros((K,), np.int32) if cam_model is None else np.asarray(cam_model, np.int32)
        ),
        points=jnp.asarray(points),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv, dtype=jnp.float32),
        obs_valid=jnp.asarray(obs_valid),
        pt_obs=jnp.asarray(pt_obs.astype(np.int32)),
        lidar_plane=jnp.asarray(default(lidar_plane, (P, 4))),
        lidar_w=jnp.asarray(default(lidar_w, (P,))),
        pose_fixed=jnp.asarray(default(pose_fixed, (C,))),
        tvec_fixed=jnp.asarray(default(tvec_fixed, (C, 3))),
        point_fixed=jnp.asarray(default(point_fixed, (P,))),
        intr_fixed=jnp.asarray(default(intr_fixed, (K,))),
        num_cams=jnp.asarray(C, jnp.int32),
        num_points=jnp.asarray(P, jnp.int32),
    )
