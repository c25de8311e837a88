"""Camera-rig bundle adjustment on the device.

Re-design of the reference RigBundleAdjuster + RigBundleAdjustmentCostFunction
(src/optim/bundle_adjustment.h:322-379, src/optim/bundle_adjustment.cc:700-900,
src/base/cost_functions.h:501-561): every image pose is the composition of a
per-snapshot rig pose and a per-rig-camera relative pose,

    x_cam = R_rel (R_rig x_world + t_rig) + t_rel,

and both factors are optimized jointly with the 3D points. Instead of a Ceres
problem with one autodiff functor per observation, the whole problem is one
fixed-shape XLA program: per-observation Jacobians for the TWO camera-side
6-blocks (rig tangent, rel tangent) via jacfwd, points eliminated per 3x3
block (Schur), and the reduced camera system (6*(S+R) dense) solved by
Cholesky — same architecture as ops/ba.py, with a two-role
camera-side coupling instead of one.

Images that are not part of any rig are modeled uniformly: they get their own
snapshot slot and share a frozen identity relative pose (slot 0), so the same
executable serves mixed rig/non-rig reconstructions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import ba as ba_ops
from . import camera_models as cm
from . import se3

Array = jax.Array


class RigBAConfig(NamedTuple):
    """Static solve configuration (part of the jit cache key)."""

    model_id: int = 1
    model_ids: tuple = ()
    loss_type: int = ba_ops.LOSS_TRIVIAL
    loss_scale: float = 1.0
    max_iterations: int = 50
    refine_relative_poses: bool = True  # RigBundleAdjuster::Options
    point_chunk: int = 512
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e8


class RigBAProblem(NamedTuple):
    """Padded rig BA problem.

    Shapes: S = snapshot (rig pose) slots, R = relative-pose slots,
    K = intrinsics slots, P = point slots, N = observation slots,
    T = max observations per point.
    """

    rig_q: Array  # [S,4] world-to-rig quaternion
    rig_t: Array  # [S,3]
    rel_q: Array  # [R,4] rig-to-camera quaternion
    rel_t: Array  # [R,3]
    intr: Array  # [K,12]
    cam_model: Array  # [K] int32 index into cfg.model_ids
    points: Array  # [P,3]
    obs_rig: Array  # [N] int32 snapshot slot
    obs_rel: Array  # [N] int32 relative-pose slot
    obs_k: Array  # [N] int32 intrinsics slot
    obs_pt: Array  # [N] int32 point slot
    obs_uv: Array  # [N,2]
    obs_valid: Array  # [N] f32 {0,1}
    pt_obs: Array  # [P,T] int32 obs index, -1 padded
    rig_fixed: Array  # [S] f32 {0,1}
    rel_fixed: Array  # [R] f32 {0,1}
    point_fixed: Array  # [P] f32 {0,1}


class RigBAResult(NamedTuple):
    rig_q: Array
    rig_t: Array
    rel_q: Array
    rel_t: Array
    points: Array
    initial_cost: Array
    final_cost: Array
    iterations: Array


def _models(cfg: RigBAConfig) -> tuple:
    return cfg.model_ids if cfg.model_ids else (cfg.model_id,)


def _project_dispatch(cfg, kparams, q, t, X, midx):
    models = _models(cfg)
    if len(models) == 1:
        return cm.project(models[0], kparams, q, t, X)
    outs = [cm.project(m, kparams, q, t, X) for m in models]
    onehot = jax.nn.one_hot(midx, len(models), dtype=outs[0][1].dtype)
    xy = sum(onehot[..., i, None] * outs[i][0] for i in range(len(models)))
    z = sum(onehot[..., i] * outs[i][1] for i in range(len(models)))
    return xy, z


def _residual(cfg, q_rig, t_rig, q_rel, t_rel, kparams, X, uv, midx):
    """Reprojection residual through the composed pose."""
    q, t = se3.se3_compose(q_rel, t_rel, q_rig, t_rig)
    xy, z = _project_dispatch(cfg, kparams, q, t, X, midx)
    r = jnp.clip(xy - uv, -1e4, 1e4)
    return r * (z > 1e-3).astype(r.dtype)[..., None]


def total_cost(rig_q, rig_t, rel_q, rel_t, points, problem: RigBAProblem, cfg: RigBAConfig) -> Array:
    q_rig = rig_q[problem.obs_rig]
    t_rig = rig_t[problem.obs_rig]
    q_rel = rel_q[problem.obs_rel]
    t_rel = rel_t[problem.obs_rel]
    k = problem.intr[problem.obs_k]
    X = points[problem.obs_pt]
    midx = problem.cam_model[problem.obs_k]
    r = _residual(cfg, q_rig, t_rig, q_rel, t_rel, k, X, problem.obs_uv, midx)
    sq = jnp.sum(r * r, axis=-1) * problem.obs_valid
    bcfg = ba_ops.BAConfig(loss_type=cfg.loss_type, loss_scale=cfg.loss_scale)
    return jnp.sum(ba_ops._rho(sq, bcfg) * problem.obs_valid)


def _obs_jacobians(problem: RigBAProblem, cfg: RigBAConfig, rig_q, rig_t, rel_q, rel_t, points):
    """Residuals + Jacobians wrt (rig tangent, rel tangent, point) at 0."""
    q_rig = rig_q[problem.obs_rig]
    t_rig = rig_t[problem.obs_rig]
    q_rel = rel_q[problem.obs_rel]
    t_rel = rel_t[problem.obs_rel]
    k = problem.intr[problem.obs_k]
    X = points[problem.obs_pt]
    uv = problem.obs_uv
    midx = problem.cam_model[problem.obs_k]

    def f(dg, dr, dx, q_rig, t_rig, q_rel, t_rel, k, X, uv, mi):
        qg = se3.quat_mul(se3.so3_exp_quat(dg[:3]), q_rig)
        tg = t_rig + dg[3:]
        qr = se3.quat_mul(se3.so3_exp_quat(dr[:3]), q_rel)
        tr = t_rel + dr[3:]
        return _residual(cfg, qg, tg, qr, tr, k, X + dx, uv, mi)

    z6 = jnp.zeros((6,), jnp.float32)
    z3 = jnp.zeros((3,), jnp.float32)

    def per_obs(q_rig, t_rig, q_rel, t_rel, k, X, uv, mi):
        r = f(z6, z6, z3, q_rig, t_rig, q_rel, t_rel, k, X, uv, mi)
        Jg, Jr, Jp = jax.jacfwd(f, argnums=(0, 1, 2))(
            z6, z6, z3, q_rig, t_rig, q_rel, t_rel, k, X, uv, mi
        )
        return r, Jg, Jr, Jp

    r, Jg, Jr, Jp = jax.vmap(per_obs)(q_rig, t_rig, q_rel, t_rel, k, X, uv, midx)

    bcfg = ba_ops.BAConfig(loss_type=cfg.loss_type, loss_scale=cfg.loss_scale)
    sq = jnp.sum(r * r, axis=-1)
    w = jnp.sqrt(jnp.maximum(ba_ops._sqrt_rho_deriv(sq, bcfg), 1e-12)) * problem.obs_valid
    r = r * w[:, None]
    Jg = Jg * w[:, None, None]
    Jr = Jr * w[:, None, None]
    Jp = Jp * w[:, None, None]

    Jg = Jg * (1.0 - problem.rig_fixed[problem.obs_rig])[:, None, None]
    rel_live = (1.0 - problem.rel_fixed[problem.obs_rel]) * (
        1.0 if cfg.refine_relative_poses else 0.0
    )
    Jr = Jr * rel_live[:, None, None]
    Jp = Jp * (1.0 - problem.point_fixed[problem.obs_pt])[:, None, None]
    return r, Jg, Jr, Jp


def _gn_system(problem: RigBAProblem, cfg: RigBAConfig, rig_q, rig_t, rel_q, rel_t, points, lam):
    """One damped GN step: returns (dx_blocks [S+R,6], dx_points [P,3])."""
    S_n = problem.rig_q.shape[0]
    R_n = problem.rel_q.shape[0]
    P = problem.points.shape[0]
    nb = S_n + R_n
    D = 6 * nb

    r, Jg, Jr, Jp = _obs_jacobians(problem, cfg, rig_q, rig_t, rel_q, rel_t, points)
    N = r.shape[0]

    # point blocks
    Hpp = jnp.zeros((P, 3, 3), jnp.float32).at[problem.obs_pt].add(
        jnp.einsum("nri,nrj->nij", Jp, Jp)
    )
    b_p = jnp.zeros((P, 3), jnp.float32).at[problem.obs_pt].add(
        -jnp.einsum("nri,nr->ni", Jp, r)
    )
    diagH = jnp.einsum("pii->pi", Hpp)
    Hpp_d = Hpp + jnp.eye(3) * (lam * diagH + 1e-8)[..., None] * jnp.eye(3) + jnp.eye(3) * 1e-6
    Hpp_inv = ba_ops._inv3(Hpp_d)

    # camera-side entries: 2 roles per observation (rig block, rel block)
    blk_g = problem.obs_rig
    blk_r = S_n + problem.obs_rel
    Jcam = jnp.concatenate([Jg, Jr], axis=0)  # [2N,2,6]
    blk = jnp.concatenate([blk_g, blk_r], axis=0)
    r2 = jnp.concatenate([r, r], axis=0)
    Jp2 = jnp.concatenate([Jp, Jp], axis=0)

    S = jnp.zeros((D, D), jnp.float32)
    b = jnp.zeros((D,), jnp.float32)
    i6 = jnp.arange(6)
    use_onehot = nb * nb <= 4096

    def scatter_block(S, rows_blk, cols_blk, vals):
        M = vals.shape[0]
        if use_onehot:
            flat = rows_blk * nb + cols_blk
            onehot = jax.nn.one_hot(flat, nb * nb, dtype=vals.dtype)
            acc = jnp.einsum("mk,mij->kij", onehot, vals)
            acc = acc.reshape(nb, nb, 6, 6).transpose(0, 2, 1, 3).reshape(D, D)
            return S + acc
        ridx = rows_blk[:, None, None] * 6 + i6[None, :, None]
        cidx = cols_blk[:, None, None] * 6 + i6[None, None, :]
        return S.at[ridx, cidx].add(vals)

    def scatter_rhs(b, blk_ids, vals6):
        if use_onehot:
            onehot = jax.nn.one_hot(blk_ids, nb, dtype=vals6.dtype)
            return b + jnp.einsum("mk,mi->ki", onehot, vals6).reshape(D)
        return b.at[blk_ids[:, None] * 6 + i6[None, :]].add(vals6)

    # camera-side JtJ: per-observation 2x2 role blocks
    Jroles = jnp.stack([Jg, Jr], axis=1)  # [N,2,2,6]
    blks = jnp.stack([blk_g, blk_r], axis=1)  # [N,2]
    JtJ = jnp.einsum("nari,nbrj->nabij", Jroles, Jroles)  # [N,2,2,6,6]
    M = N * 4
    S = scatter_block(
        S,
        jnp.repeat(blks, 2, axis=1).reshape(M),
        jnp.tile(blks, (1, 2)).reshape(M),
        JtJ.reshape(M, 6, 6),
    )
    b = scatter_rhs(b, blk, -jnp.einsum("mri,mr->mi", Jcam, r2))

    # coupling entries W_m = Jcam_m^T Jp_m for Schur
    W = jnp.einsum("mri,mrj->mij", Jcam, Jp2)  # [2N,6,3]

    pt_obs = problem.pt_obs  # [P,T]
    valid_e = (pt_obs >= 0).astype(jnp.float32)
    safe_obs = jnp.maximum(pt_obs, 0)

    csize = min(cfg.point_chunk, P)
    Ppad = ((P + csize - 1) // csize) * csize
    if Ppad != P:
        pad = Ppad - P
        safe_obs_c = jnp.pad(safe_obs, ((0, pad), (0, 0)))
        valid_e_c = jnp.pad(valid_e, ((0, pad), (0, 0)))
        Hpp_inv_c = jnp.pad(Hpp_inv, ((0, pad), (0, 0), (0, 0)))
        b_p_c = jnp.pad(b_p, ((0, pad), (0, 0)))
    else:
        safe_obs_c, valid_e_c, Hpp_inv_c, b_p_c = safe_obs, valid_e, Hpp_inv, b_p
    nchunks = Ppad // csize

    def chunk_body(carry, pstart):
        S, b = carry
        sl = jax.lax.dynamic_slice_in_dim(safe_obs_c, pstart, csize, axis=0)
        vm = jax.lax.dynamic_slice_in_dim(valid_e_c, pstart, csize, axis=0)
        Hinv = jax.lax.dynamic_slice_in_dim(Hpp_inv_c, pstart, csize, axis=0)
        bp = jax.lax.dynamic_slice_in_dim(b_p_c, pstart, csize, axis=0)
        ent = jnp.concatenate([sl, sl + N], axis=1)  # both roles
        ventry = jnp.concatenate([vm, vm], axis=1)
        Tn = ent.shape[1]
        Wg = W[ent] * ventry[..., None, None]
        blkg = blk[ent]
        Y = jnp.einsum("ctij,cjk->ctik", Wg, Hinv)
        pair = jnp.einsum("ctik,cukl->ctuil", Y, jnp.swapaxes(Wg, -1, -2))
        M2 = csize * Tn * Tn
        rows = jnp.repeat(blkg, Tn, axis=1).reshape(M2)
        cols = jnp.tile(blkg, (1, Tn)).reshape(M2)
        S = scatter_block(S, rows, cols, -pair.reshape(M2, 6, 6))
        yb = jnp.einsum("ctik,ck->cti", Y, bp).reshape(csize * Tn, 6)
        b = scatter_rhs(b, blkg.reshape(-1), -yb)
        return (S, b), None

    (S, b), _ = jax.lax.scan(chunk_body, (S, b), jnp.arange(nchunks) * csize)

    diagS = jnp.diagonal(S)
    S = S + jnp.diag(lam * diagS + 1e-8)
    dead = (jnp.abs(diagS) < 1e-10).astype(jnp.float32)
    S = S + jnp.diag(dead)

    dscale = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
    Ss = S * dscale[:, None] * dscale[None, :]
    L, low = jax.scipy.linalg.cho_factor(Ss, lower=True)
    dxs = jax.scipy.linalg.cho_solve((L, low), b * dscale)
    dx_cam = (dxs * dscale).reshape(nb, 6)
    ok = jnp.all(jnp.isfinite(dx_cam))
    dx_cam = jnp.where(ok, dx_cam, 0.0)

    # back-substitute points
    ent_all = jnp.concatenate([safe_obs, safe_obs + N], axis=1)
    vent_all = jnp.concatenate([valid_e, valid_e], axis=1)
    Wg = W[ent_all] * vent_all[..., None, None]
    dcam_g = dx_cam[blk[ent_all]]
    wtd = jnp.einsum("ptij,pti->pj", Wg, dcam_g)
    dx_p = jnp.einsum("pij,pj->pi", Hpp_inv, b_p - wtd)
    dx_p = jnp.where(ok, dx_p, 0.0)
    return dx_cam, dx_p


def _apply_step(problem, rig_q, rig_t, rel_q, rel_t, points, dx_cam, dx_p):
    S_n = problem.rig_q.shape[0]
    dg = dx_cam[:S_n]
    dr = dx_cam[S_n:]
    rig_q2 = se3.quat_normalize(se3.quat_mul(se3.so3_exp_quat(dg[:, :3]), rig_q))
    rig_t2 = rig_t + dg[:, 3:]
    rel_q2 = se3.quat_normalize(se3.quat_mul(se3.so3_exp_quat(dr[:, :3]), rel_q))
    rel_t2 = rel_t + dr[:, 3:]
    return rig_q2, rig_t2, rel_q2, rel_t2, points + dx_p


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve(problem: RigBAProblem, cfg: RigBAConfig) -> RigBAResult:
    def cost_fn(qg, tg, qr, tr, X):
        return total_cost(qg, tg, qr, tr, X, problem, cfg)

    init_cost = cost_fn(
        problem.rig_q, problem.rig_t, problem.rel_q, problem.rel_t, problem.points
    )

    def body(state):
        qg, tg, qr, tr, X, lam, cost, it, stall = state
        dx_cam, dx_p = _gn_system(problem, cfg, qg, tg, qr, tr, X, lam)
        qg2, tg2, qr2, tr2, X2 = _apply_step(problem, qg, tg, qr, tr, X, dx_cam, dx_p)
        new_cost = cost_fn(qg2, tg2, qr2, tr2, X2)
        accept = new_cost < cost
        qg = jnp.where(accept, qg2, qg)
        tg = jnp.where(accept, tg2, tg)
        qr = jnp.where(accept, qr2, qr)
        tr = jnp.where(accept, tr2, tr)
        X = jnp.where(accept, X2, X)
        cost_next = jnp.where(accept, new_cost, cost)
        lam = jnp.clip(
            jnp.where(accept, lam * 0.33, lam * 8.0), cfg.min_lambda, cfg.max_lambda
        )
        rel = jnp.abs(cost - cost_next) / jnp.maximum(cost, 1e-12)
        stall = jnp.where(accept & (rel < 1e-6), stall + 1, jnp.where(accept, 0, stall + 1))
        return qg, tg, qr, tr, X, lam, cost_next, it + 1, stall

    def cond(state):
        *_, it, stall = state
        return (it < cfg.max_iterations) & (stall < 4)

    state = (
        problem.rig_q,
        problem.rig_t,
        problem.rel_q,
        problem.rel_t,
        problem.points,
        jnp.asarray(cfg.initial_lambda, jnp.float32),
        init_cost,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    qg, tg, qr, tr, X, lam, cost, it, _ = jax.lax.while_loop(cond, body, state)
    return RigBAResult(qg, tg, qr, tr, X, init_cost, cost, it)


def make_problem(
    rig_q,
    rig_t,
    rel_q,
    rel_t,
    intr,
    points,
    obs_rig,
    obs_rel,
    obs_k,
    obs_pt,
    obs_uv,
    *,
    cam_model=None,
    obs_valid=None,
    track_len: int = 16,
    rig_fixed=None,
    rel_fixed=None,
    point_fixed=None,
) -> RigBAProblem:
    """Assemble a padded RigBAProblem from numpy arrays (host-side)."""
    import numpy as np

    rig_q = np.asarray(rig_q, np.float32)
    rel_q = np.asarray(rel_q, np.float32)
    points = np.asarray(points, np.float32)
    obs_pt = np.asarray(obs_pt, np.int32)
    N = obs_pt.shape[0]
    P = points.shape[0]
    intr = np.asarray(intr, np.float32)
    if intr.ndim == 1:
        intr = intr[None, :]
    K = intr.shape[0]
    if intr.shape[1] < 12:
        intr = np.pad(intr, ((0, 0), (0, 12 - intr.shape[1])))
    if obs_valid is None:
        obs_valid = np.ones((N,), np.float32)
    obs_valid = np.asarray(obs_valid, np.float32)

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

    def default(x, shape, val=0.0):
        return np.full(shape, val, np.float32) if x is None else np.asarray(x, np.float32)

    return RigBAProblem(
        rig_q=jnp.asarray(rig_q),
        rig_t=jnp.asarray(rig_t, dtype=jnp.float32),
        rel_q=jnp.asarray(rel_q),
        rel_t=jnp.asarray(rel_t, dtype=jnp.float32),
        intr=jnp.asarray(intr),
        cam_model=jnp.asarray(
            np.zeros((K,), np.int32) if cam_model is None else np.asarray(cam_model, np.int32)
        ),
        points=jnp.asarray(points),
        obs_rig=jnp.asarray(np.asarray(obs_rig, np.int32)),
        obs_rel=jnp.asarray(np.asarray(obs_rel, np.int32)),
        obs_k=jnp.asarray(np.asarray(obs_k, np.int32)),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv, dtype=jnp.float32),
        obs_valid=jnp.asarray(obs_valid),
        pt_obs=jnp.asarray(pt_obs.astype(np.int32)),
        rig_fixed=jnp.asarray(default(rig_fixed, (rig_q.shape[0],))),
        rel_fixed=jnp.asarray(default(rel_fixed, (rel_q.shape[0],))),
        point_fixed=jnp.asarray(default(point_fixed, (P,))),
    )
