"""Joint visual-inertial bundle adjustment (15-DoF keyframe states).

Replaces ``Optimizer::LocalInertialBA`` (/root/reference/src/Optimizer.cc:2203,
temporal window 10/25 KFs) and ``FullInertialBA`` (:3237): camera reprojection
factors + 9-dim preintegration factors + bias random-walk factors over
keyframe states [pose(6), velocity(3), gyro bias(3), accel bias(3)].

Structure: landmarks are Schur-eliminated exactly as in solver/ba.py (their
cross terms only touch the 6 pose dims); inertial/bias edges contribute
15x15 blocks between consecutive keyframes via jacfwd-linearized residuals.
The reduced system is dense (15K, 15K) — the inertial window is <= tens of
KFs, global inertial BA a few hundred.

Body-frame states with camera extrinsics Tcb (camera <- body), like
``ImuCamPose`` (G2oTypes.h:133) but split: solvers see bodies, the projection
sees cameras.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import camera as cam
from ..ops import imu, lie
from . import ba, inertial, lm

_HI = jax.lax.Precision.HIGHEST


def _mv(A, v):
    return jnp.einsum("...ij,...j->...i", A, v, precision=_HI)


class VIBAProblem(NamedTuple):
    # Keyframe body states.
    R_wb: jnp.ndarray       # (K, 3, 3)
    p_w: jnp.ndarray        # (K, 3)
    v_w: jnp.ndarray        # (K, 3)
    bg: jnp.ndarray         # (K, 3)
    ba: jnp.ndarray         # (K, 3)
    # Landmarks + observations (landmark-major, like ba.BAProblem).
    points: jnp.ndarray     # (L, 3)
    obs_kf: jnp.ndarray     # (L, O)
    obs_uv: jnp.ndarray     # (L, O, 2)
    obs_w: jnp.ndarray      # (L, O)
    obs_valid: jnp.ndarray  # (L, O)
    lm_valid: jnp.ndarray   # (L,)
    # Inertial chain: edge e connects kf edges_i[e] -> edges_j[e].
    edges_i: jnp.ndarray    # (E,)
    edges_j: jnp.ndarray    # (E,)
    preints: imu.PreintState  # batched (E, ...)
    edge_valid: jnp.ndarray   # (E,)
    walk_info: jnp.ndarray    # (6,) bias random-walk information / dt unit
    # Extrinsics + camera.
    R_cb: jnp.ndarray       # (3, 3)
    t_cb: jnp.ndarray       # (3,)
    cam_params: jnp.ndarray
    fixed: jnp.ndarray      # (K,) fixed keyframes
    # Absolute bias prior weights [w_gyro, w_acc] anchored at keyframe 0
    # (EdgePriorGyro/Acc in FullInertialBA :3237). Without it the acc bias
    # absorbs scaled gravity and the scale becomes unobservable again.
    prior_bias_w: jnp.ndarray  # (2,)
    # Optional stereo observations (EdgeStereo in LocalInertialBA): right-u
    # per observation (-1 = mono) and baseline*fx.
    obs_ur: jnp.ndarray = None  # (L, O) or None
    bf: jnp.ndarray = None


class VIBAResult(NamedTuple):
    R_wb: jnp.ndarray
    p_w: jnp.ndarray
    v_w: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    points: jnp.ndarray
    obs_inlier: jnp.ndarray
    cost: jnp.ndarray


def camera_pose(R_wb, p_w, R_cb, t_cb):
    """Tcw from body state: R_cw = R_cb R_wb^T, t_cw = t_cb - R_cw p_w."""
    R_bw = jnp.swapaxes(R_wb, -1, -2)
    R_cw = jnp.matmul(R_cb, R_bw, precision=_HI)
    t_cw = t_cb - _mv(R_cw, p_w)
    return R_cw, t_cw


def _visual_system(p: VIBAProblem, R_wb, p_w, points, inlier, robust,
                   delta2, model_id):
    """Visual residuals/Jacobians wrt BODY-pose tangent (right perturbation:
    R' = R exp(phi), p' = p + R dp) in the (L, O) layout."""
    kf = jnp.maximum(p.obs_kf, 0)
    Rk = R_wb[kf]                                   # (L, O, 3, 3)
    pk = p_w[kf]
    pw = jnp.broadcast_to(points[:, None, :], pk.shape)
    x_b = jnp.einsum("loji,loj->loi", Rk, pw - pk, precision=_HI)  # R^T (x-p)
    x_c = jnp.einsum("ij,loj->loi", p.R_cb, x_b, precision=_HI) + p.t_cb
    uv = cam.project(model_id, p.cam_params, x_c)
    r = p.obs_uv - uv
    Jproj = cam.project_jac(model_id, p.cam_params, x_c)   # (L, O, 2, 3)
    JR = jnp.einsum("loij,jk->loik", Jproj, p.R_cb, precision=_HI)  # dxc/dxb
    # d x_b/d dp = -I; d x_b/d phi = skew(x_b).
    eye = jnp.broadcast_to(jnp.eye(3, dtype=x_b.dtype), (*x_b.shape[:-1], 3, 3))
    dxb_dpose = jnp.concatenate([-eye, lie.skew(x_b)], axis=-1)   # (L, O, 3, 6)
    Jp = -jnp.einsum("loij,lojk->loik", JR, dxb_dpose, precision=_HI)
    # d x_b/d x_w = R_bw = Rk^T.
    Jl = -jnp.einsum("loij,lokj->loik", JR, Rk, precision=_HI)
    depth_ok = x_c[..., 2] > 0.05

    if p.obs_ur is not None:
        # Stereo row: u_r = u - bf/z_c (EdgeStereo with body-pose tangent).
        iz = 1.0 / jnp.maximum(x_c[..., 2], 1e-6)
        has_ur = p.obs_ur >= 0.0
        r3 = jnp.where(has_ur, p.obs_ur - (uv[..., 0] - p.bf * iz), 0.0)
        e = p.bf * iz * iz
        row2 = p.R_cb[2]                          # d z_c / d x_b
        M = jnp.einsum("j,lojk->lok", row2, dxb_dpose, precision=_HI)
        N = jnp.einsum("j,lokj->lok", row2, Rk, precision=_HI)
        Jp3 = jnp.where(has_ur[..., None],
                        Jp[..., 0, :] - e[..., None] * M, 0.0)
        Jl3 = jnp.where(has_ur[..., None],
                        Jl[..., 0, :] - e[..., None] * N, 0.0)
        r = jnp.concatenate([r, r3[..., None]], -1)
        Jp = jnp.concatenate([Jp, Jp3[..., None, :]], -2)
        Jl = jnp.concatenate([Jl, Jl3[..., None, :]], -2)

    chi2 = jnp.sum(r * r, -1) * p.obs_w
    mask = (p.obs_valid & inlier & depth_ok & (p.obs_kf >= 0)
            & p.lm_valid[:, None])
    w_rob = lm.huber_weight(chi2, delta2) if robust else jnp.ones_like(chi2)
    w = w_rob * p.obs_w * mask
    rho = jnp.where(chi2 <= delta2, chi2,
                    2.0 * jnp.sqrt(delta2 * chi2) - delta2) if robust else chi2
    cost = jnp.sum(rho * mask)

    Jpw = Jp * w[..., None, None]
    Hll = jnp.einsum("lori,lorj->lij", Jl * w[..., None, None], Jl,
                     precision=_HI)
    bl = -jnp.einsum("lori,lor->li", Jl * w[..., None, None], r, precision=_HI)
    W = jnp.einsum("lori,lorj->loij", Jpw, Jl, precision=_HI)
    Hpp_o = jnp.einsum("lori,lorj->loij", Jpw, Jp, precision=_HI)
    bp_o = -jnp.einsum("lori,lor->loi", Jpw, r, precision=_HI)
    return dict(Hll=Hll, bl=bl, W=W, Hpp_o=Hpp_o, bp_o=bp_o, cost=cost,
                chi2=chi2, mask=mask)


def _inertial_blocks(p: VIBAProblem, R_wb, p_w, v_w, bg, ba):
    """Per-edge 15x15/rhs contributions from preintegration + bias RW.

    Residual as a function of the two endpoint 15-tangents via jacfwd.
    """
    Wsqrt = inertial.preint_info_sqrt(p.preints)  # (E, 9, 9)
    wi = jnp.sqrt(p.walk_info)

    def edge_res(di, dj, Ri, pi, vi, bgi, bai, Rj, pj, vj, bgj, baj, pre, Ws):
        def apply(d, R, pp, v, bgv, bav):
            dR = lie.so3_exp(d[3:6])
            Rn = jnp.matmul(R, dR, precision=_HI)
            pn = pp + _mv(R, d[:3])
            return Rn, pn, v + d[6:9], bgv + d[9:12], bav + d[12:15]

        Ri_, pi_, vi_, bgi_, bai_ = apply(di, Ri, pi, vi, bgi, bai)
        Rj_, pj_, vj_, bgj_, baj_ = apply(dj, Rj, pj, vj, bgj, baj)
        r9 = inertial.inertial_residual(Ri_, pi_, vi_, Rj_, pj_, vj_,
                                        bgi_, bai_, pre)
        r9w = Ws @ r9
        r_rw = jnp.concatenate([bgj_ - bgi_, baj_ - bai_]) * wi
        return jnp.concatenate([r9w, r_rw])          # (15,)

    E = p.edges_i.shape[0]
    zeros = jnp.zeros((E, 15))
    args = (R_wb[p.edges_i], p_w[p.edges_i], v_w[p.edges_i],
            bg[p.edges_i], ba[p.edges_i],
            R_wb[p.edges_j], p_w[p.edges_j], v_w[p.edges_j],
            bg[p.edges_j], ba[p.edges_j], p.preints, Wsqrt)
    r = jax.vmap(edge_res)(zeros, zeros, *args)
    Ji = jax.vmap(jax.jacfwd(edge_res, argnums=0))(zeros, zeros, *args)
    Jj = jax.vmap(jax.jacfwd(edge_res, argnums=1))(zeros, zeros, *args)
    ev = p.edge_valid.astype(r.dtype)
    r = r * ev[:, None]
    Ji = Ji * ev[:, None, None]
    Jj = Jj * ev[:, None, None]
    cost = jnp.sum(r * r)
    Hii = jnp.einsum("eri,erj->eij", Ji, Ji, precision=_HI)
    Hjj = jnp.einsum("eri,erj->eij", Jj, Jj, precision=_HI)
    Hij = jnp.einsum("eri,erj->eij", Ji, Jj, precision=_HI)
    bi = -jnp.einsum("eri,er->ei", Ji, r, precision=_HI)
    bj = -jnp.einsum("eri,er->ei", Jj, r, precision=_HI)
    return Hii, Hjj, Hij, bi, bj, cost


@functools.partial(jax.jit, static_argnames=("model_id", "stages"))
def vi_bundle_adjust(p: VIBAProblem, model_id: int = cam.PINHOLE,
                     stages: tuple = (5, 10)) -> VIBAResult:
    if p.obs_ur is None:
        delta2 = lm.CHI2_MONO
    else:
        delta2 = jnp.where(p.obs_ur >= 0.0, lm.CHI2_STEREO, lm.CHI2_MONO)
    n_kf = p.R_wb.shape[0]

    def build_sys(state, inlier, robust):
        """Linearize both factor families at ``state``; returns everything
        the step needs plus the total cost (one build serves BOTH the
        acceptance test and the next linearization — the g2o-style LM
        bookkeeping solver/ba.py also uses)."""
        R_wb, p_w, v_w, bg, ba_, points = state
        vis = _visual_system(p, R_wb, p_w, points, inlier, robust, delta2,
                             model_id)
        inr = _inertial_blocks(p, R_wb, p_w, v_w, bg, ba_)
        prior_cost = (p.prior_bias_w[0] * jnp.sum(bg[0] ** 2)
                      + p.prior_bias_w[1] * jnp.sum(ba_[0] ** 2))
        total = vis["cost"] + inr[5] + prior_cost
        return dict(vis=vis, inr=inr, cost=total)

    def step_from(sys_cur, state, lam):
        vis = sys_cur["vis"]
        # Visual Schur pieces (6-dof blocks).
        pieces = ba.schur_pieces(p.obs_kf, vis, lam, n_kf)
        Hii, Hjj, Hij, bi, bj, _ = sys_cur["inr"]
        R_wb, p_w, v_w, bg, ba_, points = state

        # Assemble 15-dof system.
        S = jnp.zeros((n_kf, n_kf, 15, 15), jnp.float32)
        rhs = jnp.zeros((n_kf, 15), jnp.float32)
        S6 = -pieces["cross"]
        S6 = S6.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(pieces["Hpp"])
        S = S.at[:, :, :6, :6].add(S6)
        rhs = rhs.at[:, :6].add(pieces["bp"] - pieces["corr"])
        S = S.at[p.edges_i, p.edges_i].add(Hii)
        S = S.at[p.edges_j, p.edges_j].add(Hjj)
        S = S.at[p.edges_i, p.edges_j].add(Hij)
        S = S.at[p.edges_j, p.edges_i].add(jnp.swapaxes(Hij, -1, -2))
        rhs = rhs.at[p.edges_i].add(bi).at[p.edges_j].add(bj)

        # Absolute bias prior on KF0 (r = bias, J = I on the bias dims).
        wg, wa = p.prior_bias_w[0], p.prior_bias_w[1]
        prior_diag = jnp.concatenate([
            jnp.zeros(9), jnp.full((3,), wg), jnp.full((3,), wa)])
        S = S.at[0, 0].add(jnp.diag(prior_diag))
        rhs = rhs.at[0, 9:12].add(-wg * bg[0])
        rhs = rhs.at[0, 12:15].add(-wa * ba_[0])

        # Damping + fixing.
        diag = jnp.diagonal(S[jnp.arange(n_kf), jnp.arange(n_kf)],
                            axis1=-2, axis2=-1)
        S = S.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(
            jax.vmap(jnp.diag)(lam * jnp.maximum(diag, 1e-9) + 1e-8))
        free = (~p.fixed).astype(jnp.float32)
        S = S * free[:, None, None, None] * free[None, :, None, None]
        S = S.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(
            jnp.eye(15)[None] * p.fixed[:, None, None])
        rhs = rhs * free[:, None]

        Sd = S.transpose(0, 2, 1, 3).reshape(n_kf * 15, n_kf * 15)
        dx = jnp.linalg.solve(Sd, rhs.reshape(-1)).reshape(n_kf, 15)

        dl = ba.back_substitute(p.obs_kf, vis, pieces["Hll_inv"],
                                pieces["has_obs"], dx[:, :6])

        # Retract.
        dR = lie.so3_exp(dx[:, 3:6])
        R_new = jnp.matmul(R_wb, dR, precision=_HI)
        p_new = p_w + _mv(R_wb, dx[:, :3])
        keepf = p.fixed
        R_new = jnp.where(keepf[:, None, None], R_wb, R_new)
        p_new = jnp.where(keepf[:, None], p_w, p_new)
        v_new = jnp.where(keepf[:, None], v_w, v_w + dx[:, 6:9])
        bg_new = jnp.where(keepf[:, None], bg, bg + dx[:, 9:12])
        ba_new = jnp.where(keepf[:, None], ba_, ba_ + dx[:, 12:15])
        cand = (R_new, p_new, v_new, bg_new, ba_new, points + dl)
        return cand

    state = (p.R_wb, p.p_w, p.v_w, p.bg, p.ba, p.points)
    inlier = jnp.ones_like(p.obs_valid)

    for si, n_iters in enumerate(stages):
        robust = si < len(stages) - 1
        sys_cur = build_sys(state, inlier, robust)
        lam = jnp.asarray(1e-4, jnp.float32)

        def body(_, st, inl=inlier, rob=robust):
            s_, sys_, lam_ = st
            # One linearization per iteration: the candidate's system is
            # reused when accepted (same LM bookkeeping as solver/ba.py).
            cand = step_from(sys_, s_, lam_)
            sys_cand = build_sys(cand, inl, rob)
            acc = sys_cand["cost"] < sys_["cost"]
            s_ = jax.tree.map(lambda a, b_: jnp.where(acc, b_, a), s_, cand)
            sys_ = jax.tree.map(lambda a, b_: jnp.where(acc, b_, a),
                                sys_, sys_cand)
            return (s_, sys_, jnp.where(acc, lam_ * 0.5, lam_ * 10.0))

        state, _, _ = jax.lax.fori_loop(0, n_iters, body,
                                        (state, sys_cur, lam))

        # Re-gate visual outliers.
        R_wb, p_w, v_w, bg, ba_, points = state
        vis = _visual_system(p, R_wb, p_w, points,
                             jnp.ones_like(p.obs_valid), False, delta2,
                             model_id)
        inlier = (vis["chi2"] <= delta2)

    R_wb, p_w, v_w, bg, ba_, points = state
    vis = _visual_system(p, R_wb, p_w, points, inlier, False, delta2, model_id)
    return VIBAResult(R_wb=R_wb, p_w=p_w, v_w=v_w, bg=bg, ba=ba_,
                      points=points, obs_inlier=inlier & vis["mask"],
                      cost=vis["cost"])
