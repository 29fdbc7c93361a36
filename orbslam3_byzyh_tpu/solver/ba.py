"""Bundle adjustment with Schur-complement landmark elimination.

Replaces ``Optimizer::LocalBundleAdjustment`` (/root/reference/src/Optimizer.cc:1740)
and ``BundleAdjustment`` (:2832) together with g2o's BlockSolver Schur
machinery (/root/reference/Thirdparty/g2o/g2o/core/block_solver.h).

Landmark-major observation layout:
  * ``obs_kf   (L, O) int32``  keyframe index per observation slot (-1 empty)
  * ``obs_uv   (L, O, 2)``     measured pixels
  * ``obs_w    (L, O)``        information (inv sigma^2 of the pyramid level)
  * ``obs_valid (L, O) bool``

Each landmark row is eliminated independently (3x3 inverse), its Schur
contribution scattered into the dense reduced camera system S (K, K, 6, 6).
K (window keyframes) is small (<= ~25 + fixed, Optimizer.cc:2210) for local BA
and up to the keyframe capacity for global BA, so S stays dense, while the
landmark axis L is embarrassingly parallel and is the axis sharded across
devices for distributed BA (see parallel/).

Robust kernel: Huber sqrt(5.991); outlier re-classification between stages
mirrors the reference's optimize(5) -> filter -> optimize(10) flow
(Optimizer.cc:1900-2000 region).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import camera as cam
from ..ops import lie
from . import lm

_HI = jax.lax.Precision.HIGHEST


def _mv(A, v):
    return jnp.einsum("...ij,...j->...i", A, v, precision=_HI)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det).

    Elementwise instead of jnp.linalg.inv's batched LU; runs once per LM
    iteration on the damped (PSD, det>0) landmark blocks."""
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
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], -1),
        jnp.stack([A21, A22, A23], -1),
        jnp.stack([A31, A32, A33], -1)], -2)
    return adj * inv_det[..., None, None]


class BAProblem(NamedTuple):
    R: jnp.ndarray          # (K, 3, 3) Rcw per keyframe
    t: jnp.ndarray          # (K, 3)
    points: jnp.ndarray     # (L, 3) world landmarks
    obs_kf: jnp.ndarray     # (L, O) int32, -1 = empty slot
    obs_uv: jnp.ndarray     # (L, O, 2)
    obs_w: jnp.ndarray      # (L, O) information weights
    obs_valid: jnp.ndarray  # (L, O) bool
    fixed: jnp.ndarray      # (K,) bool — poses held constant
    lm_valid: jnp.ndarray   # (L,) bool
    cam_params: jnp.ndarray  # camera intrinsics vector
    # Optional stereo observations (EdgeStereoSE3ProjectXYZ,
    # OptimizableTypes.h:96): right-image u per observation, -1 = monocular.
    obs_ur: jnp.ndarray = None   # (L, O) or None
    bf: jnp.ndarray = None       # scalar baseline*fx (required with obs_ur)


class BAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    points: jnp.ndarray
    obs_inlier: jnp.ndarray  # (L, O) post-gating mask
    cost: jnp.ndarray


def _residuals(p: BAProblem, R, t, points, model_id):
    """Per-observation residuals and Jacobians in the (L, O) layout."""
    kf = jnp.maximum(p.obs_kf, 0)
    Rk = R[kf]             # (L, O, 3, 3)
    tk = t[kf]             # (L, O, 3)
    pw = points[:, None, :]                     # (L, 1, 3)
    pc = jnp.einsum("loij,loj->loi", Rk, jnp.broadcast_to(pw, tk.shape),
                    precision=_HI) + tk
    uv = cam.project(model_id, p.cam_params, pc)
    r = p.obs_uv - uv                            # (L, O, 2)
    Jproj = cam.project_jac(model_id, p.cam_params, pc)   # (L, O, 2, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (*pc.shape[:-1], 3, 3))
    dpc_dpose = jnp.concatenate([eye, -lie.skew(pc)], axis=-1)   # (L, O, 3, 6)
    Jp = -jnp.einsum("loij,lojk->loik", Jproj, dpc_dpose, precision=_HI)
    Jl = -jnp.einsum("loij,lojk->loik", Jproj, Rk, precision=_HI)  # (L, O, 2, 3)
    depth_ok = pc[..., 2] > 0.05
    if p.obs_ur is None:
        return r, Jp, Jl, depth_ok
    # Third residual row: u_r = u - bf/z (stereo rows only).
    iz = 1.0 / jnp.maximum(pc[..., 2], 1e-6)
    has_ur = p.obs_ur >= 0.0
    ur_pred = uv[..., 0] - p.bf * iz
    r3 = jnp.where(has_ur, p.obs_ur - ur_pred, 0.0)
    e = p.bf * iz * iz                                    # d(-bf/z)/dz
    # d(u_r)/d(pc) = du/dpc + (0, 0, e); chain through each Jacobian.
    extra_pose = jnp.stack([
        jnp.zeros_like(e), jnp.zeros_like(e), e,
        e * pc[..., 1], -e * pc[..., 0], jnp.zeros_like(e)], -1)
    Jp3 = Jp[..., 0, :] - extra_pose
    Jl3 = Jl[..., 0, :] - e[..., None] * Rk[..., 2, :]
    Jp3 = jnp.where(has_ur[..., None], Jp3, 0.0)
    Jl3 = jnp.where(has_ur[..., None], Jl3, 0.0)
    r = jnp.concatenate([r, r3[..., None]], -1)
    Jp = jnp.concatenate([Jp, Jp3[..., None, :]], -2)
    Jl = jnp.concatenate([Jl, Jl3[..., None, :]], -2)
    return r, Jp, Jl, depth_ok


def _build_system(p: BAProblem, R, t, points, inlier, model_id, robust,
                  delta2: float):
    r, Jp, Jl, depth_ok = _residuals(p, R, t, points, model_id)
    chi2 = jnp.sum(r * r, -1) * p.obs_w
    mask = (p.obs_valid & inlier & depth_ok & (p.obs_kf >= 0)
            & p.lm_valid[:, None])
    w_rob = lm.huber_weight(chi2, delta2) if robust else jnp.ones_like(chi2)
    w = w_rob * p.obs_w * mask

    rho = jnp.where(chi2 <= delta2, chi2, 2.0 * jnp.sqrt(delta2 * chi2) - delta2) \
        if robust else chi2
    cost = jnp.sum(rho * mask)

    Jpw = Jp * w[..., None, None]
    # Block pieces. NOTE: bl/bp carry the Gauss-Newton sign already
    # (H dx = b with b = -J^T W r), so downstream solves use them directly.
    Hll = jnp.einsum("lori,lorj->lij", Jl * w[..., None, None], Jl,
                     precision=_HI)                                  # (L, 3, 3)
    bl = -jnp.einsum("lori,lor->li", Jl * w[..., None, None], r,
                     precision=_HI)                                  # (L, 3)
    Wlo = jnp.einsum("lori,lorj->loij", Jpw, Jl, precision=_HI)      # (L, O, 6, 3)
    Hpp_o = jnp.einsum("lori,lorj->loij", Jpw, Jp, precision=_HI)    # (L, O, 6, 6)
    bp_o = -jnp.einsum("lori,lor->loi", Jpw, r, precision=_HI)       # (L, O, 6)
    return dict(Hll=Hll, bl=bl, W=Wlo, Hpp_o=Hpp_o, bp_o=bp_o,
                cost=cost, chi2=chi2, mask=mask)


def schur_pieces(obs_kf, sys, lam, n_kf: int):
    """Per-landmark-shard Schur contributions.

    Everything returned is a SUM over landmarks — psum-able across a
    landmark-sharded mesh (parallel/dist_ba.py). Shapes: Hpp (K,6,6),
    bp (K,6), cross (K,K,6,6), corr (K,6); plus the shard-local
    (Hll_inv, has_obs) needed for back-substitution.

    Sums over the keyframe index are segment sums over the L*O observation
    slots, and the Schur cross block sums the L*O*O slot-pair products
    W Hll_inv W^T into their (kf1, kf2) blocks: O(L O^2) work, where a dense
    one-hot (L, O, K) contraction would cost O(L K^2) and cannot run at the
    keyframe capacity of a global BA.
    """
    kf = jnp.maximum(obs_kf, 0)                # (L, O)
    L, O = kf.shape

    # Damped landmark blocks and their inverses.
    Hll = sys["Hll"]
    diag_l = jnp.diagonal(Hll, axis1=-2, axis2=-1)
    Hll_d = Hll + jax.vmap(jnp.diag)(lam * jnp.maximum(diag_l, 1e-9))
    # Guard empty landmarks (singular 3x3): add identity where no signal.
    has_obs = diag_l.sum(-1) > 1e-12
    Hll_d = jnp.where(has_obs[:, None, None], Hll_d,
                      jnp.broadcast_to(jnp.eye(3, dtype=Hll.dtype), Hll_d.shape))
    Hll_inv = _inv3x3(Hll_d)                   # (L, 3, 3)

    # Masked observations carry zero weight in every sys[...] tensor, so
    # the clamped kf index contributes nothing.
    seg = kf.reshape(-1)                                    # (L*O,)

    def kf_sum(x):
        return jax.ops.segment_sum(x.reshape(L * O, *x.shape[2:]), seg,
                                   num_segments=n_kf)

    Hpp = kf_sum(sys["Hpp_o"])                              # (K, 6, 6)
    bp = kf_sum(sys["bp_o"])                                # (K, 6)

    # Schur cross terms: cross[k1,k2] = sum over slot pairs (o1, o2) of a
    # landmark with kf[o1] = k1, kf[o2] = k2 of (W Hll_inv)[o1] W[o2]^T.
    W = sys["W"]                                # (L, O, 6, 3)
    WHinv = jnp.einsum("loij,ljk->loik", W, Hll_inv, precision=_HI)  # (L,O,6,3)
    pair = jnp.einsum("loim,lpjm->lopij", WHinv, W, precision=_HI)  # (L,O,O,6,6)
    pair_seg = (kf[:, :, None] * n_kf + kf[:, None, :]).reshape(-1)
    cross = jax.ops.segment_sum(pair.reshape(L * O * O, 6, 6), pair_seg,
                                num_segments=n_kf * n_kf)
    cross = cross.reshape(n_kf, n_kf, 6, 6)

    corr = kf_sum(jnp.einsum("loik,lk->loi", WHinv, sys["bl"],
                             precision=_HI))
    return dict(Hpp=Hpp, bp=bp, cross=cross, corr=corr,
                Hll_inv=Hll_inv, has_obs=has_obs)


def schur_solve(Hpp, bp, cross, corr, lam, fixed, n_kf: int):
    """Assemble + solve the (replicated) reduced camera system -> dp (K, 6)."""
    dtype = Hpp.dtype
    S = -cross
    S = S.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(Hpp)
    rhs = bp - corr

    # LM damping on the pose blocks.
    diag_p = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    S = S.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(
        jax.vmap(jnp.diag)(lam * jnp.maximum(diag_p, 1e-9)))

    # Fix poses: identity rows/cols, zero rhs.
    free = (~fixed).astype(dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(
        jnp.eye(6, dtype=dtype)[None] * fixed[:, None, None])
    rhs = rhs * free[:, None]

    Sd = S.transpose(0, 2, 1, 3).reshape(n_kf * 6, n_kf * 6)
    return jnp.linalg.solve(Sd, rhs.reshape(-1)).reshape(n_kf, 6)


def back_substitute(obs_kf, sys, Hll_inv, has_obs, dp):
    """Landmark updates for one shard: dl = Hll_inv (bl - sum_o W^T dp[kf])."""
    kf = jnp.maximum(obs_kf, 0)
    W = sys["W"]
    dp_per_obs = dp[kf]                          # (L, O, 6)
    Wt_dp = jnp.einsum("loij,loi->lj", W, dp_per_obs, precision=_HI)
    dl = jnp.einsum("lij,lj->li", Hll_inv, sys["bl"] - Wt_dp, precision=_HI)
    return jnp.where(has_obs[:, None], dl, 0.0)


def _schur_reduce(p: BAProblem, sys, lam, n_kf: int):
    """Single-device Schur step (pieces -> solve -> back-substitute)."""
    pieces = schur_pieces(p.obs_kf, sys, lam, n_kf)
    dp = schur_solve(pieces["Hpp"], pieces["bp"], pieces["cross"],
                     pieces["corr"], lam, p.fixed, n_kf)
    dl = back_substitute(p.obs_kf, sys, pieces["Hll_inv"], pieces["has_obs"], dp)
    return dp, dl


def _retract(R, t, points, dp, dl, fixed):
    dR, dt = lie.se3_exp(dp)                    # (K, 3, 3), (K, 3)
    Rn = jnp.matmul(dR, R, precision=_HI)
    # One Newton-Schulz step R <- R (3I - R^T R) / 2 re-orthonormalizes the
    # near-orthogonal product (quadratic convergence; input is within float
    # eps of SO(3) after the exp retraction) — pure matmuls instead of a
    # batched-SVD projection.
    RtR = jnp.matmul(jnp.swapaxes(Rn, -1, -2), Rn, precision=_HI)
    Rn = 0.5 * jnp.matmul(
        Rn, 3.0 * jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), RtR.shape)
        - RtR, precision=_HI)
    tn = _mv(dR, t) + dt
    keep = fixed[:, None]
    Rn = jnp.where(keep[..., None], R, Rn)
    tn = jnp.where(keep, t, tn)
    return Rn, tn, points + dl


@functools.partial(jax.jit, static_argnames=("model_id", "stages"))
def bundle_adjust(p: BAProblem, model_id: int = cam.PINHOLE,
                  stages: tuple = (5, 10)) -> BAResult:
    """Schur-complement LM bundle adjustment.

    ``stages``: iteration counts; outliers (chi2 > 5.991 or negative depth)
    are re-classified between stages, mirroring Optimizer.cc:1900-2000.
    Stereo observations (obs_ur >= 0) gate at 7.815 instead.
    """
    if p.obs_ur is None:
        delta2 = lm.CHI2_MONO
    else:
        delta2 = jnp.where(p.obs_ur >= 0.0, lm.CHI2_STEREO, lm.CHI2_MONO)
    n_kf = p.R.shape[0]

    inlier = jnp.ones_like(p.obs_valid)
    R, t, points = p.R, p.t, p.points

    for si, n_iters in enumerate(stages):
        robust = si < len(stages) - 1

        def build(state, inl=inlier, rob=robust):
            R_, t_, pts_ = state
            return _build_system(p, R_, t_, pts_, inl, model_id, rob, delta2)

        state = (R, t, points)
        sys_cur = build(state)
        cost = sys_cur["cost"]
        lam = jnp.asarray(1e-4, jnp.float32)

        for _ in range(n_iters):
            # One system build per iteration: the candidate's system is
            # reused as the next linearization when accepted (the standard
            # LM bookkeeping g2o also uses) instead of rebuilding.
            dp, dl = _schur_reduce(p, sys_cur, lam, n_kf)
            cand = _retract(state[0], state[1], state[2], dp, dl, p.fixed)
            sys_cand = build(cand)
            accept = sys_cand["cost"] < cost
            state = jax.tree.map(
                lambda a, b: jnp.where(accept, b, a), state, cand)
            sys_cur = jax.tree.map(
                lambda a, b: jnp.where(accept, b, a), sys_cur, sys_cand)
            lam = jnp.where(accept, lam * 0.5, lam * 10.0)
            cost = jnp.where(accept, sys_cand["cost"], cost)
        R, t, points = state

        # Outlier re-classification.
        r, _, _, depth_ok = _residuals(p, R, t, points, model_id)
        chi2 = jnp.sum(r * r, -1) * p.obs_w
        inlier = (chi2 <= delta2) & depth_ok

    final = _build_system(p, R, t, points, inlier, model_id, False, delta2)
    return BAResult(R=R, t=t, points=points,
                    obs_inlier=inlier & final["mask"], cost=final["cost"])
