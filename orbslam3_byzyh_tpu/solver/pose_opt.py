"""Motion-only pose optimization (PnP-style) on SE(3).

Replaces ``Optimizer::PoseOptimization`` (/root/reference/src/Optimizer.cc:55-415)
and the g2o graph it builds (unary EdgeSE3ProjectXYZOnlyPose /
EdgeStereoSE3ProjectXYZOnlyPose, OptimizableTypes.h:32-160).

Schedule parity (Appendix A): 4 rounds x 10 LM iterations; chi2 gates mono
5.991 / stereo 7.815 re-classify outliers between rounds; Huber kernel with
delta = sqrt(gate), dropped in the final round; observations flagged outlier
are excluded from the normal equations but re-enter if their error falls back
under the gate.

State: camera pose Tcw as (R (3,3), t (3,)). Left-multiplicative update
T <- exp([rho, phi]) * T, so d(pc)/d(delta) = [I | -skew(pc)].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import camera as cam
from ..ops import lie
from . import lm, pallas_pose_opt

_HI = jax.lax.Precision.HIGHEST


def _mv(A, v):
    return jnp.einsum("...ij,...j->...i", A, v, precision=_HI)


def use_fused_kernel(platform: str, model_id: int) -> bool:
    """Whether :func:`pose_optimization` runs the fused Triton kernel
    (solver/pallas_pose_opt.py): on a GPU, for the pinhole model it
    implements. Everything else takes the XLA path."""
    return platform == "gpu" and model_id == cam.PINHOLE


class PoseOptResult(NamedTuple):
    R: jnp.ndarray        # (3, 3) optimized Rcw
    t: jnp.ndarray        # (3,) optimized tcw
    inlier: jnp.ndarray   # (N,) final inlier mask
    n_inliers: jnp.ndarray
    chi2: jnp.ndarray     # (N,) final per-observation chi2


def _residuals_mono(R, t, pts_w, obs_uv, cam_params, model_id):
    """r_i = obs - proj(R p + t); J_i (2,6) wrt left se3 perturbation."""
    pc = _mv(R, pts_w) + t
    uv = cam.project(model_id, cam_params, pc)
    r = obs_uv - uv
    Jproj = cam.project_jac(model_id, cam_params, pc)  # (N, 2, 3)
    # d pc / d [rho, phi] = [I | -skew(pc)]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (*pc.shape[:-1], 3, 3))
    dpc = jnp.concatenate([eye, -lie.skew(pc)], axis=-1)  # (N, 3, 6)
    J = -jnp.einsum("nij,njk->nik", Jproj, dpc, precision=_HI)  # (N, 2, 6)
    depth_ok = pc[..., 2] > 0.05
    return r, J, depth_ok


def _residuals_stereo(R, t, pts_w, obs_uv, obs_ur, bf, cam_params, model_id):
    """3-component stereo residual (u, v, u_r = u - bf/z):
    EdgeStereoSE3ProjectXYZOnlyPose (OptimizableTypes.h:96-160). Rows where
    obs_ur < 0 are monocular: the third residual/Jacobian row is zeroed."""
    r2, J2, depth_ok = _residuals_mono(R, t, pts_w, obs_uv, cam_params,
                                       model_id)
    pc = _mv(R, pts_w) + t
    iz = 1.0 / jnp.maximum(pc[..., 2], 1e-6)
    ur_pred = (obs_uv[..., 0] - r2[..., 0]) - bf * iz    # u_pred - bf/z
    has_ur = obs_ur >= 0.0
    r3 = jnp.where(has_ur, obs_ur - ur_pred, 0.0)
    # d(u_r)/d(pc) = du/dpc + (0, 0, bf/z^2); chain through [I | -skew(pc)].
    e = bf * iz * iz
    extra = jnp.stack([
        jnp.zeros_like(e), jnp.zeros_like(e), e,
        e * pc[..., 1], -e * pc[..., 0], jnp.zeros_like(e)], -1)  # (N, 6)
    J3 = J2[..., 0, :] - extra
    J3 = jnp.where(has_ur[..., None], J3, 0.0)
    r = jnp.concatenate([r2, r3[..., None]], -1)          # (N, 3)
    J = jnp.concatenate([J2, J3[..., None, :]], -2)       # (N, 3, 6)
    return r, J, depth_ok, has_ur


def pose_optimization(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                      cam_params, model_id: int = cam.PINHOLE,
                      n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Monocular motion-only BA.

    R0, t0: initial Tcw. pts_w: (N, 3) world points. obs_uv: (N, 2) pixels.
    inv_sigma2: (N,) observation information (per pyramid level). valid: (N,).
    Runs the fused kernel where :func:`use_fused_kernel` says so, else
    :func:`pose_optimization_xla`.
    """
    if use_fused_kernel(jax.default_backend(), model_id):
        # One fused kernel for the whole 4x10 schedule (the XLA lowering is
        # ~40 dependent micro-steps per frame).
        R, t, inlier, n_inl, chi2 = pallas_pose_opt.pose_optimization_fused(
            R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params,
            n_rounds=n_rounds, n_iters=n_iters)
        return PoseOptResult(R=R, t=t, inlier=inlier, n_inliers=n_inl,
                             chi2=chi2)
    return pose_optimization_xla(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                                 cam_params, model_id=model_id,
                                 n_rounds=n_rounds, n_iters=n_iters)


@functools.partial(jax.jit, static_argnames=("model_id", "n_rounds", "n_iters"))
def pose_optimization_xla(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                          cam_params, model_id: int = cam.PINHOLE,
                          n_rounds: int = 4, n_iters: int = 10
                          ) -> PoseOptResult:
    """:func:`pose_optimization` as plain XLA ops (every camera model)."""
    delta2 = lm.CHI2_MONO

    def chi2_of(R, t):
        r, _, depth_ok = _residuals_mono(R, t, pts_w, obs_uv, cam_params, model_id)
        chi2 = jnp.sum(r * r, -1) * inv_sigma2
        return jnp.where(depth_ok, chi2, 1e9)

    def run_round(carry, robust):
        R, t, inlier = carry

        def build(x):
            Rr, tr = x
            r, J, depth_ok = _residuals_mono(Rr, tr, pts_w, obs_uv,
                                             cam_params, model_id)
            chi2 = jnp.sum(r * r, -1) * inv_sigma2
            w_rob = lm.huber_weight(chi2, delta2) if robust else jnp.ones_like(chi2)
            mask = inlier & valid & depth_ok
            w = w_rob * inv_sigma2 * mask
            H, b = lm.assemble_normal(J, r, w)
            # Exact Huber cost for the accept/reject test.
            rho = jnp.where(chi2 <= delta2, chi2,
                            2.0 * jnp.sqrt(delta2 * chi2) - delta2) if robust else chi2
            cost = jnp.sum(rho * mask)
            return H, -b, cost

        def retract(x, dx):
            Rr, tr = x
            dR, dt = lie.se3_exp(dx)
            Rn = lie.normalize_rotation(
                jnp.matmul(dR, Rr, precision=_HI))
            tn = _mv(dR, tr) + dt
            return (Rn, tn)

        _, _, cost0 = build((R, t))
        lam = jnp.asarray(1e-3, jnp.float32)

        # Statically unrolled LM iterations: each step is tiny (one 6x6
        # system over ~1k points), straight-line code.
        st = ((R, t), lam, cost0)
        for _ in range(n_iters):
            st = lm.lm_step(st[0], st[1], st[2], build, retract)
        (R, t), _, _ = st

        # Re-classify inliers for the next round (Optimizer.cc:310-360).
        chi2 = chi2_of(R, t)
        inlier = (chi2 <= delta2) & valid
        return (R, t, inlier), None

    inlier = valid
    carry = (R0, t0, inlier)
    for rd in range(n_rounds):
        robust = rd < n_rounds - 1  # final round drops the kernel
        carry, _ = run_round(carry, robust)
    R, t, inlier = carry
    chi2 = chi2_of(R, t)
    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=inlier.sum(), chi2=chi2)


@functools.partial(jax.jit, static_argnames=("model_id", "n_rounds",
                                             "n_iters"))
def pose_optimization_stereo(R0, t0, pts_w, obs_uv, obs_ur, bf, inv_sigma2,
                             valid, cam_params,
                             model_id: int = cam.PINHOLE,
                             n_rounds: int = 4, n_iters: int = 10
                             ) -> PoseOptResult:
    """Motion-only BA with mixed mono/stereo observations.

    obs_ur: (N,) right-image u per keypoint, < 0 for mono-only rows. The
    reference's PoseOptimization mixes EdgeSE3ProjectXYZOnlyPose and
    EdgeStereoSE3ProjectXYZOnlyPose the same way, with per-type chi2 gates
    5.991 / 7.815 (Optimizer.cc:278-280).
    """
    has_ur = obs_ur >= 0.0
    delta2 = jnp.where(has_ur, lm.CHI2_STEREO, lm.CHI2_MONO)

    def chi2_of(R, t):
        r, _, depth_ok, _ = _residuals_stereo(R, t, pts_w, obs_uv, obs_ur,
                                              bf, cam_params, model_id)
        chi2 = jnp.sum(r * r, -1) * inv_sigma2
        return jnp.where(depth_ok, chi2, 1e9)

    def run_round(carry, robust):
        R, t, inlier = carry

        def build(x):
            Rr, tr = x
            r, J, depth_ok, _ = _residuals_stereo(
                Rr, tr, pts_w, obs_uv, obs_ur, bf, cam_params, model_id)
            chi2 = jnp.sum(r * r, -1) * inv_sigma2
            w_rob = (lm.huber_weight(chi2, delta2) if robust
                     else jnp.ones_like(chi2))
            mask = inlier & valid & depth_ok
            w = w_rob * inv_sigma2 * mask
            H, b = lm.assemble_normal(J, r, w)
            rho = jnp.where(chi2 <= delta2, chi2,
                            2.0 * jnp.sqrt(delta2 * chi2) - delta2) \
                if robust else chi2
            cost = jnp.sum(rho * mask)
            return H, -b, cost

        def retract(x, dx):
            Rr, tr = x
            dR, dt = lie.se3_exp(dx)
            Rn = lie.normalize_rotation(jnp.matmul(dR, Rr, precision=_HI))
            tn = _mv(dR, tr) + dt
            return (Rn, tn)

        _, _, cost0 = build((R, t))
        st = ((R, t), jnp.asarray(1e-3, jnp.float32), cost0)
        for _ in range(n_iters):
            st = lm.lm_step(st[0], st[1], st[2], build, retract)
        (R, t), _, _ = st
        chi2 = chi2_of(R, t)
        inlier = (chi2 <= delta2) & valid
        return (R, t, inlier), None

    inlier = valid
    carry = (R0, t0, inlier)
    for rd in range(n_rounds):
        carry, _ = run_round(carry, rd < n_rounds - 1)
    R, t, inlier = carry
    chi2 = chi2_of(R, t)
    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=inlier.sum(), chi2=chi2)
