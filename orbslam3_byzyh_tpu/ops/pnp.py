"""Batched RANSAC PnP: camera pose from 2D-3D correspondences.

Replaces the reference's relocalization solvers — ``MLPnPsolver``
(/root/reference/src/MLPnPsolver.cpp, used by Tracking::Relocalization
Tracking.cc:5111-5146) and the legacy ``PnPsolver`` (EPnP). Re-design:
instead of a sequential RANSAC loop with early exit, ALL
hypotheses are solved and scored in one vmapped batch (the reference's
~300-iteration budget is one tensor op here), then the best is refined by
the standard motion-only pose optimization.

Per-hypothesis minimal solver: 6-point DLT for the projection matrix
(ideal/normalized image coordinates — camera-model-agnostic like MLPnP's
bearing vectors), orthogonalized onto SO(3) by SVD with cheirality fix.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..solver import pose_opt
from . import camera as cam

_HI = jax.lax.Precision.HIGHEST


class PnPResult(NamedTuple):
    R: jnp.ndarray          # (3, 3) world->cam
    t: jnp.ndarray          # (3,)
    inlier: jnp.ndarray     # (N,)
    n_inliers: jnp.ndarray  # ()
    ok: jnp.ndarray         # () bool — a valid hypothesis existed


def _dlt_pose(X: jnp.ndarray, x: jnp.ndarray):
    """Projection from >=6 points: X (S, 3) world, x (S, 2) ideal coords."""
    s = X.shape[0]
    ones = jnp.ones((s, 1), X.dtype)
    Xh = jnp.concatenate([X, ones], -1)                      # (S, 4)
    z = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, z, -x[:, :1] * Xh], -1)        # (S, 12)
    r2 = jnp.concatenate([z, Xh, -x[:, 1:2] * Xh], -1)
    A = jnp.concatenate([r1, r2], 0)                         # (2S, 12)
    AtA = jnp.matmul(A.T, A, precision=_HI)
    _, vecs = jnp.linalg.eigh(AtA)
    P = vecs[:, 0].reshape(3, 4)
    M = P[:, :3]
    U, S, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    R = U @ jnp.diag(jnp.concatenate([jnp.ones(2), d[None]])) @ Vt
    # Signed beta absorbs the eigenvector's sign ambiguity: M = beta * R
    # with R in SO(3) fixes both scale and cheirality at once.
    beta = jnp.sign(jnp.linalg.det(M)) * jnp.mean(S)
    beta = jnp.where(jnp.abs(beta) < 1e-12, 1e-12, beta)
    t = P[:, 3] / beta
    return R, t


@functools.partial(jax.jit, static_argnames=("n_iters", "sample_size",
                                              "model_id"))
def pnp_ransac(key, pts_w, uv, inv_sigma2, valid, cam_params,
               n_iters: int = 128, sample_size: int = 6,
               chi2_th: float = 5.991,
               model_id: int = cam.PINHOLE) -> PnPResult:
    """Vmapped-hypothesis RANSAC PnP + inlier-refined pose optimization.

    pts_w: (N, 3); uv: (N, 2) pixels; valid: (N,) usable correspondences.
    """
    n = pts_w.shape[0]
    fx, fy, cx, cy = (cam_params[0], cam_params[1], cam_params[2],
                      cam_params[3])
    x_ideal = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)

    w = valid.astype(jnp.float32) + 1e-9
    keys = jax.random.split(key, n_iters)

    def draw(k):
        return jax.random.choice(k, n, shape=(sample_size,), replace=False,
                                 p=w / w.sum())

    idx = jax.vmap(draw)(keys)                       # (I, S)

    def hypothesis(sample_idx):
        R, t = _dlt_pose(pts_w[sample_idx], x_ideal[sample_idx])
        pc = pts_w @ R.T + t
        proj = cam.project(model_id, cam_params, pc)
        chi2 = jnp.sum((uv - proj) ** 2, -1) * inv_sigma2
        inl = valid & (chi2 < chi2_th) & (pc[:, 2] > 0.05)
        finite = jnp.isfinite(R).all() & jnp.isfinite(t).all()
        return R, t, jnp.where(finite, inl.sum(), -1), inl

    Rs, ts, scores, inls = jax.vmap(hypothesis)(idx)
    best = jnp.argmax(scores)
    ok = scores[best] >= sample_size

    # Refine on the best hypothesis' inliers (PoseOptimization schedule).
    res = pose_opt.pose_optimization(
        Rs[best], ts[best], pts_w, uv, inv_sigma2,
        inls[best] & valid, cam_params, model_id=model_id)
    return PnPResult(R=res.R, t=res.t, inlier=res.inlier,
                     n_inliers=res.n_inliers, ok=ok)
