"""Pose-graph (essential-graph) optimization over Sim3 / SE3 / 4-DoF.

Replaces ``Optimizer::OptimizeEssentialGraph`` (6/7-DoF,
/root/reference/src/Optimizer.cc:4509,:5667) and the 4-DoF inertial variant
(:4852), including g2o's Sim3 vertex/edge machinery
(Thirdparty/g2o/g2o/types/types_seven_dof_expmap.cpp).

Vertices: world->kf Sim3 (R, t, s). Edge (i, j) with measurement M_ij stored
as the relative Sim3 S_i * S_j^{-1} at graph-build time; residual
r = log_sim3(M_ij^{-1} * S_i * S_j^{-1}) — zero iff the relative pose is
preserved. Per-edge (7, 14) Jacobians come from jax.jacfwd on the tangent
perturbation (analytic enough at these sizes), assembled into a dense
(7K, 7K) Gauss-Newton system: pose graphs are at most the keyframe
capacity, so a dense solve does; no sparse machinery needed.

DoF control: ``dof_mask`` zeroes tangent dims — [1]*7 = full Sim3 (mono loop
closing), scale off = SE3 (stereo/inertial), 4-DoF yaw+t for the inertial
pose graph (rotation x/y + scale off).

Perturbation frame: by default the tangent is a LEFT perturbation of the
world->camera Sim3 (exp(delta) * S), whose rotation axes live in the CAMERA
frame. The 4-DoF mask must instead free yaw about the WORLD z axis (gravity)
— the reference's ``VertexPose4DoF::UpdateW`` applies its update in the world
frame (/root/reference/include/G2oTypes.h:166 region). ``right_perturb=True``
switches the retraction and Jacobians to S * exp(delta), whose tangent axes
live in the world frame, so DOF_4 then frees exactly world-yaw + translation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

_HI = jax.lax.Precision.HIGHEST

DOF_SIM3 = (1, 1, 1, 1, 1, 1, 1)
DOF_SE3 = (1, 1, 1, 1, 1, 1, 0)
DOF_4 = (1, 1, 1, 0, 0, 1, 0)   # t + yaw(z) only (Edge4DoF behaviour)


def sim3_tuple_inv(S):
    return lie.sim3_inv(*S)


def sim3_tuple_mul(A, B):
    return lie.sim3_mul(*A, *B)


def relative_sim3(Ri, ti, si, Rj, tj, sj):
    """M_ij = S_i * S_j^{-1} for measurement construction."""
    return lie.sim3_mul(Ri, ti, si, *lie.sim3_inv(Rj, tj, sj))


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray     # (K, 3, 3)
    t: jnp.ndarray     # (K, 3)
    s: jnp.ndarray     # (K,)
    cost: jnp.ndarray


def _edge_residual(delta_i, delta_j, Si, Sj, Minv, right: bool):
    """r(delta) = log(Minv * S_i(di) * S_j(dj)^{-1}) with the perturbed
    vertex S(d) = exp(d) * S (left, camera-frame axes) or S * exp(d)
    (right, world-frame axes — the 4-DoF convention)."""
    Ei = lie.sim3_exp(delta_i)
    Ej = lie.sim3_exp(delta_j)
    if right:
        Si_new = sim3_tuple_mul(Si, Ei)
        Sj_new = sim3_tuple_mul(Sj, Ej)
    else:
        Si_new = sim3_tuple_mul(Ei, Si)
        Sj_new = sim3_tuple_mul(Ej, Sj)
    rel = sim3_tuple_mul(Minv, sim3_tuple_mul(Si_new, sim3_tuple_inv(Sj_new)))
    return lie.sim3_log(*rel)


@functools.partial(jax.jit, static_argnames=("n_iters", "right_perturb"))
def optimize_pose_graph(R, t, s, edges_i, edges_j, meas_R, meas_t, meas_s,
                        edge_w, fixed, dof_mask, n_iters: int = 20,
                        right_perturb: bool = False) -> PoseGraphResult:
    """Gauss-Newton pose-graph optimization.

    R, t, s: (K,...) vertex Sim3s. edges_*: (E,) endpoint ids + measurements
    M_ij (relative S_i S_j^{-1} at build time). edge_w: (E,) weights (0 masks
    padding edges). fixed: (K,) bool. dof_mask: (7,) float mask on tangent
    (see module docstring for the left/right perturbation-frame contract).
    """
    n_kf = R.shape[0]
    dof = jnp.asarray(dof_mask, jnp.float32)

    def residual_and_jac(Rv, tv, sv):
        Si = (Rv[edges_i], tv[edges_i], sv[edges_i])
        Sj = (Rv[edges_j], tv[edges_j], sv[edges_j])
        Minv = lie.sim3_inv(meas_R, meas_t, meas_s)

        def one(di, dj, SiR, Sit, Sis, SjR, Sjt, Sjs, MiR, Mit, Mis):
            return _edge_residual(di, dj, (SiR, Sit, Sis), (SjR, Sjt, Sjs),
                                  (MiR, Mit, Mis), right_perturb)

        zeros = jnp.zeros((edges_i.shape[0], 7))
        r = jax.vmap(one)(zeros, zeros, *Si, *Sj, Minv[0], Minv[1], Minv[2])
        Ji = jax.vmap(jax.jacfwd(one, argnums=0))(
            zeros, zeros, *Si, *Sj, Minv[0], Minv[1], Minv[2])
        Jj = jax.vmap(jax.jacfwd(one, argnums=1))(
            zeros, zeros, *Si, *Sj, Minv[0], Minv[1], Minv[2])
        return r, Ji * dof[None, None, :], Jj * dof[None, None, :]

    def build_normal(Rv, tv, sv):
        r, Ji, Jj = residual_and_jac(Rv, tv, sv)
        w = edge_w
        cost = (jnp.sum(r * r, -1) * w).sum()
        H = jnp.zeros((n_kf, n_kf, 7, 7), jnp.float32)
        b = jnp.zeros((n_kf, 7), jnp.float32)
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        Hii = jnp.einsum("eri,erj->eij", Jiw, Ji, precision=_HI)
        Hjj = jnp.einsum("eri,erj->eij", Jjw, Jj, precision=_HI)
        Hij = jnp.einsum("eri,erj->eij", Jiw, Jj, precision=_HI)
        bi = -jnp.einsum("eri,er->ei", Jiw, r, precision=_HI)
        bj = -jnp.einsum("eri,er->ei", Jjw, r, precision=_HI)
        H = H.at[edges_i, edges_i].add(Hii)
        H = H.at[edges_j, edges_j].add(Hjj)
        H = H.at[edges_i, edges_j].add(Hij)
        H = H.at[edges_j, edges_i].add(jnp.swapaxes(Hij, -1, -2))
        b = b.at[edges_i].add(bi).at[edges_j].add(bj)
        return H, b, cost

    def solve(H, b, lam):
        free = (~fixed).astype(jnp.float32)
        H = H * free[:, None, None, None] * free[None, :, None, None]
        diag_fix = (fixed.astype(jnp.float32)[:, None]
                    + (1.0 - dof)[None, :] * free[:, None])
        H = H.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(
            jax.vmap(jnp.diag)(jnp.minimum(diag_fix, 1.0)))
        b = b * free[:, None] * dof[None, :]
        diag = jnp.diagonal(H, axis1=0, axis2=1)      # (7, 7, K) -> careful
        Hd = H.transpose(0, 2, 1, 3).reshape(n_kf * 7, n_kf * 7)
        damp = lam * jnp.maximum(jnp.diagonal(Hd), 1e-6)
        Hd = Hd + jnp.diag(damp)
        return jnp.linalg.solve(Hd, b.reshape(-1)).reshape(n_kf, 7)

    def retract(Rv, tv, sv, dx):
        E = lie.sim3_exp(dx)
        if right_perturb:
            Rn, tn, sn = lie.sim3_mul(Rv, tv, sv, E[0], E[1], E[2])
        else:
            Rn, tn, sn = lie.sim3_mul(E[0], E[1], E[2], Rv, tv, sv)
        keep = fixed
        Rn = jnp.where(keep[:, None, None], Rv, Rn)
        tn = jnp.where(keep[:, None], tv, tn)
        sn = jnp.where(keep, sv, sn)
        return lie.normalize_rotation(Rn), tn, sn

    _, _, cost0 = build_normal(R, t, s)

    def body(_, st):
        Rv, tv, sv, lam, cost = st
        H, b, _ = build_normal(Rv, tv, sv)
        dx = solve(H, b, lam)
        Rn, tn, sn = retract(Rv, tv, sv, dx)
        _, _, cost_new = build_normal(Rn, tn, sn)
        accept = cost_new < cost
        Rv = jnp.where(accept, Rn, Rv)
        tv = jnp.where(accept, tn, tv)
        sv = jnp.where(accept, sn, sv)
        lam = jnp.where(accept, lam * 0.5, lam * 10.0)
        cost = jnp.where(accept, cost_new, cost)
        return (Rv, tv, sv, lam, cost)

    Rv, tv, sv, _, cost = jax.lax.fori_loop(
        0, n_iters, body, (R, t, s, jnp.asarray(1e-4, jnp.float32), cost0))
    return PoseGraphResult(R=Rv, t=tv, s=sv, cost=cost)
