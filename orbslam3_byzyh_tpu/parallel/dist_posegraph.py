"""Distributed pose-graph optimization: edge-sharded Gauss-Newton.

The essential-graph/pose-graph solve (solver/pose_graph.py — the
replacement for OptimizeEssentialGraph, /root/reference/src/Optimizer.cc:4509)
scales with the edge count (covisibility + spanning tree + loop edges), not
the keyframe count. For multi-host maps the edge set is sharded across the
device mesh with ``shard_map``: each device linearizes its edge shard and
scatters block contributions into a full-size (K, K, 7, 7) normal system,
which one ``psum`` all-reduces between the devices; the damped solve + retraction stay
replicated (K is bounded by the keyframe budget, the solve is tiny next to
the per-edge autodiff).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import lie
from ..solver import pose_graph as pg

_HI = jax.lax.Precision.HIGHEST


def pad_edges(edges_i, edges_j, meas_R, meas_t, meas_s, edge_w,
              n_devices: int):
    """Pad the edge arrays to a multiple of the mesh size (padding edges get
    weight 0 and self-loop endpoints 0-0, contributing nothing)."""
    e = edges_i.shape[0]
    target = -(-e // n_devices) * n_devices
    pad = target - e
    if pad == 0:
        return edges_i, edges_j, meas_R, meas_t, meas_s, edge_w
    zi = jnp.zeros(pad, edges_i.dtype)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=meas_R.dtype), (pad, 3, 3))
    return (jnp.concatenate([edges_i, zi]),
            jnp.concatenate([edges_j, zi]),
            jnp.concatenate([meas_R, eye]),
            jnp.concatenate([meas_t, jnp.zeros((pad, 3), meas_t.dtype)]),
            jnp.concatenate([meas_s, jnp.ones(pad, meas_s.dtype)]),
            jnp.concatenate([edge_w, jnp.zeros(pad, edge_w.dtype)]))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "axis", "n_iters",
                                    "right_perturb"))
def dist_optimize_pose_graph(R, t, s, edges_i, edges_j, meas_R, meas_t,
                             meas_s, edge_w, fixed, dof_mask, mesh: Mesh,
                             axis: str = "lm", n_iters: int = 20,
                             right_perturb: bool = False
                             ) -> pg.PoseGraphResult:
    """Same semantics as pose_graph.optimize_pose_graph, edge-sharded.

    Edge arrays must be length-divisible by the mesh size (use pad_edges).
    ``right_perturb`` selects the world-frame tangent convention (4-DoF
    inertial graphs; see solver/pose_graph.py module docstring).
    """
    n_kf = R.shape[0]
    dof = jnp.asarray(dof_mask, jnp.float32)

    def build_local(Rv, tv, sv, ei, ej, mR, mt, ms_, w):
        """Runs per device on its edge shard; returns psum'd normal system."""
        Si = (Rv[ei], tv[ei], sv[ei])
        Sj = (Rv[ej], tv[ej], sv[ej])
        Minv = lie.sim3_inv(mR, mt, ms_)

        def one(di, dj, SiR, Sit, Sis, SjR, Sjt, Sjs, MiR, Mit, Mis):
            return pg._edge_residual(di, dj, (SiR, Sit, Sis),
                                     (SjR, Sjt, Sjs), (MiR, Mit, Mis),
                                     right_perturb)

        zeros = jnp.zeros((ei.shape[0], 7))
        r = jax.vmap(one)(zeros, zeros, *Si, *Sj, Minv[0], Minv[1], Minv[2])
        Ji = jax.vmap(jax.jacfwd(one, argnums=0))(
            zeros, zeros, *Si, *Sj, Minv[0], Minv[1], Minv[2])
        Jj = jax.vmap(jax.jacfwd(one, argnums=1))(
            zeros, zeros, *Si, *Sj, Minv[0], Minv[1], Minv[2])
        Ji = Ji * dof[None, None, :]
        Jj = Jj * dof[None, None, :]

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
        H = H.at[ei, ei].add(Hii)
        H = H.at[ej, ej].add(Hjj)
        H = H.at[ei, ej].add(Hij)
        H = H.at[ej, ei].add(jnp.swapaxes(Hij, -1, -2))
        b = b.at[ei].add(bi).at[ej].add(bj)
        # One all-reduce: the reduced normal system, not the edges.
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        cost = jax.lax.psum(cost, axis)
        return H, b, cost

    build = jax.shard_map(
        build_local, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis)),
        out_specs=(P(), P(), P()))

    def solve(H, b, lam):
        free = (~fixed).astype(jnp.float32)
        H = H * free[:, None, None, None] * free[None, :, None, None]
        diag_fix = (fixed.astype(jnp.float32)[:, None]
                    + (1.0 - dof)[None, :] * free[:, None])
        H = H.at[jnp.arange(n_kf), jnp.arange(n_kf)].add(
            jax.vmap(jnp.diag)(jnp.minimum(diag_fix, 1.0)))
        b = b * free[:, None] * dof[None, :]
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
        Rn = jnp.where(fixed[:, None, None], Rv, Rn)
        tn = jnp.where(fixed[:, None], tv, tn)
        sn = jnp.where(fixed, sv, sn)
        return lie.normalize_rotation(Rn), tn, sn

    args = (edges_i, edges_j, meas_R, meas_t, meas_s, edge_w)
    _, _, cost0 = build(R, t, s, *args)

    def body(_, st):
        Rv, tv, sv, lam, cost = st
        H, b, _ = build(Rv, tv, sv, *args)
        dx = solve(H, b, lam)
        Rn, tn, sn = retract(Rv, tv, sv, dx)
        _, _, cost_new = build(Rn, tn, sn, *args)
        accept = cost_new < cost
        Rv = jnp.where(accept, Rn, Rv)
        tv = jnp.where(accept, tn, tv)
        sv = jnp.where(accept, sn, sv)
        lam = jnp.where(accept, lam * 0.5, lam * 10.0)
        cost = jnp.where(accept, cost_new, cost)
        return (Rv, tv, sv, lam, cost)

    Rv, tv, sv, _, cost = jax.lax.fori_loop(
        0, n_iters, body, (R, t, s, jnp.asarray(1e-4, jnp.float32), cost0))
    return pg.PoseGraphResult(R=Rv, t=tv, s=sv, cost=cost)
