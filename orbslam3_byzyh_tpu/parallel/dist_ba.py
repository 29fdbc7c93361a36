"""Distributed bundle adjustment: landmark-sharded Schur over a device mesh.

The new capability the reference never had (SURVEY §2.3: its parallelism is
three pthreads + mutexes). Here the landmark axis of the BA problem is sharded
across the devices of a 1-D mesh with ``shard_map``; each device builds its
shard's Schur contributions (solver/ba.py:schur_pieces), which are
``psum``-reduced (an all-reduce between the cards) into the replicated
reduced camera system; the dense (6K, 6K) solve is
replicated; landmark back-substitution stays shard-local. One round trip of
(K*K*36 + K*6) floats per iteration — independent of the landmark count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import camera as cam
from ..solver import ba, lm


def make_mesh(n_devices: int | None = None, axis: str = "lm") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (axis,))


def shard_problem(p: ba.BAProblem, mesh: Mesh, axis: str = "lm") -> ba.BAProblem:
    """Device-put the problem: landmark-axis arrays sharded, the rest
    replicated."""
    lm_sharded = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def put(x, sharded):
        return jax.device_put(x, lm_sharded if sharded else repl)

    return ba.BAProblem(
        R=put(p.R, False), t=put(p.t, False),
        points=put(p.points, True),
        obs_kf=put(p.obs_kf, True), obs_uv=put(p.obs_uv, True),
        obs_w=put(p.obs_w, True), obs_valid=put(p.obs_valid, True),
        fixed=put(p.fixed, False), lm_valid=put(p.lm_valid, True),
        cam_params=put(p.cam_params, False),
        obs_ur=(put(p.obs_ur, True) if p.obs_ur is not None else None),
        bf=(put(p.bf, False) if p.bf is not None else None))


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "model_id",
                                             "stages"))
def dist_bundle_adjust(p: ba.BAProblem, mesh: Mesh, axis: str = "lm",
                       model_id: int = cam.PINHOLE,
                       stages: tuple = (5, 10)) -> ba.BAResult:
    """Same semantics as solver.ba.bundle_adjust, landmark-sharded.

    Stereo rows (obs_ur/bf) shard along the landmark axis like every other
    observation array, so the stereo/inertial flagship's full-map BA runs
    through the same psum-reduced Schur path."""
    n_kf = p.R.shape[0]

    lm_spec = ba.BAProblem(
        R=P(), t=P(), points=P(axis),
        obs_kf=P(axis), obs_uv=P(axis), obs_w=P(axis), obs_valid=P(axis),
        fixed=P(), lm_valid=P(axis), cam_params=P(),
        obs_ur=(P(axis) if p.obs_ur is not None else None),
        bf=(P() if p.bf is not None else None))

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(lm_spec,),
        out_specs=(P(), P(), P(axis), ba.BAResult(
            R=P(), t=P(), points=P(axis), obs_inlier=P(axis), cost=P())))
    def run(ps: ba.BAProblem):
        if ps.obs_ur is None:
            delta2 = lm.CHI2_MONO
        else:
            delta2 = jnp.where(ps.obs_ur >= 0.0, lm.CHI2_STEREO, lm.CHI2_MONO)
        R, t, points = ps.R, ps.t, ps.points
        inlier = jnp.ones_like(ps.obs_valid)

        def build(R_, t_, pts_, inl, rob):
            sys = ba._build_system(ps, R_, t_, pts_, inl, model_id, rob, delta2)
            sys["cost"] = jax.lax.psum(sys["cost"], axis)
            return sys

        for si, n_iters in enumerate(stages):
            robust = si < len(stages) - 1
            state = (R, t, points)
            sys_cur = build(R, t, points, inlier, robust)
            cost = sys_cur["cost"]
            lam_ = jnp.asarray(1e-4, jnp.float32)
            for _ in range(n_iters):
                # One build per iteration (candidate system reused on
                # acceptance — same LM bookkeeping as solver/ba.py).
                pieces = ba.schur_pieces(ps.obs_kf, sys_cur, lam_, n_kf)
                Hpp = jax.lax.psum(pieces["Hpp"], axis)
                bp = jax.lax.psum(pieces["bp"], axis)
                cross = jax.lax.psum(pieces["cross"], axis)
                corr = jax.lax.psum(pieces["corr"], axis)
                dp = ba.schur_solve(Hpp, bp, cross, corr, lam_, ps.fixed, n_kf)
                dl = ba.back_substitute(ps.obs_kf, sys_cur, pieces["Hll_inv"],
                                        pieces["has_obs"], dp)
                cand = ba._retract(state[0], state[1], state[2], dp, dl,
                                   ps.fixed)
                sys_cand = build(cand[0], cand[1], cand[2], inlier, robust)
                accept = sys_cand["cost"] < cost
                state = jax.tree.map(
                    lambda a, b: jnp.where(accept, b, a), state, cand)
                sys_cur = jax.tree.map(
                    lambda a, b: jnp.where(accept, b, a), sys_cur, sys_cand)
                lam_ = jnp.where(accept, lam_ * 0.5, lam_ * 10.0)
                cost = jnp.where(accept, sys_cand["cost"], cost)
            R, t, points = state

            r, _, _, depth_ok = ba._residuals(ps, R, t, points, model_id)
            chi2 = jnp.sum(r * r, -1) * ps.obs_w
            inlier = (chi2 <= delta2) & depth_ok

        final = build(R, t, points, inlier, False)
        result = ba.BAResult(R=R, t=t, points=points,
                             obs_inlier=inlier & final["mask"],
                             cost=final["cost"])
        return R, t, points, result

    _, _, _, res = run(p)
    return res
