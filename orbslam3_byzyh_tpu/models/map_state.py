"""Functional map state: fixed-capacity pytrees-of-arrays.

Replaces the reference's pointer-graph map data model —
``Map``/``KeyFrame``/``MapPoint`` (/root/reference/src/{Map.cc,KeyFrame.cc,
MapPoint.cc}) and their mutex webs — with immutable arrays + liveness masks:

  * ``KeyFrames``: poses (Rcw, tcw), timestamps, per-KF keypoint slabs
    (the Frame contract: xy/level/angle/desc/valid), liveness mask.
  * ``Landmarks``: positions, representative descriptor, view normal +
    scale-invariance range (MapPoint.h:…), found/visible counters, liveness.
  * ``Observations``: landmark-major (L, O) slots holding (kf index,
    keypoint index) — the COO covisibility structure every solver consumes
    directly (see solver/ba.py layout).

"Deletion" is mask-clearing (replaces ``SetBadFlag`` bookkeeping). Indices
are stable, so serialization needs no pointer fixups (SURVEY §5 checkpoint
notes).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class KeyFrames(NamedTuple):
    R: jnp.ndarray           # (K, 3, 3) world->cam
    t: jnp.ndarray           # (K, 3)
    stamp: jnp.ndarray       # (K,)
    kp_xy: jnp.ndarray       # (K, N, 2) undistorted level-0 pixels
    kp_level: jnp.ndarray    # (K, N) int32
    kp_angle: jnp.ndarray    # (K, N)
    kp_desc: jnp.ndarray     # (K, N, 8) uint32
    kp_valid: jnp.ndarray    # (K, N) bool
    kp_ur: jnp.ndarray       # (K, N) right-image u (stereo/RGBD), -1 = mono
    valid: jnp.ndarray       # (K,) liveness


class Landmarks(NamedTuple):
    pos: jnp.ndarray         # (L, 3)
    desc: jnp.ndarray        # (L, 8) uint32 representative descriptor
    normal: jnp.ndarray      # (L, 3) mean viewing direction
    min_dist: jnp.ndarray    # (L,) scale-invariance range lower bound
    max_dist: jnp.ndarray    # (L,)
    n_obs: jnp.ndarray       # (L,) int32
    n_found: jnp.ndarray     # (L,) tracking found counter (MapPoint found ratio)
    n_visible: jnp.ndarray   # (L,)
    first_kf: jnp.ndarray    # (L,) int32 creating keyframe
    valid: jnp.ndarray       # (L,) liveness


class Observations(NamedTuple):
    kf: jnp.ndarray          # (L, O) int32 keyframe index, -1 empty
    kp: jnp.ndarray          # (L, O) int32 keypoint index within that KF
    valid: jnp.ndarray       # (L, O) bool


class MapState(NamedTuple):
    kfs: KeyFrames
    lms: Landmarks
    obs: Observations


def empty_map(max_kf: int, max_lm: int, max_obs: int, n_feat: int) -> MapState:
    f32, i32 = jnp.float32, jnp.int32
    kfs = KeyFrames(
        R=jnp.tile(jnp.eye(3, dtype=f32), (max_kf, 1, 1)),
        t=jnp.zeros((max_kf, 3), f32),
        stamp=jnp.zeros((max_kf,), f32),
        kp_xy=jnp.zeros((max_kf, n_feat, 2), f32),
        kp_level=jnp.zeros((max_kf, n_feat), i32),
        kp_angle=jnp.zeros((max_kf, n_feat), f32),
        kp_desc=jnp.zeros((max_kf, n_feat, 8), jnp.uint32),
        kp_valid=jnp.zeros((max_kf, n_feat), bool),
        kp_ur=jnp.full((max_kf, n_feat), -1.0, f32),
        valid=jnp.zeros((max_kf,), bool),
    )
    lms = Landmarks(
        pos=jnp.zeros((max_lm, 3), f32),
        desc=jnp.zeros((max_lm, 8), jnp.uint32),
        normal=jnp.zeros((max_lm, 3), f32),
        min_dist=jnp.zeros((max_lm,), f32),
        max_dist=jnp.full((max_lm,), 1e9, f32),
        n_obs=jnp.zeros((max_lm,), i32),
        n_found=jnp.zeros((max_lm,), i32),
        n_visible=jnp.zeros((max_lm,), i32),
        first_kf=jnp.zeros((max_lm,), i32),
        valid=jnp.zeros((max_lm,), bool),
    )
    obs = Observations(
        kf=jnp.full((max_lm, max_obs), -1, i32),
        kp=jnp.full((max_lm, max_obs), -1, i32),
        valid=jnp.zeros((max_lm, max_obs), bool),
    )
    return MapState(kfs=kfs, lms=lms, obs=obs)


def add_keyframe(state: MapState, slot: int, R, t, stamp, feats,
                 ur=None) -> MapState:
    """Write a keyframe into `slot` (host passes the cursor). ur: optional
    (N,) right-image u per keypoint (stereo/RGBD; -1 = monocular)."""
    kfs = state.kfs
    if ur is None:
        ur = jnp.full((kfs.kp_ur.shape[1],), -1.0, jnp.float32)
    kfs = kfs._replace(
        R=kfs.R.at[slot].set(R),
        t=kfs.t.at[slot].set(t),
        stamp=kfs.stamp.at[slot].set(stamp),
        kp_xy=kfs.kp_xy.at[slot].set(feats.xy),
        kp_level=kfs.kp_level.at[slot].set(feats.level),
        kp_angle=kfs.kp_angle.at[slot].set(feats.angle),
        kp_desc=kfs.kp_desc.at[slot].set(feats.desc),
        kp_valid=kfs.kp_valid.at[slot].set(feats.valid),
        kp_ur=kfs.kp_ur.at[slot].set(ur),
        valid=kfs.valid.at[slot].set(True),
    )
    return state._replace(kfs=kfs)


def add_landmarks(state: MapState, slots, pos, desc, kf_a, kp_a, kf_b, kp_b,
                  mask, normal, min_dist, max_dist) -> MapState:
    """Batch-create landmarks at `slots` with two initial observations each.

    slots: (M,) int32 target rows; mask: (M,) which rows are real.
    kf_a/kf_b: scalars or (M,) keyframe ids; kp_a/kp_b: (M,) keypoint indices.
    """
    lms, obs = state.lms, state.obs
    safe = jnp.where(mask, slots, state.lms.pos.shape[0])  # OOB drops writes
    kf_a = jnp.broadcast_to(jnp.asarray(kf_a), kp_a.shape)
    kf_b = jnp.broadcast_to(jnp.asarray(kf_b), kp_b.shape)
    lms = lms._replace(
        pos=lms.pos.at[safe].set(pos),
        desc=lms.desc.at[safe].set(desc),
        normal=lms.normal.at[safe].set(normal),
        min_dist=lms.min_dist.at[safe].set(min_dist),
        max_dist=lms.max_dist.at[safe].set(max_dist),
        n_obs=lms.n_obs.at[safe].set(2),
        n_found=lms.n_found.at[safe].set(1),
        n_visible=lms.n_visible.at[safe].set(1),
        first_kf=lms.first_kf.at[safe].set(kf_a),
        valid=lms.valid.at[safe].set(True),
    )
    # Clear the WHOLE observation row first: slots are recycled (culled
    # landmarks free their slot device-side), and a recycled row may still
    # carry the previous occupant's observations at indices >= 2.
    obs = obs._replace(
        kf=obs.kf.at[safe].set(-1)
        .at[safe, 0].set(kf_a).at[safe, 1].set(kf_b),
        kp=obs.kp.at[safe].set(-1)
        .at[safe, 0].set(kp_a).at[safe, 1].set(kp_b),
        valid=obs.valid.at[safe].set(False)
        .at[safe, 0].set(True).at[safe, 1].set(True),
    )
    return state._replace(lms=lms, obs=obs)


def add_observations(state: MapState, lm_idx, kf_id, kp_idx, mask) -> MapState:
    """Append (kf, kp) observations to landmarks at their first free slot."""
    obs = state.obs
    free = ~obs.valid[lm_idx]                       # (M, O)
    # First free slot per row (argmax over bool finds first True).
    slot = jnp.argmax(free, axis=-1)
    has_free = free[jnp.arange(lm_idx.shape[0]), slot]
    ok = mask & has_free
    safe_lm = jnp.where(ok, lm_idx, state.lms.pos.shape[0])
    kf_id = jnp.broadcast_to(jnp.asarray(kf_id), kp_idx.shape)
    obs = obs._replace(
        kf=obs.kf.at[safe_lm, slot].set(kf_id),
        kp=obs.kp.at[safe_lm, slot].set(kp_idx),
        valid=obs.valid.at[safe_lm, slot].set(True),
    )
    lms = state.lms._replace(
        n_obs=state.lms.n_obs.at[safe_lm].add(1))
    return state._replace(obs=obs, lms=lms)


def covisibility_counts(state: MapState, kf_id: int, max_kf: int) -> jnp.ndarray:
    """Number of landmarks shared between kf_id and every other KF.

    Replaces ``KeyFrame::UpdateConnections`` + covisibility-weight queries
    (KeyFrame.h:221-247) with one segmented reduction over the obs table.
    """
    sees_q = (state.obs.kf == kf_id) & state.obs.valid          # (L, O)
    lm_in_q = sees_q.any(-1) & state.lms.valid                  # (L,)
    contrib = lm_in_q[:, None] & state.obs.valid & (state.obs.kf != kf_id)
    flat_kf = jnp.where(contrib, state.obs.kf, max_kf)
    counts = jnp.zeros((max_kf + 1,), jnp.int32).at[flat_kf.reshape(-1)].add(1)
    return counts[:max_kf]


@jax.jit
def covisibility_matrix(state: MapState) -> jnp.ndarray:
    """(K, K) pairwise shared-landmark counts — the FULL covisibility graph
    the essential-graph optimizer needs (covisibility edges over all KF
    pairs with weight >= threshold, Optimizer::OptimizeEssentialGraph,
    /root/reference/src/Optimizer.cc:4509 + KeyFrame::UpdateConnections).
    One (L, K) indicator matmul replaces the reference's per-KF
    observation-map walks."""
    max_kf = state.kfs.valid.shape[0]
    max_lm = state.lms.pos.shape[0]
    ov = state.obs.valid & (state.obs.kf >= 0) & state.lms.valid[:, None]
    cols = jnp.where(ov, state.obs.kf, max_kf)
    rows = jnp.broadcast_to(jnp.arange(max_lm)[:, None], cols.shape)
    ind = jnp.zeros((max_lm, max_kf + 1), jnp.float32).at[
        rows.reshape(-1), cols.reshape(-1)].add(1.0)
    ind = jnp.minimum(ind[:, :max_kf], 1.0)
    C = jnp.einsum("lk,lm->km", ind, ind,
                   precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    return C * (1 - jnp.eye(max_kf, dtype=jnp.int32))


def landmarks_seen_by(state: MapState, kf_id: int):
    """(L,) bool mask + (L,) keypoint index of landmarks observed by kf_id."""
    hit = (state.obs.kf == kf_id) & state.obs.valid
    seen = hit.any(-1) & state.lms.valid
    slot = jnp.argmax(hit, axis=-1)
    kp = jnp.where(seen, state.obs.kp[jnp.arange(hit.shape[0]), slot], -1)
    return seen, kp


def compact_keyframes(state: MapState, n_kf: int):
    """Renumber the live keyframes down to slots [0, n_valid), preserving
    temporal (id) order, and remap every keyframe reference in the state.

    The reference never needs this — its KeyFrames are heap objects and
    deletion frees them (``KeyFrame::SetBadFlag``) — but the fixed-capacity
    array map allocates slots monotonically, so culling must eventually
    recycle slots or long sequences exhaust ``max_kf`` and KF insertion
    silently stops. Host-side (runs rarely, at capacity).

    Returns ``(state', old2new (K,) int32 np array, n_valid)``; dead old ids
    map to -1.
    """
    kf_valid = np.asarray(state.kfs.valid)
    max_kf = kf_valid.shape[0]
    old_ids = np.where(kf_valid)[0]            # ascending == temporal order
    m = len(old_ids)
    old2new = np.full(max_kf, -1, np.int32)
    old2new[old_ids] = np.arange(m, dtype=np.int32)

    gather = np.zeros(max_kf, np.int64)
    gather[:m] = old_ids
    g = jnp.asarray(gather)
    kfs = state.kfs
    live = jnp.arange(max_kf) < m
    kfs = KeyFrames(
        R=kfs.R[g], t=kfs.t[g], stamp=kfs.stamp[g],
        kp_xy=kfs.kp_xy[g], kp_level=kfs.kp_level[g],
        kp_angle=kfs.kp_angle[g], kp_desc=kfs.kp_desc[g],
        kp_valid=kfs.kp_valid[g] & live[:, None],
        kp_ur=kfs.kp_ur[g],
        valid=kfs.valid[g] & live)

    obs = state.obs
    o2n = jnp.asarray(old2new)
    okf_new = jnp.where(obs.kf >= 0, o2n[jnp.maximum(obs.kf, 0)], -1)
    oval = obs.valid & (okf_new >= 0)
    obs = obs._replace(kf=jnp.where(oval, okf_new, -1),
                       kp=jnp.where(oval, obs.kp, -1), valid=oval)

    # first_kf may reference a culled KF (creator died, landmark survived):
    # remap to the nearest surviving predecessor so age logic stays sane.
    first_old = np.asarray(state.lms.first_kf)
    pos = np.clip(np.searchsorted(old_ids, first_old, "right") - 1, 0, None)
    lms = state.lms._replace(
        first_kf=jnp.asarray(pos.astype(np.int32)),
        n_obs=(oval & (obs.kf >= 0)).sum(-1).astype(jnp.int32))
    return state._replace(kfs=kfs, lms=lms, obs=obs), old2new, m


def compact_landmarks(state: MapState, n_lm: int):
    """Renumber live landmarks down to [0, n_valid) (creation-order
    preserving) so culled landmark slots are recycled. The observation table
    is landmark-major, so this is a row gather. Returns
    ``(state', old2new (L,) int32 np array, n_valid)``."""
    lm_valid = np.asarray(state.lms.valid)
    max_lm = lm_valid.shape[0]
    old_ids = np.where(lm_valid)[0]
    m = len(old_ids)
    old2new = np.full(max_lm, -1, np.int32)
    old2new[old_ids] = np.arange(m, dtype=np.int32)

    gather = np.zeros(max_lm, np.int64)
    gather[:m] = old_ids
    g = jnp.asarray(gather)
    live = jnp.arange(max_lm) < m
    lms = state.lms
    lms = Landmarks(
        pos=lms.pos[g], desc=lms.desc[g], normal=lms.normal[g],
        min_dist=lms.min_dist[g], max_dist=lms.max_dist[g],
        n_obs=lms.n_obs[g], n_found=lms.n_found[g],
        n_visible=lms.n_visible[g], first_kf=lms.first_kf[g],
        valid=lms.valid[g] & live)
    obs = state.obs
    obs = Observations(kf=jnp.where(live[:, None], obs.kf[g], -1),
                       kp=jnp.where(live[:, None], obs.kp[g], -1),
                       valid=obs.valid[g] & live[:, None])
    return state._replace(lms=lms, obs=obs), old2new, m


def check_invariants(state: MapState, n_kf: int, n_lm: int) -> list:
    """Debug-time consistency checks over the array map (the reference's
    Map::CheckEssentialGraph / scattered asserts, Map.h:127-128). Returns a
    list of violation strings (empty = consistent). Host-side, not jitted —
    for tests and post-mortem debugging, like the original."""
    import numpy as np
    errs = []
    kfs, lms, obs = state.kfs, state.lms, state.obs
    kf_valid = np.asarray(kfs.valid)
    lm_valid = np.asarray(lms.valid)
    okf = np.asarray(obs.kf)
    okp = np.asarray(obs.kp)
    oval = np.asarray(obs.valid)

    if kf_valid[:n_kf].sum() == 0 and n_kf > 0:
        errs.append(f"no valid keyframes among the first {n_kf} slots")
    if kf_valid[n_kf:].any():
        errs.append("keyframe liveness beyond the host cursor")
    if lm_valid[n_lm:].any():
        errs.append("landmark liveness beyond the host cursor")

    live_obs = oval & (okf >= 0)
    # Observations must reference live keyframes and in-range keypoints.
    bad_kf = live_obs & ~kf_valid[np.maximum(okf, 0)]
    if bad_kf.any():
        errs.append(f"{int(bad_kf.sum())} observations point at dead "
                    "keyframes")
    n_feat = kfs.kp_valid.shape[1]
    if (live_obs & ((okp < 0) | (okp >= n_feat))).any():
        errs.append("observation keypoint index out of range")
    # Live landmarks need >= 1 observation; dead ones keep no live obs rows
    # counted against them.
    lm_n_obs = live_obs.sum(-1)
    starved = lm_valid & (lm_n_obs == 0)
    if starved.any():
        errs.append(f"{int(starved.sum())} live landmarks with zero "
                    "observations")
    # Rotations must stay orthonormal (det +1, R R^T = I).
    R = np.asarray(kfs.R)[kf_valid]
    if len(R):
        rtr = np.einsum("kij,kil->kjl", R, R)
        eye_err = np.abs(rtr - np.eye(3)).max()
        if eye_err > 1e-2:
            errs.append(f"keyframe rotation drifted off SO(3): |R^TR - I| "
                        f"max {eye_err:.2e}")
        det = np.linalg.det(R)
        if (det < 0.5).any():
            errs.append("keyframe rotation with non-positive determinant")
    # Positions finite.
    if not np.isfinite(np.asarray(lms.pos)[lm_valid]).all():
        errs.append("non-finite landmark positions")
    return errs
