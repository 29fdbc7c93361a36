"""Local mapping: new-landmark triangulation, local BA, culling.

Replaces ``LocalMapping`` (/root/reference/src/LocalMapping.cc):
``CreateNewMapPoints`` (:506), the LocalBundleAdjustment dispatch (:168-210),
``MapPointCulling`` (:451) and ``KeyFrameCulling`` (:1177) — as pure jitted
functions over the MapState arrays, driven by pipeline/system.py (the thread
+ queue machinery of the reference becomes host-side orchestration).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import map_state as ms
from ..ops import camera as cam
from ..ops import geometry, matching
from ..solver import ba
from .tracking import INV_SIGMA2, SCALE, SIGMA2

_HI = jax.lax.Precision.HIGHEST


def fundamental_from_poses(R1, t1, R2, t2, cam_params):
    """F12 with x2^T F12 x1 = 0 from two world->cam poses (pixel coords).

    (GeometricTools::ComputeF12, /root/reference/src/GeometricTools.cc:44.)
    """
    R12 = jnp.matmul(R1, R2.T, precision=_HI)
    t12 = t1 - jnp.einsum("ij,j->i", R12, t2, precision=_HI)
    # Map from image2 to image1: E21 = [t12]x R12 => x1n^T E x2n.
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    K = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], jnp.float32)
    K = K.at[0, 0].set(fx).at[1, 1].set(fy).at[0, 2].set(cx).at[1, 2].set(cy)
    Kinv = jnp.linalg.inv(K)
    from ..ops import lie
    E = jnp.matmul(lie.skew(t12), R12, precision=_HI)
    F21 = Kinv.T @ E @ Kinv          # x1^T F21 x2 = 0
    return F21.T                      # x2^T F12 x1 = 0


class TriangulationResult(NamedTuple):
    pos: jnp.ndarray       # (N, 3) new landmark positions
    kp_a: jnp.ndarray      # (N,) keypoint index in KF a
    kp_b: jnp.ndarray      # (N,) keypoint index in KF b
    desc: jnp.ndarray      # (N, 8) descriptor (from KF a)
    normal: jnp.ndarray    # (N, 3)
    min_dist: jnp.ndarray
    max_dist: jnp.ndarray
    good: jnp.ndarray      # (N,) validity


@functools.partial(jax.jit, static_argnames=("model_id",))
def triangulate_pair(Ra, ta, xy_a, level_a, desc_a, free_a,
                     Rb, tb, xy_b, level_b, desc_b, free_b,
                     cam_params, model_id: int = cam.PINHOLE,
                     ) -> TriangulationResult:
    """Epipolar-guided matching + DLT between two keyframes.

    free_*: keypoints not yet bound to a landmark (only those triangulate;
    CreateNewMapPoints :506 matches unmatched features only).
    Checks (reference parity): positive depth both views, reprojection chi2
    < 5.991 * sigma2(level), scale-consistency ratio between view distances.
    """
    F12 = fundamental_from_poses(Ra, ta, Rb, tb, cam_params)
    ones1 = jnp.ones_like(xy_a[:, :1])
    lines = jnp.concatenate([xy_a, ones1], -1) @ F12.T
    mj, md = matching.search_epipolar(lines, desc_a, free_a, xy_b, level_b,
                                      desc_b, free_b, SIGMA2,
                                      max_dist=matching.TH_LOW, ratio=0.8)
    n = xy_a.shape[0]
    kp_b = jnp.maximum(mj, 0)
    matched = mj >= 0

    K = jnp.array([[cam_params[0], 0, cam_params[2]],
                   [0, cam_params[1], cam_params[3]],
                   [0, 0, 1.0]], jnp.float32)
    Pa = geometry.projection_matrix(K, Ra, ta)
    Pb = geometry.projection_matrix(K, Rb, tb)
    X = geometry.triangulate_dlt(Pa, Pb, xy_a, xy_b[kp_b])

    pca = jnp.einsum("ij,nj->ni", Ra, X) + ta
    pcb = jnp.einsum("ij,nj->ni", Rb, X) + tb

    def reproj2(P, xo, Xw):
        Xh = jnp.concatenate([Xw, jnp.ones_like(Xw[:, :1])], -1)
        p = Xh @ P.T
        w = jnp.where(jnp.abs(p[:, 2]) < 1e-9, 1e-9, p[:, 2])
        return jnp.sum((xo - p[:, :2] / w[:, None]) ** 2, -1)

    ea = reproj2(Pa, xy_a, X) * INV_SIGMA2[level_a]
    eb = reproj2(Pb, xy_b[kp_b], X) * INV_SIGMA2[level_b[kp_b]]

    ca = -jnp.einsum("ji,j->i", Ra, ta)
    cb = -jnp.einsum("ji,j->i", Rb, tb)
    da = jnp.linalg.norm(X - ca, axis=-1)
    db = jnp.linalg.norm(X - cb, axis=-1)
    ratio_dist = da / jnp.maximum(db, 1e-9)
    ratio_octave = SCALE ** (level_a - level_b[kp_b]).astype(jnp.float32)
    ratio_factor = 1.5 * SCALE
    scale_ok = (ratio_dist < ratio_octave * ratio_factor) & \
               (ratio_dist > ratio_octave / ratio_factor)

    # Parallax between rays (reject near-zero like the reference's cos gate).
    ray_a = (X - ca) / jnp.maximum(da, 1e-9)[:, None]
    ray_b = (X - cb) / jnp.maximum(db, 1e-9)[:, None]
    cos_par = jnp.sum(ray_a * ray_b, -1)

    good = (matched & (pca[:, 2] > 0) & (pcb[:, 2] > 0)
            & (ea < 5.991) & (eb < 5.991) & scale_ok
            & (cos_par < 0.9998) & jnp.isfinite(X).all(-1))

    normal = 0.5 * (ray_a + ray_b)
    normal = normal / jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)
    # Scale-invariance range from the observing level (MapPoint ctor behaviour).
    level_factor = SCALE ** level_a.astype(jnp.float32)
    max_dist = da * level_factor
    min_dist = max_dist / SCALE ** (8 - 1)
    return TriangulationResult(pos=X, kp_a=jnp.arange(n, dtype=jnp.int32),
                               kp_b=kp_b, desc=desc_a, normal=normal,
                               min_dist=min_dist, max_dist=max_dist, good=good)


@functools.partial(jax.jit, static_argnames=("use_stereo",))
def _full_ba_problem(state: ms.MapState, free_kf: jnp.ndarray, cam_params,
                     use_stereo: bool = False, bf: float = 0.0
                     ) -> ba.BAProblem:
    """Assemble the whole-map BAProblem with only ``free_kf`` poses free."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    kf_safe = jnp.maximum(obs.kf, 0)
    kp_safe = jnp.maximum(obs.kp, 0)
    obs_uv = kfs.kp_xy[kf_safe, kp_safe]
    obs_level = kfs.kp_level[kf_safe, kp_safe]
    obs_w = INV_SIGMA2[obs_level]
    return ba.BAProblem(
        R=kfs.R, t=kfs.t, points=lms.pos,
        obs_kf=obs.kf, obs_uv=obs_uv, obs_w=obs_w,
        obs_valid=obs.valid & (obs.kf >= 0),
        fixed=~(free_kf & kfs.valid),
        lm_valid=lms.valid,
        cam_params=cam_params,
        # Stereo rows (EdgeStereoSE3ProjectXYZ) when the rig provides u_r.
        obs_ur=(kfs.kp_ur[kf_safe, kp_safe] if use_stereo else None),
        bf=(jnp.asarray(bf, jnp.float32) if use_stereo else None))


@jax.jit
def _apply_ba_result(state: ms.MapState, res: ba.BAResult) -> ms.MapState:
    """Write a full-map BAResult back into the state (+ inlier gating)."""
    kfs = state.kfs._replace(R=res.R, t=res.t)
    lms = state.lms._replace(pos=res.points)
    obs = state.obs._replace(valid=state.obs.valid & res.obs_inlier)
    # Landmarks losing all observations die.
    n_obs = (obs.valid & (obs.kf >= 0)).sum(-1)
    lms = lms._replace(valid=lms.valid & (n_obs >= 2),
                       n_obs=n_obs.astype(jnp.int32))
    return state._replace(kfs=kfs, lms=lms, obs=obs)


@functools.partial(jax.jit, static_argnames=("model_id", "use_stereo"))
def local_ba(state: ms.MapState, free_kf: jnp.ndarray, cam_params,
             model_id: int = cam.PINHOLE, use_stereo: bool = False,
             bf: float = 0.0):
    """Bundle adjust the whole map with only ``free_kf`` poses free.

    The reference's covisibility-window LocalBundleAdjustment
    (Optimizer.cc:1740) restricts both the KF set and the observation set;
    here all (masked) observations stay — extra constraints cost nothing
    once batched, and fixed poses anchor the gauge exactly like its fixed
    "other observers".
    Returns the updated state (+ observation inlier gating applied).
    """
    prob = _full_ba_problem(state, free_kf, cam_params, use_stereo, bf)
    res = ba.bundle_adjust(prob, model_id=model_id)
    return _apply_ba_result(state, res)


@functools.partial(jax.jit, static_argnames=(
    "model_id", "use_stereo", "n_free", "n_window", "n_lm_window"))
def windowed_local_ba(state: ms.MapState, kf_id: jnp.ndarray, cam_params,
                      model_id: int = cam.PINHOLE, use_stereo: bool = False,
                      bf: float = 0.0, n_free: int = 9, n_window: int = 32,
                      n_lm_window: int = 4096):
    """Covisibility-windowed local bundle adjustment, O(window) per call.

    Mirrors ``Optimizer::LocalBundleAdjustment``
    (/root/reference/src/Optimizer.cc:1740-1810): free = current KF + its
    best covisible neighbours (``n_free`` total); the window landmarks are
    everything those free KFs observe; fixed = the other observers of those
    landmarks (capped at ``n_window - n_free``, the reference caps its
    inertial variant at 200 fixed, :2280). The whole problem — selection,
    gather, Schur BA, scatter-back — is ONE jitted kernel with static
    shapes, so per-keyframe cost stays constant as the map grows (the
    round-1 version optimized every observation of the whole map).
    """
    kfs, lms, obs = state.kfs, state.lms, state.obs
    max_kf = kfs.valid.shape[0]
    max_lm = lms.pos.shape[0]
    n_fixed_cap = n_window - n_free
    kf_id = jnp.asarray(kf_id, jnp.int32)

    # --- Free set: current KF + top covisible neighbours. -----------------
    counts = ms.covisibility_counts(state, kf_id, max_kf)
    counts = jnp.where(kfs.valid, counts, -1).at[kf_id].set(-1)
    top_c, top_i = jax.lax.top_k(counts, n_free - 1)
    free_ids = jnp.concatenate([kf_id[None], top_i.astype(jnp.int32)])
    free_ok = jnp.concatenate([jnp.ones((1,), bool), top_c > 0])
    free_mask = jnp.zeros((max_kf,), bool).at[
        jnp.where(free_ok, free_ids, max_kf)].set(True, mode="drop")

    # --- Window landmarks: observed by any free KF. -----------------------
    obs_live = obs.valid & (obs.kf >= 0)
    kf_safe_all = jnp.maximum(obs.kf, 0)
    obs_in_free = obs_live & free_mask[kf_safe_all]
    lm_in = obs_in_free.any(-1) & lms.valid                     # (L,)
    lm_score, lm_ids = jax.lax.top_k(lm_in.astype(jnp.float32), n_lm_window)
    lm_ok = lm_score > 0.5                                      # (Lw,)

    # --- Fixed set: other observers of the window landmarks. --------------
    contrib = lm_in[:, None] & obs_live & ~free_mask[kf_safe_all]
    flat_kf = jnp.where(contrib, obs.kf, max_kf).reshape(-1)
    fix_counts = jnp.zeros((max_kf + 1,), jnp.int32).at[flat_kf].add(1)
    fix_counts = jnp.where(kfs.valid & ~free_mask, fix_counts[:max_kf], -1)
    fc, fi = jax.lax.top_k(fix_counts, n_fixed_cap)
    fix_ok = fc > 0

    win_ids = jnp.concatenate([free_ids, fi.astype(jnp.int32)])   # (W,)
    win_ok = jnp.concatenate([free_ok, fix_ok])
    win_fixed = jnp.concatenate([jnp.zeros((n_free,), bool),
                                 jnp.ones((n_fixed_cap,), bool)])
    # Dead slots are fixed; the global gauge anchor KF0 stays fixed
    # (the reference fixes the map-origin KF whenever it enters the window).
    win_fixed = win_fixed | ~win_ok | (win_ids == 0)
    # Gauge guard: with no fixed camera at all, anchor the oldest free KF
    # (LocalBundleAdjustment falls back the same way for tiny maps).
    no_fixed = ~(win_fixed & win_ok).any()
    anchor = jnp.argmin(jnp.where(free_ok, free_ids, max_kf))
    win_fixed = win_fixed.at[anchor].set(win_fixed[anchor] | no_fixed)

    loc = jnp.full((max_kf + 1,), -1, jnp.int32).at[
        jnp.where(win_ok, win_ids, max_kf)].set(
            jnp.arange(n_window, dtype=jnp.int32), mode="drop")

    # --- Gather the window problem. ----------------------------------------
    okf_g = obs.kf[lm_ids]                                      # (Lw, O)
    okp_g = jnp.maximum(obs.kp[lm_ids], 0)
    oval_g = obs.valid[lm_ids] & (okf_g >= 0) & lm_ok[:, None]
    okf_local = jnp.where(oval_g, loc[jnp.maximum(okf_g, 0)], -1)
    in_win = okf_local >= 0
    kf_safe = jnp.maximum(okf_g, 0)
    obs_uv = kfs.kp_xy[kf_safe, okp_g]
    obs_level = kfs.kp_level[kf_safe, okp_g]
    prob = ba.BAProblem(
        R=kfs.R[win_ids], t=kfs.t[win_ids], points=lms.pos[lm_ids],
        obs_kf=jnp.where(in_win, okf_local, -1),
        obs_uv=obs_uv, obs_w=INV_SIGMA2[obs_level],
        obs_valid=oval_g & in_win,
        fixed=win_fixed, lm_valid=lm_ok,
        cam_params=cam_params,
        obs_ur=(jnp.where(in_win, kfs.kp_ur[kf_safe, okp_g], -1.0)
                if use_stereo else None),
        bf=(jnp.asarray(bf, jnp.float32) if use_stereo else None))
    # (4, 6) iterations instead of the reference's nominal (5, 10): its
    # per-KF local BA runs with mbAbortBA set whenever a new KF arrives
    # (LocalMapping.cc:1168-1175), so under real-time load it rarely
    # completes the nominal schedule either.
    res = ba.bundle_adjust(prob, model_id=model_id, stages=(4, 6))

    # --- Scatter back (free poses, window landmarks, inlier gating). ------
    scat_kf = jnp.where(win_ok & ~win_fixed, win_ids, max_kf)
    kfs = kfs._replace(R=kfs.R.at[scat_kf].set(res.R, mode="drop"),
                       t=kfs.t.at[scat_kf].set(res.t, mode="drop"))
    scat_lm = jnp.where(lm_ok, lm_ids, max_lm)
    lms = lms._replace(pos=lms.pos.at[scat_lm].set(res.points, mode="drop"))
    # Observations of out-of-window KFs keep their validity untouched.
    keep = res.obs_inlier | ~in_win
    new_valid = obs.valid.at[scat_lm].set(obs.valid[lm_ids] & keep,
                                          mode="drop")
    obs = obs._replace(valid=new_valid)
    n_obs = (obs.valid & (obs.kf >= 0)).sum(-1)
    lms = lms._replace(valid=lms.valid & (n_obs >= 2),
                       n_obs=n_obs.astype(jnp.int32))
    return state._replace(kfs=kfs, lms=lms, obs=obs)


def global_ba(state: ms.MapState, cam_params, model_id: int = cam.PINHOLE,
              use_stereo: bool = False, bf: float = 0.0, mesh=None):
    """Full bundle adjustment: every valid keyframe free except the gauge
    anchor KF 0 (RunGlobalBundleAdjustment,
    /root/reference/src/LoopClosing.cc:2869 → GlobalBundleAdjustemnt,
    src/Optimizer.cc:2813). The reference runs this in a detached thread and
    merges corrections back via spanning-tree propagation; here the map is a
    value, so the refined state simply replaces the old one (XLA's async
    dispatch provides the tracking/GBA overlap).

    ``mesh``: an optional jax.sharding.Mesh — when given, the landmark axis
    is sharded across its devices and the Schur reduction runs through
    ``parallel.dist_ba`` (psum all-reduce); semantics identical to the
    single-device path. This is the production entry point of the
    distributed BA (new capability vs the reference, SURVEY §2.3)."""
    free = state.kfs.valid & (
        jnp.arange(state.kfs.valid.shape[0]) != 0)
    if mesh is not None and state.lms.pos.shape[0] % mesh.size != 0:
        # shard_map needs the landmark axis divisible by the mesh; an
        # auto-created mesh with an odd max_lm must not crash the first
        # loop closure — fall back to the single-device path.
        from ..utils import verbose
        verbose.print_mess(
            f"global_ba: max_lm={state.lms.pos.shape[0]} not divisible by "
            f"mesh size {mesh.size}; falling back to single-device BA")
        mesh = None
    if mesh is None:
        return local_ba(state, free, cam_params, model_id,
                        use_stereo=use_stereo, bf=bf)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel import dist_ba
    prob = _full_ba_problem(state, free, cam_params, use_stereo, bf)
    prob = dist_ba.shard_problem(prob, mesh)
    res = dist_ba.dist_bundle_adjust(prob, mesh, model_id=model_id)
    # Re-replicate (one all-gather) so the host pipeline's state keeps its
    # single-device layout between keyframes.
    res = jax.device_put(res, NamedSharding(mesh, P()))
    return _apply_ba_result(state, res)


def landmark_overflow_valve(state: ms.MapState, margin: int):
    """Array-capacity valve for landmarks: when fewer than ``margin`` free
    slots remain, retire the live landmarks whose LAST observation is
    oldest (smallest max observing-KF id — slot ids are allocated in
    temporal order, so this is least-recently-seen). The reference's heap
    map grows without bound (MapPoints only die via culling); a
    fixed-capacity array must eventually recycle, and without this valve a
    long run in continuously-new territory fills the array and silently
    stops triangulating — tracking then starves and gets lost (observed in
    the 120 s tour soak at both 16k and 64k capacity).

    Landmarks observed by the newest keyframes (including the one being
    inserted) have the largest last-seen ids and are never selected unless
    the whole map is recent."""
    lms, obs = state.lms, state.obs
    L = lms.valid.shape[0]
    n_free = (~lms.valid).sum()
    need = jnp.maximum(jnp.asarray(margin, jnp.int32) - n_free, 0)
    last_seen = jnp.max(jnp.where(obs.valid, obs.kf, -1), axis=1)
    key = jnp.where(lms.valid, last_seen, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key)                       # oldest-live first
    kill = (jnp.zeros((L,), bool)
            .at[order].set(jnp.arange(L, dtype=jnp.int32) < need)
            & lms.valid)
    return state._replace(lms=lms._replace(valid=lms.valid & ~kill))


def _alloc_landmark_slots(lm_valid: jnp.ndarray, good: jnp.ndarray):
    """Allocate a free landmark slot per ``good`` row, device-side.

    Free slots (``~lm_valid``) are ranked by cumsum; good rows take ranks in
    order. Culled slots are recycled immediately — the host-side compaction
    becomes a rare safety valve instead of a correctness requirement.
    Returns (slots, ok): ok is good & "a slot was available".
    """
    L = lm_valid.shape[0]
    free = ~lm_valid
    n_free = free.sum()
    rank_free = jnp.cumsum(free) - 1
    slot_of_rank = jnp.zeros((L,), jnp.int32).at[
        jnp.where(free, rank_free, L)].set(
            jnp.arange(L, dtype=jnp.int32), mode="drop")
    r = jnp.cumsum(good) - 1
    ok = good & (r < n_free)
    slots = slot_of_rank[jnp.clip(r, 0, L - 1)]
    return slots, ok


@functools.partial(jax.jit, static_argnames=(
    "model_id", "use_stereo", "n_neighbors", "n_free", "n_window",
    "n_lm_window", "do_kf_cull", "do_local_ba"))
def keyframe_bundle(state: ms.MapState, kf_id, R, t, stamp, feats, ur,
                    bindings, cam_params, n_lm_hwm,
                    img_w: float, img_h: float,
                    model_id: int = cam.PINHOLE, use_stereo: bool = False,
                    bf: float = 0.0, n_neighbors: int = 3, n_free: int = 9,
                    n_window: int = 32, n_lm_window: int = 4096,
                    do_kf_cull: bool = True, do_local_ba: bool = True):
    """The WHOLE per-keyframe LocalMapping work as one device dispatch:
    KF insert + observation binding, neighbour selection (device top-k),
    epipolar triangulation against ``n_neighbors`` covisible KFs with
    device-side landmark-slot allocation, duplicate fusion, windowed local
    BA, landmark culling and keyframe culling.

    Replaces the host-orchestrated stage sequence (which cost ~10 blocking
    host<->device round-trips per keyframe) so the host can dispatch the
    bundle and keep feeding tracking frames — the array-state analog of the
    reference's Tracking ∥ LocalMapping pipeline (System.cc:223-265, KF
    queue LocalMapping.cc:361-370). Small results return in ``info`` for a
    single deferred host read:

      info = [parent, parent_count, n_lm_hwm', R_kf(9), t_kf(3)]  (15 floats)

    Returns (state', bindings', info, culled_mask).
    """
    n_feat = feats.xy.shape[0]
    kf_id = jnp.asarray(kf_id, jnp.int32)
    state = ms.add_keyframe(state, kf_id, R, t, stamp, feats, ur=ur)
    kp_idx = jnp.arange(n_feat, dtype=jnp.int32)
    state = ms.add_observations(state, jnp.maximum(bindings, 0), kf_id,
                                kp_idx, bindings >= 0)

    max_kf = state.kfs.valid.shape[0]
    counts = ms.covisibility_counts(state, kf_id, max_kf)
    counts = jnp.where(state.kfs.valid, counts, 0).at[kf_id].set(0)
    cv, ci = jax.lax.top_k(counts, n_neighbors)

    # Capacity valve BEFORE triangulation (after this KF's observations
    # bind, so its landmarks rank newest and survive): keep at least one
    # frame's worth of free slots per creation path — stereo KFs also
    # back-project depth landmarks right after the bundle.
    state = landmark_overflow_valve(
        state, 2 * n_feat if use_stereo else n_feat)

    # Triangulate new landmarks against the best covisible neighbours
    # (CreateNewMapPoints :506; >= 15 shared points gate as before).
    free_kp = feats.valid & (bindings < 0)
    hwm = jnp.asarray(n_lm_hwm, jnp.int32)
    for i in range(n_neighbors):
        nb = ci[i]
        ok_nb = cv[i] >= 15
        kfs = state.kfs
        res = triangulate_pair(
            kfs.R[kf_id], kfs.t[kf_id], feats.xy, feats.level, feats.desc,
            free_kp & ok_nb,
            kfs.R[nb], kfs.t[nb], kfs.kp_xy[nb], kfs.kp_level[nb],
            kfs.kp_desc[nb], kfs.kp_valid[nb] & ok_nb,
            cam_params, model_id=model_id)
        slots, ok = _alloc_landmark_slots(state.lms.valid, res.good)
        state = ms.add_landmarks(state, slots, res.pos, res.desc,
                                 kf_id, res.kp_a, nb, res.kp_b, ok,
                                 res.normal, res.min_dist, res.max_dist)
        bindings = bindings.at[jnp.where(ok, res.kp_a, n_feat)].set(
            jnp.where(ok, slots, -1), mode="drop")
        free_kp = feats.valid & (bindings < 0)
        hwm = jnp.maximum(hwm, jnp.max(jnp.where(ok, slots + 1, 0)))

    state = fuse_duplicates(state, kf_id, cam_params, img_w, img_h)
    if do_local_ba:
        # Visual systems refine + cull inside the bundle; inertial systems
        # pass do_local_ba=False and run LocalInertialBA + chain-aware
        # culling on the host afterwards (their schedule needs the chain).
        state = windowed_local_ba(state, kf_id, cam_params,
                                  model_id=model_id,
                                  use_stereo=use_stereo, bf=bf,
                                  n_free=n_free, n_window=n_window,
                                  n_lm_window=n_lm_window)
        state = cull_landmarks(state, kf_id)
    valid_pre = state.kfs.valid
    if do_kf_cull:
        state = cull_keyframes(state, kf_id)
    culled = valid_pre & ~state.kfs.valid

    # Fusion/BA/culling may have killed landmarks bound to this frame.
    lmv = state.lms.valid
    bindings = jnp.where(
        (bindings >= 0) & lmv[jnp.maximum(bindings, 0)], bindings, -1)

    info = jnp.concatenate([
        ci[0][None].astype(jnp.float32), cv[0][None].astype(jnp.float32),
        hwm[None].astype(jnp.float32),
        state.kfs.R[kf_id].reshape(-1), state.kfs.t[kf_id]])
    return state, bindings, info, culled


@jax.jit
def fuse_duplicates(state: ms.MapState, kf_id: jnp.ndarray, cam_params,
                    img_w: float, img_h: float):
    """SearchInNeighbors / ORBmatcher::Fuse (LocalMapping.cc:917,
    ORBmatcher.cc:1326): project map landmarks NOT yet seen by the new KF
    into it; a hit on a keypoint already bound to another landmark means a
    duplicate — the landmark with fewer observations dies; a hit on a free
    keypoint becomes a new observation."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    n_lm = lms.pos.shape[0]
    n_feat = kfs.kp_xy.shape[1]
    seen, kp_of = ms.landmarks_seen_by(state, kf_id)
    R, t = kfs.R[kf_id], kfs.t[kf_id]

    visible, proj, dist, plevel = matching.frustum_cull(
        R, t, lms.pos, lms.normal, lms.min_dist, lms.max_dist, cam_params,
        img_w, img_h)
    cand = visible & lms.valid & ~seen
    radius = 3.0 * SCALE ** plevel.astype(jnp.float32)
    mj, md = matching.search_by_projection(
        proj, plevel, lms.desc, cand,
        kfs.kp_xy[kf_id], kfs.kp_level[kf_id], kfs.kp_desc[kf_id],
        kfs.kp_valid[kf_id],
        radius=radius, max_dist=matching.TH_LOW, ratio=None,
        level_window=(-1, 1))

    # Keypoint -> landmark already bound in this KF.
    kp2lm = jnp.full((n_feat,), -1, jnp.int32).at[
        jnp.where(seen, kp_of, n_feat)].set(
            jnp.where(seen, jnp.arange(n_lm), -1), mode="drop")
    hit_kp = jnp.maximum(mj, 0)
    other = kp2lm[hit_kp]                            # (L,)
    dup = (mj >= 0) & (other >= 0) & cand
    other_safe = jnp.maximum(other, 0)
    keep_other = lms.n_obs[other_safe] >= lms.n_obs
    die = dup & keep_other                           # this landmark loses
    die = die | jnp.zeros((n_lm,), bool).at[
        jnp.where(dup & ~keep_other, other_safe, n_lm)].set(
            True, mode="drop")                       # the bound one loses
    lms2 = lms._replace(valid=lms.valid & ~die)
    state = state._replace(
        lms=lms2, obs=obs._replace(valid=obs.valid & lms2.valid[:, None]))

    # Fresh observations on free keypoints.
    new_obs = (mj >= 0) & (other < 0) & cand & ~die
    return ms.add_observations(state, jnp.arange(n_lm), kf_id, hit_kp,
                               new_obs)


@jax.jit
def redundancy_stats(state: ms.MapState):
    """Per-keyframe (frac, seen_cnt): the fraction of a KF's landmarks that
    are redundantly observed (>= 3 other KFs), and its live-observation
    count — the KeyFrameCulling decision inputs (LocalMapping.cc:1177)."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    max_kf = kfs.valid.shape[0]
    valid_obs = obs.valid & (obs.kf >= 0) & lms.valid[:, None]
    n_obs = valid_obs.sum(-1)                         # (L,)
    redundant_lm = n_obs >= 4                         # self + 3 others

    flat_kf = jnp.where(valid_obs, obs.kf, max_kf).reshape(-1)
    ones = valid_obs.reshape(-1).astype(jnp.int32)
    red = (valid_obs & redundant_lm[:, None]).reshape(-1).astype(jnp.int32)
    seen_cnt = jnp.zeros((max_kf + 1,), jnp.int32).at[flat_kf].add(ones)
    red_cnt = jnp.zeros((max_kf + 1,), jnp.int32).at[flat_kf].add(red)
    frac = red_cnt[:max_kf] / jnp.maximum(seen_cnt[:max_kf], 1)
    return frac, seen_cnt[:max_kf]


@jax.jit
def drop_keyframe(state: ms.MapState, kf_id: jnp.ndarray,
                  do: jnp.ndarray = True):
    """Invalidate keyframe ``kf_id``: clear its liveness + observations and
    re-count landmark support (SetBadFlag semantics, KeyFrame.cc). ``do``
    lets callers gate the drop without retracing."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    do = jnp.asarray(do, bool)
    kf_valid = kfs.valid.at[kf_id].set(jnp.where(do, False, kfs.valid[kf_id]))
    drop = obs.valid & (obs.kf == kf_id) & do
    obs_valid = obs.valid & ~drop
    n_obs2 = (obs_valid & (obs.kf >= 0)).sum(-1)
    lms2 = lms._replace(valid=lms.valid & (n_obs2 >= 2),
                        n_obs=n_obs2.astype(jnp.int32))
    return state._replace(kfs=kfs._replace(valid=kf_valid),
                          obs=obs._replace(valid=obs_valid), lms=lms2)


@jax.jit
def cull_keyframes(state: ms.MapState, kf_id: jnp.ndarray,
                   redundancy: float = 0.9, protect_last: int = 3):
    """KeyFrameCulling (LocalMapping.cc:1177): cull (at most one per call,
    like the reference's incremental sweep) a keyframe >=90% of whose
    landmarks are seen by >=3 other keyframes. KF0 and the newest KFs are
    protected; inertial systems use the chain-aware variant in
    inertial_system._maybe_cull_keyframes (preintegration merge)."""
    kfs = state.kfs
    max_kf = kfs.valid.shape[0]
    frac, seen_cnt = redundancy_stats(state)
    ids = jnp.arange(max_kf)
    protected = (ids == 0) | (ids >= kf_id - protect_last) | ~kfs.valid \
        | (seen_cnt < 30)
    score = jnp.where(protected, -1.0, frac)
    c = jnp.argmax(score)
    return drop_keyframe(state, c, score[c] >= redundancy)


@jax.jit
def cull_candidate(state: ms.MapState, eligible: jnp.ndarray,
                   min_seen: int = 30):
    """Best redundancy-cull candidate among ``eligible`` keyframes: one
    2-float read [best_id, best_frac] instead of pulling the full
    redundancy/validity arrays to the host per keyframe (the inertial
    chain-aware culling's eligibility — chain gaps, recency — is computed
    from host mirrors; the redundancy score lives here)."""
    frac, seen = redundancy_stats(state)
    score = jnp.where(eligible & state.kfs.valid & (seen >= min_seen),
                      frac, -1.0)
    best = jnp.argmax(score)
    return jnp.stack([best.astype(jnp.float32), score[best]])


@jax.jit
def cull_landmarks(state: ms.MapState, current_kf: jnp.ndarray,
                   min_found_ratio: float = 0.25):
    """MapPointCulling (:451): kill landmarks with poor found/visible ratio
    or too few observations soon after creation."""
    lms = state.lms
    found_ratio = lms.n_found / jnp.maximum(lms.n_visible, 1)
    age = current_kf - lms.first_kf
    bad = (found_ratio < min_found_ratio) & (lms.n_visible >= 3)
    bad = bad | ((age >= 2) & (lms.n_obs <= 2) & (age < 30))
    return state._replace(lms=lms._replace(valid=lms.valid & ~bad))
