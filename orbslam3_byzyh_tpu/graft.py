"""Driver entry points: single-chip forward step + multi-chip dry-run.

``tracking_step`` is the flagship per-frame computation (ORB extraction +
local-map tracking + motion-only pose optimization) as one jittable function.
``dryrun_step`` builds a landmark-sharded distributed BA over an n-device mesh
(the "training step" of a SLAM engine: the map refinement path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops import fast_orb
from .pipeline import tracking
from .solver import ba


def tracking_step(img, R, t, lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
                  lm_valid, cam_params):
    """One full tracking frame: extract ORB features, project the local map,
    match, and run motion-only pose optimization. img: (H, W) float32."""
    feats = fast_orb.extract(img, n_features=1024)
    bindings = jnp.full((1024,), -1, jnp.int32)
    res = tracking.track_local_map(
        R, t, bindings,
        lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
        feats.xy, feats.level, feats.desc, feats.valid,
        cam_params, int(img.shape[1]), int(img.shape[0]))
    return res.R, res.t, res.n_inliers


def example_tracking_args(h: int = 480, w: int = 640, n_lm: int = 4096):
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
    lm_pos = jnp.asarray(
        np.stack([rng.uniform(-5, 5, n_lm), rng.uniform(-4, 4, n_lm),
                  rng.uniform(3, 12, n_lm)], -1).astype(np.float32))
    lm_desc = jnp.asarray(rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint32))
    normal = lm_pos / jnp.linalg.norm(lm_pos, axis=-1, keepdims=True)
    cam_params = jnp.asarray(np.array([400.0, 400.0, w / 2, h / 2], np.float32))
    return (img, jnp.eye(3), jnp.zeros(3), lm_pos, lm_desc, normal,
            jnp.full((n_lm,), 0.5), jnp.full((n_lm,), 40.0),
            jnp.ones((n_lm,), bool), cam_params)


def make_tiny_map_state(n_kf: int = 6, n_lm: int = 64, max_obs: int = 4,
                        stereo_bf: float = 80.0, seed: int = 0):
    """Consistent synthetic MapState (poses + projected keypoints + stereo
    rows) for driving the production full-map BA entry point
    (pipeline.mapping.global_ba), built with array operations so it scales
    to the runners' capacity (1024 keyframes / 65536 landmarks).

    Keyframes step 5 cm along x looking down +z; landmark l is observed by
    the ``max_obs`` consecutive keyframes starting at ``l % (n_kf - max_obs
    + 1)`` and sits in front of them. Each keyframe's keypoint slots hold its
    observations in landmark order."""
    from .models import map_state as ms

    rng = np.random.default_rng(seed)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    cam_params = np.array([fx, fy, cx, cy], np.float32)
    n_obs = min(n_kf, max_obs)
    ts = np.zeros((n_kf, 3), np.float32)
    ts[:, 0] = -0.05 * np.arange(n_kf)
    ts[:, 1] = 0.02 * np.sin(0.1 * np.arange(n_kf))
    Rs = np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1))
    k0 = np.arange(n_lm) % (n_kf - n_obs + 1)
    obs_kf = (k0[:, None] + np.arange(n_obs)).astype(np.int32)   # (L, O)
    centre = -ts[k0 + n_obs // 2, 0]
    X = np.stack([centre + rng.uniform(-1, 1, n_lm), rng.uniform(-2, 2, n_lm),
                  rng.uniform(4, 8, n_lm)], -1).astype(np.float32)
    # Keypoint slot of each observation: its rank within the keyframe.
    flat_kf = obs_kf.reshape(-1)
    order = np.argsort(flat_kf, kind="stable")
    first = np.searchsorted(flat_kf[order], np.arange(n_kf))
    slot = np.empty_like(flat_kf)
    slot[order] = np.arange(flat_kf.size) - first[flat_kf[order]]
    n_feat = int(slot.max()) + 1
    pc = X[:, None, :] + ts[obs_kf]                      # R = I
    u = fx * pc[..., 0] / pc[..., 2] + cx + rng.normal(0, 0.5, pc.shape[:2])
    v = fy * pc[..., 1] / pc[..., 2] + cy + rng.normal(0, 0.5, pc.shape[:2])
    kp_xy = np.zeros((n_kf, n_feat, 2), np.float32)
    kp_ur = np.full((n_kf, n_feat), -1.0, np.float32)
    kp_valid = np.zeros((n_kf, n_feat), bool)
    kp_xy[flat_kf, slot] = np.stack([u, v], -1).reshape(-1, 2)
    kp_ur[flat_kf, slot] = (u - stereo_bf / pc[..., 2]).reshape(-1)
    kp_valid[flat_kf, slot] = True
    max_obs_slots = max(max_obs, n_obs)
    obs_kf_full = np.full((n_lm, max_obs_slots), -1, np.int32)
    obs_kp_full = np.full((n_lm, max_obs_slots), -1, np.int32)
    obs_kf_full[:, :n_obs] = obs_kf
    obs_kp_full[:, :n_obs] = slot.reshape(n_lm, n_obs)
    state = ms.empty_map(n_kf, n_lm, max_obs_slots, n_feat)
    kfs = state.kfs._replace(
        R=jnp.asarray(Rs), t=jnp.asarray(ts), kp_xy=jnp.asarray(kp_xy),
        kp_ur=jnp.asarray(kp_ur), kp_valid=jnp.asarray(kp_valid),
        valid=jnp.ones((n_kf,), bool))
    lms = state.lms._replace(
        pos=jnp.asarray(X + rng.normal(0, 0.01, X.shape).astype(np.float32)),
        n_obs=jnp.full((n_lm,), n_obs, jnp.int32),
        valid=jnp.ones((n_lm,), bool))
    obs = state.obs._replace(kf=jnp.asarray(obs_kf_full),
                             kp=jnp.asarray(obs_kp_full),
                             valid=jnp.asarray(obs_kf_full >= 0))
    return ms.MapState(kfs=kfs, lms=lms, obs=obs), jnp.asarray(cam_params), \
        stereo_bf


def make_tiny_ba_problem(n_kf: int = 4, n_lm: int = 64, n_obs: int = 4):
    """Tiny synthetic BA problem for the multi-chip dry-run."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, n_lm), rng.uniform(-2, 2, n_lm),
                  rng.uniform(4, 8, n_lm)], -1).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1))
    ts = np.stack([np.array([-0.3 * k, 0, 0], np.float32)
                   for k in range(n_kf)])
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    obs_kf = np.full((n_lm, n_obs), -1, np.int32)
    obs_uv = np.zeros((n_lm, n_obs, 2), np.float32)
    obs_valid = np.zeros((n_lm, n_obs), bool)
    for l in range(n_lm):
        for o, k in enumerate(range(min(n_kf, n_obs))):
            pc = Rs[k] @ X[l] + ts[k]
            obs_kf[l, o] = k
            obs_uv[l, o] = [fx * pc[0] / pc[2] + cx + rng.normal(0, 0.5),
                            fy * pc[1] / pc[2] + cy + rng.normal(0, 0.5)]
            obs_valid[l, o] = True
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    return ba.BAProblem(
        R=jnp.asarray(Rs), t=jnp.asarray(ts), points=jnp.asarray(X),
        obs_kf=jnp.asarray(obs_kf), obs_uv=jnp.asarray(obs_uv),
        obs_w=jnp.ones((n_lm, n_obs), jnp.float32),
        obs_valid=jnp.asarray(obs_valid), fixed=jnp.asarray(fixed),
        lm_valid=jnp.ones(n_lm, bool),
        cam_params=jnp.asarray(np.array([fx, fy, cx, cy], np.float32)))
