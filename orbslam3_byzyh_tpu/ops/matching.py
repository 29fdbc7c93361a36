"""Batched Hamming-distance descriptor matching.

Replaces the reference ``ORBmatcher`` (/root/reference/src/ORBmatcher.cc):
the sequential per-keypoint candidate loops become one masked dense distance
matrix + argmin reductions; the rotation-consistency histogram
(``ComputeThreeMaxima``, ORBmatcher.h:99) and greedy mutual exclusion become
segmented reductions.

Thresholds (Appendix A parity): TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 with
top-3 bins kept; ``DescriptorDistance`` (:2384) = 256-bit popcount.

Descriptors are (N, 8) uint32. Distances are int32 in [0, 256]; the sentinel
``INVALID_DIST`` (1024) marks masked-out pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INVALID_DIST = 1024


def hamming_matrix(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int32 Hamming distances.

    Word-by-word accumulation so XLA fuses per-word (N, M) popcounts instead
    of materialising an (N, M, 8) cube. Words are bitcast to int32 first
    (xor/popcount are bit-pattern ops, so the cast is free).
    """
    da = jax.lax.bitcast_convert_type(da, jnp.int32)
    db = jax.lax.bitcast_convert_type(db, jnp.int32)
    n, m = da.shape[0], db.shape[0]
    dist = jnp.zeros((n, m), jnp.int32)
    for k in range(da.shape[1]):
        x = da[:, None, k] ^ db[None, :, k]
        dist = dist + jax.lax.population_count(x)
    return dist


def masked_hamming(da, db, valid_a, valid_b, pair_mask=None):
    """Distance matrix with invalid rows/cols/pairs set to INVALID_DIST."""
    dist = hamming_matrix(da, db)
    ok = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        ok = ok & pair_mask
    return jnp.where(ok, dist, INVALID_DIST)


def best_two(dist: jnp.ndarray):
    """Per-row best and second-best distances + best index. dist: (N, M)."""
    if dist.shape[1] < 2:
        dist = jnp.pad(dist, ((0, 0), (0, 2 - dist.shape[1])),
                       constant_values=INVALID_DIST)
    vals, idx = jax.lax.top_k(-dist, 2)
    return -vals[:, 0], -vals[:, 1], idx[:, 0]


def ratio_test(best, second, ratio: float):
    """Lowe-style nearest/second-nearest gate (mfNNratio, ORBmatcher.h:40)."""
    return best.astype(jnp.float32) < ratio * second.astype(jnp.float32)


def mutual_filter_from_best(best, best_j, accept, m: int):
    """Resolve target conflicts: each column keeps only its best row.

    Mirrors the reference's "already matched" bookkeeping (e.g.
    SearchForInitialization's vnMatches21, ORBmatcher.cc:735): when two
    queries pick the same target, the smaller distance wins.
    """
    n = best.shape[0]
    best_d = jnp.where(accept, best, INVALID_DIST)
    # Per-column minimum over the rows that chose that column.
    col_min = jnp.full((m,), INVALID_DIST, jnp.int32).at[best_j].min(
        best_d.astype(jnp.int32))
    keep = accept & (best_d == col_min[best_j]) & (best_d < INVALID_DIST)
    # Tie-break duplicates (equal distance, same column): keep lowest row index.
    first_row = jnp.full((m,), n, jnp.int32).at[best_j].min(
        jnp.where(keep, jnp.arange(n), n))
    keep = keep & (first_row[best_j] == jnp.arange(n))
    return keep


def mutual_filter(dist: jnp.ndarray, best_j: jnp.ndarray, accept: jnp.ndarray):
    n = dist.shape[0]
    return mutual_filter_from_best(dist[jnp.arange(n), best_j], best_j,
                                   accept, dist.shape[1])


def rotation_consistency(angle_a, angle_b, best_j, accept,
                         n_bins: int = HISTO_LENGTH):
    """Keep only matches whose angle difference falls in the top-3 histogram
    bins (ComputeThreeMaxima parity, including the 0.1x count cutoffs)."""
    rot = angle_a - angle_b[best_j]
    rot = jnp.mod(rot, 2.0 * jnp.pi)
    bin_idx = jnp.clip(
        jnp.round(rot * (n_bins / (2.0 * jnp.pi))).astype(jnp.int32), 0, n_bins)
    bin_idx = jnp.where(bin_idx == n_bins, 0, bin_idx)
    hist = jnp.zeros(n_bins, jnp.int32).at[bin_idx].add(accept.astype(jnp.int32))
    top_vals, top_bins = jax.lax.top_k(hist, 3)
    # Reference drops bins 2/3 when below 10% of max1 (ORBmatcher.cc:2340-2360).
    keep2 = top_vals[1] > 0.1 * top_vals[0]
    keep3 = top_vals[2] > 0.1 * top_vals[0]
    in_top = (bin_idx == top_bins[0]) \
        | ((bin_idx == top_bins[1]) & keep2) \
        | ((bin_idx == top_bins[2]) & keep3)
    return accept & in_top


def apply_rotation_filter(mj, angle_a, angle_b):
    """Post-filter a finished match vector by the rotation histogram: keep
    only rows whose angle difference lands in the top-3 bins (the
    reference's end-of-search ComputeThreeMaxima erase pass, e.g.
    ORBmatcher.cc:1951 SearchByProjection frame-vs-frame tail)."""
    accept = mj >= 0
    keep = rotation_consistency(angle_a, angle_b, jnp.maximum(mj, 0), accept)
    return jnp.where(keep, mj, -1)


def match(da, db, valid_a, valid_b, pair_mask=None, max_dist: int = TH_LOW,
          ratio: float = 0.9, angles=None, mutual: bool = True):
    """Generic one-shot matcher.

    Returns (match_j: (N,) int32 index into b or -1, dist: (N,) int32).
    ``angles`` is an optional (angle_a, angle_b) tuple enabling the rotation
    histogram gate.
    """
    dist = masked_hamming(da, db, valid_a, valid_b, pair_mask)
    best, second, best_j = best_two(dist)
    accept = best <= max_dist
    if ratio is not None:
        accept = accept & ratio_test(best, second, ratio)
    if angles is not None:
        accept = rotation_consistency(angles[0], angles[1], best_j, accept)
    if mutual:
        accept = mutual_filter(dist, best_j, accept)
    return jnp.where(accept, best_j, -1), jnp.where(accept, best, INVALID_DIST)


# ---------------------------------------------------------------------------
# Geometry-guided candidate masks
# ---------------------------------------------------------------------------

def match_window(da, db, valid_a, valid_b, xy_a, xy_b, radius,
                 level_a, level_b, level_window=(-8, 8),
                 max_dist: int = TH_LOW, ratio: float = 0.9,
                 mutual: bool = True):
    """Window-gated match (SearchForInitialization-style, ORBmatcher.cc:735)."""
    pm = window_mask(xy_a, xy_b, radius) \
        & level_mask(level_a, level_b, *level_window)
    return match(da, db, valid_a, valid_b, pair_mask=pm, max_dist=max_dist,
                 ratio=ratio, mutual=mutual)


def window_mask(xy_a, xy_b, radius):
    """Candidate pairs within a pixel window. radius: scalar or (N,)."""
    d2 = jnp.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, -1)
    r = jnp.asarray(radius)
    r2 = (r * r) if r.ndim == 0 else (r * r)[:, None]
    return d2 <= r2


def level_mask(level_a, level_b, min_delta: int = 0, max_delta: int = 0):
    """Pyramid-level compatibility: level_b within [la+min, la+max]."""
    diff = level_b[None, :] - level_a[:, None]
    return (diff >= min_delta) & (diff <= max_delta)


def epipolar_mask(F12, xy1, xy2, level2, sigma_levels2):
    """Pairs (i, j) consistent with the fundamental F12 (x2^T F12 x1 = 0).

    Mirrors the epipolar gate inside SearchForTriangulation
    (ORBmatcher.cc:1046 + CheckDistEpipolarLine): squared point-line distance
    in image 2 below 3.84 * sigma2(level of kp2).
    """
    ones1 = jnp.ones_like(xy1[:, :1])
    l2 = jnp.concatenate([xy1, ones1], -1) @ F12.T      # (N1, 3) lines in im2
    num = (l2[:, None, 0] * xy2[None, :, 0] + l2[:, None, 1] * xy2[None, :, 1]
           + l2[:, None, 2]) ** 2
    den = jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12)[:, None]
    d2 = num / den
    th = 3.84 * sigma_levels2[level2][None, :]
    return d2 < th


def predict_scale_level(dist, max_dist, scale: float = 1.2, n_levels: int = 8):
    """Pyramid level a landmark would appear at, from its distance
    (MapPoint::PredictScale behaviour)."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-6), 1e-6)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


def frustum_cull(R, t, pos, normal, min_dist, max_dist, cam_params,
                 img_w: float, img_h: float, view_cos_limit: float = 0.5):
    """Frame::isInFrustum (/root/reference/src/Frame.cc:667) batched.

    Returns (visible mask, projected uv, distance, predicted level).
    """
    pc = jnp.einsum("ij,nj->ni", R, pos) + t
    z = pc[:, 2]
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * pc[:, 0] * inv_z + cx
    v = fy * pc[:, 1] * inv_z + cy
    cam_center = -jnp.einsum("ji,j->i", R, t)
    po = pos - cam_center
    dist = jnp.linalg.norm(po, axis=-1)
    view_cos = jnp.sum(po * normal, -1) / jnp.maximum(dist, 1e-9)
    ok = ((z > 0.01) & (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
          & (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
          & (view_cos > view_cos_limit))
    level = predict_scale_level(dist, max_dist)
    return ok, jnp.stack([u, v], -1), dist, level


def search_by_projection(proj_xy, pred_level, lm_desc, lm_valid,
                         kp_xy, kp_level, kp_desc, kp_valid,
                         radius, max_dist: int = TH_HIGH, ratio: float = 0.9,
                         level_window: tuple = (-1, 1)):
    """Project-and-match: landmarks (rows) against frame keypoints (cols).

    Mirrors ORBmatcher::SearchByProjection (frame-vs-map, ORBmatcher.cc:46 and
    frame-vs-last-frame :1951): per-landmark search radius scaled by predicted
    level, candidate keypoints restricted to a level window.
    Returns (match_j, dist) per landmark.
    """
    pm = window_mask(proj_xy, kp_xy, radius)
    pm = pm & level_mask(pred_level, kp_level, *level_window)
    return match(lm_desc, kp_desc, lm_valid, kp_valid, pair_mask=pm,
                 max_dist=max_dist, ratio=ratio, mutual=True)


def search_epipolar(lines_a, desc_a, valid_a, kp_xy, kp_level, desc_b,
                    valid_b, sigma2_levels, max_dist: int = TH_LOW,
                    ratio: float = 0.8):
    """Epipolar-gated match for triangulation (SearchForTriangulation,
    ORBmatcher.cc:1046): rows carry their epipolar line in image b; gate is
    squared point-line distance < 3.84 * sigma2(level_b)."""
    th_b = 3.84 * sigma2_levels[kp_level]
    num = (lines_a[:, None, 0] * kp_xy[None, :, 0]
           + lines_a[:, None, 1] * kp_xy[None, :, 1]
           + lines_a[:, None, 2]) ** 2
    den = jnp.maximum(lines_a[:, 0] ** 2 + lines_a[:, 1] ** 2, 1e-12)[:, None]
    pm = (num / den) < th_b[None, :]
    return match(desc_a, desc_b, valid_a, valid_b, pair_mask=pm,
                 max_dist=max_dist, ratio=ratio, mutual=True)
