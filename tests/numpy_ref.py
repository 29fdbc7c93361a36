"""Plain numpy references for the descriptor matcher and the steered BRIEF
sampler (ops/matching.py, ops/fast_orb.py), independent of JAX.

Used by the CPU tests and by chip_smoke.py to check the device paths.
"""

from __future__ import annotations

import os

import numpy as np

INVALID_DIST = 1024
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int32)
# ORB bit_pattern_31: (256, 4) rows of (ax, ay, bx, by).
_PATTERN = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "orbslam3_byzyh_tpu", "ops",
                                "orb_pattern.npy")).astype(np.float64)


def hamming(da: np.ndarray, db: np.ndarray, rows: int = 256) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int32 bit distances."""
    da = np.ascontiguousarray(da, np.uint32)
    db = np.ascontiguousarray(db, np.uint32)
    out = np.empty((da.shape[0], db.shape[0]), np.int32)
    for i in range(0, da.shape[0], rows):
        x = np.ascontiguousarray(da[i:i + rows, None, :] ^ db[None, :, :])
        out[i:i + rows] = _POP8[x.view(np.uint8)].sum(-1)
    return out


def best_two(dist: np.ndarray):
    """Per-row (best, second, argbest); ties keep the lowest column."""
    j = np.argmin(dist, axis=1)
    two = np.sort(dist, axis=1)[:, :2]
    return two[:, 0], two[:, 1], j


def match(dist: np.ndarray, max_dist: int, ratio: float, mutual: bool = True):
    """matching.match semantics on a masked distance matrix:
    (match_j or -1, accepted distance or INVALID_DIST)."""
    n, m = dist.shape
    best, second, j = best_two(dist)
    accept = best <= max_dist
    if ratio is not None:
        accept &= best.astype(np.float32) < np.float32(ratio) * second.astype(
            np.float32)
    if mutual:
        best_d = np.where(accept, best, INVALID_DIST)
        col_min = np.full(m, INVALID_DIST, np.int64)
        np.minimum.at(col_min, j, best_d)
        keep = accept & (best_d == col_min[j]) & (best_d < INVALID_DIST)
        first = np.full(m, n, np.int64)
        np.minimum.at(first, j, np.where(keep, np.arange(n), n))
        accept = keep & (first[j] == np.arange(n))
    return np.where(accept, j, -1), np.where(accept, best, INVALID_DIST)


def window_level_mask(xy_a, xy_b, radius, level_a, level_b, lo, hi):
    """Pairs within the per-row pixel radius and the level window
    (float32, like the device)."""
    diff = (xy_a[:, None, :].astype(np.float32)
            - xy_b[None, :, :].astype(np.float32))
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    r = np.asarray(radius, np.float32)
    r2 = r * r if r.ndim == 0 else (r * r)[:, None]
    diff = level_b[None, :] - level_a[:, None]
    return (d2 <= r2) & (diff >= lo) & (diff <= hi)


def masked(dist, valid_a, valid_b, pair_mask=None):
    ok = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        ok &= pair_mask
    return np.where(ok, dist, INVALID_DIST)


def brief(blurred: np.ndarray, xy: np.ndarray, angle: np.ndarray,
          margin: float = 1e-5):
    """Steered BRIEF of keypoints at level-local ``xy`` on a blurred level
    (computeOrbDescriptor: rotated pattern, rounded offsets, clamped, bit i
    of word w set when sample A < sample B for pair 32 w + i).

    Returns (desc (K, 8) uint32, ambiguous (K,) bool): a keypoint is
    ambiguous when a rotated offset lies within ``margin`` px of a rounding
    boundary or two compared samples differ by less than 1e-3 without being
    equal — float32 rounding on another device may flip such a bit.
    """
    h, w = blurred.shape
    ca = np.cos(angle.astype(np.float64))[:, None]
    sa = np.sin(angle.astype(np.float64))[:, None]
    cx = np.round(xy[:, 0:1])
    cy = np.round(xy[:, 1:2])
    samples, ambiguous = [], np.zeros(len(xy), bool)
    for px, py in ((_PATTERN[:, 0], _PATTERN[:, 1]),
                   (_PATTERN[:, 2], _PATTERN[:, 3])):
        col = px[None, :] * ca - py[None, :] * sa
        row = px[None, :] * sa + py[None, :] * ca
        for v in (col, row):
            ambiguous |= (np.abs(v - np.floor(v) - 0.5) < margin).any(1)
        gx = np.clip(cx + np.round(col), 0, w - 1).astype(np.int64)
        gy = np.clip(cy + np.round(row), 0, h - 1).astype(np.int64)
        samples.append(blurred[gy, gx])
    va, vb = samples
    ambiguous |= ((np.abs(va - vb) < 1e-3) & (va != vb)).any(1)
    bits = (va < vb).reshape(len(xy), 32, 8)
    packed = np.packbits(bits, axis=-1, bitorder="little")[..., 0]
    return packed.view("<u4").reshape(len(xy), 8), ambiguous
