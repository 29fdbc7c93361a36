"""ORB feature extraction: pyramid FAST + steered BRIEF.

Replaces the reference ``ORBextractor`` (/root/reference/src/ORBextractor.cc):
  * ``ComputePyramid`` (:1687)        -> :func:`build_pyramid` (XLA resize chain)
  * FAST + grid + quadtree (:711,:1061)-> dense FAST score map (rolled-slice
    segment test), 3x3 NMS, per-cell threshold fallback 20->7, and per-tile
    top-k in place of the sequential ``DistributeOctTree`` (SURVEY.md §7.3).
  * ``IC_Angle`` (:91)                -> circular-moment convolutions m10/m01
    evaluated densely, sampled at keypoints.
  * ``computeOrbDescriptor`` (:150)    -> batched rotated-pattern gather from
    the 7x7 sigma=2 Gaussian-blurred level (:1632), packed into uint32 words
    (:func:`_pattern_positions`, :func:`_pack_bits`).

Behaviour constants from SURVEY.md Appendix A: PATCH=31/HALF=15, EDGE=19,
FAST radius 3 thresholds 20->7, 8 levels, scale 1.2, geometric per-level
feature budget. Deviation (flagged in SURVEY §7.3): spatial distribution uses
per-tile top-k by response instead of the quadtree; tile size 32 px
(reference cell: 35 px).

Everything is static-shaped: each pyramid level yields a fixed-capacity
keypoint slab with a validity mask.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# --- constants (Appendix A parity) -----------------------------------------
PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
EDGE_THRESHOLD = 19
FAST_RADIUS = 3
INI_TH_FAST = 20.0
MIN_TH_FAST = 7.0
TILE = 32            # spatial-distribution tile (reference grid cell: 35)

# BRIEF sampling pattern: standard ORB bit_pattern_31 constant (256 pairs),
# identical to /root/reference/src/ORBextractor.cc:206 (itself from OpenCV).
_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))
PATTERN_AX = jnp.asarray(_PATTERN[:, 0], jnp.float32)
PATTERN_AY = jnp.asarray(_PATTERN[:, 1], jnp.float32)
PATTERN_BX = jnp.asarray(_PATTERN[:, 2], jnp.float32)
PATTERN_BY = jnp.asarray(_PATTERN[:, 3], jnp.float32)

# Bresenham circle r=3, 16 px, contiguous order (matches cv::FAST geometry).
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)  # (dx, dy)


def _umax_table() -> np.ndarray:
    """Circular-patch half-widths for IC_Angle (ORBextractor ctor :496-520)."""
    umax = np.zeros(HALF_PATCH_SIZE + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH_SIZE * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH_SIZE * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF_PATCH_SIZE**2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH_SIZE, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _gauss_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = np.arange(ksize) - ksize // 2
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


_GAUSS1D = _gauss_kernel_1d()


class LevelFeatures(NamedTuple):
    """Fixed-capacity keypoint slab for one pyramid level."""

    xy: jnp.ndarray        # (K, 2) float32, level-local pixel coords (x, y)
    response: jnp.ndarray  # (K,) FAST score
    angle: jnp.ndarray     # (K,) radians
    desc: jnp.ndarray      # (K, 8) uint32 packed 256-bit descriptor
    valid: jnp.ndarray     # (K,) bool


class FrameFeatures(NamedTuple):
    """All-level features in level-0 coordinates (the Frame contract)."""

    xy: jnp.ndarray        # (N, 2) float32, level-0 (undistorted later)
    level: jnp.ndarray     # (N,) int32 octave
    angle: jnp.ndarray     # (N,) radians
    response: jnp.ndarray  # (N,)
    desc: jnp.ndarray      # (N, 8) uint32
    valid: jnp.ndarray     # (N,) bool


def level_sizes(h: int, w: int, n_levels: int, scale: float):
    out = []
    for lv in range(n_levels):
        s = scale ** lv
        out.append((int(round(h / s)), int(round(w / s))))
    return out


def level_feature_budget(n_features: int, n_levels: int, scale: float):
    """Geometric per-level split (ORBextractor ctor :475-494)."""
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    budget, total = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n_first * factor ** lv))
        budget.append(b)
        total += b
    budget.append(max(n_features - total, 0))
    return budget


def _resize_linear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize with host-precomputed indices/weights.

    Two axis-wise lerps with static gather indices, matching
    cv::resize(INTER_LINEAR) pixel-center semantics.
    """
    in_h, in_w = img.shape

    def plan(n_in, n_out):
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        w1 = np.clip(src - i0, 0.0, 1.0).astype(np.float32)
        return (jnp.asarray(i0), jnp.asarray(i1),
                jnp.asarray(w1))

    r0, r1, rw = plan(in_h, out_h)
    x = img[r0, :] * (1.0 - rw)[:, None] + img[r1, :] * rw[:, None]
    c0, c1, cw = plan(in_w, out_w)
    return x[:, c0] * (1.0 - cw)[None, :] + x[:, c1] * cw[None, :]


def build_pyramid(img: jnp.ndarray, n_levels: int, scale: float):
    """img: (H, W) float32. Chain-resize like ComputePyramid (:1687)."""
    sizes = level_sizes(img.shape[0], img.shape[1], n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(_resize_linear(levels[-1], *sizes[lv]))
    return levels


def fast_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense FAST-9/16 corner score (OpenCV cornerScore semantics).

    score(p) = max over the 16 arcs of 9 contiguous circle pixels of
    min_i |I_i - I_p| in the consistent direction, minus 1; 0 if no arc
    passes even at threshold 1. Computed via 16 shifted views + circular
    log-step min-reduction (no data-dependent loops).
    """
    h, w = img.shape
    r = FAST_RADIUS
    pad = jnp.pad(img, r, mode="edge")
    # d[k] = I(p + c_k) - I(p)
    ds = [
        jax.lax.dynamic_slice(pad, (r + int(dy), r + int(dx)), (h, w)) - img
        for dx, dy in _CIRCLE
    ]
    d = jnp.stack(ds, 0)  # (16, H, W)

    def arc_min9(x):
        # min over 9 consecutive circle entries, for every start index.
        m = jnp.minimum(x, jnp.roll(x, -1, 0))          # window 2
        m = jnp.minimum(m, jnp.roll(m, -2, 0))          # 4
        m = jnp.minimum(m, jnp.roll(m, -4, 0))          # 8
        m = jnp.minimum(m, jnp.roll(x, -8, 0))          # 9
        return jnp.max(m, 0)

    score_bright = arc_min9(d)       # darkest pixel of the best bright arc
    score_dark = arc_min9(-d)
    score = jnp.maximum(score_bright, score_dark) - 1.0
    return jnp.clip(score, 0.0, None)


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    m = jax.lax.reduce_window(score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    return jnp.where(score >= m, score, 0.0)


def _cell_threshold(score: jnp.ndarray, cell: int = 35) -> jnp.ndarray:
    """Per-cell FAST threshold fallback: keep >=20, else >=7 within each cell
    (ComputeKeyPointsOctTree :1061-1176 behaviour)."""
    h, w = score.shape
    ph = -h % cell
    pw = -w % cell
    s = jnp.pad(score, ((0, ph), (0, pw)))
    tiles = s.reshape(h_t := (h + ph) // cell, cell, w_t := (w + pw) // cell, cell)
    cell_max = tiles.max(axis=(1, 3))
    thr = jnp.where(cell_max >= INI_TH_FAST, INI_TH_FAST, MIN_TH_FAST)
    thr_map = jnp.repeat(jnp.repeat(thr, cell, 0), cell, 1)[:h, :w]
    return jnp.where(score >= thr_map, score, 0.0)


def _border_mask(score: jnp.ndarray, border: int) -> jnp.ndarray:
    h, w = score.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ok = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    return jnp.where(ok, score, 0.0)


def select_keypoints(score: jnp.ndarray, capacity: int, k_per_tile: int = 8):
    """Spatially-distributed top-`capacity` selection.

    Two stages, both static-shaped: (1) top-`k_per_tile` within each TILE x TILE
    tile (spatial uniformity, quadtree stand-in), (2) global top-`capacity`
    over tile winners by response.
    Returns xy (capacity, 2) float32 and response/valid arrays.
    """
    h, w = score.shape
    ph = -h % TILE
    pw = -w % TILE
    s = jnp.pad(score, ((0, ph), (0, pw)))
    hp, wp = h + ph, w + pw
    nty, ntx = hp // TILE, wp // TILE
    tiles = s.reshape(nty, TILE, ntx, TILE).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(nty * ntx, TILE * TILE)
    # Small levels may hold fewer tile-winner slots than `capacity`; widen
    # k_per_tile until stage 2 has enough candidates.
    while nty * ntx * k_per_tile < capacity:
        k_per_tile *= 2
    k_per_tile = min(k_per_tile, TILE * TILE)
    if k_per_tile <= 16:
        # Tiny k: k compare/select sweeps instead of a sort-based top_k.
        vals_l, idx_l = [], []
        cols = jax.lax.broadcasted_iota(jnp.int32, tiles.shape, 1)
        remaining = tiles
        for _ in range(k_per_tile):
            i = jnp.argmax(remaining, -1).astype(jnp.int32)
            hit = cols == i[:, None]
            vals_l.append(jnp.max(remaining, -1))
            idx_l.append(i)
            remaining = jnp.where(hit, -jnp.inf, remaining)
        vals = jnp.stack(vals_l, -1)
        idx = jnp.stack(idx_l, -1)
    else:
        vals, idx = jax.lax.top_k(tiles, k_per_tile)      # (T, k)
    ty = jax.lax.broadcasted_iota(jnp.int32, (nty * ntx, k_per_tile), 0) // ntx
    tx = jax.lax.broadcasted_iota(jnp.int32, (nty * ntx, k_per_tile), 0) % ntx
    py = ty * TILE + idx // TILE
    px = tx * TILE + idx % TILE
    vals = vals.reshape(-1)
    py = py.reshape(-1)
    px = px.reshape(-1)
    top_vals, top_i = jax.lax.top_k(vals, capacity)
    sel_y = py[top_i]
    sel_x = px[top_i]
    valid = top_vals > 0.0
    xy = jnp.stack([sel_x, sel_y], -1).astype(jnp.float32)
    return xy, top_vals, valid


def _sep_conv2d(img: jnp.ndarray, k1d: jnp.ndarray) -> jnp.ndarray:
    """Separable 2D convolution with edge padding (Gaussian blur).

    Implemented as shifted elementwise adds, which XLA fuses into one pass.
    """
    taps = np.asarray(k1d)
    r = len(taps) // 2
    h, w = img.shape
    x = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    acc = jnp.zeros_like(img)
    for i, kv in enumerate(taps):
        acc = acc + float(kv) * jax.lax.dynamic_slice(x, (i, 0), (h, w))
    x = jnp.pad(acc, ((0, 0), (r, r)), mode="edge")
    acc = jnp.zeros_like(img)
    for i, kv in enumerate(taps):
        acc = acc + float(kv) * jax.lax.dynamic_slice(x, (0, i), (h, w))
    return acc


def orientation_maps(img: jnp.ndarray):
    """Dense IC_Angle moments (m10, m01) via row-decomposed prefix sums.

    The circular-disc moments decompose into 31 row segments: with row
    prefix sums C = cumsum(I) and D = cumsum(x*I), each row's segment sum is
    two shifted differences — O(rows) elementwise ops instead of a 31x31
    convolution, identical result (IC_Angle :91 parity).
    """
    h, w = img.shape
    pad = HALF_PATCH_SIZE + 1
    imgp = jnp.pad(img, ((pad, pad), (pad, pad)))
    hp, wp = imgp.shape
    xs = jax.lax.broadcasted_iota(jnp.float32, (hp, wp), 1)
    C = jnp.cumsum(imgp, axis=1)
    D = jnp.cumsum(xs * imgp, axis=1)
    # Prepend a zero column so segment sum over [x0+a, x0+b] is
    # P[x0+b+1] - P[x0+a] with P = [0, cumsum].
    C = jnp.concatenate([jnp.zeros((hp, 1)), C], axis=1)
    D = jnp.concatenate([jnp.zeros((hp, 1)), D], axis=1)

    umax = _umax_table()
    m10 = jnp.zeros((h, w), jnp.float32)
    m01 = jnp.zeros((h, w), jnp.float32)
    # Center pixel (x0, y0) of the output sits at (x0+pad, y0+pad) in imgp.
    x0 = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + pad
    for v in range(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1):
        half = int(umax[abs(v)])
        row = pad + v
        # Slices of the padded prefix arrays aligned to output pixels:
        # segment [x0-half, x0+half] -> P[row, x0+half+1] - P[row, x0-half].
        Chi = jax.lax.dynamic_slice(C, (row, pad + half + 1), (h, w))
        Clo = jax.lax.dynamic_slice(C, (row, pad - half), (h, w))
        Dhi = jax.lax.dynamic_slice(D, (row, pad + half + 1), (h, w))
        Dlo = jax.lax.dynamic_slice(D, (row, pad - half), (h, w))
        seg_sum = Chi - Clo
        seg_xsum = Dhi - Dlo
        m10 = m10 + (seg_xsum - x0 * seg_sum)
        m01 = m01 + float(v) * seg_sum
    return m10, m01


def _pattern_positions(xy, angle, w: int, h: int):
    """Global (gy, gx) int32 positions, (K, 512) each, of the rotated BRIEF
    samples (A pattern then B pattern), clipped to the image."""
    ca, sa = jnp.cos(angle), jnp.sin(angle)

    def rot(px, py):
        col = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
        row = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
        return col, row

    cx = jnp.round(xy[:, 0:1])
    cy = jnp.round(xy[:, 1:2])
    ax, ay = rot(PATTERN_AX, PATTERN_AY)
    bx, by = rot(PATTERN_BX, PATTERN_BY)
    ox = jnp.concatenate([ax, bx], 1)
    oy = jnp.concatenate([ay, by], 1)
    gx = jnp.clip(cx + ox, 0, w - 1).astype(jnp.int32)
    gy = jnp.clip(cy + oy, 0, h - 1).astype(jnp.int32)
    return gy, gx


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(K, 256) comparison bits -> (K, 8) uint32 words, bit i of byte j
    from bits[8 j + i] (computeOrbDescriptor :150 packing parity). int32
    wrap-around preserves the bits; they are bitcast at the end."""
    k = bits.shape[0]
    byte_vals = jnp.zeros((k, 32), jnp.float32)
    for j in range(8):
        byte_vals = byte_vals + bits[:, j::8] * float(2 ** j)
    b4 = byte_vals.astype(jnp.int32).reshape(k, 8, 4)
    words = (b4[..., 0] + b4[..., 1] * 256 + b4[..., 2] * 65536
             + b4[..., 3] * 16777216)
    return jax.lax.bitcast_convert_type(words, jnp.uint32)


@functools.partial(jax.jit, static_argnames=("n_features", "n_levels", "scale"))
def extract(img: jnp.ndarray, n_features: int = 1024, n_levels: int = 8,
            scale: float = 1.2) -> FrameFeatures:
    """Full ORB extraction. img: (H, W) float32 grayscale in [0, 255].

    Returns FrameFeatures with capacity n_features (padded, masked).

    All levels' descriptor samples are fetched in ONE gather from a
    concatenated blurred-pyramid buffer instead of one gather per level.
    """
    img = img.astype(jnp.float32)
    pyr = build_pyramid(img, n_levels, scale)
    budget = level_feature_budget(n_features, n_levels, scale)

    xs, lvls, angs, resps, valids = [], [], [], [], []
    blur_flat, idx_all = [], []
    offset = 0
    for lv, lvl_img in enumerate(pyr):
        cap = budget[lv]
        if cap == 0:
            continue
        score = fast_score_map(lvl_img)
        score = _border_mask(score, EDGE_THRESHOLD)
        score = _cell_threshold(score)
        score = _nms3(score)
        xy, resp, valid = select_keypoints(score, cap)

        m10, m01 = orientation_maps(lvl_img)
        h, w = lvl_img.shape
        ix = jnp.clip(xy[:, 0].astype(jnp.int32), 0, w - 1)
        iy = jnp.clip(xy[:, 1].astype(jnp.int32), 0, h - 1)
        flat = iy * w + ix
        angle = jnp.arctan2(m01.reshape(-1)[flat], m10.reshape(-1)[flat])

        blurred = _sep_conv2d(lvl_img, _GAUSS1D)
        gy, gx = _pattern_positions(xy, angle, w, h)
        blur_flat.append(blurred.reshape(-1))
        idx_all.append(offset + gy * w + gx)
        offset += h * w

        s = scale ** lv
        xs.append(xy * s)
        lvls.append(jnp.full((cap,), lv, jnp.int32))
        angs.append(angle)
        resps.append(resp)
        valids.append(valid)

    # ONE gather over the concatenated blurred levels, in level order.
    vals = jnp.concatenate(blur_flat, 0)[jnp.concatenate(idx_all, 0)]
    bits = (vals[:, :256] < vals[:, 256:]).astype(jnp.float32)
    desc = _pack_bits(bits)

    return FrameFeatures(
        xy=jnp.concatenate(xs, 0),
        level=jnp.concatenate(lvls, 0),
        angle=jnp.concatenate(angs, 0),
        response=jnp.concatenate(resps, 0),
        desc=desc,
        valid=jnp.concatenate(valids, 0),
    )
