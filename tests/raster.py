"""numpy/scipy rasterizer for the synthetic world (tests/synth_world.py).

Reproduces the OpenCV drawing calls the synthetic imagery was designed
with, so every machine renders the same frames without OpenCV:

* filled integer circles (``cv2.circle``, LINE_8), rectangles and the blob
  triangle (``cv2.fillConvexPoly``, LINE_8): exact ports of OpenCV's
  midpoint-circle and convex-polygon scanline fills, cached per radius;
* anti-aliased 1/16-pixel circles (``cv2.circle``, LINE_AA, shift 4):
  OpenCV's polygon (``ellipse2Poly`` vertices, angle step by radius) with an
  alpha profile over the major-axis distance to the polygon edge, measured
  per angle step from OpenCV's own output (mean absolute difference under
  one grey level per frame, see tests/test_synth_render.py);
* the 3x3, sigma 0.8 Gaussian blur: OpenCV's fixed-point separable kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.ndimage as ndi

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


# ---------------------------------------------------------------------------
# Integer shapes (exact)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def circle_mask(r: int) -> np.ndarray:
    """(2r+1, 2r+1) mask of a filled LINE_8 circle (midpoint algorithm)."""
    hw = np.full(r + 1, -1, np.int64)
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        hw[dy] = max(hw[dy], dx)
        hw[dx] = max(hw[dx], dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    off = np.abs(np.arange(-r, r + 1))
    return off[None, :] <= hw[off][:, None]


def _line8(mask, off, p0, p1):
    """LINE_8 Bresenham segment, drawn left to right, into a local mask."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        mask[y + off, x + off] = True
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0


@functools.lru_cache(maxsize=None)
def triangle_mask(r: int) -> np.ndarray:
    """(2r+3, 2r+3) mask of the filled triangle (0,-r), (-r,r), (r,r):
    outline segments, then the convex-polygon scanline fill."""
    v = [(0, -r), (-r, r), (r, r)]
    n, off = len(v), r + 1
    mask = np.zeros((2 * r + 3, 2 * r + 3), bool)
    for p0, p1 in zip([v[-1]] + v[:-1], v):
        _line8(mask, off, p0, p1)
    half = _XY_ONE >> 1
    imin = min(range(n), key=lambda i: v[i][1])
    y, y_max = v[imin][1], max(p[1] for p in v)
    edges_left = n
    edges = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=y),
             dict(idx=imin, di=n - 1, x=-_XY_ONE, dx=0, ye=y)]
    while True:
        for e in edges:
            if y < e["ye"]:
                continue
            idx0, idx = e["idx"], (e["idx"] + e["di"]) % n
            while True:
                edges_left -= 1
                if edges_left < 0:
                    break
                ty = v[idx][1]
                if ty > y:
                    xs, xe = v[idx0][0] << _XY_SHIFT, v[idx][0] << _XY_SHIFT
                    # C integer division truncates toward zero.
                    e.update(ye=ty, x=xs, idx=idx,
                             dx=int(((xe - xs) * 2 + (ty - y)) / (2 * (ty - y))))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if edges_left < 0:
            break
        left, right = sorted(edges, key=lambda e: e["x"])
        x1 = (left["x"] + half) >> _XY_SHIFT
        x2 = (right["x"] + half) >> _XY_SHIFT
        mask[y + off, x1 + off:x2 + off + 1] = True
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > y_max:
            break
    return mask


def paint(img: np.ndarray, mask: np.ndarray, cx: int, cy: int, val: int):
    """img[cy + dy, cx + dx] = val wherever the centred mask is set."""
    h, w = img.shape
    k = mask.shape[0] // 2
    y0, x0 = cy - k, cx - k
    ya, xa = max(y0, 0), max(x0, 0)
    yb, xb = min(y0 + mask.shape[0], h), min(x0 + mask.shape[1], w)
    if ya < yb and xa < xb:
        img[ya:yb, xa:xb][mask[ya - y0:yb - y0, xa - x0:xb - x0]] = val


def fill_rect(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, val: int):
    """Filled rectangle with inclusive corners, clipped to the image."""
    img[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = val


# ---------------------------------------------------------------------------
# Anti-aliased 1/16-pixel circles
# ---------------------------------------------------------------------------

_SIN = np.sin(np.deg2rad(np.arange(451))).astype(np.float32).astype(np.float64)
_ALPHA_D = np.linspace(-0.6, 1.8, 49)
# Alpha vs major-axis distance (px, outside > 0) to the polygon, one row per
# ellipse2Poly angle step (90, 30, 18, 5 degrees).
_ALPHA = {
    90: [1.0, 1.0, 1.0, 0.998, 0.997, 0.992, 0.985, 0.982, 0.981, 0.988,
         0.978, 0.98, 0.975, 0.97, 0.96, 0.955, 0.942, 0.921, 0.897, 0.877,
         0.858, 0.821, 0.772, 0.711, 0.675, 0.668, 0.596, 0.542, 0.491, 0.444,
         0.442, 0.391, 0.342, 0.297, 0.297, 0.267, 0.227, 0.187, 0.174, 0.123,
         0.146, 0.129, 0.104, 0.091, 0.078, 0.07, 0.074, 0.061, 0.053],
    30: [1.0, 1.0, 1.0, 0.997, 0.993, 0.992, 0.988, 0.987, 0.985, 0.985,
         0.98, 0.971, 0.96, 0.947, 0.933, 0.919, 0.907, 0.892, 0.871, 0.848,
         0.811, 0.777, 0.727, 0.676, 0.635, 0.579, 0.534, 0.477, 0.428, 0.381,
         0.328, 0.288, 0.244, 0.21, 0.178, 0.146, 0.118, 0.095, 0.077, 0.063,
         0.049, 0.036, 0.021, 0.008, 0.006, 0.004, 0.003, 0.002, 0.001],
    18: [1.0, 1.0, 0.999, 0.998, 0.996, 0.993, 0.994, 0.992, 0.988, 0.987,
         0.984, 0.978, 0.965, 0.952, 0.938, 0.924, 0.912, 0.894, 0.872, 0.847,
         0.81, 0.771, 0.721, 0.676, 0.63, 0.579, 0.531, 0.474, 0.426, 0.378,
         0.327, 0.283, 0.24, 0.204, 0.17, 0.139, 0.113, 0.089, 0.071, 0.057,
         0.044, 0.03, 0.015, 0.004, 0.002, 0.001, 0.0, 0.0, 0.0],
    5: [1.0, 1.0, 0.999, 0.99, 0.987, 0.984, 0.979, 0.981, 0.98, 0.975,
        0.972, 0.967, 0.948, 0.932, 0.918, 0.907, 0.891, 0.877, 0.857, 0.825,
        0.793, 0.747, 0.693, 0.648, 0.606, 0.553, 0.508, 0.457, 0.41, 0.363,
        0.317, 0.272, 0.232, 0.194, 0.163, 0.132, 0.109, 0.085, 0.065, 0.053,
        0.039, 0.027, 0.013, 0.001, 0.0, 0.0, 0.0, 0.0, 0.0],
}


def _angle_step(r16: int) -> int:
    r_px = (r16 + 8) >> 4
    return 90 if r_px < 3 else 30 if r_px < 10 else 18 if r_px < 15 else 5


def aa_polygon(cx16: int, cy16: int, r16: int):
    """Vertices (float px, closed) of the polygon OpenCV fills for an
    anti-aliased circle with centre and radius in 1/16 px."""
    step = _angle_step(r16)
    ang = np.minimum(np.arange(0, 360 + step, step), 360)
    ang = ang[np.r_[True, ang[1:] != ang[:-1]]]
    scale = _XY_ONE / 16.0
    x = np.rint((cx16 + r16 * _SIN[450 - ang]) * scale) / _XY_ONE
    y = np.rint((cy16 + r16 * _SIN[ang]) * scale) / _XY_ONE
    keep = np.r_[True, (x[1:] != x[:-1]) | (y[1:] != y[:-1])]
    return x[keep], y[keep]


def fill_circle_aa(img: np.ndarray, cx16: int, cy16: int, r16: int,
                   val: int):
    """Blend an anti-aliased filled circle into the uint8 image."""
    x, y = aa_polygon(cx16, cy16, r16)
    h, w = img.shape
    xa, xb = max(int(np.floor(x.min())) - 2, 0), min(int(np.ceil(x.max())) + 3, w)
    ya, yb = max(int(np.floor(y.min())) - 2, 0), min(int(np.ceil(y.max())) + 3, h)
    if xa >= xb or ya >= yb:
        return
    ex, ey = np.diff(x), np.diff(y)
    ok = (ex != 0) | (ey != 0)
    ex, ey, x0, y0 = ex[ok], ey[ok], x[:-1][ok], y[:-1][ok]
    # Outward normals scaled so that the distance runs along the edge's
    # minor axis (the direction the anti-aliasing filter is sampled in).
    major = np.maximum(np.abs(ex), np.abs(ey))
    nx, ny = ey / major, -ex / major
    px = np.arange(xa, xb, dtype=np.float64)[None, :, None]
    py = np.arange(ya, yb, dtype=np.float64)[:, None, None]
    d = ((px - x0) * nx + (py - y0) * ny).max(-1)
    alpha = np.interp(d, _ALPHA_D, _ALPHA[_angle_step(r16)],
                      left=1.0, right=0.0)
    patch = img[ya:yb, xa:xb].astype(np.float64)
    img[ya:yb, xa:xb] = np.rint(patch + (val - patch) * alpha)


# ---------------------------------------------------------------------------
# Blur
# ---------------------------------------------------------------------------

_BLUR_TAPS = np.array([61, 134, 61], np.int64)   # 3-tap sigma 0.8, x256


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """3x3 sigma-0.8 Gaussian blur of a uint8 image (reflect-101 border,
    8-bit fixed-point taps, rounded)."""
    acc = ndi.correlate1d(img.astype(np.int64), _BLUR_TAPS, axis=1,
                          mode="mirror")
    acc = ndi.correlate1d(acc, _BLUR_TAPS, axis=0, mode="mirror")
    return ((acc + 32768) >> 16).astype(np.uint8)
