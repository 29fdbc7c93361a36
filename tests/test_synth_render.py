"""The numpy rasterizer of the synthetic world against OpenCV's drawing.

OpenCV is only the reference here; the renderer itself needs numpy and
scipy alone, so every machine renders the same frames.
"""

import numpy as np
import pytest

import raster
from synth_world import SynthWorld

cv2 = pytest.importorskip("cv2")


def _render_opencv(world: SynthWorld, t: float) -> np.ndarray:
    """SynthWorld.render drawn with OpenCV primitives."""
    R, tt = world.pose(t)
    pc = world.pts @ R.T + tt
    z = pc[:, 2]
    vis = z > 0.5
    u = world.fx * pc[:, 0] / np.maximum(z, 1e-6) + world.cx
    v = world.fy * pc[:, 1] / np.maximum(z, 1e-6) + world.cy
    img = np.full((world.h, world.w), 30, np.uint8)
    for i in np.argsort(-z):
        if not vis[i]:
            continue
        if world.subpix:
            S = 16
            uf, vf = float(u[i]), float(v[i])
            if not (-10 <= uf < world.w + 10 and -10 <= vf < world.h + 10):
                continue
            rf = max(3.0, world.sizes[i] * 8.0 / z[i])
            r16 = int(round(rf * S))
            cv2.circle(img, (int(round(uf * S)), int(round(vf * S))), r16,
                       int(world.intens[i]), -1, cv2.LINE_AA, 4)
            for s in range(4):
                su = int(round((uf + world.sat_off[i, s, 0] * rf) * S))
                sv = int(round((vf + world.sat_off[i, s, 1] * rf) * S))
                cv2.circle(img, (su, sv), max(S, r16 // 3),
                           int(world.sat_int[i, s]), -1, cv2.LINE_AA, 4)
            continue
        ui, vi = int(round(u[i])), int(round(v[i]))
        if not (-10 <= ui < world.w + 10 and -10 <= vi < world.h + 10):
            continue
        r = max(3, int(round(world.sizes[i] * 8.0 / z[i])))
        val = int(world.intens[i])
        if world.shapes[i] == 0:
            cv2.circle(img, (ui, vi), r, val, -1)
        elif world.shapes[i] == 1:
            cv2.rectangle(img, (ui - r, vi - r), (ui + r, vi + r), val, -1)
        else:
            pts = np.array([[ui, vi - r], [ui - r, vi + r], [ui + r, vi + r]])
            cv2.fillConvexPoly(img, pts, val)
        for s in range(4):
            su = int(round(ui + world.sat_off[i, s, 0] * r))
            sv = int(round(vi + world.sat_off[i, s, 1] * r))
            cv2.circle(img, (su, sv), max(1, r // 3),
                       int(world.sat_int[i, s]), -1)
    return cv2.GaussianBlur(img, (3, 3), 0.8).astype(np.float32)


@pytest.mark.parametrize("subpix", [False, True], ids=["default", "subpix"])
def test_frames_match_opencv(subpix):
    """Mean absolute difference at most 1 grey level per frame."""
    world = SynthWorld(seed=11, motion="excited", subpix=subpix)
    for t in (0.0, 2.5):
        diff = np.abs(world.render(t) - _render_opencv(world, t))
        assert diff.mean() <= 1.0, (t, diff.mean())


@pytest.mark.parametrize("shape", ["circle", "triangle"])
def test_integer_shapes_exact(shape):
    """LINE_8 circles and the blob triangle are pixel-exact ports."""
    for r in range(1, 48):
        ref = np.zeros((128, 128), np.uint8)
        if shape == "circle":
            cv2.circle(ref, (64, 64), r, 255, -1)
            mask = raster.circle_mask(r)
        else:
            cv2.fillConvexPoly(ref, np.array(
                [[64, 64 - r], [64 - r, 64 + r], [64 + r, 64 + r]]), 255)
            mask = raster.triangle_mask(r)
        out = np.zeros_like(ref)
        raster.paint(out, mask, 64, 64, 255)
        np.testing.assert_array_equal(out, ref, err_msg=f"r={r}")


def test_blur_exact(rng):
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    np.testing.assert_array_equal(raster.gaussian_blur3(img),
                                  cv2.GaussianBlur(img, (3, 3), 0.8))
