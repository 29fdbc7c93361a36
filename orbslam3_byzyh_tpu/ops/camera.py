"""Batched camera models: pinhole (+radial-tangential) and Kannala-Brandt8.

Replaces the reference's polymorphic ``GeometricCamera`` hierarchy
(``/root/reference/include/CameraModels/GeometricCamera.h:61-89``,
``src/CameraModels/Pinhole.cpp``, ``src/CameraModels/KannalaBrandt8.cpp``).

Design: instead of virtual dispatch per point, each model is a set of
pure functions over ``(..., )``-batched arrays, parameterised by a flat
``params`` vector. A static ``model_id`` selects the model at trace time — the
per-frame pipeline is specialised per camera, so there is no runtime dispatch.

Conventions:
  * Camera frame: z forward, x right, y down (same as the reference).
  * ``project`` maps camera-frame 3D points -> pixel coordinates.
  * ``unproject`` maps pixels -> unit-z ray (x, y, 1) ("bearing" before norm).

Parameter layouts (float32):
  * PINHOLE:  [fx, fy, cx, cy]
  * KB8:      [fx, fy, cx, cy, k0, k1, k2, k3]   (theta-polynomial fisheye)
  * Radial-tangential distortion (used by the pinhole front-end on raw
    detections): [k1, k2, p1, p2, k3?]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PINHOLE = 0
KB8 = 1


# ---------------------------------------------------------------------------
# Pinhole (parity: /root/reference/src/CameraModels/Pinhole.cpp:33-96)
# ---------------------------------------------------------------------------

def pinhole_project(params: jnp.ndarray, pc: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = pc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * pc[..., 0] * inv_z + cx
    v = fy * pc[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def pinhole_unproject(params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixels (..., 2) -> unit-z rays (..., 3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def pinhole_project_jac(params: jnp.ndarray, pc: jnp.ndarray) -> jnp.ndarray:
    """d(pixel)/d(point): (..., 2, 3). Parity: Pinhole::projectJac."""
    fx, fy = params[0], params[1]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1)
    row1 = jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Radial-tangential distortion (OpenCV model; the reference applies it via
# cv::undistortPoints in Frame::UndistortKeyPoints, /root/reference/src/Frame.cc:1003)
# ---------------------------------------------------------------------------

def radtan_distort(dist: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply distortion to normalized coords (..., 2). dist = [k1,k2,p1,p2,(k3)]."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else jnp.zeros_like(k1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def radtan_undistort(dist: jnp.ndarray, xy_d: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Invert distortion by fixed-point iteration (cv::undistortPoints-style)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else jnp.zeros_like(k1)
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv_r = 1.0 / jnp.where(jnp.abs(radial) < 1e-9, 1e-9, radial)
        x = (xd - dx) * inv_r
        y = (yd - dy) * inv_r
    return jnp.stack([x, y], axis=-1)


def undistort_pixels(params: jnp.ndarray, dist: jnp.ndarray, uv: jnp.ndarray,
                     iters: int = 8) -> jnp.ndarray:
    """Pixel -> undistorted pixel under the same intrinsics (Frame.cc:1003 parity)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    xy = radtan_undistort(dist, jnp.stack([x, y], axis=-1), iters)
    u = fx * xy[..., 0] + cx
    v = fy * xy[..., 1] + cy
    return jnp.stack([u, v], axis=-1)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (equidistant fisheye)
# Parity: /root/reference/src/CameraModels/KannalaBrandt8.cpp:40-55 (project),
# :180-228 (Newton unproject), :229-269 (jacobian).
# ---------------------------------------------------------------------------

def kb8_project(params: jnp.ndarray, pc: jnp.ndarray) -> jnp.ndarray:
    """r(theta) = theta + k0 th^3 + k1 th^5 + k2 th^7 + k3 th^9."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    R2 = x * x + y * y
    R = jnp.sqrt(R2)
    theta = jnp.arctan2(R, z)
    th2 = theta * theta
    r = theta * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
    inv_R = 1.0 / jnp.where(R < 1e-9, 1e-9, R)
    # Degenerate on-axis point maps to principal point.
    psi_cos = jnp.where(R < 1e-9, 1.0, x * inv_R)
    psi_sin = jnp.where(R < 1e-9, 0.0, y * inv_R)
    u = fx * r * psi_cos + cx
    v = fy * r * psi_sin + cy
    return jnp.stack([u, v], axis=-1)


def kb8_unproject(params: jnp.ndarray, uv: jnp.ndarray, iters: int = 10) -> jnp.ndarray:
    """Newton-invert r(theta); returns unit-z ray (..., 3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r_d = jnp.sqrt(mx * mx + my * my)
    # Reference clamps theta_d to [-pi/2, pi/2] (KannalaBrandt8.cpp:192).
    r_d_c = jnp.minimum(r_d, jnp.pi / 2.0)
    theta = r_d_c
    for _ in range(iters):
        th2 = theta * theta
        th4 = th2 * th2
        th6 = th4 * th2
        th8 = th4 * th4
        f = theta * (1.0 + k0 * th2 + k1 * th4 + k2 * th6 + k3 * th8) - r_d_c
        fp = 1.0 + 3 * k0 * th2 + 5 * k1 * th4 + 7 * k2 * th6 + 9 * k3 * th8
        theta = theta - f / jnp.where(jnp.abs(fp) < 1e-9, 1e-9, fp)
    scale = jnp.tan(theta) / jnp.where(r_d < 1e-9, 1e-9, r_d)
    scale = jnp.where(r_d < 1e-9, 1.0, scale)
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def kb8_project_jac(params: jnp.ndarray, pc: jnp.ndarray) -> jnp.ndarray:
    """Analytic d(pixel)/d(point) (..., 2, 3) for the KB8 model."""
    fx, fy = params[0], params[1]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.where(r2 < 1e-12, 1e-12, r2))
    r3 = r2 * r
    theta = jnp.arctan2(r, z)
    th2 = theta * theta
    th4 = th2 * th2
    th6 = th4 * th2
    th8 = th4 * th4
    f = theta * (1.0 + k0 * th2 + k1 * th4 + k2 * th6 + k3 * th8)
    fp = 1.0 + 3 * k0 * th2 + 5 * k1 * th4 + 7 * k2 * th6 + 9 * k3 * th8
    # d theta / d (x,y,z)
    norm2 = r2 + z * z
    dtheta_dx = x * z / (norm2 * r)
    dtheta_dy = y * z / (norm2 * r)
    dtheta_dz = -r / norm2
    # u = fx * f(theta) * x / r + cx
    # du/dx = fx * (fp * dtheta_dx * x / r + f * (r2 - x^2) / r3)
    du_dx = fx * (fp * dtheta_dx * x / r + f * y * y / r3)
    du_dy = fx * (fp * dtheta_dy * x / r - f * x * y / r3)
    du_dz = fx * fp * dtheta_dz * x / r
    dv_dx = fy * (fp * dtheta_dx * y / r - f * x * y / r3)
    dv_dy = fy * (fp * dtheta_dy * y / r + f * x * x / r3)
    dv_dz = fy * fp * dtheta_dz * y / r
    row0 = jnp.stack([du_dx, du_dy, du_dz], axis=-1)
    row1 = jnp.stack([dv_dx, dv_dy, dv_dz], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Model-generic entry points (static dispatch at trace time)
# ---------------------------------------------------------------------------

def project(model_id: int, params: jnp.ndarray, pc: jnp.ndarray) -> jnp.ndarray:
    if model_id == PINHOLE:
        return pinhole_project(params, pc)
    return kb8_project(params, pc)


def unproject(model_id: int, params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    if model_id == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model_id: int, params: jnp.ndarray, pc: jnp.ndarray) -> jnp.ndarray:
    if model_id == PINHOLE:
        return pinhole_project_jac(params, pc)
    return kb8_project_jac(params, pc)
