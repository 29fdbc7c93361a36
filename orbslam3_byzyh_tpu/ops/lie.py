"""Batched Lie-group operations: SO(3), SE(3), Sim(3).

This replaces the reference's vendored Sophus headers
(``/root/reference/Thirdparty/Sophus/sophus/{so3,se3,sim3}.hpp``) and the IMU
Lie helpers (``/root/reference/include/ImuTypes.h:254-260`` — ``NormalizeRotation``,
``RightJacobianSO3``, ``InverseRightJacobianSO3``, ``Skew``).

Design notes:
  * Rotations are 3x3 float32 matrices; poses are (R, t) pairs rather than 4x4
    homogeneous matrices so that XLA keeps the 3x3 blocks in registers.
  * Every function is written for arbitrary leading batch dimensions
    ("``...``" semantics) so the same code serves a single pose and a
    (num_keyframes,)-batched pose array without ``vmap`` overhead.
  * Small-angle branches use smooth ``jnp.where`` selection on Taylor series —
    no data-dependent control flow, so everything jits into straight-line code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Threshold under which Taylor expansions replace trig expressions (f32-safe).
_EPS = 1e-5

# 3x3 geometry matmuls must run at full f32 precision: a default-precision
# f32 dot may run in bf16 or TF32 passes, which is fatal for pose chains.
# These matrices are tiny, so HIGHEST costs nothing.
_HI = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_HI)


def _mv(A: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("...ij,...j->...i", A, v, precision=_HI)


def skew(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3).

    Mirrors ``IMU::Skew`` (/root/reference/src/ImuTypes.cc:510-515).
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`skew`. (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> SO(3) via Rodrigues. (..., 3) -> (..., 3, 3).

    Parity target: ``IMU::ExpSO3`` (/root/reference/src/ImuTypes.cc:429-445).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2)
    W = skew(w)
    W2 = _mm(W, W)
    small = theta < _EPS
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2)
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SO(3) -> so(3). (..., 3, 3) -> (..., 3).

    Parity target: ``IMU::LogSO3`` (/root/reference/src/ImuTypes.cc:447-460).
    Handles the theta -> pi region via the diagonal-based axis extraction.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    w_vee = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis

    # theta from atan2(sin, cos): smooth everywhere (arccos has an infinite
    # gradient at +-1, which poisons autodiff through near-identity logs —
    # pose-graph edges sit exactly there).
    sin2 = jnp.sum(w_vee * w_vee, axis=-1)
    sin_theta = jnp.sqrt(sin2 + 1e-14)
    theta = jnp.arctan2(sin_theta, cos_theta)
    near_pi = theta > (jnp.pi - 1e-3)

    # Generic branch: w = theta / sin(theta) * w_vee; the regularized
    # sin_theta keeps the ratio smooth (and ~1 + eps-level bias) at theta=0.
    # sin(theta) ~ 0 near pi is guarded; that region is overwritten below.
    scale = theta / jnp.where(near_pi, 1.0, sin_theta)
    w_generic = scale[..., None] * w_vee

    # Near-pi branch: axis from largest diagonal of (R + I)/2.
    Rp = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    diag = jnp.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag - cos_theta[..., None]) / jnp.clip(1.0 - cos_theta[..., None], 1e-8, None), 0.0, None)
    axis = jnp.sqrt(axis_sq)
    # Fix signs using the off-diagonal skew part; fall back to sign of largest component.
    sign = jnp.where(w_vee >= 0.0, 1.0, -1.0)
    axis = axis * sign
    norm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.clip(norm, 1e-8, None)
    w_pi = theta[..., None] * axis

    return jnp.where(near_pi[..., None], w_pi, w_generic)


def so3_right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian Jr of SO(3). (..., 3) -> (..., 3, 3).

    Parity target: ``IMU::RightJacobianSO3`` (/root/reference/src/ImuTypes.cc:462-478).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2)
    W = skew(w)
    W2 = _mm(W, W)
    small = theta < _EPS
    safe2 = jnp.where(small, 1.0, theta2)
    safe3 = jnp.where(small, 1.0, theta2 * theta)
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe2)
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / safe3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - a[..., None, None] * W + b[..., None, None] * W2


def so3_right_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian of SO(3).

    Parity target: ``IMU::InverseRightJacobianSO3`` (/root/reference/src/ImuTypes.cc:480-496).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2)
    W = skew(w)
    W2 = _mm(W, W)
    small = theta < _EPS
    safe = jnp.where(small, 1.0, theta)
    safe2 = jnp.where(small, 1.0, theta2)
    # 1/theta^2 - (1 + cos)/(2 theta sin)
    sin_t = jnp.sin(safe)
    cos_t = jnp.cos(safe)
    c = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe2 - (1.0 + cos_t) / (2.0 * safe * jnp.where(jnp.abs(sin_t) < 1e-8, 1.0, sin_t)),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + 0.5 * W + c[..., None, None] * W2


@jax.custom_jvp
def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation matrix back onto SO(3) via SVD.

    Parity target: ``IMU::NormalizeRotation`` (/root/reference/src/ImuTypes.cc:517-522).

    Differentiation: the SVD's jvp is singular when singular values coincide
    — which for a rotation matrix is ALWAYS (all three equal 1), so jacfwd
    through the raw SVD yields NaN exactly when the input is numerically
    clean (bit-exact on CPU/HIGHEST-precision matmuls; float32 rounding used
    to mask this). The custom JVP below treats the projection as identity:
    on SO(3) the orthogonal-projection derivative restricted to the tangent
    space IS the identity, and inputs here are always within float eps of a
    rotation.
    """
    U, _, Vt = jnp.linalg.svd(R)
    Rn = _mm(U, Vt)
    # Ensure det +1 (flip last column of U if reflection).
    det = jnp.linalg.det(Rn)
    U = U.at[..., :, 2].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    return _mm(U, Vt)


@normalize_rotation.defjvp
def _normalize_rotation_jvp(primals, tangents):
    (R,), (dR,) = primals, tangents
    Rn = normalize_rotation(R)
    # Project the incoming tangent onto the output's SO(3) tangent space:
    # dR_out = Rn * skew(Rn^T dR) = 0.5 * (dR - Rn dR^T Rn). Exact for
    # on-manifold perturbations (where Rn^T dR is already skew) and degrades
    # gracefully for off-manifold inputs instead of silently passing their
    # symmetric (normal-space) component through as a wrong Jacobian.
    dRn = 0.5 * (dR - _mm(Rn, _mm(jnp.swapaxes(dR, -1, -2), Rn)))
    return Rn, dRn


# ---------------------------------------------------------------------------
# SE(3): pose as tuple (R: (...,3,3), t: (...,3))
# ---------------------------------------------------------------------------

def se3_identity(batch_shape=(), dtype=jnp.float32):
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
    t = jnp.zeros((*batch_shape, 3), dtype=dtype)
    return R, t


def se3_exp(xi: jnp.ndarray):
    """se(3) -> SE(3). xi = (..., 6) with [rho (trans), phi (rot)] ordering.

    Convention matches Sophus ``SE3::exp`` (upsilon first, omega second),
    /root/reference/Thirdparty/Sophus/sophus/se3.hpp.
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    # V = left Jacobian of SO(3) = Jr(-phi)
    V = so3_right_jacobian(-phi)
    t = _mv(V, rho)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """SE(3) -> se(3) tangent (..., 6), [rho, phi] ordering."""
    phi = so3_log(R)
    Vinv = _left_jacobian_inv(phi)
    rho = _mv(Vinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def _left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """Inverse left Jacobian of SO(3): Jl^{-1}(phi) = Jr^{-1}(-phi)."""
    return so3_right_jacobian_inv(-phi)


def se3_mul(Ra, ta, Rb, tb):
    """Compose: (Ra,ta) * (Rb,tb)."""
    R = _mm(Ra, Rb)
    t = _mv(Ra, tb) + ta
    return R, t


def se3_inv(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -_mv(Rt, t)


def se3_apply(R, t, p):
    """Transform points p: (..., 3) by pose (R, t)."""
    return _mv(R, p) + t


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s) — used for loop closing / map merging
# (parity with Sophus Sim3 and g2o::Sim3, /root/reference/Thirdparty/g2o/g2o/types/sim3.h)
# ---------------------------------------------------------------------------

def sim3_identity(batch_shape=(), dtype=jnp.float32):
    R, t = se3_identity(batch_shape, dtype)
    s = jnp.ones(batch_shape, dtype=dtype)
    return R, t, s


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    """Compose Sim3: x -> sa*Ra*(sb*Rb*x + tb) + ta."""
    R = _mm(Ra, Rb)
    t = sa[..., None] * _mv(Ra, tb) + ta
    s = sa * sb
    return R, t, s


def sim3_inv(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * _mv(Rt, t)
    return Rt, t_inv, s_inv


def sim3_apply(R, t, s, p):
    return s[..., None] * _mv(R, p) + t


def sim3_exp(xi: jnp.ndarray):
    """sim(3) -> Sim(3). xi = (..., 7) = [rho, phi, sigma] (Sophus ordering).

    Uses the closed-form W matrix from Sophus ``sim3.hpp`` (calcW).
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    W = _sim3_calc_w(phi, sigma, s)
    t = _mv(W, rho)
    return R, t, s


def sim3_log(R, t, s):
    """Sim(3) -> sim(3) tangent (..., 7)."""
    sigma = jnp.log(s)
    phi = so3_log(R)
    W = _sim3_calc_w(phi, sigma, s)
    Winv = jnp.linalg.inv(W)
    rho = _mv(Winv, t)
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def _sim3_calc_w(phi, sigma, scale):
    """W matrix for Sim3 exp/log — the scaled left-Jacobian analog.

    Four-case closed form (general / small-theta / small-sigma / both small),
    selected branch-free with ``jnp.where``. Same math as Sophus sim3.hpp's
    internal ``calcW`` (which g2o::Sim3 also mirrors).
    """
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2)
    W = skew(phi)
    W2 = _mm(W, W)
    small_theta = theta < _EPS
    small_sigma = jnp.abs(sigma) < _EPS
    sigma2 = sigma * sigma
    safe_theta = jnp.where(small_theta, 1.0, theta)
    safe_theta2 = jnp.where(small_theta, 1.0, theta2)
    safe_sigma = jnp.where(small_sigma, 1.0, sigma)
    safe_sigma2 = jnp.where(small_sigma, 1.0, sigma2)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)

    # C = (e^sigma - 1)/sigma, -> 1 + sigma/2 as sigma -> 0.
    C = jnp.where(small_sigma, 1.0 + sigma * 0.5, (scale - 1.0) / safe_sigma)

    # sigma ~ 0 branch:
    A_s0 = jnp.where(small_theta, 0.5, (1.0 - cos_t) / safe_theta2)
    B_s0 = jnp.where(small_theta, 1.0 / 6.0, (theta - sin_t) / (safe_theta2 * safe_theta))

    # general sigma, theta ~ 0 branch:
    A_t0 = ((sigma - 1.0) * scale + 1.0) / safe_sigma2
    B_t0 = (scale * 0.5 * sigma2 + scale - 1.0 - sigma * scale) / (safe_sigma2 * safe_sigma)

    # fully general branch:
    a = scale * sin_t
    b = scale * cos_t
    c = safe_theta2 + sigma2
    A_g = (a * sigma + (1.0 - b) * safe_theta) / (safe_theta * c)
    B_g = (C - ((b - 1.0) * sigma + a * safe_theta) / c) / safe_theta2

    A = jnp.where(small_sigma, A_s0, jnp.where(small_theta, A_t0, A_g))
    B = jnp.where(small_sigma, B_s0, jnp.where(small_theta, B_t0, B_g))

    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return A[..., None, None] * W + B[..., None, None] * W2 + C[..., None, None] * eye


# ---------------------------------------------------------------------------
# Quaternion helpers (trajectory IO uses TUM qx qy qz qw convention)
# ---------------------------------------------------------------------------

def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (..., 4) in (qx, qy, qz, qw) order.

    Branch-free Shepperd's method via 4-way where-selection.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate computations; pick by largest pivot.
    qw0 = jnp.sqrt(jnp.clip(1.0 + tr, 1e-12, None)) * 0.5
    s0 = 0.25 / qw0
    c0 = jnp.stack([(m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0, qw0], axis=-1)

    qx1 = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, 1e-12, None)) * 0.5
    s1 = 0.25 / qx1
    c1 = jnp.stack([qx1, (m01 + m10) * s1, (m02 + m20) * s1, (m21 - m12) * s1], axis=-1)

    qy2 = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, 1e-12, None)) * 0.5
    s2 = 0.25 / qy2
    c2 = jnp.stack([(m01 + m10) * s2, qy2, (m12 + m21) * s2, (m02 - m20) * s2], axis=-1)

    qz3 = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, 1e-12, None)) * 0.5
    s3 = 0.25 / qz3
    c3 = jnp.stack([(m02 + m20) * s3, (m12 + m21) * s3, qz3, (m10 - m01) * s3], axis=-1)

    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = jnp.where(
        cond0[..., None], c0, jnp.where(cond1[..., None], c1, jnp.where(cond2[..., None], c2, c3))
    )
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (qx, qy, qz, qw) -> rotation matrix (..., 3, 3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
