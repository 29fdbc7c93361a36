"""On-manifold IMU preintegration (Forster-style), as a jittable scan.

Replaces the reference's ``IMU::Preintegrated``
(``/root/reference/src/ImuTypes.cc:247-324`` IntegrateNewMeasurement,
``:330-…`` MergePrevious, bias-corrected getters ``:360-420``).

Design: a preintegration window is a fixed-capacity batch of
measurements ``(acc[N,3], gyr[N,3], dt[N])`` with ``dt == 0`` padding — a zero
``dt`` step is exactly the identity update, so no masks are needed. The whole
window integrates in one ``lax.scan``; re-integration after a bias update is
the same scan with new bias (the raw measurements are kept, mirroring
``Reintegrate`` at ImuTypes.cc:231).

State covariance ordering matches the reference: [dR, dV, dP, bg, ba] (15x15).
Noise ordering matches ``Calib::Set``: diag(ng², x3, na², x3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie

GRAVITY = 9.81  # IMU::GRAVITY_VALUE, /root/reference/include/ImuTypes.h:43
GRAVITY_VEC = jnp.array([0.0, 0.0, -GRAVITY], jnp.float32)

_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def _mv(A, v):
    return jnp.einsum("...ij,...j->...i", A, v, precision=_HI)


class PreintState(NamedTuple):
    """Running preintegration state between two frames/keyframes."""

    dT: jnp.ndarray      # () total time
    dR: jnp.ndarray      # (3, 3) delta rotation
    dV: jnp.ndarray      # (3,) delta velocity
    dP: jnp.ndarray      # (3,) delta position
    C: jnp.ndarray       # (15, 15) covariance [dR, dV, dP, bg, ba]
    JRg: jnp.ndarray     # (3, 3) d(dR)/d(bg)
    JVg: jnp.ndarray     # (3, 3) d(dV)/d(bg)
    JVa: jnp.ndarray     # (3, 3) d(dV)/d(ba)
    JPg: jnp.ndarray     # (3, 3) d(dP)/d(bg)
    JPa: jnp.ndarray     # (3, 3) d(dP)/d(ba)
    avg_a: jnp.ndarray   # (3,) average rotated specific force
    avg_w: jnp.ndarray   # (3,) average bias-corrected angular rate
    bias: jnp.ndarray    # (6,) linearization bias [bg, ba]


def init_state(bias: jnp.ndarray | None = None) -> PreintState:
    if bias is None:
        bias = jnp.zeros(6, jnp.float32)
    z3 = jnp.zeros(3, jnp.float32)
    z33 = jnp.zeros((3, 3), jnp.float32)
    return PreintState(
        dT=jnp.zeros((), jnp.float32),
        dR=jnp.eye(3, dtype=jnp.float32),
        dV=z3, dP=z3,
        C=jnp.zeros((15, 15), jnp.float32),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        avg_a=z3, avg_w=z3,
        bias=jnp.asarray(bias, jnp.float32),
    )


def integrate_step(state: PreintState, acc: jnp.ndarray, gyr: jnp.ndarray,
                   dt: jnp.ndarray, noise_cov: jnp.ndarray,
                   walk_cov: jnp.ndarray) -> PreintState:
    """One measurement update, mirroring IntegrateNewMeasurement order:
    position/velocity first (old dR), then rotation, then covariance.

    A dt == 0 step is the identity (used for padding).
    """
    bg, ba = state.bias[:3], state.bias[3:]
    a = acc - ba
    w = gyr - bg

    dT_new = state.dT + dt
    denom = jnp.where(dT_new > 0, dT_new, 1.0)
    avg_a = (state.dT * state.avg_a + _mv(state.dR, a) * dt) / denom
    avg_w = (state.dT * state.avg_w + w * dt) / denom

    # eq.(38): position/velocity with the NOT-yet-updated rotation.
    dRa = _mv(state.dR, a)
    dP = state.dP + state.dV * dt + 0.5 * dRa * dt * dt
    dV = state.dV + dRa * dt

    Wacc = lie.skew(a)
    dR_dt_W = _mm(state.dR * dt, Wacc)

    # Bias Jacobians (recursive form, ImuTypes.cc:291-296). Position uses the
    # PREVIOUS JRg (update ordering matters).
    JPa = state.JPa + state.JVa * dt - 0.5 * state.dR * dt * dt
    JPg = state.JPg + state.JVg * dt - 0.5 * dt * _mm(dR_dt_W, state.JRg)
    JVa = state.JVa - state.dR * dt
    JVg = state.JVg - _mm(dR_dt_W, state.JRg)

    # Rotation update.
    phi = w * dt
    dRi = lie.so3_exp(phi)
    rightJ = lie.so3_right_jacobian(phi)
    dR = lie.normalize_rotation(_mm(state.dR, dRi))
    JRg = _mm(dRi.T, state.JRg) - rightJ * dt

    # Covariance: 9x9 block via A (9x9) and B (9x6) (ImuTypes.cc:311-313).
    z33 = jnp.zeros((3, 3), jnp.float32)
    eye3 = jnp.eye(3, dtype=jnp.float32)
    A = jnp.block([
        [dRi.T, z33, z33],
        [-dR_dt_W, eye3, z33],
        [-0.5 * dt * dR_dt_W, eye3 * dt, eye3],
    ])
    B = jnp.block([
        [rightJ * dt, z33],
        [z33, state.dR * dt],
        [z33, 0.5 * state.dR * dt * dt],
    ])
    C9 = _mm(_mm(A, state.C[:9, :9]), A.T) + _mm(_mm(B, noise_cov), B.T)
    Cb = state.C[9:, 9:] + walk_cov * jnp.where(dt > 0, 1.0, 0.0)
    C = state.C.at[:9, :9].set(C9).at[9:, 9:].set(Cb)

    # dt == 0 padding must be a strict no-op (normalize_rotation still runs SVD
    # on dR; keep the old values wholesale).
    is_pad = dt <= 0
    new = PreintState(dT_new, dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa,
                      avg_a, avg_w, state.bias)
    return jax.tree.map(lambda n, o: jnp.where(is_pad, o, n), new, state)


@jax.jit
def integrate(acc: jnp.ndarray, gyr: jnp.ndarray, dts: jnp.ndarray,
              bias: jnp.ndarray, noise_cov: jnp.ndarray,
              walk_cov: jnp.ndarray) -> PreintState:
    """Integrate a window of N measurements (dt==0 rows are padding).

    acc, gyr: (N, 3); dts: (N,). Returns the final PreintState.
    """
    state = init_state(bias)

    def step(s, x):
        a, w, dt = x
        return integrate_step(s, a, w, dt, noise_cov, walk_cov), None

    state, _ = jax.lax.scan(step, state, (acc, gyr, dts))
    return state


# ---------------------------------------------------------------------------
# Bias-corrected getters (first-order update around the linearization bias;
# parity: GetDeltaRotation/Velocity/Position, /root/reference/src/ImuTypes.cc:383-420)
# ---------------------------------------------------------------------------

def delta_rotation(state: PreintState, new_bias: jnp.ndarray,
                   normalize: bool = True) -> jnp.ndarray:
    dbg = new_bias[..., :3] - state.bias[..., :3]
    dR = _mm(state.dR, lie.so3_exp(_mv(state.JRg, dbg)))
    # normalize=False keeps the op autodiff-safe: the SVD re-projection has
    # repeated singular values (all ~1) whose gradients are NaN; the product
    # of two rotations is orthonormal to f32 precision anyway.
    return lie.normalize_rotation(dR) if normalize else dR


def delta_velocity(state: PreintState, new_bias: jnp.ndarray) -> jnp.ndarray:
    dbg = new_bias[..., :3] - state.bias[..., :3]
    dba = new_bias[..., 3:] - state.bias[..., 3:]
    return state.dV + _mv(state.JVg, dbg) + _mv(state.JVa, dba)


def delta_position(state: PreintState, new_bias: jnp.ndarray) -> jnp.ndarray:
    dbg = new_bias[..., :3] - state.bias[..., :3]
    dba = new_bias[..., 3:] - state.bias[..., 3:]
    return state.dP + _mv(state.JPg, dbg) + _mv(state.JPa, dba)


@jax.jit
def predict_state(R_wb: jnp.ndarray, v_w: jnp.ndarray, p_w: jnp.ndarray,
                  state: PreintState, new_bias: jnp.ndarray):
    """Dead-reckon world-frame body state across the preintegrated window.

    Parity: Tracking::PredictStateIMU (/root/reference/src/Tracking.cc:1964-2043).
    """
    t = state.dT
    dR = delta_rotation(state, new_bias)
    dV = delta_velocity(state, new_bias)
    dP = delta_position(state, new_bias)
    R_new = lie.normalize_rotation(_mm(R_wb, dR))
    v_new = v_w + GRAVITY_VEC * t + _mv(R_wb, dV)
    p_new = p_w + v_w * t + 0.5 * GRAVITY_VEC * t * t + _mv(R_wb, dP)
    return R_new, v_new, p_new


def split_interval(t0: float, t1: float, stamps: jnp.ndarray):
    """Per-measurement dt within [t0, t1] with boundary splitting.

    Mirrors the midpoint bookkeeping of Tracking::PreintegrateIMU
    (/root/reference/src/Tracking.cc:1893-1910): samples outside the window
    contribute 0; boundary samples are clipped.
    """
    lo = jnp.maximum(stamps[:-1], t0)
    hi = jnp.minimum(stamps[1:], t1)
    return jnp.maximum(hi - lo, 0.0)
