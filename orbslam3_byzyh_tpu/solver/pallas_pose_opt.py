"""Fused Pallas kernel (Triton route) for motion-only pose optimization.

The XLA expression of ``Optimizer::PoseOptimization``
(/root/reference/src/Optimizer.cc:55-415, solver/pose_opt.py) is a chain of
about 40 dependent LM micro-steps per frame: each iteration builds one 6x6
system over ~1k points, solves it and re-projects the rotation with a 3x3
SVD, so the step is bound by kernel launches rather than by arithmetic.
This kernel runs the ENTIRE 4x10 schedule in one program: the points are
loaded once into registers (one block, padded to a power of two), the
normal equations are block reductions, and the pose/LM state is scalars.

Math parity with solver/pose_opt.py (same residuals, Huber weights, Marquardt
damping, accept/reject rule, per-round chi2 re-classification), with one
documented deviation: the SO(3) re-projection after retraction uses
Gram-Schmidt instead of SVD; for LM-sized steps the two agree to float32
precision.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

CHI2_MONO = 5.991
MIN_BLOCK = 1024
N_PARAMS = 16          # R (9) + t (3) + fx, fy, cx, cy


def block_size(n: int) -> int:
    """Points per program: the next power of two >= n, at least 1024."""
    return max(MIN_BLOCK, 1 << max(n - 1, 0).bit_length())


def num_warps(block: int) -> int:
    """One warp per 256 points: 8 values per thread for each point array."""
    return max(4, block // 256)


# ---------------------------------------------------------------------------
# Scalar 6x6 Cholesky (Python-unrolled; all operands are 0-d traced scalars)
# ---------------------------------------------------------------------------

def _chol_solve6(H, g, lam):
    """Solve (H + lam*diag(H)) x = g. H: 6x6 nested scalar list; g: len-6."""
    A = [[H[i][j] for j in range(6)] for i in range(6)]
    for i in range(6):
        A[i][i] = A[i][i] + lam * jnp.maximum(A[i][i], 1e-9)
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = A[i][i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        Lii = jnp.sqrt(jnp.maximum(s, 1e-12))
        L[i][i] = Lii
        inv = 1.0 / Lii
        for j in range(i + 1, 6):
            s2 = A[j][i]
            for k in range(i):
                s2 = s2 - L[j][k] * L[i][k]
            L[j][i] = s2 * inv
    y = [None] * 6
    for i in range(6):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


# ---------------------------------------------------------------------------
# Scalar SE(3) retraction: x' = exp([rho, phi]) * x  (Sophus ordering)
# ---------------------------------------------------------------------------

def _so3_exp_scalars(wx, wy, wz):
    """Rodrigues on scalars -> 3x3 nested list (lie.so3_exp parity)."""
    th2 = wx * wx + wy * wy + wz * wz
    th = jnp.sqrt(th2)
    small = th < 1e-6
    safe_th = jnp.where(small, 1.0, th)
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / safe_th)
    b = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.where(small, 1.0, th2))
    # R = I + a W + b W^2, W = skew(w).
    W = [[0.0, -wz, wy], [wz, 0.0, -wx], [-wy, wx, 0.0]]
    W2 = [[sum(W[i][k] * W[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    return [[eye[i][j] + a * W[i][j] + b * W2[i][j] for j in range(3)]
            for i in range(3)]


def _left_jacobian_scalars(wx, wy, wz):
    """V(phi) with t = V rho (so3 left Jacobian; lie.se3_exp parity)."""
    th2 = wx * wx + wy * wy + wz * wz
    th = jnp.sqrt(th2)
    small = th < 1e-6
    b = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.where(small, 1.0, th2))
    th3 = th2 * th
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (th - jnp.sin(th)) / jnp.where(small, 1.0, th3))
    W = [[0.0, -wz, wy], [wz, 0.0, -wx], [-wy, wx, 0.0]]
    W2 = [[sum(W[i][k] * W[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    return [[eye[i][j] + b * W[i][j] + c * W2[i][j] for j in range(3)]
            for i in range(3)]


def _gram_schmidt(R):
    """Orthonormalize a 3x3 scalar-list near-rotation (det kept +1 via
    cross product for the last row)."""
    def norm3(v):
        return jnp.sqrt(jnp.maximum(v[0] * v[0] + v[1] * v[1] + v[2] * v[2],
                                    1e-18))
    r0 = R[0]
    n0 = norm3(r0)
    r0 = [r0[i] / n0 for i in range(3)]
    d = sum(R[1][i] * r0[i] for i in range(3))
    r1 = [R[1][i] - d * r0[i] for i in range(3)]
    n1 = norm3(r1)
    r1 = [r1[i] / n1 for i in range(3)]
    r2 = [r0[1] * r1[2] - r0[2] * r1[1],
          r0[2] * r1[0] - r0[0] * r1[2],
          r0[0] * r1[1] - r0[1] * r1[0]]
    return [r0, r1, r2]


def _retract(pose, dx):
    """pose: flat 12-list [R row-major 9, t 3]; dx: 6-list [rho, phi]."""
    dR = _so3_exp_scalars(dx[3], dx[4], dx[5])
    # V = Jl(phi) = Jr(-phi); lie.se3_exp uses so3_right_jacobian(-phi)
    # which equals the left Jacobian of +phi.
    V = _left_jacobian_scalars(dx[3], dx[4], dx[5])
    dt = [sum(V[i][k] * dx[k] for k in range(3)) for i in range(3)]
    R = [[pose[3 * i + j] for j in range(3)] for i in range(3)]
    t = [pose[9], pose[10], pose[11]]
    Rn = [[sum(dR[i][k] * R[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    Rn = _gram_schmidt(Rn)
    tn = [sum(dR[i][k] * t[k] for k in range(3)) + dt[i] for i in range(3)]
    return [Rn[0][0], Rn[0][1], Rn[0][2],
            Rn[1][0], Rn[1][1], Rn[1][2],
            Rn[2][0], Rn[2][1], Rn[2][2], tn[0], tn[1], tn[2]]


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def _lane(vec, lanes, i):
    """Scalar element i of a small loaded vector (masked sum: no scalar
    pointer arithmetic in the kernel)."""
    return jnp.sum(jnp.where(lanes == i, vec, 0.0))


def _kernel_factory(n_rounds: int, n_iters: int):
    def kernel(params_ref, x_ref, y_ref, z_ref, ou_ref, ov_ref, iv2_ref,
               val_ref, pose_out_ref, chi2_out_ref):
        lanes = jax.lax.broadcasted_iota(jnp.int32, (N_PARAMS,), 0)
        params = params_ref[...]
        X = x_ref[...]
        Y = y_ref[...]
        Z = z_ref[...]
        OU = ou_ref[...]
        OV = ov_ref[...]
        IV2 = iv2_ref[...]
        VALID = val_ref[...]
        fx, fy, cx, cy = (_lane(params, lanes, 12 + i) for i in range(4))
        delta2 = CHI2_MONO

        def point_terms(pose):
            """Camera-frame coords + residuals for the current pose."""
            pcx = pose[0] * X + pose[1] * Y + pose[2] * Z + pose[9]
            pcy = pose[3] * X + pose[4] * Y + pose[5] * Z + pose[10]
            pcz = pose[6] * X + pose[7] * Y + pose[8] * Z + pose[11]
            depth_ok = pcz > 0.05
            iz = 1.0 / jnp.where(depth_ok, pcz, 1.0)
            ru = OU - (fx * pcx * iz + cx)
            rv = OV - (fy * pcy * iz + cy)
            chi2 = (ru * ru + rv * rv) * IV2
            return pcx, pcy, pcz, iz, ru, rv, chi2, depth_ok

        def rho_of(chi2, robust: bool):
            if not robust:
                return chi2
            return jnp.where(chi2 <= delta2, chi2,
                             2.0 * jnp.sqrt(delta2 * chi2) - delta2)

        def cost_of(pose, inlier, robust: bool):
            *_, chi2, depth_ok = point_terms(pose)
            mask = (inlier > 0.5) & depth_ok
            return jnp.sum(jnp.where(mask, rho_of(chi2, robust), 0.0))

        def build(pose, inlier, robust: bool):
            pcx, pcy, pcz, iz, ru, rv, chi2, depth_ok = point_terms(pose)
            mask = (inlier > 0.5) & depth_ok
            if robust:
                w_rob = jnp.where(chi2 <= delta2, 1.0,
                                  jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))
            else:
                w_rob = 1.0
            w = jnp.where(mask, w_rob * IV2, 0.0)
            # J rows (2 x 6 per point), analytic pinhole
            # (pose_opt._residuals_mono): J = -Jproj @ [I | -skew(pc)].
            a = fx * iz
            b = -fx * pcx * iz * iz
            c = fy * iz
            d = -fy * pcy * iz * iz
            Ju = [-a, None, -b, -(b * pcy), -(a * pcz - b * pcx), a * pcy]
            Jv = [None, -c, -d, -(-c * pcz + d * pcy), d * pcx, -c * pcx]

            def dot(p, q):
                return 0.0 if p is None or q is None else p * q

            H = [[None] * 6 for _ in range(6)]
            for i in range(6):
                for j in range(i, 6):
                    H[i][j] = jnp.sum(w * (dot(Ju[i], Ju[j])
                                           + dot(Jv[i], Jv[j])))
                    H[j][i] = H[i][j]
            # pose_opt's build returns -b; the solve uses that directly.
            g = [-jnp.sum(w * (dot(Ju[i], ru) + dot(Jv[i], rv)))
                 for i in range(6)]
            return H, g

        # ---- n_rounds x n_iters LM, inlier re-classification per round ----
        pose = [_lane(params, lanes, i) for i in range(12)]
        inlier = VALID
        for rnd in range(n_rounds):
            robust = rnd < n_rounds - 1
            st = tuple(pose) + (jnp.float32(1e-3),
                                cost_of(pose, inlier, robust))

            def body(_, st, inl=inlier, rob=robust):
                pose_c = list(st[:12])
                lam_c, cost_c = st[12], st[13]
                H, g = build(pose_c, inl, rob)
                pose_n = _retract(pose_c, _chol_solve6(H, g, lam_c))
                cost_n = cost_of(pose_n, inl, rob)
                accept = cost_n < cost_c
                pose_o = [jnp.where(accept, pose_n[i], pose_c[i])
                          for i in range(12)]
                lam_o = jnp.where(accept, lam_c * 0.5, lam_c * 10.0)
                cost_o = jnp.where(accept, cost_n, cost_c)
                return tuple(pose_o) + (lam_o, cost_o)

            st = jax.lax.fori_loop(0, n_iters, body, st)
            pose = list(st[:12])
            *_, chi2, depth_ok = point_terms(pose)
            chi2 = jnp.where(depth_ok, chi2, 1e9)
            inlier = jnp.where((chi2 <= delta2) & (VALID > 0.5), 1.0, 0.0)

        *_, chi2, depth_ok = point_terms(pose)
        chi2_out_ref[...] = jnp.where(depth_ok, chi2, 1e9)
        out = jnp.zeros((N_PARAMS,), jnp.float32)
        for i in range(12):
            out = jnp.where(lanes == i, pose[i], out)
        pose_out_ref[...] = out

    return kernel


@functools.partial(jax.jit,
                   static_argnames=("n_rounds", "n_iters", "interpret"))
def pose_optimization_fused(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                            cam_params, n_rounds: int = 4, n_iters: int = 10,
                            interpret: bool = False):
    """Drop-in device path for pose_opt.pose_optimization (PINHOLE only).

    One program (grid of 1) per frame. Returns (R, t, inlier, n_inliers,
    chi2) with the same semantics.
    """
    n = pts_w.shape[0]
    block = block_size(n)

    def lane_pad(v, fill=0.0):
        return jnp.pad(v.astype(jnp.float32), (0, block - n),
                       constant_values=fill)

    params = jnp.concatenate([
        R0.reshape(9).astype(jnp.float32), t0.astype(jnp.float32),
        cam_params[:4].astype(jnp.float32)])
    pose_out, chi2_out = pl.pallas_call(
        _kernel_factory(n_rounds, n_iters),
        out_shape=(jax.ShapeDtypeStruct((N_PARAMS,), jnp.float32),
                   jax.ShapeDtypeStruct((block,), jnp.float32)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps(block), num_stages=1),
        interpret=interpret,
        name="pose_opt_fused",
    )(params, lane_pad(pts_w[:, 0]), lane_pad(pts_w[:, 1]),
      lane_pad(pts_w[:, 2], 1.0), lane_pad(obs_uv[:, 0]),
      lane_pad(obs_uv[:, 1]), lane_pad(inv_sigma2),
      lane_pad(valid))

    R = pose_out[:9].reshape(3, 3)
    t = pose_out[9:12]
    chi2 = chi2_out[:n]
    inlier = (chi2 <= CHI2_MONO) & valid
    return R, t, inlier, inlier.sum(), chi2
