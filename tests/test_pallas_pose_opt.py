"""Fused pose-opt kernel (Pallas, Triton route) vs the XLA reference path.

The CPU tests run the kernel in interpret mode and lower it for CUDA; the
``gpu`` tests run it compiled on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_byzyh_tpu.ops import camera, lie
from orbslam3_byzyh_tpu.solver import pallas_pose_opt, pose_opt


def make_problem(rng, n=700, noise=0.5, n_outliers=60):
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 12, n)], -1).astype(np.float32)
    w = rng.normal(0, 0.05, 3).astype(np.float32)
    R_gt = np.asarray(lie.so3_exp(jnp.asarray(w)))
    t_gt = np.array([0.3, -0.1, 0.2], np.float32)
    cam = np.array([420.0, 420.0, 320.0, 240.0], np.float32)
    pc = pts @ R_gt.T + t_gt
    uv = np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2],
                   cam[1] * pc[:, 1] / pc[:, 2] + cam[3]], -1)
    uv += rng.normal(0, noise, uv.shape)
    out_idx = rng.choice(n, n_outliers, replace=False)
    uv[out_idx] += rng.uniform(20, 80, (n_outliers, 2))
    levels = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.2 ** (2.0 * levels)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 30, replace=False)] = False
    return (jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(pts),
            jnp.asarray(uv.astype(np.float32)), jnp.asarray(inv_s2),
            jnp.asarray(valid), jnp.asarray(cam), out_idx)


def _perturbed_start(R_gt, t_gt):
    """Start from a perturbed pose (like the motion-model prediction)."""
    R0 = lie.so3_exp(jnp.asarray([0.01, -0.02, 0.015])) @ R_gt
    return R0, t_gt + jnp.asarray([0.05, -0.03, 0.08])


def _check_matches_xla(R_gt, t_gt, pts, uv, inv_s2, valid, cam, interpret):
    R0, t0 = _perturbed_start(R_gt, t_gt)
    ref = pose_opt.pose_optimization_xla(R0, t0, pts, uv, inv_s2, valid,
                                         cam)
    Rk, tk, inl, n_inl, chi2 = pallas_pose_opt.pose_optimization_fused(
        R0, t0, pts, uv, inv_s2, valid, cam, interpret=interpret)
    # Both must land on the same pose (allow small float divergence from
    # the Gram-Schmidt vs SVD rotation re-projection).
    assert np.allclose(np.asarray(Rk), np.asarray(ref.R), atol=2e-3)
    assert np.allclose(np.asarray(tk), np.asarray(ref.t), atol=5e-3)
    # Inlier sets agree except near the chi2 boundary.
    agree = (np.asarray(inl) == np.asarray(ref.inlier)).mean()
    assert agree > 0.98, agree
    assert int(n_inl) == int(np.asarray(inl).sum())


def _check_recovers_gt(R_gt, t_gt, pts, uv, inv_s2, valid, cam, out_idx,
                       interpret):
    R0 = lie.so3_exp(jnp.asarray([0.02, 0.01, -0.02])) @ R_gt
    t0 = t_gt + jnp.asarray([-0.06, 0.04, 0.05])
    Rk, tk, inl, n_inl, chi2 = pallas_pose_opt.pose_optimization_fused(
        R0, t0, pts, uv, inv_s2, valid, cam, interpret=interpret)
    ang = np.degrees(np.linalg.norm(np.asarray(
        lie.so3_log(Rk @ R_gt.T))))
    assert ang < 0.2, ang
    assert np.linalg.norm(np.asarray(tk) - np.asarray(t_gt)) < 0.02
    # Injected outliers must be flagged.
    assert np.asarray(inl)[out_idx].mean() < 0.1


class TestFusedPoseOpt:
    def test_matches_xla_path(self, rng):
        *prob, _ = make_problem(rng)
        _check_matches_xla(*prob, interpret=True)

    def test_recovers_gt_pose(self, rng):
        _check_recovers_gt(*make_problem(rng), interpret=True)

    def test_lowers_for_cuda(self, rng):
        """Every primitive of the kernel has a Triton lowering."""
        R_gt, t_gt, pts, uv, inv_s2, valid, cam, _ = make_problem(rng)
        triton_call = jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")
        exp = jax.export.export(
            jax.jit(pallas_pose_opt.pose_optimization_fused),
            platforms=["cuda"], disabled_checks=[triton_call])(
                R_gt, t_gt, pts, uv, inv_s2, valid, cam)
        assert "__gpu$xla.gpu.triton" in exp.mlir_module()

    @pytest.mark.parametrize("n, block, warps", [
        (700, 1024, 4), (1024, 1024, 4), (1200, 2048, 8), (2049, 4096, 16)])
    def test_block_and_warps(self, n, block, warps):
        assert pallas_pose_opt.block_size(n) == block
        assert pallas_pose_opt.num_warps(block) == warps


@pytest.mark.parametrize("platform, model, fused", [
    ("gpu", camera.PINHOLE, True),
    ("gpu", camera.KB8, False),
    ("cpu", camera.PINHOLE, False),
])
def test_kernel_choice(platform, model, fused):
    assert pose_opt.use_fused_kernel(platform, model) is fused


@pytest.mark.gpu
class TestFusedPoseOptOnCard:
    def test_matches_xla_path(self, gpu_device, rng):
        *prob, _ = make_problem(rng, n=1200)
        _check_matches_xla(*prob, interpret=False)

    def test_recovers_gt_pose(self, gpu_device, rng):
        _check_recovers_gt(*make_problem(rng, n=1200), interpret=False)
