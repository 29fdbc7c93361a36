"""Matching-op tests against numpy brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

import numpy_ref
from orbslam3_byzyh_tpu.ops import matching


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def np_hamming(a, b):
    return np.unpackbits((a[:, None, :] ^ b[None, :, :]).view(np.uint8),
                         axis=-1).sum(-1)


class TestHamming:
    def test_matrix_matches_numpy(self, rng):
        a, b = rand_desc(rng, 64), rand_desc(rng, 96)
        ours = np.asarray(matching.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(ours, np_hamming(a, b))

    def test_identical_is_zero(self, rng):
        a = rand_desc(rng, 32)
        d = np.asarray(matching.hamming_matrix(jnp.asarray(a), jnp.asarray(a)))
        assert (np.diag(d) == 0).all()

    def test_masked(self, rng):
        a, b = rand_desc(rng, 16), rand_desc(rng, 16)
        va = np.ones(16, bool); va[3] = False
        vb = np.ones(16, bool); vb[5] = False
        d = np.asarray(matching.masked_hamming(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb)))
        assert (d[3] == matching.INVALID_DIST).all()
        assert (d[:, 5] == matching.INVALID_DIST).all()


class TestMatch:
    def test_perfect_match_with_noise(self, rng):
        """b = permuted a with a few flipped bits -> match recovers permutation."""
        n = 128
        a = rand_desc(rng, n)
        perm = rng.permutation(n)
        b = a[perm].copy()
        # flip 10 random bits in each
        for i in range(n):
            for _ in range(10):
                w = rng.integers(8)
                bit = np.uint32(1) << np.uint32(rng.integers(32))
                b[i, w] ^= bit
        mj, md = matching.match(
            jnp.asarray(a), jnp.asarray(b),
            jnp.ones(n, bool), jnp.ones(n, bool),
            max_dist=matching.TH_LOW, ratio=0.9)
        mj = np.asarray(mj)
        inv = np.empty(n, int)
        inv[perm] = np.arange(n)
        recovered = (mj == inv).mean()
        assert recovered > 0.95, recovered

    def test_mutual_exclusion(self, rng):
        """Two identical queries, one target: only one keeps the match."""
        a = rand_desc(rng, 1)
        da = np.concatenate([a, a], 0)
        db = a
        mj, _ = matching.match(jnp.asarray(da), jnp.asarray(db),
                               jnp.ones(2, bool), jnp.ones(1, bool),
                               max_dist=256, ratio=None)
        mj = np.asarray(mj)
        assert (mj >= 0).sum() == 1

    def test_ratio_test_rejects_ambiguous(self, rng):
        a = rand_desc(rng, 1)
        # Two equally-distant targets (~16 bits each) -> rejected by ratio.
        b = np.concatenate([a, a], 0)
        for t in range(2):
            for w in range(8):
                b[t, w] ^= np.uint32(1) << np.uint32(t + 2 * w)
        mj, _ = matching.match(jnp.asarray(a), jnp.asarray(b),
                               jnp.ones(1, bool), jnp.ones(2, bool),
                               max_dist=256, ratio=0.9)
        assert np.asarray(mj)[0] == -1

    def test_rotation_consistency(self, rng):
        """Matches with outlier rotation offsets are removed."""
        n = 100
        a = rand_desc(rng, n)
        b = a.copy()
        ang_a = np.zeros(n, np.float32)
        ang_b = np.full(n, -0.5, np.float32)  # consistent +0.5 offset
        ang_b[:5] = 2.0  # 5 outliers
        mj, _ = matching.match(
            jnp.asarray(a), jnp.asarray(b),
            jnp.ones(n, bool), jnp.ones(n, bool),
            max_dist=256, ratio=None,
            angles=(jnp.asarray(ang_a), jnp.asarray(ang_b)))
        mj = np.asarray(mj)
        assert (mj[5:] == np.arange(5, n)).all()
        assert (mj[:5] == -1).all()


class TestGuidedSearch:
    def test_window_mask(self, rng):
        xa = rng.uniform(0, 100, (8, 2)).astype(np.float32)
        xb = rng.uniform(0, 100, (12, 2)).astype(np.float32)
        m = np.asarray(matching.window_mask(jnp.asarray(xa), jnp.asarray(xb), 20.0))
        ref = (((xa[:, None] - xb[None]) ** 2).sum(-1)) <= 400
        np.testing.assert_array_equal(m, ref)

    def test_search_by_projection(self, rng):
        """Landmarks projected near their true keypoints are matched."""
        n_lm, n_kp = 50, 200
        kp_desc = rand_desc(rng, n_kp)
        kp_xy = rng.uniform(20, 600, (n_kp, 2)).astype(np.float32)
        kp_level = rng.integers(0, 4, n_kp).astype(np.int32)
        idx = rng.choice(n_kp, n_lm, replace=False)
        lm_desc = kp_desc[idx].copy()
        proj = kp_xy[idx] + rng.normal(0, 1.0, (n_lm, 2)).astype(np.float32)
        mj, _ = matching.search_by_projection(
            jnp.asarray(proj), jnp.asarray(kp_level[idx]),
            jnp.asarray(lm_desc), jnp.ones(n_lm, bool),
            jnp.asarray(kp_xy), jnp.asarray(kp_level),
            jnp.asarray(kp_desc), jnp.ones(n_kp, bool),
            radius=5.0, level_window=(0, 0))
        mj = np.asarray(mj)
        assert (mj == idx).mean() > 0.9


def _related_descs(rng, n, m, n_true):
    """a: random; b: noisy copies of n_true rows of a, then random rows."""
    a = rand_desc(rng, n)
    b = rand_desc(rng, m)
    src = rng.choice(n, n_true, replace=False)
    b[:n_true] = a[src]
    bits = b[:n_true].view(np.uint8)
    for i in range(n_true):
        flips = rng.choice(256, rng.integers(0, 60), replace=False)
        np.bitwise_xor.at(bits[i], flips // 8,
                          (1 << (flips % 8)).astype(np.uint8))
    return a, b, src


@pytest.mark.parametrize("mode", ["plain", "window", "epipolar"])
def test_plain_matcher_matches_numpy(rng, mode):
    """The XLA matcher equals a numpy brute-force top-2 + ratio + mutual
    filter, integer distances exactly."""
    n, m = 300, 260
    da, db, src = _related_descs(rng, n, m, 200)
    va, vb = rng.random(n) > 0.05, rng.random(m) > 0.05
    xy_a = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    xy_b = rng.uniform(0, 640, (m, 2)).astype(np.float32)
    lvl_a = rng.integers(0, 8, n).astype(np.int32)
    lvl_b = rng.integers(0, 8, m).astype(np.int32)
    # True pairs sit near each other, on neighbouring pyramid levels.
    xy_b[:200] = xy_a[src] + rng.normal(0, 10, (200, 2))
    lvl_b[:200] = np.clip(lvl_a[src] + rng.integers(-1, 2, 200), 0, 7)
    dist = numpy_ref.hamming(da, db)
    J = jnp.asarray
    if mode == "plain":
        mj, md = matching.match(J(da), J(db), J(va), J(vb))
        ref = numpy_ref.match(numpy_ref.masked(dist, va, vb),
                              matching.TH_LOW, 0.9)
    elif mode == "window":
        radius = rng.uniform(40, 200, n).astype(np.float32)
        mj, md = matching.search_by_projection(
            J(xy_a), J(lvl_a), J(da), J(va), J(xy_b), J(lvl_b), J(db), J(vb),
            J(radius))
        pm = numpy_ref.window_level_mask(xy_a, xy_b, radius, lvl_a, lvl_b,
                                         -1, 1)
        ref = numpy_ref.match(numpy_ref.masked(dist, va, vb, pm),
                              matching.TH_HIGH, 0.9)
    else:
        F = rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
        lines = (np.concatenate([xy_a, np.ones((n, 1), np.float32)], -1)
                 @ F.T).astype(np.float32)
        # Move the true partners onto (near) their epipolar lines.
        ln = lines[src].astype(np.float64)
        off = (ln[:, :2] * xy_b[:200]).sum(-1) + ln[:, 2]
        xy_b[:200] -= (off / (ln[:, :2] ** 2).sum(-1))[:, None] * ln[:, :2]
        xy_b[:200] += rng.normal(0, 0.5, (200, 2))
        sigma2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
        mj, md = matching.search_epipolar(
            J(lines), J(da), J(va), J(xy_b), J(lvl_b), J(db), J(vb),
            J(sigma2))
        th = np.float32(3.84) * sigma2[lvl_b]
        num = (lines[:, None, 0] * xy_b[None, :, 0]
               + lines[:, None, 1] * xy_b[None, :, 1]
               + lines[:, None, 2]) ** 2
        den = np.maximum(lines[:, 0] ** 2 + lines[:, 1] ** 2,
                         np.float32(1e-12))[:, None]
        ref = numpy_ref.match(numpy_ref.masked(dist, va, vb,
                                               (num / den) < th[None, :]),
                              matching.TH_LOW, 0.8)
    np.testing.assert_array_equal(np.asarray(mj), ref[0])
    np.testing.assert_array_equal(np.asarray(md), ref[1])
    assert (ref[0] >= 0).sum() > 20      # the case exercises real matches
