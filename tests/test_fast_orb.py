"""ORB extractor tests: FAST vs OpenCV, orientation, descriptor invariance."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

import numpy_ref
from orbslam3_byzyh_tpu.ops import fast_orb


def make_test_image(rng, h=240, w=320):
    """Random blobs + corners; blurred so gradients are realistic."""
    img = rng.uniform(0, 64, size=(h, w)).astype(np.float32)
    for _ in range(60):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        sz = rng.integers(3, 12)
        img[y:y + sz, x:x + sz] += rng.uniform(64, 192)
    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    return np.clip(img, 0, 255).astype(np.float32)


class TestFAST:
    def test_score_map_matches_opencv_detection(self, rng):
        img = make_test_image(rng)
        score = np.asarray(fast_orb.fast_score_map(jnp.asarray(img)))
        for thr in (20, 40):
            det = cv2.FastFeatureDetector_create(
                threshold=thr, nonmaxSuppression=False)
            kps = det.detect(img.astype(np.uint8), None)
            cv_mask = np.zeros_like(score, bool)
            for kp in kps:
                x, y = int(round(kp.pt[0])), int(round(kp.pt[1]))
                cv_mask[y, x] = True
            ours_mask = score >= thr
            # Ignore a 3px border (OpenCV skips it entirely).
            b = 3
            cv_in = cv_mask[b:-b, b:-b]
            ours_in = ours_mask[b:-b, b:-b]
            # uint8 rounding of the input makes exact parity impossible;
            # require >97% agreement on the union.
            union = cv_in | ours_in
            agree = (cv_in == ours_in)[union].mean() if union.any() else 1.0
            assert agree > 0.93, f"thr={thr}: agreement {agree}"

    def test_score_matches_opencv_response(self, rng):
        img = make_test_image(rng)
        score = np.asarray(fast_orb.fast_score_map(jnp.asarray(img)))
        det = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=True)
        kps = det.detect(img.astype(np.uint8), None)
        assert len(kps) > 30
        diffs = []
        for kp in kps[:200]:
            x, y = int(round(kp.pt[0])), int(round(kp.pt[1]))
            diffs.append(abs(score[y, x] - kp.response))
        # Responses should agree up to uint8-rounding noise for most corners.
        assert np.median(diffs) <= 1.0, np.median(diffs)


class TestSelection:
    def test_capacity_and_mask(self, rng):
        img = make_test_image(rng)
        score = fast_orb.fast_score_map(jnp.asarray(img))
        score = fast_orb._border_mask(score, fast_orb.EDGE_THRESHOLD)
        score = fast_orb._nms3(score)
        xy, resp, valid = fast_orb.select_keypoints(score, 300)
        assert xy.shape == (300, 2)
        v = np.asarray(valid)
        r = np.asarray(resp)
        assert v.sum() > 50
        assert (r[v] > 0).all()

    def test_spatial_distribution(self, rng):
        """Tile-based selection must spread keypoints across the image."""
        img = make_test_image(rng, 256, 256)
        score = fast_orb.fast_score_map(jnp.asarray(img))
        score = fast_orb._border_mask(score, fast_orb.EDGE_THRESHOLD)
        score = fast_orb._nms3(score)
        xy, _, valid = fast_orb.select_keypoints(score, 200)
        pts = np.asarray(xy)[np.asarray(valid)]
        # Each image quadrant should hold some keypoints.
        for qx in (0, 1):
            for qy in (0, 1):
                n = ((pts[:, 0] >= qx * 128) & (pts[:, 0] < (qx + 1) * 128)
                     & (pts[:, 1] >= qy * 128) & (pts[:, 1] < (qy + 1) * 128)).sum()
                assert n > 5, (qx, qy, n)


class TestDescriptors:
    def test_extract_shapes(self, rng):
        img = make_test_image(rng, 480, 640)
        feats = fast_orb.extract(jnp.asarray(img), n_features=512)
        assert feats.xy.shape == (512, 2)
        assert feats.desc.shape == (512, 8)
        assert np.asarray(feats.valid).sum() > 200

    def test_rotation_invariance(self, rng):
        """Descriptors at the same physical corner should match under rotation."""
        img = make_test_image(rng, 320, 320)
        feats0 = fast_orb.extract(jnp.asarray(img), n_features=256)
        # Rotate image by 30 degrees around center.
        M = cv2.getRotationMatrix2D((160, 160), 30.0, 1.0)
        img_r = cv2.warpAffine(img, M, (320, 320))
        feats1 = fast_orb.extract(jnp.asarray(img_r), n_features=256)

        xy0 = np.asarray(feats0.xy)[np.asarray(feats0.valid)]
        d0 = np.asarray(feats0.desc)[np.asarray(feats0.valid)]
        l0 = np.asarray(feats0.level)[np.asarray(feats0.valid)]
        xy1 = np.asarray(feats1.xy)[np.asarray(feats1.valid)]
        d1 = np.asarray(feats1.desc)[np.asarray(feats1.valid)]

        # Ground-truth correspondence via the known rotation.
        ones = np.ones((len(xy0), 1))
        proj = np.concatenate([xy0, ones], -1) @ M.T  # (N, 2)

        def hamming(a, b):
            return np.unpackbits(
                (a ^ b).view(np.uint8), axis=-1).sum(-1)

        dists = []
        rand_dists = []
        rng2 = np.random.default_rng(0)
        for i in range(len(xy0)):
            if l0[i] != 0:
                continue
            d2 = np.linalg.norm(xy1 - proj[i], axis=-1)
            j = d2.argmin()
            if d2[j] < 2.0:
                dists.append(hamming(d0[i], d1[j]))
                rand_dists.append(hamming(d0[i], d1[rng2.integers(len(d1))]))
        assert len(dists) > 20
        # Matched corners: small Hamming distance; random pairs: ~128.
        assert np.median(dists) < 60, np.median(dists)
        assert np.median(rand_dists) > 90

    def test_descriptor_determinism(self, rng):
        img = make_test_image(rng)
        f1 = fast_orb.extract(jnp.asarray(img), n_features=256)
        f2 = fast_orb.extract(jnp.asarray(img), n_features=256)
        np.testing.assert_array_equal(np.asarray(f1.desc), np.asarray(f2.desc))


class TestPyramid:
    def test_level_sizes(self):
        sizes = fast_orb.level_sizes(480, 752, 8, 1.2)
        assert sizes[0] == (480, 752)
        assert sizes[1] == (400, 627)
        assert len(sizes) == 8

    def test_budget_sums(self):
        b = fast_orb.level_feature_budget(1024, 8, 1.2)
        assert sum(b) == 1024
        assert b[0] > b[1] > b[7]


def _keypoints(rng, case, h, w):
    """Level-local keypoints for the BRIEF cases."""
    if case == "interior":
        k = 96
        return np.stack([rng.uniform(22, w - 23, k),
                         rng.uniform(22, h - 23, k)], -1)
    if case == "border":
        # Within the 15 px pattern radius of an image edge: samples clamp.
        xs = np.concatenate([rng.uniform(0, 18, 24),
                             rng.uniform(w - 19, w - 1, 24),
                             rng.uniform(0, w - 1, 48)])
        ys = np.concatenate([rng.uniform(0, h - 1, 48),
                             rng.uniform(0, 18, 24),
                             rng.uniform(h - 19, h - 1, 24)])
        return np.stack([xs, ys], -1)
    # Astride multiples of 128 columns (tile edges of a lane-tiled layout).
    xs = np.concatenate([b + np.array([-18, -5, -1, 0, 4, 18])
                         for b in (128, 256, 384, 512)]).astype(np.float64)
    return np.stack([xs, rng.uniform(25, h - 25, len(xs))], -1)


@pytest.mark.parametrize("case", ["interior", "border", "tile_edges"])
def test_brief_matches_numpy(rng, case):
    """extract's sampling (_pattern_positions + one gather + _pack_bits)
    equals a numpy steered-BRIEF, bit for bit."""
    h, w = 240, 640
    blurred = rng.uniform(0, 255, (h, w)).astype(np.float32)
    xy = np.round(_keypoints(rng, case, h, w)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, len(xy)).astype(np.float32)
    gy, gx = fast_orb._pattern_positions(jnp.asarray(xy), jnp.asarray(angle),
                                         w, h)
    vals = jnp.asarray(blurred).reshape(-1)[gy * w + gx]
    desc = np.asarray(fast_orb._pack_bits(
        (vals[:, :256] < vals[:, 256:]).astype(jnp.float32)))
    ref, ambiguous = numpy_ref.brief(blurred, xy, angle)
    assert ambiguous.mean() < 0.1
    np.testing.assert_array_equal(desc[~ambiguous], ref[~ambiguous])
