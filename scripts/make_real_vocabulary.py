#!/usr/bin/env python3
"""Train a deployable-scale ORB vocabulary from REAL imagery.

The reference requires a ~1M-node vocabulary trained on real images
(ORBvoc.txt, /root/reference/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:44;
loaded by build.sh:36-38 — absent from this mount). The synthetic 10k-word
vocabulary (scripts/make_synth_vocabulary.py) is trained on blob renders
whose descriptor distribution does not transfer to real scenes.

This tool builds a 100k-word (k=10, depth=5) tree from the real photographs
shipped with the scientific-python stack (sklearn's china/flower scenes,
matplotlib's grace_hopper portrait, scipy's ascent — real architecture,
foliage, faces, fabric), densified by viewpoint augmentation: each photo is
re-rendered through hundreds of random similarity+perspective warps with
photometric jitter, and ORB descriptors are extracted with the SAME
pipeline the SLAM engine uses (ops/fast_orb), so the tree is trained on the
distribution it will quantize at runtime.

Usage:
  python scripts/make_real_vocabulary.py vocabulary/real_voc_100k.npz \
      [--views-per-image 250] [--features 1200] [--k 10] [--depth 5] \
      [--holdout grace_hopper]

The --holdout image is EXCLUDED from training and written alongside as
<out>.holdout.npz (descriptor sets of augmented views) for the
discrimination test (tests/test_vocabulary_transfer.py).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def load_real_images():
    """All real photographs reachable without network access."""
    import numpy as np
    imgs = {}
    try:
        from sklearn.datasets import load_sample_images
        for name, im in zip(["china", "flower"],
                            load_sample_images().images):
            imgs[name] = np.asarray(im).mean(-1).astype(np.float32)
    except Exception as e:                                  # pragma: no cover
        print("sklearn samples unavailable:", e)
    try:
        import matplotlib
        from PIL import Image
        p = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                         "sample_data", "grace_hopper.jpg")
        imgs["grace_hopper"] = np.asarray(
            Image.open(p).convert("L"), np.float32)
    except Exception as e:                                  # pragma: no cover
        print("matplotlib sample unavailable:", e)
    try:
        from scipy import datasets as sdat
        imgs["ascent"] = np.asarray(sdat.ascent(), np.float32)
    except Exception as e:                                  # pragma: no cover
        print("scipy ascent unavailable:", e)
    try:
        from scipy import datasets as sdat
        face = sdat.face(gray=True)
        imgs["face"] = np.asarray(face, np.float32)
    except Exception as e:                                  # pragma: no cover
        print("scipy face unavailable (needs cache):", type(e).__name__)
    return imgs


def augmented_views(img, n_views, rng, w=640, h=480):
    """Random similarity + perspective + photometric warps of one photo."""
    import cv2
    import numpy as np
    H0, W0 = img.shape
    for _ in range(n_views):
        scale = rng.uniform(0.6, 2.2)
        angle = rng.uniform(0, 360)
        cx = rng.uniform(0.3, 0.7) * W0
        cy = rng.uniform(0.3, 0.7) * H0
        M = cv2.getRotationMatrix2D((cx, cy), angle, scale)
        M[0, 2] += w / 2 - cx
        M[1, 2] += h / 2 - cy
        view = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT)
        # Mild perspective jitter.
        j = rng.uniform(-0.04, 0.04, (4, 2)).astype(np.float32)
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = src + j * np.float32([w, h])
        P = cv2.getPerspectiveTransform(src, dst)
        view = cv2.warpPerspective(view, P, (w, h),
                                   borderMode=cv2.BORDER_REFLECT)
        # Photometric jitter.
        gain = rng.uniform(0.6, 1.4)
        bias = rng.uniform(-25, 25)
        view = np.clip(view * gain + bias, 0, 255)
        if rng.uniform() < 0.3:
            view = cv2.GaussianBlur(view, (3, 3), rng.uniform(0.5, 1.2))
        yield view.astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--views-per-image", type=int, default=250)
    ap.add_argument("--features", type=int, default=1200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--holdout", default="grace_hopper")
    ap.add_argument("--holdout-views", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from orbslam3_byzyh_tpu.ops import bow, fast_orb

    imgs = load_real_images()
    print("real images:", {k: v.shape for k, v in imgs.items()})
    if len(imgs) < 2:
        raise SystemExit("not enough real imagery available")

    rng = np.random.default_rng(args.seed)
    all_desc = []
    doc_ids = []
    doc = 0
    for name, img in imgs.items():
        if name == args.holdout:
            continue
        for view in augmented_views(img, args.views_per_image, rng):
            feats = fast_orb.extract(jnp.asarray(view),
                                     n_features=args.features)
            valid = np.asarray(feats.valid)
            d = np.asarray(feats.desc)[valid]
            all_desc.append(d)
            doc_ids.append(np.full(len(d), doc, np.int64))
            doc += 1
        print(f"{name}: {doc} views, "
              f"{sum(len(d) for d in all_desc)} descriptors")
    descs = np.concatenate(all_desc, 0)
    ids = np.concatenate(doc_ids, 0)
    print(f"training k={args.k} depth={args.depth} "
          f"({args.k ** args.depth} words) on {len(descs)} descriptors")
    voc = bow.train_vocabulary(descs, k=args.k, depth=args.depth,
                               seed=args.seed, doc_ids=ids)
    bow.save_vocabulary(args.output, voc)
    print(f"saved {args.output}: {voc.n_words} words, "
          f"{np.asarray(voc.node_desc).shape[0]} nodes")

    # Held-out views for the transfer/discrimination test.
    if args.holdout in imgs:
        hold = []
        for view in augmented_views(imgs[args.holdout], args.holdout_views,
                                    rng):
            feats = fast_orb.extract(jnp.asarray(view),
                                     n_features=args.features)
            valid = np.asarray(feats.valid)
            hold.append(np.asarray(feats.desc)[valid])
        np.savez_compressed(
            args.output + ".holdout.npz",
            **{f"view_{i}": d for i, d in enumerate(hold)})
        print(f"saved {len(hold)} held-out views "
              f"({args.output}.holdout.npz)")


if __name__ == "__main__":
    main()
