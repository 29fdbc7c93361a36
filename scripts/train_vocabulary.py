#!/usr/bin/env python3
"""Train a binary BoW vocabulary from dataset images.

Usage:
  python scripts/train_vocabulary.py <out.npz> <seq_dir> [<seq_dir>...] \
      [--k 10] [--depth 4] [--stride 5] [--max-frames 300] [--features 1024]

The reference ships no trainable vocabulary pipeline — it loads the
pre-trained ORBvoc.txt (absent from this mount, SURVEY Appendix B). This
tool replaces that dependency: extract ORB descriptors over dataset frames
(EuRoC mav0 layout) and train the k-ary binary-k-means tree of
ops/bow.py (DBoW2's TemplatedVocabulary::create equivalent).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("sequences", nargs="+")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--max-frames", type=int, default=300)
    ap.add_argument("--features", type=int, default=1024)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from orbslam3_byzyh_tpu.io import euroc
    from orbslam3_byzyh_tpu.ops import bow, fast_orb

    all_desc = []
    for seq_dir in args.sequences:
        seq = euroc.load_euroc(seq_dir)
        idxs = range(0, len(seq), args.stride)
        idxs = list(idxs)[: args.max_frames]
        for i in idxs:
            img = seq.read_image(i)
            feats = fast_orb.extract(jnp.asarray(img, jnp.float32),
                                     n_features=args.features)
            valid = np.asarray(feats.valid)
            all_desc.append(np.asarray(feats.desc)[valid])
        print(f"{seq_dir}: {len(idxs)} frames, "
              f"{sum(d.shape[0] for d in all_desc)} descriptors so far")

    descs = np.concatenate(all_desc, 0)
    print(f"training k={args.k} depth={args.depth} on {descs.shape[0]} "
          f"descriptors ({args.k ** args.depth} words)")
    voc = bow.train_vocabulary(descs, k=args.k, depth=args.depth, seed=0)
    bow.save_vocabulary(args.output, voc)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
