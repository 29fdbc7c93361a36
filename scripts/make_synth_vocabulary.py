#!/usr/bin/env python3
"""Train the shipped 10k-word vocabulary from rendered synthetic worlds.

The reference depends on the ~1M-word pre-trained ORBvoc.txt (not in this
mount, SURVEY Appendix B). This script builds the repo's shipped vocabulary
at DBoW2-like scale (k=10, depth=4 -> up to 10^4 words) from a corpus of
rendered synthetic frames spanning several worlds and trajectories, so the
BoW word space discriminates across hundreds of keyframes (the 512-word
starter voc collided on nearly every word).

Usage:
  python scripts/make_synth_vocabulary.py [out.npz] [--worlds 6]
      [--frames 40] [--k 10] [--depth 4]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output", nargs="?",
                    default="vocabulary/synthetic_voc_10k.npz")
    ap.add_argument("--worlds", type=int, default=6)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--features", type=int, default=1536)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from orbslam3_byzyh_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from orbslam3_byzyh_tpu.ops import bow, fast_orb
    from synth_world import SynthWorld

    extract = jax.jit(
        lambda im: fast_orb.extract(im, n_features=args.features))

    all_desc, doc_ids = [], []
    doc = 0
    for w in range(args.worlds):
        world = SynthWorld(seed=w, motion="excited" if w % 2 else "default")
        for i in range(args.frames):
            t = i * 0.25
            feats = extract(jnp.asarray(world.render(t)))
            valid = np.asarray(feats.valid)
            d = np.asarray(feats.desc)[valid]
            all_desc.append(d)
            doc_ids.append(np.full(len(d), doc))
            doc += 1
        print(f"world {w}: corpus {sum(len(d) for d in all_desc)}",
              flush=True)

    descs = np.concatenate(all_desc)
    ids = np.concatenate(doc_ids)
    print(f"training k={args.k} depth={args.depth} on {len(descs)} "
          "descriptors ...", flush=True)
    voc = bow.train_vocabulary(descs, k=args.k, depth=args.depth,
                               doc_ids=ids)
    print(f"vocabulary: {voc.n_words} words")
    bow.save_vocabulary(args.output, voc)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
