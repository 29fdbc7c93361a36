#!/usr/bin/env python3
"""Render an atlas checkpoint to PNG — the offline stand-in for the
reference's Pangolin map window (MapDrawer, /root/reference/src/MapDrawer.cc).

Usage:
  python scripts/view_atlas.py <checkpoint_dir> [--out map.png] [--map N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--out", default="map.png")
    ap.add_argument("--map", type=int, default=None,
                    help="map index (default: current)")
    args = ap.parse_args()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from orbslam3_byzyh_tpu.io import checkpoint
    from orbslam3_byzyh_tpu.utils import viewer

    atlas = checkpoint.load_atlas(args.checkpoint)
    idx = atlas.current if args.map is None else args.map
    state = atlas.maps[idx]
    meta = atlas.meta[idx]
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    viewer.draw_map(state, meta.n_kf, ax=ax)
    ax.set_title(f"map {idx}/{len(atlas.maps)}: {meta.n_kf} KFs, "
                 f"{meta.n_lm} landmarks")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
