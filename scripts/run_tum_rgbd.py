#!/usr/bin/env python3
"""TUM RGB-D runner (rgbd_tum.cc equivalent).

Usage:
  python scripts/run_tum_rgbd.py <settings.yaml> <sequence_dir> \
      [--associations FILE] [--output-name NAME] [--max-frames N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _default_vocabulary():
    """Shipped 10k-word vocabulary (vocabulary/synthetic_voc_10k.npz) —
    the repo's stand-in for the reference's ORBvoc.txt; enables
    relocalization + loop closing by default."""
    import os
    p = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "vocabulary", "synthetic_voc_10k.npz")
    return p if os.path.exists(p) else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--associations", default=None)
    ap.add_argument("--output-name", default="rgbd")
    ap.add_argument("--vocabulary", default=_default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)
    args = ap.parse_args()

    from orbslam3_byzyh_tpu.io import settings, trajectory, tum_rgbd
    from orbslam3_byzyh_tpu.pipeline.stereo_system import RgbdConfig, RgbdSlam

    cfg_yaml = settings.load_settings(args.settings)
    seq = tum_rgbd.load_tum_rgbd(args.sequence,
                                 association_file=args.associations)
    n = len(seq) if args.max_frames is None else min(len(seq),
                                                     args.max_frames)
    voc = None
    if args.no_vocabulary:
        args.vocabulary = None
    if args.vocabulary:
        from orbslam3_byzyh_tpu.ops import bow
        voc = bow.load_vocabulary(args.vocabulary)

    cam = cfg_yaml.cam1
    slam = RgbdSlam(RgbdConfig(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height, dist=cam.dist,
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 30.0,
        max_kf=args.max_kf, max_lm=args.max_lm,
        vocabulary=voc,
        bf=cfg_yaml.bf or 40.0, th_depth=cfg_yaml.th_depth or 40.0,
        depth_scale=1.0))  # loader already divides by the png factor

    for i in range(n):
        rgb, depth = seq.read_pair(i)
        slam.track(rgb, depth, float(seq.stamps[i]))

    print(f"tracked {len(slam.trajectory)}/{n}; kf={slam.n_kf} "
          f"lm={slam.n_lm}")
    stamps = [s + slam.t0 for s, _, _ in slam.trajectory]
    Rs = [R for _, R, _ in slam.trajectory]
    ts = [t for _, _, t in slam.trajectory]
    trajectory.save_tum(f"f_{args.output_name}.txt", stamps, Rs, ts)
    ks, kR, kt = slam.keyframe_trajectory()
    trajectory.save_tum(f"kf_{args.output_name}.txt", ks, kR, kt)


if __name__ == "__main__":
    main()
