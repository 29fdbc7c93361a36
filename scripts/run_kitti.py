#!/usr/bin/env python3
"""KITTI odometry runner (mono_kitti.cc / stereo_kitti.cc equivalent).

Usage:
  python scripts/run_kitti.py <settings.yaml> <sequence_dir> \
      [--stereo] [--output-name NAME] [--max-frames N]

Writes the trajectory in KITTI format (12 numbers per line: flattened 3x4
[R|t] of cam-to-world, System::SaveTrajectoryKITTI parity) plus TUM format.
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
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--output-name", default="kitti")
    ap.add_argument("--vocabulary", default=_default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)
    args = ap.parse_args()

    import numpy as np

    from orbslam3_byzyh_tpu.io import kitti, settings, trajectory
    from orbslam3_byzyh_tpu.pipeline.stereo_system import (StereoConfig,
                                                           StereoSlam)
    from orbslam3_byzyh_tpu.pipeline.system import MonoSlam, SlamConfig

    cfg_yaml = settings.load_settings(args.settings)
    seq = kitti.load_kitti(args.sequence)
    n = len(seq) if args.max_frames is None else min(len(seq),
                                                     args.max_frames)
    voc = None
    if args.no_vocabulary:
        args.vocabulary = None
    if args.vocabulary:
        from orbslam3_byzyh_tpu.ops import bow
        voc = bow.load_vocabulary(args.vocabulary)

    cam = cfg_yaml.cam1
    common = dict(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height, dist=cam.dist,
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 10.0,
        max_kf=args.max_kf, max_lm=args.max_lm,
        vocabulary=voc)
    if args.stereo:
        slam = StereoSlam(StereoConfig(**common, bf=cfg_yaml.bf or 386.1448,
                                       th_depth=cfg_yaml.th_depth or 35.0))
    else:
        slam = MonoSlam(SlamConfig(**common))

    for i in range(n):
        t = float(seq.stamps[i])
        if args.stereo:
            slam.track(seq.read_image(i), seq.read_image(i, right=True), t)
        else:
            slam.track(seq.read_image(i), t)

    print(f"tracked {len(slam.trajectory)}/{n}; kf={slam.n_kf} "
          f"lm={slam.n_lm}")
    stamps = [s + slam.t0 for s, _, _ in slam.trajectory]
    Rs = [R for _, R, _ in slam.trajectory]
    ts = [t for _, _, t in slam.trajectory]
    # KITTI format: row-major 3x4 of Twc per frame.
    with open(f"{args.output_name}_kitti.txt", "w") as f:
        for R, t in zip(Rs, ts):
            Rwc = np.asarray(R).T
            twc = -Rwc @ np.asarray(t)
            P = np.concatenate([Rwc, twc[:, None]], 1).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in P) + "\n")
    trajectory.save_tum(f"f_{args.output_name}.txt", stamps, Rs, ts)


if __name__ == "__main__":
    main()
