#!/usr/bin/env python3
"""Monocular EuRoC runner (mono_euroc.cc equivalent).

Usage:
  python scripts/run_euroc_mono.py <settings.yaml> <sequence_dir> \
      [--timestamps FILE] [--output-name NAME] [--vocabulary VOC.npz] \
      [--max-frames N]

Replaces /root/reference/Examples/Monocular/mono_euroc.cc: loads the EuRoC
sequence + YAML calibration, runs the SLAM system frame by frame with the
native prefetcher, and writes f_<name>.txt / kf_<name>.txt trajectories in
the reference's TUM/EuRoC format (nanosecond stamps) so
evaluate_ate_scale.py can score them directly.
"""

import argparse
import os
import sys
import time

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
    ap.add_argument("sequence", nargs="+")
    ap.add_argument("--timestamps", nargs="*", default=None)
    ap.add_argument("--output-name", default="output")
    ap.add_argument("--vocabulary", default=_default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    # MH01-05 multi-session scale by default (euroc_eval_examples.sh:14-20
    # runs 5 sequences back to back; well over 256 live keyframes).
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write map_NNNN.png every N frames (offline viewer)")
    ap.add_argument("--localization-after", type=int, default=0,
                    help="freeze the map after N frames (localization mode)")
    ap.add_argument("--min-init-matches", type=int, default=100,
                    help="two-view init match gate (Tracking.cc:3620; lower for low-texture scenes)")
    args = ap.parse_args()

    import numpy as np

    from orbslam3_byzyh_tpu.io import euroc, settings, trajectory
    from orbslam3_byzyh_tpu.native import ImagePrefetcher
    from orbslam3_byzyh_tpu.pipeline.system import MonoSlam, SlamConfig
    from orbslam3_byzyh_tpu.utils.timers import StageTimers

    cfg_yaml = settings.load_settings(args.settings)

    voc = None
    if args.no_vocabulary:
        args.vocabulary = None
    if args.vocabulary:
        from orbslam3_byzyh_tpu.ops import bow
        voc = bow.load_vocabulary(args.vocabulary)

    cam = cfg_yaml.cam1
    cfg = SlamConfig(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height,
        dist=cam.dist,
        n_features=cfg_yaml.orb.n_features,
        fps=cfg_yaml.fps or 20.0,
        vocabulary=voc,
        use_loop_closing=not args.no_loop_closing,
        max_kf=args.max_kf, max_lm=args.max_lm,
        min_init_matches=args.min_init_matches)
    if cfg_yaml.chessboard is not None:
        # Fork feature: chessboard world-frame initialization
        # (UseChessboardInit keys, /root/reference/src/Tracking.cc:158-185).
        # The rebase transforms the whole map, so the trajectory writer
        # below emits chessboard-world poses — the fork's
        # SaveTrajectoryEuRoCWithChessboard contract (System.h:162-163).
        from orbslam3_byzyh_tpu.utils.chessboard import ChessboardConfig
        cb = cfg_yaml.chessboard
        cfg.chessboard = ChessboardConfig(
            width=cb.width, height=cb.height, square_size=cb.square_size,
            start_x=cb.start_x, start_y=cb.start_y, z_height=cb.z_height)
    slam = MonoSlam(cfg)
    # Atlas persistence keys (System.SaveAtlasToFile/LoadAtlasFromFile).
    if cfg_yaml.load_atlas:
        slam.load_atlas_checkpoint(cfg_yaml.load_atlas)
        print(f"loaded atlas from {cfg_yaml.load_atlas} "
              f"({len(slam.atlas.maps) - 1} stored maps)")
    timers = StageTimers()
    # Per-stage REGISTER_TIMES taxonomy: the system's
    # internal stages record into the same report.
    slam.timers = timers

    n_total = 0
    fcount = 0
    t_start = time.perf_counter()
    for si, seq_dir in enumerate(args.sequence):
        if si > 0:
            slam.change_dataset()   # multi-session (SLAM.ChangeDataset())
        ts_file = (args.timestamps[si] if args.timestamps
                   and si < len(args.timestamps) else None)
        seq = euroc.load_euroc(seq_dir, ts_file)
        n_frames = len(seq) if args.max_frames is None else min(
            len(seq), args.max_frames)
        n_total += n_frames
        pf = ImagePrefetcher(seq.image_paths[:n_frames])
        for idx, img in pf:
            with timers.time("total_track"):
                slam.track(img, float(seq.stamps[idx]))
            fcount += 1
            if args.localization_after and fcount == args.localization_after:
                slam.activate_localization_mode()
            if args.snapshot_every and fcount % args.snapshot_every == 0:
                from orbslam3_byzyh_tpu.utils import viewer
                viewer.snapshot(slam, f"map_{fcount:05d}.png")
        pf.close()
    wall = time.perf_counter() - t_start

    print(f"tracked {len(slam.trajectory)}/{n_total} frames in {wall:.1f}s "
          f"({n_total / wall:.1f} fps); keyframes={slam.n_kf} "
          f"landmarks={slam.n_lm} maps={len(slam.atlas.maps)}")
    print(timers.report())

    stamps = [s + slam.t0 for s, _, _ in slam.trajectory]
    Rs = [R for _, R, _ in slam.trajectory]
    ts = [t for _, _, t in slam.trajectory]
    trajectory.save_tum(f"f_{args.output_name}.txt", stamps, Rs, ts,
                        stamp_scale=1e9)
    ks, kR, kt = slam.keyframe_trajectory()
    trajectory.save_tum(f"kf_{args.output_name}.txt", ks, kR, kt,
                        stamp_scale=1e9)
    timers.save("ExecTimeMean.txt")
    if cfg_yaml.save_atlas:
        slam.save_atlas_checkpoint(cfg_yaml.save_atlas)
        print(f"saved atlas to {cfg_yaml.save_atlas}")


if __name__ == "__main__":
    main()
