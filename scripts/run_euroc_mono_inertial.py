#!/usr/bin/env python3
"""Monocular-inertial EuRoC / TUM-VI runner.

Usage:
  python scripts/run_euroc_mono_inertial.py <settings.yaml> <sequence_dir> \
      [--timestamps FILE] [--output-name NAME] [--vocabulary VOC.npz] \
      [--max-frames N] [--clahe]

Replaces /root/reference/Examples/Monocular-Inertial/mono_inertial_euroc.cc
and mono_inertial_tum_vi.cc: loads images + per-frame IMU batches, runs the
visual-inertial system, writes f_/kf_ trajectories (nanosecond TUM format)
for evaluate_ate_scale.py. --clahe applies the TUM-VI mains' CLAHE
equalization (clipLimit=3, tiles 8x8).
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
    ap.add_argument("--clahe", action="store_true")
    args = ap.parse_args()

    import cv2
    import numpy as np

    from orbslam3_byzyh_tpu.io import euroc, settings, trajectory
    from orbslam3_byzyh_tpu.native import ImagePrefetcher
    from orbslam3_byzyh_tpu.pipeline.inertial_system import (ImuConfig,
                                                             MonoInertialSlam)
    from orbslam3_byzyh_tpu.pipeline.system import SlamConfig
    from orbslam3_byzyh_tpu.utils.timers import StageTimers

    cfg_yaml = settings.load_settings(args.settings)
    if cfg_yaml.imu is None:
        raise SystemExit("settings file has no IMU block")

    voc = None
    if args.no_vocabulary:
        args.vocabulary = None
    if args.vocabulary:
        from orbslam3_byzyh_tpu.ops import bow
        voc = bow.load_vocabulary(args.vocabulary)

    cam = cfg_yaml.cam1
    kb8 = cam.params[4:8] if cam.model == "KannalaBrandt8" else None
    cfg = SlamConfig(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height,
        dist=cam.dist, kb8=kb8,
        n_features=cfg_yaml.orb.n_features,
        fps=cfg_yaml.fps or 20.0,
        vocabulary=voc,
        use_loop_closing=not args.no_loop_closing,
        max_kf=args.max_kf, max_lm=args.max_lm,
        min_init_matches=args.min_init_matches)
    imu_cfg = ImuConfig(
        T_bc=np.asarray(cfg_yaml.imu.Tbc, np.float32),
        gyro_noise=cfg_yaml.imu.noise_gyro, acc_noise=cfg_yaml.imu.noise_acc,
        gyro_walk=cfg_yaml.imu.walk_gyro, acc_walk=cfg_yaml.imu.walk_acc,
        freq=cfg_yaml.imu.frequency)
    slam = MonoInertialSlam(cfg, imu_cfg)
    timers = StageTimers()
    # Per-stage REGISTER_TIMES taxonomy: the system's
    # internal stages record into the same report.
    slam.timers = timers
    clahe = cv2.createCLAHE(3.0, (8, 8)) if args.clahe else None

    # Multi-sequence = multi-session Atlas runs (SLAM.ChangeDataset()
    # between sequences, mono_inertial_euroc.cc multi-arg pattern).
    n_total = 0
    fcount = 0
    t_start = time.perf_counter()
    for si, seq_dir in enumerate(args.sequence):
        if si > 0:
            slam.change_dataset()
        ts_file = (args.timestamps[si] if args.timestamps
                   and si < len(args.timestamps) else None)
        seq = euroc.load_euroc(seq_dir, ts_file)
        if seq.imu_stamps is None:
            raise SystemExit(f"{seq_dir} has no mav0/imu0/data.csv")
        n_frames = len(seq) if args.max_frames is None else min(
            len(seq), args.max_frames)
        n_total += n_frames
        pf = ImagePrefetcher(seq.image_paths[:n_frames])
        t_prev = None
        for idx, img in pf:
            t = float(seq.stamps[idx])
            if clahe is not None:
                img = clahe.apply(img.astype(np.uint8)).astype(np.float32)
            imu_data = (seq.imu_between(t_prev, t)
                        if t_prev is not None else None)
            with timers.time("total_track"):
                slam.track(img, t, imu_data)
            t_prev = t
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
          f"landmarks={slam.n_lm} maps={len(slam.atlas.maps)} "
          f"imu_ready={slam.imu_ready}")
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


if __name__ == "__main__":
    main()
