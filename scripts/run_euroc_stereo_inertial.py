#!/usr/bin/env python3
"""Stereo(-inertial) EuRoC runner — the reference's flagship benchmark
configuration (euroc_eval_examples.sh stereo + stereo-inertial rows).

Usage:
  python scripts/run_euroc_stereo_inertial.py <settings.yaml> <sequence_dir> \
      [--timestamps FILE] [--output-name NAME] [--no-imu] [--max-frames N]

Replaces /root/reference/Examples/Stereo-Inertial/stereo_inertial_euroc.cc
(and stereo_euroc.cc with --no-imu): rectifies the stereo pair from
Stereo.T_c1_c2, feeds per-frame IMU batches, writes f_/kf_ trajectories.
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
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write map_NNNN.png every N frames (offline viewer)")
    ap.add_argument("--localization-after", type=int, default=0,
                    help="freeze the map after N frames (localization mode)")
    args = ap.parse_args()

    import numpy as np

    from orbslam3_byzyh_tpu.io import euroc, rectify, settings, trajectory
    from orbslam3_byzyh_tpu.pipeline.inertial_system import ImuConfig
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import StereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import (StereoConfig,
                                                           StereoSlam)
    from orbslam3_byzyh_tpu.utils.timers import StageTimers

    cfg_yaml = settings.load_settings(args.settings)
    if cfg_yaml.cam2 is None or cfg_yaml.Tlr is None:
        raise SystemExit("settings file lacks camera2 / Stereo.T_c1_c2")
    first_seq = euroc.load_euroc(args.sequence[0],
                                 args.timestamps[0] if args.timestamps
                                 else None)

    rig = rectify.build_rectification(cfg_yaml.cam1, cfg_yaml.cam2,
                                      cfg_yaml.Tlr)

    voc = None
    if args.no_vocabulary:
        args.vocabulary = None
    if args.vocabulary:
        from orbslam3_byzyh_tpu.ops import bow
        voc = bow.load_vocabulary(args.vocabulary)

    cfg = StereoConfig(
        fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy,
        width=cfg_yaml.cam1.width, height=cfg_yaml.cam1.height,
        n_features=cfg_yaml.orb.n_features,
        fps=cfg_yaml.fps or 20.0,
        vocabulary=voc,
        use_loop_closing=not args.no_loop_closing,
        max_kf=args.max_kf, max_lm=args.max_lm,
        bf=rig.bf, th_depth=cfg_yaml.th_depth or 35.0)

    use_imu = (not args.no_imu and cfg_yaml.imu is not None
               and first_seq.imu_stamps is not None)
    if use_imu:
        imu_cfg = ImuConfig(
            T_bc=np.asarray(cfg_yaml.imu.Tbc, np.float32),
            gyro_noise=cfg_yaml.imu.noise_gyro,
            acc_noise=cfg_yaml.imu.noise_acc,
            gyro_walk=cfg_yaml.imu.walk_gyro,
            acc_walk=cfg_yaml.imu.walk_acc,
            freq=cfg_yaml.imu.frequency)
        slam = StereoInertialSlam(cfg, imu_cfg)
    else:
        slam = StereoSlam(cfg)

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
        seq_l = euroc.load_euroc(seq_dir, ts_file, cam="cam0")
        seq_r = euroc.load_euroc(seq_dir, ts_file, cam="cam1")
        n_frames = len(seq_l) if args.max_frames is None else min(
            len(seq_l), args.max_frames)
        n_total += n_frames
        t_prev = None
        for idx in range(n_frames):
            t = float(seq_l.stamps[idx])
            img_l = seq_l.read_image(idx)
            img_r = seq_r.read_image(idx)
            img_l, img_r = rig.rectify(img_l, img_r)
            with timers.time("total_track"):
                if use_imu:
                    imu_data = (seq_l.imu_between(t_prev, t)
                                if t_prev is not None else None)
                    slam.track(img_l, img_r, t, imu_data)
                else:
                    slam.track(img_l, img_r, t)
            t_prev = t
            fcount += 1
            if args.localization_after and fcount == args.localization_after:
                slam.activate_localization_mode()
            if args.snapshot_every and fcount % args.snapshot_every == 0:
                from orbslam3_byzyh_tpu.utils import viewer
                viewer.snapshot(slam, f"map_{fcount:05d}.png")

    wall = time.perf_counter() - t_start

    print(f"tracked {len(slam.trajectory)}/{n_total} frames in {wall:.1f}s "
          f"({n_total / wall:.1f} fps); keyframes={slam.n_kf} "
          f"landmarks={slam.n_lm} maps={len(slam.atlas.maps)}"
          + (f" imu_ready={slam.imu_ready}" if use_imu else ""))
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
