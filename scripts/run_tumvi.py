#!/usr/bin/env python3
"""TUM-VI runner: mono-inertial and (fisheye) stereo-inertial on the
512x512 Kannala-Brandt rig.

Usage:
  python scripts/run_tumvi.py <TUM_512.yaml> <sequence_dir...> \
      [--timestamps FILE...] [--stereo] [--no-imu] [--output-name NAME] \
      [--max-frames N] [--vocabulary VOC]

Replaces /root/reference/Examples/Monocular-Inertial/mono_inertial_tum_vi.cc
and Examples/Stereo-Inertial/stereo_inertial_tum_vi.cc: CLAHE-equalized
512x512 input (clipLimit=3.0, tiles 8x8 — the TUM-VI mains apply it before
TrackMonocular), KB8 cameras end-to-end, per-frame IMU batches, f_/kf_
trajectory output in TUM format (ns stamps) for evaluate_ate_scale.py.
TUM-VI sequences use the EuRoC directory layout (mav0/cam0/data + data.csv),
so the EuRoC reader handles them.
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
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)
    ap.add_argument("--output-name", default="tumvi")
    ap.add_argument("--vocabulary", default=_default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--no-clahe", action="store_true")
    args = ap.parse_args()

    import cv2
    import numpy as np

    from orbslam3_byzyh_tpu.io import euroc, settings, trajectory
    from orbslam3_byzyh_tpu.pipeline.inertial_system import (ImuConfig,
                                                             MonoInertialSlam)
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import \
        FisheyeStereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import (FisheyeStereoConfig,
                                                           FisheyeStereoSlam)
    from orbslam3_byzyh_tpu.pipeline.system import MonoSlam, SlamConfig
    from orbslam3_byzyh_tpu.utils.timers import StageTimers

    cfg_yaml = settings.load_settings(args.settings)
    cam1 = cfg_yaml.cam1
    kb8_1 = (cam1.params[4:8] if cam1.model == "KannalaBrandt8" else None)

    voc = None
    if args.no_vocabulary:
        args.vocabulary = None
    if args.vocabulary:
        from orbslam3_byzyh_tpu.ops import bow
        voc = bow.load_vocabulary(args.vocabulary)

    common = dict(
        fx=float(cam1.params[0]), fy=float(cam1.params[1]),
        cx=float(cam1.params[2]), cy=float(cam1.params[3]),
        width=cam1.width, height=cam1.height,
        kb8=kb8_1,
        n_features=cfg_yaml.orb.n_features,
        fps=cfg_yaml.fps or 20.0,
        vocabulary=voc,
        max_kf=args.max_kf, max_lm=args.max_lm,
        use_loop_closing=not args.no_loop_closing)
    use_imu = not args.no_imu and cfg_yaml.imu is not None
    imu_cfg = None
    if use_imu:
        imu_cfg = ImuConfig(
            T_bc=np.asarray(cfg_yaml.imu.Tbc, np.float32),
            gyro_noise=cfg_yaml.imu.noise_gyro,
            acc_noise=cfg_yaml.imu.noise_acc,
            gyro_walk=cfg_yaml.imu.walk_gyro,
            acc_walk=cfg_yaml.imu.walk_acc,
            freq=cfg_yaml.imu.frequency)

    if args.stereo:
        cam2 = cfg_yaml.cam2
        if cam2 is None or cfg_yaml.Tlr is None:
            raise SystemExit("stereo requested but settings lack "
                             "Camera2 / Stereo.T_c1_c2")
        Tlr = np.asarray(cfg_yaml.Tlr, np.float64)   # x_c1 = Tlr x_c2
        R_rl = Tlr[:3, :3].T.astype(np.float32)
        t_rl = (-Tlr[:3, :3].T @ Tlr[:3, 3]).astype(np.float32)
        cfg = FisheyeStereoConfig(
            **common,
            cam2=cam2.params[:4].astype(np.float32),
            kb8_2=(cam2.params[4:8]
                   if cam2.model == "KannalaBrandt8" else None),
            dist2=cam2.dist,
            R_rl=R_rl, t_rl=t_rl,
            bf=float(np.linalg.norm(Tlr[:3, 3]) * cam1.params[0]),
            th_depth=cfg_yaml.th_depth or 35.0)
        slam = (FisheyeStereoInertialSlam(cfg, imu_cfg) if use_imu
                else FisheyeStereoSlam(cfg))
    else:
        cfg = SlamConfig(**common)
        slam = MonoInertialSlam(cfg, imu_cfg) if use_imu else MonoSlam(cfg)

    clahe = None if args.no_clahe else cv2.createCLAHE(3.0, (8, 8))

    def prep(img):
        if clahe is not None:
            img = clahe.apply(img.astype(np.uint8)).astype(np.float32)
        return img

    timers = StageTimers()
    # Per-stage REGISTER_TIMES taxonomy: the system's
    # internal stages record into the same report.
    slam.timers = timers
    n_total = 0
    t_start = time.perf_counter()
    for si, seq_dir in enumerate(args.sequence):
        if si > 0:
            slam.change_dataset()
        ts_file = (args.timestamps[si] if args.timestamps
                   and si < len(args.timestamps) else None)
        seq_l = euroc.load_euroc(seq_dir, ts_file, cam="cam0")
        seq_r = (euroc.load_euroc(seq_dir, ts_file, cam="cam1")
                 if args.stereo else None)
        n_frames = len(seq_l) if args.max_frames is None else min(
            len(seq_l), args.max_frames)
        n_total += n_frames
        t_prev = None
        for idx in range(n_frames):
            t = float(seq_l.stamps[idx])
            img_l = prep(seq_l.read_image(idx))
            imu_data = (seq_l.imu_between(t_prev, t)
                        if use_imu and t_prev is not None else None)
            with timers.time("total_track"):
                if args.stereo:
                    img_r = prep(seq_r.read_image(idx))
                    if use_imu:
                        slam.track(img_l, img_r, t, imu_data)
                    else:
                        slam.track(img_l, img_r, t)
                else:
                    if use_imu:
                        slam.track(img_l, t, imu_data)
                    else:
                        slam.track(img_l, t)
            t_prev = t
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
