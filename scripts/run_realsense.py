#!/usr/bin/env python3
"""Live RealSense D435i / T265 capture runner.

Parity with the reference's optional RealSense mains
(/root/reference/Examples/*/{mono,stereo,rgbd}*_realsense_D435i.cc,
*_realsense_t265.cc — gated on librealsense2 exactly like this script is
gated on pyrealsense2): configures the device streams, feeds frames (+IMU
for the inertial modes) to the matching pipeline facade, and writes f_/kf_
trajectories on exit.

Usage:
  python scripts/run_realsense.py <mode> <settings.yaml> \
      [--duration SEC] [--output-name NAME]
  mode: mono | mono_inertial | stereo | stereo_inertial | rgbd
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["mono", "mono_inertial", "stereo",
                                     "stereo_inertial", "rgbd"])
    ap.add_argument("settings")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--output-name", default="realsense")
    args = ap.parse_args()

    try:
        import pyrealsense2 as rs
    except ImportError:
        sys.exit("pyrealsense2 not installed — live capture needs RealSense "
                 "hardware + SDK (the reference gates its RealSense mains "
                 "on librealsense2 the same way); use the dataset runners "
                 "or scripts/grab_data.py --fake instead")

    import numpy as np

    from orbslam3_byzyh_tpu.io import settings, trajectory
    from ros_nodes import build_slam

    cfg_yaml = settings.load_settings(args.settings)
    slam = build_slam(args.mode, cfg_yaml)
    use_imu = args.mode.endswith("inertial")

    pipe = rs.pipeline()
    cfg = rs.config()
    cam = cfg_yaml.cam1
    if args.mode == "rgbd":
        cfg.enable_stream(rs.stream.color, cam.width, cam.height,
                          rs.format.y8, int(cfg_yaml.fps or 30))
        cfg.enable_stream(rs.stream.depth, cam.width, cam.height,
                          rs.format.z16, int(cfg_yaml.fps or 30))
    else:
        cfg.enable_stream(rs.stream.infrared, 1, cam.width, cam.height,
                          rs.format.y8, int(cfg_yaml.fps or 30))
        if args.mode.startswith("stereo"):
            cfg.enable_stream(rs.stream.infrared, 2, cam.width, cam.height,
                              rs.format.y8, int(cfg_yaml.fps or 30))
    if use_imu:
        cfg.enable_stream(rs.stream.gyro, rs.format.motion_xyz32f, 200)
        cfg.enable_stream(rs.stream.accel, rs.format.motion_xyz32f, 250)

    imu_buf = []

    def imu_cb(frame):
        if frame.is_motion_frame():
            m = frame.as_motion_frame()
            kind = frame.get_profile().stream_type()
            imu_buf.append((frame.get_timestamp() / 1e3, kind,
                            (m.get_motion_data().x, m.get_motion_data().y,
                             m.get_motion_data().z)))

    pipe.start(cfg, imu_cb if use_imu else None)
    t_end = time.time() + args.duration
    try:
        while time.time() < t_end:
            frames = pipe.wait_for_frames()
            t = frames.get_timestamp() / 1e3
            if args.mode == "rgbd":
                img = np.asanyarray(
                    frames.get_color_frame().get_data()).astype(np.float32)
                depth = np.asanyarray(
                    frames.get_depth_frame().get_data()).astype(np.float32)
                depth *= frames.get_depth_frame().get_units()
                slam.track(img, depth, t)
                continue
            ir1 = np.asanyarray(
                frames.get_infrared_frame(1).get_data()).astype(np.float32)
            imu_data = None
            if use_imu:
                # Pair gyro/accel samples up to t (nearest-accel per gyro).
                gy = [(s[0], s[2]) for s in imu_buf
                      if s[1] == rs.stream.gyro and s[0] <= t]
                ac = [(s[0], s[2]) for s in imu_buf
                      if s[1] == rs.stream.accel and s[0] <= t]
                del imu_buf[:len(gy) + len(ac)]
                if gy and ac:
                    ats = np.array([a[0] for a in ac])
                    avs = np.array([a[1] for a in ac], np.float32)
                    ts = np.array([g[0] for g in gy])
                    gv = np.array([g[1] for g in gy], np.float32)
                    nearest = np.searchsorted(ats, ts).clip(0, len(ac) - 1)
                    imu_data = (ts, gv, avs[nearest])
            if args.mode.startswith("stereo"):
                ir2 = np.asanyarray(
                    frames.get_infrared_frame(2).get_data()).astype(
                        np.float32)
                if use_imu:
                    slam.track(ir1, ir2, t, imu_data)
                else:
                    slam.track(ir1, ir2, t)
            else:
                if use_imu:
                    slam.track(ir1, t, imu_data)
                else:
                    slam.track(ir1, t)
    finally:
        pipe.stop()

    stamps = [s + slam.t0 for s, _, _ in slam.trajectory]
    Rs = [R for _, R, _ in slam.trajectory]
    ts = [t for _, _, t in slam.trajectory]
    trajectory.save_tum(f"f_{args.output_name}.txt", stamps, Rs, ts,
                        stamp_scale=1e9)
    ks, kR, kt = slam.keyframe_trajectory()
    trajectory.save_tum(f"kf_{args.output_name}.txt", ks, kR, kt,
                        stamp_scale=1e9)
    print(f"tracked {len(slam.trajectory)} frames; keyframes={slam.n_kf}")


if __name__ == "__main__":
    main()
