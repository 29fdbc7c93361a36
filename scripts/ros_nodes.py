#!/usr/bin/env python3
"""ROS wrapper nodes for the SLAM engine.

Parity with the reference's optional ROS examples
(/root/reference/Examples/ROS/ORB_SLAM3/src/{ros_mono,ros_mono_inertial,
ros_stereo,ros_stereo_inertial,ros_rgbd}.cc): each node subscribes to the
sensor topics, feeds the matching pipeline facade per frame, and publishes
the camera pose. ROS is optional hardware/integration support and is not
part of this environment — the module degrades to a clear error without
rospy installed.

Usage:
  python scripts/ros_nodes.py mono <settings.yaml> [--image-topic T]
  python scripts/ros_nodes.py mono_inertial <settings.yaml> [--imu-topic T]
  python scripts/ros_nodes.py stereo <settings.yaml>
  python scripts/ros_nodes.py stereo_inertial <settings.yaml>
  python scripts/ros_nodes.py rgbd <settings.yaml>
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def build_slam(mode, cfg_yaml):
    import numpy as np

    from orbslam3_byzyh_tpu.pipeline.inertial_system import (ImuConfig,
                                                             MonoInertialSlam)
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import StereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import (RgbdConfig,
                                                           RgbdSlam,
                                                           StereoConfig,
                                                           StereoSlam)
    from orbslam3_byzyh_tpu.pipeline.system import MonoSlam, SlamConfig

    cam = cfg_yaml.cam1
    common = dict(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height, dist=cam.dist,
        kb8=(cam.params[4:8] if cam.model == "KannalaBrandt8" else None),
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 30.0)
    imu_cfg = None
    if cfg_yaml.imu is not None:
        imu_cfg = ImuConfig(
            T_bc=np.asarray(cfg_yaml.imu.Tbc, np.float32),
            gyro_noise=cfg_yaml.imu.noise_gyro,
            acc_noise=cfg_yaml.imu.noise_acc,
            gyro_walk=cfg_yaml.imu.walk_gyro,
            acc_walk=cfg_yaml.imu.walk_acc,
            freq=cfg_yaml.imu.frequency)
    if mode == "mono":
        return MonoSlam(SlamConfig(**common))
    if mode == "mono_inertial":
        return MonoInertialSlam(SlamConfig(**common), imu_cfg)
    scfg = dict(common, bf=cfg_yaml.bf or 40.0,
                th_depth=cfg_yaml.th_depth or 35.0)
    if mode == "stereo":
        return StereoSlam(StereoConfig(**scfg))
    if mode == "stereo_inertial":
        return StereoInertialSlam(StereoConfig(**scfg), imu_cfg)
    if mode == "rgbd":
        return RgbdSlam(RgbdConfig(**scfg))
    raise SystemExit(f"unknown mode {mode}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["mono", "mono_inertial", "stereo",
                                     "stereo_inertial", "rgbd"])
    ap.add_argument("settings")
    ap.add_argument("--image-topic", default="/camera/image_raw")
    ap.add_argument("--right-topic", default="/camera/right/image_raw")
    ap.add_argument("--depth-topic", default="/camera/depth_registered/image_raw")
    ap.add_argument("--imu-topic", default="/imu")
    ap.add_argument("--pose-topic", default="/orbslam3_tpu/pose")
    args = ap.parse_args()

    try:
        import rospy
        from cv_bridge import CvBridge
        from geometry_msgs.msg import PoseStamped
        from sensor_msgs.msg import Image, Imu
    except ImportError:
        sys.exit("rospy/cv_bridge not installed — ROS nodes need a ROS "
                 "environment (the reference gates its ROS examples the "
                 "same way); use the dataset runners instead")

    import numpy as np

    from orbslam3_byzyh_tpu.io import settings

    cfg_yaml = settings.load_settings(args.settings)
    slam = build_slam(args.mode, cfg_yaml)
    bridge = CvBridge()
    rospy.init_node(f"orbslam3_tpu_{args.mode}")
    pose_pub = rospy.Publisher(args.pose_topic, PoseStamped, queue_size=10)

    imu_buf = []

    def on_imu(msg):
        imu_buf.append((
            msg.header.stamp.to_sec(),
            [msg.angular_velocity.x, msg.angular_velocity.y,
             msg.angular_velocity.z],
            [msg.linear_acceleration.x, msg.linear_acceleration.y,
             msg.linear_acceleration.z]))

    def drain_imu(t1):
        batch = [s for s in imu_buf if s[0] <= t1]
        del imu_buf[:len(batch)]
        if not batch:
            return None
        ts = np.array([s[0] for s in batch])
        g = np.array([s[1] for s in batch], np.float32)
        a = np.array([s[2] for s in batch], np.float32)
        return ts, g, a

    def publish(pose, stamp):
        if pose is None:
            return
        from scipy.spatial.transform import Rotation
        R, t = np.asarray(pose[0]), np.asarray(pose[1])
        c = -R.T @ t
        q = Rotation.from_matrix(R.T).as_quat()
        msg = PoseStamped()
        msg.header.stamp = stamp
        msg.header.frame_id = "world"
        msg.pose.position.x, msg.pose.position.y, msg.pose.position.z = c
        (msg.pose.orientation.x, msg.pose.orientation.y,
         msg.pose.orientation.z, msg.pose.orientation.w) = q
        pose_pub.publish(msg)

    def to_gray(msg):
        img = bridge.imgmsg_to_cv2(msg, desired_encoding="mono8")
        return img.astype(np.float32)

    if args.mode in ("mono", "mono_inertial"):
        use_imu = args.mode == "mono_inertial"
        if use_imu:
            rospy.Subscriber(args.imu_topic, Imu, on_imu, queue_size=1000)

        def on_image(msg):
            t = msg.header.stamp.to_sec()
            img = to_gray(msg)
            if use_imu:
                pose = slam.track(img, t, drain_imu(t))
            else:
                pose = slam.track(img, t)
            publish(pose, msg.header.stamp)

        rospy.Subscriber(args.image_topic, Image, on_image, queue_size=5)
    elif args.mode == "rgbd":
        import message_filters
        subs = [message_filters.Subscriber(args.image_topic, Image),
                message_filters.Subscriber(args.depth_topic, Image)]
        sync = message_filters.ApproximateTimeSynchronizer(subs, 5, 0.02)

        def on_pair(img_msg, depth_msg):
            t = img_msg.header.stamp.to_sec()
            depth = bridge.imgmsg_to_cv2(depth_msg).astype(np.float32)
            publish(slam.track(to_gray(img_msg), depth, t),
                    img_msg.header.stamp)

        sync.registerCallback(on_pair)
    else:   # stereo / stereo_inertial
        import message_filters
        use_imu = args.mode == "stereo_inertial"
        if use_imu:
            rospy.Subscriber(args.imu_topic, Imu, on_imu, queue_size=1000)
        subs = [message_filters.Subscriber(args.image_topic, Image),
                message_filters.Subscriber(args.right_topic, Image)]
        sync = message_filters.ApproximateTimeSynchronizer(subs, 5, 0.02)

        def on_pair(l_msg, r_msg):
            t = l_msg.header.stamp.to_sec()
            if use_imu:
                pose = slam.track(to_gray(l_msg), to_gray(r_msg), t,
                                  drain_imu(t))
            else:
                pose = slam.track(to_gray(l_msg), to_gray(r_msg), t)
            publish(pose, l_msg.header.stamp)

        sync.registerCallback(on_pair)

    rospy.spin()


if __name__ == "__main__":
    main()
