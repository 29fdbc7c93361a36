#!/usr/bin/env python3
"""Generate the committed golden regression fixtures (tests/golden/).

The reference ships demo trajectories usable as format/behaviour oracles
(/root/reference/f_dataset-Basler_mono_final_23.txt, 977 poses + 34 KFs).
This script produces the repo's equivalents from the FROZEN golden config:
MonoSlam on SynthWorld(seed=3), 45 frames @10 fps, 1536 features — writing

  tests/golden/f_golden_mono.txt   (per-frame TUM lines, ns stamps)
  tests/golden/kf_golden_mono.txt  (keyframe TUM lines)
  tests/golden/golden_mono.json    (run metrics: n_kf, n_lm, ATE vs GT)

tests/test_golden.py replays the same config and gates against these.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))


def main():
    import numpy as np

    from orbslam3_byzyh_tpu.io import trajectory
    from orbslam3_byzyh_tpu.pipeline.system import MonoSlam, SlamConfig
    from orbslam3_byzyh_tpu.utils import evaluate
    from synth_world import SynthWorld

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "tests", "golden")
    os.makedirs(out_dir, exist_ok=True)

    world = SynthWorld(seed=3)
    cfg = SlamConfig(
        kf_ref_min_obs=1,  # quantized world: dense-KF cadence
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
                     width=world.w, height=world.h,
                     n_features=1536, max_kf=48, max_lm=4096, max_obs=8,
                     fps=10, min_init_matches=60)
    slam = MonoSlam(cfg)
    stamps_in = np.arange(0, 4.5, 0.1)
    for t in stamps_in:
        slam.track(world.render(t), float(t))

    traj = slam.trajectory
    stamps = [s for s, _, _ in traj]
    Rs = [R for _, R, _ in traj]
    ts = [t for _, _, t in traj]
    trajectory.save_tum(os.path.join(out_dir, "f_golden_mono.txt"),
                        stamps, Rs, ts, stamp_scale=1e9)
    ks, kR, kt = slam.keyframe_trajectory()
    trajectory.save_tum(os.path.join(out_dir, "kf_golden_mono.txt"),
                        ks, kR, kt, stamp_scale=1e9)

    est_c = evaluate.camera_centers(np.stack(Rs), np.stack(ts))
    gt_c = np.stack([
        -world.pose(float(s))[0].T @ world.pose(float(s))[1]
        for s in stamps])
    _, _, _, rmse = evaluate.horn_align(est_c, gt_c, with_scale=True)
    meta = dict(n_frames=len(traj), n_kf_slots=int(slam.n_kf),
                n_kf_live=int(len(ks)),
                n_lm_live=int(np.asarray(slam.state.lms.valid).sum()),
                ate_scaled_rmse_m=round(float(rmse), 4),
                config="MonoSlam seed=3 45f@10fps 1536feat (frozen)")
    with open(os.path.join(out_dir, "golden_mono.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
