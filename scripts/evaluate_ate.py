#!/usr/bin/env python3
"""ATE evaluation CLI (evaluate_ate_scale.py compatible).

Replaces /root/reference/evaluation/evaluate_ate_scale.py: associates an
estimated TUM trajectory with ground truth by timestamp, Horn-aligns (with
and without scale) and reports RMSE. Accepts the same file formats (including
the in-repo EuRoC left-camera ground truth files).

Usage:
  python scripts/evaluate_ate.py GT.txt f_estimate.txt \
      [--max-difference 20000000] [--plot out.png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from orbslam3_byzyh_tpu.utils import evaluate


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            rows.append([float(x) for x in parts[:8]])
    d = np.asarray(rows)
    return d[:, 0], d[:, 1:4]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ground_truth")
    ap.add_argument("estimate")
    ap.add_argument("--max-difference", type=float, default=20000000,
                    help="association window (same unit as the stamps; "
                         "default 2e7 = 20 ms in ns, like the reference)")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args()

    gt_t, gt_p = load(args.ground_truth)
    est_t, est_p = load(args.estimate)

    rmse_scaled, n = evaluate.ate_rmse(est_t, est_p, gt_t, gt_p,
                                       max_dt=args.max_difference,
                                       with_scale=True)
    rmse_raw, _ = evaluate.ate_rmse(est_t, est_p, gt_t, gt_p,
                                    max_dt=args.max_difference,
                                    with_scale=False)
    print(f"compared_pose_pairs {n} pairs")
    print(f"absolute_translational_error.rmse {rmse_raw:.6f} m")
    print(f"absolute_translational_error.rmse_scaled {rmse_scaled:.6f} m")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 7))
        ax.plot(gt_p[:, 0], gt_p[:, 1], "k-", lw=0.8, label="ground truth")
        ax.plot(est_p[:, 0], est_p[:, 1], "b-", lw=0.8, label="estimate")
        ax.legend(); ax.axis("equal")
        fig.savefig(args.plot, dpi=120)


if __name__ == "__main__":
    main()
