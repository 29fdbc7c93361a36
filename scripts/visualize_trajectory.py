#!/usr/bin/env python3
"""Trajectory visualization (fork tooling parity).

Replaces /root/reference/Scripts/Output_Process/visualize_trajectory.py:
reads TUM-format trajectories (f_*.txt / kf_*.txt), renders 2D top-down and
3D views plus per-axis position curves to PNG/PDF.

Usage:
  python scripts/visualize_trajectory.py f_output.txt [kf_output.txt] \
      [--out trajectory_visualization_output]
"""

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def load_tum(path):
    d = np.loadtxt(path)
    if d.ndim == 1:
        d = d[None]
    return d[:, 0], d[:, 1:4], d[:, 4:8]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trajectory")
    ap.add_argument("keyframes", nargs="?", default=None)
    ap.add_argument("--out", default="trajectory_visualization_output")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    t, p, q = load_tum(args.trajectory)
    kf = load_tum(args.keyframes) if args.keyframes else None

    # 2D top-down (x-z like the reference's camera-frame plots).
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    pairs = [(0, 2, "x", "z"), (0, 1, "x", "y"), (2, 1, "z", "y")]
    for ax, (i, j, ni, nj) in zip(axes, pairs):
        ax.plot(p[:, i], p[:, j], "b-", lw=0.8, label="frames")
        if kf is not None:
            ax.plot(kf[1][:, i], kf[1][:, j], "r.", ms=4, label="keyframes")
        ax.set_xlabel(ni)
        ax.set_ylabel(nj)
        ax.axis("equal")
        ax.legend()
    fig.suptitle("Trajectory (2D projections)")
    fig.savefig(os.path.join(args.out, "trajectory_2d.png"), dpi=120)

    # 3D view.
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    ax.plot(p[:, 0], p[:, 1], p[:, 2], "b-", lw=0.8)
    if kf is not None:
        ax.scatter(kf[1][:, 0], kf[1][:, 1], kf[1][:, 2], c="r", s=8)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.savefig(os.path.join(args.out, "trajectory_3d.png"), dpi=120)

    # Per-axis curves over time.
    t_rel = (t - t[0]) / (1e9 if t.max() > 1e12 else 1.0)
    fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    for k, name in enumerate("xyz"):
        axes[k].plot(t_rel, p[:, k], lw=0.8)
        axes[k].set_ylabel(name + " (m)")
    axes[2].set_xlabel("time (s)")
    fig.suptitle("Position vs time")
    fig.savefig(os.path.join(args.out, "position_time.png"), dpi=120)
    print(f"wrote plots to {args.out}/")


if __name__ == "__main__":
    main()
