#!/usr/bin/env python3
"""Trajectory statistics (fork tooling parity).

Replaces /root/reference/Scripts/Output_Process/trajectory_info.py: prints
length, duration, velocity statistics, bounding box and frame-rate info for a
TUM-format trajectory.
"""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trajectory")
    args = ap.parse_args()
    d = np.loadtxt(args.trajectory)
    if d.ndim == 1:
        d = d[None]
    t = d[:, 0]
    if t.max() > 1e12:
        t = t / 1e9
    p = d[:, 1:4]

    seg = np.linalg.norm(np.diff(p, axis=0), axis=-1)
    dt = np.diff(t)
    dt_safe = np.where(dt > 0, dt, np.nan)
    vel = seg / dt_safe

    print(f"poses:            {len(p)}")
    print(f"duration:         {t[-1] - t[0]:.2f} s")
    print(f"path length:      {seg.sum():.3f} m")
    print(f"mean frame rate:  {1.0 / np.nanmean(dt_safe):.2f} Hz")
    print(f"velocity mean:    {np.nanmean(vel):.3f} m/s")
    print(f"velocity max:     {np.nanmax(vel):.3f} m/s")
    lo, hi = p.min(0), p.max(0)
    print(f"bbox min:         {lo}")
    print(f"bbox max:         {hi}")
    print(f"bbox size:        {hi - lo}")


if __name__ == "__main__":
    main()
