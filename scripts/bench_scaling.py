#!/usr/bin/env python3
"""Distributed-BA scaling benchmark over a virtual (or real) device mesh.

Measures the PRODUCTION full-map BA entry point
(pipeline.mapping.global_ba -> parallel.dist_ba.dist_bundle_adjust) at mesh
sizes 1..N on one fixed, realistically-sized problem (strong scaling), and
prints one JSON line per mesh size plus a summary line with the scaling
efficiency:

    efficiency(N) = T(1) / (N * T(N))          — ideal machine
    efficiency_vs_cores(N) = T(1) / (min(N, C) * T(N))

On this environment's virtual CPU mesh the N logical devices share C=2
physical cores, so ideal-machine efficiency is bounded by C/N; the
``efficiency_vs_cores`` number is the honest figure there (the per-shard
compute split is real, the extra silicon is not). On a mesh of real GPUs
the two numbers coincide.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python scripts/bench_scaling.py [--devices 1 2 4 8] [--iters 3]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--n-kf", type=int, default=96)
    ap.add_argument("--n-lm", type=int, default=16384)
    ap.add_argument("--n-obs", type=int, default=8)
    args = ap.parse_args()

    import jax

    from orbslam3_byzyh_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import numpy as np

    from orbslam3_byzyh_tpu import graft
    from orbslam3_byzyh_tpu.parallel import dist_ba
    from orbslam3_byzyh_tpu.pipeline import mapping

    n_avail = jax.device_count()
    sizes = args.devices or [n for n in (1, 2, 4, 8) if n <= n_avail]
    try:
        n_cores = len(os.sched_getaffinity(0))
    except AttributeError:
        n_cores = os.cpu_count() or 1
    on_cpu = jax.devices()[0].platform == "cpu"

    prob = graft.make_tiny_ba_problem(
        n_kf=args.n_kf, n_lm=args.n_lm, n_obs=args.n_obs)

    times = {}
    for n in sizes:
        mesh = dist_ba.make_mesh(n)
        p = dist_ba.shard_problem(prob, mesh)
        res = dist_ba.dist_bundle_adjust(p, mesh)   # compile + warm
        jax.block_until_ready(res.cost)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            res = dist_ba.dist_bundle_adjust(p, mesh)
            jax.block_until_ready(res.cost)
        dt = (time.perf_counter() - t0) / args.iters
        times[n] = dt
        print(json.dumps({
            "metric": "dist_ba_time", "devices": n,
            "value": round(dt * 1e3, 2), "unit": "ms",
            "n_kf": args.n_kf, "n_lm": args.n_lm, "cost": float(res.cost)}))

    n_max = sizes[-1]
    t1, tn = times[sizes[0]], times[n_max]
    eff = t1 / (n_max * tn)
    eff_cores = t1 / (min(n_max, n_cores) * tn)
    print(json.dumps({
        "metric": "dist_ba_scaling_efficiency", "devices": n_max,
        "value": round(eff_cores if on_cpu else eff, 3),
        "unit": "fraction",
        "efficiency_ideal_machine": round(eff, 3),
        "efficiency_vs_physical_cores": round(eff_cores, 3),
        "physical_cores": n_cores, "platform": jax.devices()[0].platform,
        "vs_baseline": round((eff_cores if on_cpu else eff) / 0.7, 3)}))


if __name__ == "__main__":
    main()
