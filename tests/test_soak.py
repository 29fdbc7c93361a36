"""Long-sequence stereo-inertial soak with loop closure (VERDICT r3 #7).

Thin pytest wrapper over scripts/soak_stereo_inertial.py — the >=180 s
orbit sequence with flat-latency / loop-closed / ATE gates. Tens of minutes
on a CPU host, so it lives in the ``soak`` tier (run with ``-m soak``).
"""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.soak

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_soak_stereo_inertial(tmp_path):
    out = tmp_path / "soak.json"
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_COMPILATION_CACHE_DIR=os.path.join(REPO, ".jax_cache"))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "soak_stereo_inertial.py"),
         "--duration", "180", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=3 * 3600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert rep["imu_ready"]
    assert rep["loops_closed"] >= 1 or rep["merges_closed"] >= 1
    assert rep["kf_latency_flat"]
    assert rep["ate_rmse_m"] < 0.3
