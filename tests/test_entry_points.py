"""Entry-point plumbing: compile-cache location, the GPU smoke script's
refusal to run elsewhere, and no module tied to another accelerator."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest

from orbslam3_byzyh_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", [None, "/some/cache"],
                         ids=["env_unset", "env_set"])
def test_compile_cache_dir(monkeypatch, restore_cache_dir, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.enable_compile_cache() == str(
            REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(
            REPO / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert compile_cache.enable_compile_cache() == env_dir
        # JAX reads the variable itself; nothing is configured in code.
        assert jax.config.jax_compilation_cache_dir == before


def test_chip_smoke_needs_a_gpu(tmp_path):
    """On a CPU device the smoke run fails, names the missing GPU and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert "GPU" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_smoke_path_needs_no_opencv():
    """Everything chip_smoke.py runs imports without OpenCV."""
    code = ("import sys; sys.modules['cv2'] = None; import chip_smoke; "
            "import synth_world, raster, numpy_ref; "
            "from orbslam3_byzyh_tpu import graft; "
            "from orbslam3_byzyh_tpu.ops import bow, fast_orb, matching; "
            "from orbslam3_byzyh_tpu.parallel import dist_ba, dist_posegraph; "
            "from orbslam3_byzyh_tpu.pipeline import stereo_inertial, system; "
            "from orbslam3_byzyh_tpu.solver import pallas_pose_opt, pose_opt")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_no_tpu_pallas_modules():
    """No module of the repository imports the TPU Pallas dialect."""
    needles = ("pallas." + "tpu", "pallas import " + "tpu", "pl" + "tpu")
    offenders = [
        str(p.relative_to(REPO))
        for p in REPO.rglob("*.py")
        if ".git" not in p.parts and any(
            n in p.read_text(errors="ignore") for n in needles)]
    assert offenders == []
