"""chip_smoke.py's refusals, and where the compile cache goes."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _child_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="needs a GPU"):
        _load().require_gpu(jax.devices())


def test_script_exits_nonzero_without_gpu():
    proc = subprocess.run([sys.executable, SCRIPT], cwd=REPO,
                          env=_child_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(SCRIPT, tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_child_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_compile_cache_goes_to_jax_compilation_cache_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there
    and the package sets no directory of its own."""
    cache = tmp_path / "cache"
    env = _child_env()
    env.pop("ROBCHAR_NO_COMPILATION_CACHE", None)
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    code = (
        "import code_robchar_tpu, jax, jax.numpy as jnp\n"
        "from code_robchar_tpu import config\n"
        "assert config.compile_cache_dir() is None\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((8, 8)))"
        ".block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == str(cache)
    assert any(name.endswith("-cache") for name in os.listdir(cache))
