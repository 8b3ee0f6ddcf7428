"""The one platform decision (phi_tpu.placement) and the compile-cache
placement (pipeline.enable_compile_cache)."""

import os
import subprocess
import sys

import jax
import pytest

from phi_tpu import placement

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_selects_host_path_here():
    # the tests run with JAX held to the CPU: None means the host path
    assert placement.resolve(None) == "cpu"
    assert placement.current() == "cpu"
    assert not placement.on_device()
    with placement.use(None) as choice:
        assert choice == "cpu" and placement.current() == "cpu"
    assert placement._current is None


def test_gpu_request_without_gpu_fails(tmp_path):
    from phi_tpu.config import Options
    from phi_tpu.pipeline import run_pipeline
    from phi_tpu.testing import write_tiny_instance
    with pytest.raises(RuntimeError, match="no GPU"):
        placement.resolve("gpu")
    gfa, reads = write_tiny_instance(str(tmp_path))
    with pytest.raises(RuntimeError, match="no GPU"):
        run_pipeline(gfa, reads, None, Options(k=4, w=2, device="gpu"))
    assert placement._current is None


def test_tpu_is_refused(monkeypatch):
    with pytest.raises(ValueError, match="'gpu', 'cpu' or None"):
        placement.resolve("tpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(RuntimeError, match="'tpu'"):
        placement.resolve(None)


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR when set; <checkout>/.jax_cache otherwise."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = ("import jax\n"
            "from phi_tpu.pipeline import enable_compile_cache\n"
            "enable_compile_cache()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = str(tmp_path / "cc") if env_dir else os.path.join(REPO,
                                                             ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want
