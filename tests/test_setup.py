"""Package set-up: where XLA's persistent compilation cache lives."""
import os
import subprocess
import sys

import jax

import rust_raytracer_jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert rust_raytracer_jax.compilation_cache_dir() == os.path.join(
        _REPO, ".jax_cache")


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert rust_raytracer_jax.compilation_cache_dir() == str(tmp_path)


def test_import_configures_jax(tmp_path):
    """Importing the package points JAX's cache at the rule's directory:
    the env var when set, the checkout's .jax_cache otherwise."""
    code = ("import jax, rust_raytracer_jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    for env_dir, expect in ((str(tmp_path), str(tmp_path)),
                            (None, os.path.join(_REPO, ".jax_cache"))):
        env = {k: v for k, v in os.environ.items()
               if k != "JAX_COMPILATION_CACHE_DIR"}
        env["PYTHONPATH"] = _REPO
        env["JAX_PLATFORMS"] = "cpu"
        if env_dir:
            env["JAX_COMPILATION_CACHE_DIR"] = env_dir
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120,
                             cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == expect


def test_cache_configured_in_this_process():
    assert jax.config.jax_compilation_cache_dir == (
        rust_raytracer_jax.compilation_cache_dir())
