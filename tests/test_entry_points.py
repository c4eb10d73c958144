"""Entry-point plumbing that needs no accelerator: the compile-cache
helper and chip_smoke.py's refusal to run without a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax

from brickjax.utils import compile_cache as cc

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_cache_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_fixed_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.enable_compile_cache() == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(
            ROOT / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def _python(code, env, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_import_sets_no_cache():
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = _python("import jax, brickjax, brickjax.api, "
                "brickjax.drivers.weak; "
                "print(jax.config.jax_compilation_cache_dir)", env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "None"


def test_cache_lands_in_env_dir(tmp_path):
    repo_cache = (ROOT / ".jax_cache").exists()
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    r = _python("from brickjax.utils.compile_cache import "
                "enable_compile_cache; enable_compile_cache(); import jax; "
                "print(jax.jit(lambda x: x * 3.0 + 1.0)(2.0))", env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert any(tmp_path.iterdir())
    assert (ROOT / ".jax_cache").exists() == repo_cache


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
