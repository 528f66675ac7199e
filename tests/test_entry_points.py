"""The GPU entry points (chip_smoke.py, bench.py) refuse every other
backend, and the compile-cache placement they share with the CLI."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(script, cwd, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_ok(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            pass
    return False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU backend — and in a directory holding chip_smoke.py and
    nothing else of the repo — the smoke exits non-zero and prints no
    result."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        cwd = tmp_path / "alone"
        cwd.mkdir()
        script = shutil.copy(script, cwd)
    proc = _run(script, cwd, tmp_path)
    assert proc.returncode != 0
    assert not _printed_ok(proc.stdout), proc.stdout
    assert '"ok": true' not in proc.stdout


def test_bench_refuses_non_gpu_backend(tmp_path):
    """bench.py exits non-zero on the CPU backend, prints no JSON record
    and does not re-exec itself."""
    proc = _run(REPO / "bench.py", REPO, tmp_path)
    assert proc.returncode != 0
    assert "refusing to measure" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")]


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the helper
    sets nothing."""
    import jax
    from sitator_tpu.util.compile_cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Unset, the cache lands in <checkout>/.jax_cache — a fixed path,
    listed in .gitignore."""
    import jax
    from sitator_tpu.util.compile_cache import enable_compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
