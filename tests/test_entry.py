"""Entry points that choose a device or refuse one: march-mode "auto",
the compile-cache location, and the GPU-only measurement paths."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,expected", [("gpu", "pallas"), ("cpu", "fast")]
)
def test_auto_march_mode_resolves_by_platform(platform, expected):
    from bhx.config import resolve_march_mode

    assert resolve_march_mode("auto", platform) == expected
    # Explicit modes pass through untouched on every platform.
    assert resolve_march_mode("diff", platform) == "diff"


def test_cli_auto_resolves_to_fast_on_cpu():
    import argparse

    from bhx.cli import _add_scene_flags, _build_config

    p = argparse.ArgumentParser()
    _add_scene_flags(p)
    cfg = _build_config(p.parse_args(["--width", "32", "--height", "18"]))
    assert cfg.march_mode == "fast"


def _cache_dir_in_subprocess(env):
    code = (
        "import bhx, jax; d = bhx.enable_compile_cache(); "
        "print(repr(d), repr(jax.config.jax_compilation_cache_dir))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env_var(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    line = _cache_dir_in_subprocess(env)
    assert line == f"{str(tmp_path / 'cc')!r} {str(tmp_path / 'cc')!r}"


def test_compile_cache_default_is_fixed_inside_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    assert _cache_dir_in_subprocess(env) == f"{want!r} {want!r}"
    with open(os.path.join(REPO, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()


def test_run_bench_refuses_non_gpu_device():
    from bhx.bench import run_bench

    with pytest.raises(RuntimeError, match="no GPU"):
        run_bench(width=16, height=9, iters=1)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs 1 GPU" in out.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
