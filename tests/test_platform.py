"""What keeps the program honest about the device it runs on: the GPU
smoke script refuses to run without a GPU, the compile cache sits where
it is asked to, and no TPU-only kernel code is left in the package."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

import jax

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No GPU (or no package beside the script): non-zero exit and no
    result line."""
    if where == "checkout":
        script = REPO / "chip_smoke.py"
    else:
        script = tmp_path / "chip_smoke.py"
        shutil.copyfile(REPO / "chip_smoke.py", script)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0, proc.stdout
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from ec504_imageencoder_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    from ec504_imageencoder_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = enable_compile_cache()
        assert first == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
        assert enable_compile_cache() == first  # same path every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_tpu_only_kernel_code_left():
    """The device path is plain jnp/lax for XLA: no Pallas import and no
    per-platform lowering switch anywhere in the package."""
    pattern = re.compile(r"jax\.experimental\.pallas|experimental import pallas"
                         r"|platform_dependent")
    hits = [
        f"{p.relative_to(REPO)}:{i}"
        for p in (REPO / "ec504_imageencoder_tpu").rglob("*.py")
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert not hits, hits


def test_jpeg1080_fixtures_are_baseline_420_1080p():
    """chip_smoke.py and bench.py stage their JPEG folders from these."""
    from ec504_imageencoder_tpu.io import jpeg as jpeg_io

    paths = sorted((REPO / "tests" / "golden" / "jpeg1080").glob("*.jpg"))
    assert len(paths) == 2
    for p in paths:
        assert p.stat().st_size < 300_000
        g = jpeg_io.probe_jpeg(str(p))
        assert (g["width"], g["height"], g["ncomp"]) == (1920, 1080, 3)
        assert (g["hsamp"], g["vsamp"]) == (2, 2)
