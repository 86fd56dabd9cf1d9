"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

The suite runs on the CPU; sharding tests use an 8-device virtual CPU
platform (same XLA partitioner, same collectives).  Must run before any
backend initializes.  Code that runs only on the GPU is exercised by
`python chip_smoke.py` on the card, not here (tests that need the card
carry the `gpu` marker and skip without one).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# The CLI and api entry points turn the persistent compile cache on; the
# suite's workers compile tiny CPU programs, and one on-disk cache shared
# by all of them would only couple them.
jax.config.update("jax_enable_compilation_cache", False)

import pathlib

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_dir() -> pathlib.Path:
    return GOLDEN


@pytest.fixture(scope="session")
def fixture_frames() -> dict[str, np.ndarray]:
    """The 3 unique fixture images, stb-decoded RGB (golden from reference)."""
    with np.load(GOLDEN / "fixture_rgb.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="session")
def golden_mpeg() -> bytes:
    return (GOLDEN / "awesome_video.mpeg").read_bytes()


@pytest.fixture(scope="session")
def frame_order() -> list[str]:
    import json

    return json.loads((GOLDEN / "frame_order.json").read_text())["unique_ids"]


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(20260817)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX has a GPU (decided per test,
    never at import, so every xdist worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    try:
        has_gpu = bool(jax.devices("gpu"))
    except RuntimeError:
        has_gpu = False
    if not has_gpu:
        pytest.skip("needs a GPU; run on the card via `python chip_smoke.py`")
