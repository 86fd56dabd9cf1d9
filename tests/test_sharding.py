"""Sharded encode on the 8-device virtual CPU mesh: bytes must be
identical to the host oracle under every mesh shape."""

import numpy as np
import pytest

import jax

from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu.parallel import mesh as mesh_lib
from ec504_imageencoder_tpu.parallel.sharded_encoder import ShardedMPEG1Encoder

@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@pytest.fixture(scope="module")
def frames(fixture_frames):
    return np.stack([fixture_frames["0"], fixture_frames["1"]] * 2)[:, :128, :192]


@pytest.fixture(scope="module")
def reference_bytes(frames):
    enc = MPEG1IntraEncoder(quality=45, backend="numpy", max_slice_bytes=8192)
    return enc.encode(frames)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_matches_oracle(frames, reference_bytes, shape):
    nd, nr = shape
    enc = ShardedMPEG1Encoder(
        quality=45,
        backend="jax",
        max_slice_bytes=8192,
        mesh=mesh_lib.make_mesh(n_data=nd, n_rows=nr),
    )
    assert enc.encode(frames) == reference_bytes


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_high_quality_f32_dct_deterministic(frames, shape):
    """q >= 70 auto-selects the f32 matmul DCT.  The guarantee
    (ops/dct.py): any sharding of the SAME backend is byte-identical;
    across backends (numpy vs XLA) f32 contraction-order ties can flip
    a rounding on rare content (found by an r5 soak at q=79), so
    cross-backend promises equal PSNR, not equal bytes."""
    unsharded = MPEG1IntraEncoder(quality=85, backend="jax").encode(frames)
    enc = ShardedMPEG1Encoder(
        quality=85, backend="jax", mesh=mesh_lib.make_mesh(*shape)
    )
    assert enc.dct_impl == "f32"  # the auto switch engaged
    assert enc.encode(frames) == unsharded


def test_f32_dct_cross_backend_equal_psnr():
    """The r5 soak's counterexample, kept as a regression boundary: at
    q=79 this exact noise content encodes to different BYTES under
    numpy vs XLA CPU (a half-ulp f32 tie) with identical decoded
    PSNR — the documented cross-backend guarantee."""
    from ec504_imageencoder_tpu.models.decoder import decode_es_fast, psnr
    from ec504_imageencoder_tpu.syntax import headers

    rng = np.random.default_rng(20260821)
    frames = rng.integers(0, 256, (1, 87, 44, 3), dtype=np.uint8)
    es_np = MPEG1IntraEncoder(quality=79, backend="numpy").encode(frames)
    es_jx = MPEG1IntraEncoder(quality=79, backend="jax").encode(frames)
    d1 = decode_es_fast(es_np + headers.sequence_end())
    d2 = decode_es_fast(es_jx + headers.sequence_end())
    p1, p2 = psnr(frames[0], d1[0]), psnr(frames[0], d2[0])
    assert abs(p1 - p2) < 0.05, (p1, p2)


COLLECTIVE_RE = (
    r"= \S+ (?:all-gather|all-reduce|collective-permute|all-to-all"
    r"|reduce-scatter|collective-broadcast)\("
)


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4)])
def test_sharded_step_compiles_collective_free(shape):
    """HLO-level evidence for the zero-collective scaling claim
    (parallel/mesh.py docstring): the compiled partitioned program must
    contain no cross-device communication ops.  Slices are independent
    bitstream islands, so any collective is a partitioning defect (a
    flatten that merges the sharded leading axes forces all-gathers;
    ops/vlc_lut.py gathers from a replicated table and ops/bitpack.py
    vmaps over the leading axes to keep them unmerged)."""
    import re

    from ec504_imageencoder_tpu.models.mpeg1 import quality_to_quant
    from ec504_imageencoder_tpu.parallel.sharded_encoder import (
        _sharded_pipeline,
    )

    intra_q, qscale = quality_to_quant(45)
    mesh = mesh_lib.make_mesh(*shape)
    fn = _sharded_pipeline(mesh, qscale, 8192)
    rgb = np.zeros((8, 64, 128, 3), np.uint8)
    hlo = fn.lower(rgb, intra_q).compile().as_text()
    found = re.findall(COLLECTIVE_RE, hlo)
    assert not found, f"collectives in sharded HLO: {found}"


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_graft_entry_dryrun_raises_when_short_of_devices():
    """Asking for more devices than exist raises; it never switches to
    another platform's devices."""
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="need 16"):
        g.dryrun_multichip(16)


def test_graft_entry_single():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    seg, bits = out
    assert np.asarray(bits).min() > 0


def test_sharded_planes_intake_matches_host(frames):
    """ShardedMPEG1Encoder.encode_from_planes must shard over the mesh
    and stay byte-identical to the host oracle's planes intake."""
    from ec504_imageencoder_tpu.ops.color import (
        rgb_to_ycbcr_studio,
        subsample_420,
    )

    y, cb, cr = rgb_to_ycbcr_studio(frames, np)
    cbs, crs = subsample_420(cb, np), subsample_420(cr, np)
    host = MPEG1IntraEncoder(quality=45, backend="numpy").encode_from_planes(
        y, cbs, crs)
    enc = ShardedMPEG1Encoder(
        quality=45, backend="jax", mesh=mesh_lib.make_mesh(4, 2)
    )
    assert enc.encode_from_planes(y, cbs, crs) == host
    with pytest.raises(NotImplementedError):
        enc.encode_from_coeffs(None, None, None, 0, 0)


def test_sharded_planes_pipeline_collective_free():
    import re

    from ec504_imageencoder_tpu.models.mpeg1 import quality_to_quant
    from ec504_imageencoder_tpu.parallel.sharded_encoder import (
        _sharded_planes_pipeline,
    )

    intra_q, qscale = quality_to_quant(45)
    mesh = mesh_lib.make_mesh(4, 2)
    fn = _sharded_planes_pipeline(mesh, qscale, 8192)
    y = np.zeros((8, 64, 128), np.uint8)
    c = np.zeros((8, 32, 64), np.uint8)
    hlo = fn.lower(y, c, c, intra_q).compile().as_text()
    found = re.findall(COLLECTIVE_RE, hlo)
    assert not found, f"collectives in sharded planes HLO: {found}"
