"""Hybrid JPEG decode: staged native entry points (planes/coeffs) + the
device back-half ops (ops/jpeg_tpu.py) must be pixel-identical to the
full native decode (and therefore to stb_image), and the encoder's
YCbCr-planes intake must match the RGB intake bit-for-bit."""

import numpy as np
import pytest

from ec504_imageencoder_tpu.io import jpeg as jio
from ec504_imageencoder_tpu.ops import jpeg_tpu as jt


@pytest.fixture(scope="module")
def jpeg_cases(tmp_path_factory, rng):
    """Synthesized 4:2:0 JPEGs across sizes/odd dims/progressive."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("jpegs")
    cases = []
    for i, (w, h, q, prog) in enumerate([
        (64, 48, 90, False), (33, 17, 75, False), (401, 299, 85, False),
        (128, 96, 95, True), (257, 129, 60, True), (16, 16, 50, False),
    ]):
        base = (np.sin(np.arange(h)[:, None] / 7) * 50 + 128)[:, :, None]
        img = np.clip(base + rng.integers(-40, 40, (h, w, 3)), 0, 255)
        p = str(tmp / f"f{i}.jpg")
        Image.fromarray(img.astype(np.uint8)).save(
            p, quality=q, progressive=prog, subsampling=2)
        cases.append(p)
    return cases


def test_probe_geometry(jpeg_cases):
    g = jio.probe_jpeg(jpeg_cases[0])
    assert (g["width"], g["height"]) == (64, 48)
    assert (g["chroma_w"], g["chroma_h"]) == (32, 24)
    assert (g["hsamp"], g["vsamp"]) == (2, 2)


def test_staged_decode_bit_exact_numpy(jpeg_cases):
    for p in jpeg_cases:
        g = jio.probe_jpeg(p)
        full = jio.decode_jpeg(p)
        y, cb, cr = jio.decode_planes_batch([p], g)
        assert np.array_equal(jt.decode_rgb_from_planes(y, cb, cr, np)[0],
                              full), p
        yc, cbc, crc = jio.decode_coeffs_batch([p], g)
        r = jt.decode_rgb_from_coeffs(yc, cbc, crc, g["height"], g["width"],
                                      np)[0]
        assert np.array_equal(r, full), p


def test_staged_decode_bit_exact_jit(jpeg_cases):
    import jax
    import jax.numpy as jnp

    p = jpeg_cases[2]  # odd dims
    g = jio.probe_jpeg(p)
    full = jio.decode_jpeg(p)
    yc, cbc, crc = jio.decode_coeffs_batch([p], g)
    fn = jax.jit(lambda a, b, c: jt.decode_rgb_from_coeffs(
        a, b, c, g["height"], g["width"], jnp))
    assert np.array_equal(np.asarray(fn(yc, cbc, crc))[0], full)


def test_staged_decode_fixtures(golden_dir):
    import glob

    jpgs = sorted(glob.glob(str(golden_dir / "*.jpg")))
    if not jpgs:
        pytest.skip("no fixture jpgs in golden dir")
    g = jio.probe_jpeg(jpgs[0])
    full = np.stack([jio.decode_jpeg(p) for p in jpgs])
    y, cb, cr = jio.decode_planes_batch(jpgs, g)
    assert np.array_equal(jt.decode_rgb_from_planes(y, cb, cr, np), full)


def test_encode_from_planes_matches_rgb_intake(fixture_frames):
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
    from ec504_imageencoder_tpu.ops.color import (
        rgb_to_ycbcr_studio,
        subsample_420,
    )

    frames = np.stack([fixture_frames["0"], fixture_frames["2"]])[:, :144, :224]
    es_rgb = MPEG1IntraEncoder(quality=50, backend="numpy").encode(frames)
    y, cb, cr = rgb_to_ycbcr_studio(frames, np)
    es_pl = MPEG1IntraEncoder(quality=50, backend="numpy").encode_from_planes(
        y, subsample_420(cb, np), subsample_420(cr, np))
    assert es_pl == es_rgb


def test_encode_from_planes_odd_dims_decodable(fixture_frames):
    from ec504_imageencoder_tpu.models.decoder import decode_es, psnr
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
    from ec504_imageencoder_tpu.ops.color import (
        rgb_to_ycbcr_studio,
        subsample_420,
    )
    from ec504_imageencoder_tpu.syntax import headers

    f = fixture_frames["1"][None, :150, :100]
    y, cb, cr = rgb_to_ycbcr_studio(f, np)
    cbs = subsample_420(cb, np)  # (75, 50) = ceil dims for 150x100
    crs = subsample_420(cr, np)
    enc = MPEG1IntraEncoder(quality=60, backend="numpy")
    es = enc.encode_from_planes(y, cbs, crs) + headers.sequence_end()
    dec = decode_es(es)
    assert dec[0].shape == (150, 100, 3)
    assert psnr(f[0], dec[0]) > 30.0


def test_stream_plane_batches(jpeg_cases, tmp_path, rng):
    from PIL import Image

    from ec504_imageencoder_tpu.io.stream import FolderFrameSource

    for i in range(5):
        img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(str(tmp_path / f"s{i}.jpg"),
                                  quality=85, subsampling=2)
    src = FolderFrameSource(str(tmp_path))
    assert src.supports_planes()
    got = []
    for start, (y, cb, cr) in src.plane_batches(2):
        assert y.shape[1:] == (48, 64) and cb.shape[1:] == (24, 32)
        got.append((start, y.shape[0]))
    assert got == [(0, 2), (2, 2), (4, 1)]
    # plane content equals a direct batch decode
    y0, cb0, cr0 = src.planes(0, 5)
    yy, _, _ = jio.decode_planes_batch(src.paths, src.geometry)
    assert np.array_equal(y0, yy)


def test_cli_stream_ycbcr_intake(tmp_path, rng):
    """mpeg-encode --stream with the auto YCbCr intake produces a
    decodable stream from a JPEG folder."""
    from PIL import Image

    from ec504_imageencoder_tpu.cli import main
    from ec504_imageencoder_tpu.models.decoder import decode_stream

    for i in range(5):
        img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
        Image.fromarray(img).save(str(tmp_path / f"f{i}.jpg"),
                                  quality=85, subsampling=2)
    out = str(tmp_path / "out.mpeg")
    rc = main([str(tmp_path), "-o", out, "--stream", "--intake", "ycbcr",
               "--backend", "numpy", "--batch", "2", "-q", "45"])
    assert rc == 0
    frames = decode_stream(open(out, "rb").read())
    assert len(frames) == 5 and frames[0].shape == (64, 96, 3)


def test_encode_from_coeffs_matches_planes_intake(jpeg_cases):
    """The coefficients intake (device IDCT fused into the encode jit)
    must produce the same stream as decoding to planes on the host."""
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder

    p = jpeg_cases[2]  # 401x299: odd dims exercise the in-jit padding
    g = jio.probe_jpeg(p)
    y, cb, cr = jio.decode_planes_batch([p], g)
    yc, cbc, crc = jio.decode_coeffs_batch([p], g)
    a = MPEG1IntraEncoder(quality=45, backend="jax").encode_from_coeffs(
        yc, cbc, crc, g["height"], g["width"])
    b = MPEG1IntraEncoder(quality=45, backend="jax").encode_from_planes(
        y, cb, cr)
    assert a == b
    c = MPEG1IntraEncoder(quality=45, backend="numpy").encode_from_coeffs(
        yc, cbc, crc, g["height"], g["width"])
    assert c == b


def test_encode_from_planes_fuzz_sizes(rng):
    """Planes intake == RGB intake across random MB-aligned sizes and
    qualities (beyond the single fixture case)."""
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
    from ec504_imageencoder_tpu.ops.color import (
        rgb_to_ycbcr_studio,
        subsample_420,
    )

    for h, w, q in ((32, 48, 12), (80, 64, 50), (48, 112, 92)):
        frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
        es_rgb = MPEG1IntraEncoder(quality=q, backend="numpy").encode(frames)
        y, cb, cr = rgb_to_ycbcr_studio(frames, np)
        es_pl = MPEG1IntraEncoder(
            quality=q, backend="numpy"
        ).encode_from_planes(y, subsample_420(cb, np), subsample_420(cr, np))
        assert es_pl == es_rgb, (h, w, q)


def test_cli_stream_coeffs_intake(tmp_path, rng):
    """mpeg-encode --stream --intake coeffs (device-IDCT path) produces
    the same stream as the ycbcr intake."""
    from PIL import Image

    from ec504_imageencoder_tpu.cli import main

    for i in range(4):
        img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
        Image.fromarray(img).save(str(tmp_path / f"f{i}.jpg"),
                                  quality=85, subsampling=2)
    out_c = str(tmp_path / "c.mpeg")
    out_y = str(tmp_path / "y.mpeg")
    assert main([str(tmp_path), "-o", out_c, "--stream", "--intake",
                 "coeffs", "--backend", "numpy", "--batch", "2",
                 "-q", "45"]) == 0
    assert main([str(tmp_path), "-o", out_y, "--stream", "--intake",
                 "ycbcr", "--backend", "numpy", "--batch", "2",
                 "-q", "45"]) == 0
    assert open(out_c, "rb").read() == open(out_y, "rb").read()


def test_api_encode_jpeg_folder(tmp_path, rng):
    """The one-call streaming API: all three intakes agree and decode."""
    from PIL import Image

    from ec504_imageencoder_tpu.api import encode_jpeg_folder
    from ec504_imageencoder_tpu.models.decoder import decode_stream

    folder = tmp_path / "jpgs"
    folder.mkdir()
    for i in range(5):
        img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
        Image.fromarray(img).save(str(folder / f"f{i}.jpg"),
                                  quality=85, subsampling=2)
    outs = {}
    for intake in ("ycbcr", "coeffs", "rgb"):
        p = str(tmp_path / f"{intake}.mpeg")
        n = encode_jpeg_folder(str(folder), p, quality=45, batch_size=2,
                               intake=intake)
        outs[intake] = open(p, "rb").read()
        assert n == len(outs[intake])
    assert outs["ycbcr"] == outs["coeffs"]
    # rgb intake differs in bytes (extra colorspace round trip) but must
    # decode the same frame count
    assert len(decode_stream(outs["rgb"])) == 5
    assert len(decode_stream(outs["ycbcr"])) == 5
