"""Native stb-compatible JPEG decoder: exactness against committed stb
golden dumps and end-to-end compat encode from JPEG bytes."""

import pathlib
import subprocess

import numpy as np
import pytest

from ec504_imageencoder_tpu.io import jpeg as jpeg_io

NATIVE_DIR = pathlib.Path(jpeg_io.__file__).parent / "native"


@pytest.fixture(scope="module", autouse=True)
def build_native():
    jpeg_io._load_native()
    assert (NATIVE_DIR / "libstbjpeg.so").exists()


@pytest.fixture(scope="module")
def fixture_jpegs(tmp_path_factory):
    """Unpack the reference's fixture JPEGs (3 unique images)."""
    ref = pathlib.Path("/root/reference/images.zip")
    if not ref.exists():
        pytest.skip("reference fixtures unavailable")
    d = tmp_path_factory.mktemp("jpegs")
    subprocess.run(["unzip", "-q", str(ref), "0.jpg", "1.jpg", "2.jpg", "-d", str(d)], check=True)
    return d


def test_native_matches_stb_goldens(fixture_jpegs, fixture_frames):
    for k in "012":
        img = jpeg_io.decode_jpeg(str(fixture_jpegs / f"{k}.jpg"))
        np.testing.assert_array_equal(img, fixture_frames[k])


def test_pil_fuzz_roundtrip(tmp_path):
    """Native decode of PIL-encoded images is sane (not stb-golden here,
    just structural: correct dims, plausible content)."""
    from PIL import Image

    rng = np.random.default_rng(5)
    for trial, (mode, prog, sub) in enumerate(
        [("RGB", False, 0), ("RGB", True, 2), ("RGB", True, 1), ("L", False, 0)]
    ):
        w, h = int(rng.integers(8, 90)), int(rng.integers(8, 90))
        arr = rng.integers(0, 256, (h, w, 3) if mode == "RGB" else (h, w), dtype=np.uint8)
        p = tmp_path / f"f{trial}.jpg"
        kw = {"quality": 90, "progressive": prog}
        if mode == "RGB":
            kw["subsampling"] = sub
        Image.fromarray(arr, mode).save(p, **kw)
        img = jpeg_io.decode_jpeg(str(p))
        assert img.shape == (h, w, 3)
        pil = np.asarray(Image.open(p).convert("RGB")).astype(int)
        # different decoder family: chroma filters differ at edges, so only
        # bound the average error (bit-exactness vs stb is tested above)
        assert np.abs(img.astype(int) - pil).mean() < 3.0


def test_end_to_end_compat_from_jpeg_files(fixture_jpegs, frame_order, golden_mpeg):
    from ec504_imageencoder_tpu.models.encoder import encode_compat

    frames = np.stack(
        [jpeg_io.decode_jpeg(str(fixture_jpegs / f"{k}.jpg")) for k in frame_order]
    )
    mine, _ = encode_compat(frames, 12, backend="numpy")
    assert mine == golden_mpeg


def test_batch_decode_matches_sequential(fixture_jpegs):
    """Threaded native batch intake is pixel-identical to per-file decode
    and preserves scan order."""
    paths = jpeg_io.scan_folder(str(fixture_jpegs))
    assert len(paths) >= 3
    seq = np.stack([jpeg_io.decode_jpeg(p) for p in paths])
    bat, names = jpeg_io.load_folder(str(fixture_jpegs))
    np.testing.assert_array_equal(seq, bat)
    assert names == paths


def test_batch_decode_skips_bad_files(fixture_jpegs, tmp_path):
    """Corrupt files are skipped with a warning (reference encoder.h:163-167)."""
    import shutil

    for k in "012":
        shutil.copy(fixture_jpegs / f"{k}.jpg", tmp_path / f"{k}.jpg")
    (tmp_path / "zz_broken.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    with pytest.warns(UserWarning, match="skipping"):
        frames, names = jpeg_io.load_folder(str(tmp_path))
    assert len(frames) == 3
    assert not any("zz_broken" in n for n in names)


def test_batch_decode_rejects_dim_mismatch(fixture_jpegs, tmp_path):
    """Mismatched dimensions abort (reference image_processing.c:48-66)."""
    import shutil

    from PIL import Image

    for k in "01":
        shutil.copy(fixture_jpegs / f"{k}.jpg", tmp_path / f"{k}.jpg")
    Image.new("RGB", (64, 48)).save(tmp_path / "small.jpg")
    with pytest.raises(ValueError, match="dimensions"):
        jpeg_io.load_folder(str(tmp_path))


JPEG1080 = pathlib.Path(__file__).parent / "golden" / "jpeg1080"


def test_native_decoder_rebuilt_from_source(tmp_path, monkeypatch):
    """With no library on disk, first use builds it from the committed
    source and Makefile, then loads and decodes with it."""
    import shutil

    d = tmp_path / "native"
    d.mkdir()
    for f in ("Makefile", "stb_compat_jpeg.cpp"):
        shutil.copy(NATIVE_DIR / f, d / f)
    monkeypatch.setattr(jpeg_io, "_NATIVE_DIR", str(d))
    monkeypatch.setattr(jpeg_io, "_native", None)
    lib = jpeg_io._load_native()
    assert lib._name == str(d / "libstbjpeg.so")
    assert [p.name for p in d.iterdir() if p.suffix == ".tmp"] == []
    img = jpeg_io.decode_jpeg(str(JPEG1080 / "frame_0000.jpg"))
    assert img.shape == (1080, 1920, 3)


def test_jpeg_intake_raises_without_native_decoder(tmp_path, monkeypatch):
    """No silent fallback to another decoder: every intake raises when
    the native library cannot be built."""
    import shutil

    from ec504_imageencoder_tpu.io.stream import FolderFrameSource

    monkeypatch.setattr(jpeg_io, "_NATIVE_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(jpeg_io, "_native", None)
    folder = tmp_path / "jpegs"
    folder.mkdir()
    shutil.copy(JPEG1080 / "frame_0000.jpg", folder / "a.jpg")
    with pytest.raises(RuntimeError, match="native JPEG decoder"):
        jpeg_io.decode_jpeg(str(folder / "a.jpg"))
    with pytest.raises(RuntimeError, match="native JPEG decoder"):
        jpeg_io.load_folder(str(folder))
    with pytest.raises(RuntimeError, match="native JPEG decoder"):
        FolderFrameSource(str(folder))
