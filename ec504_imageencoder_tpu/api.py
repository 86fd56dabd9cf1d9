"""Top-level convenience API, including the reference's exact entry point.

Drop-in for `mpeg_encode_procedure` (reference include/encoder.h:20,
called by main.c and the JNI shim): same arguments, same on-disk outputs
(the .mpeg system stream + per-image .bit plane dumps), same return
convention (0 = success), byte-exact output in compat mode.
"""

from __future__ import annotations

import os

import numpy as np

from ec504_imageencoder_tpu.utils.compile_cache import enable_compile_cache


def mpeg_encode_procedure(
    images_folder: str,
    bitstream_folder: str,
    video_path: str,
    quality_factor: int = 12,
    backend: str = "jax",
) -> int:
    """Encode every JPEG in `images_folder` to `video_path` (compat mode)
    and write per-image raw YCbCr dumps into `bitstream_folder`."""
    enable_compile_cache()
    from ec504_imageencoder_tpu.io.jpeg import load_folder
    from ec504_imageencoder_tpu.models.encoder import encode_compat

    try:
        frames, _ = load_folder(images_folder)
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    data, dumps = encode_compat(frames, quality_factor, backend=backend)
    os.makedirs(bitstream_folder, exist_ok=True)
    parent = os.path.dirname(video_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(video_path, "wb") as f:
        f.write(data)
    for i, d in enumerate(dumps):
        with open(os.path.join(bitstream_folder, f"image_{i + 1}.bit"), "wb") as f:
            f.write(d)
    return 0


def encode_video(
    frames: np.ndarray,
    path: str,
    quality: int = 50,
    fps: float = 25.0,
    gop_size: int = 15,
    backend: str = "jax",
) -> int:
    """One-call ISO-compliant encode of (B, H, W, 3) uint8 frames."""
    enable_compile_cache()
    from ec504_imageencoder_tpu.models.mpeg1 import (
        FRAME_RATE_CODES,
        MPEG1IntraEncoder,
    )

    code = FRAME_RATE_CODES.get(fps, 3)
    enc = MPEG1IntraEncoder(
        quality=quality, frame_rate_code=code, gop_size=gop_size, backend=backend
    )
    return enc.encode_to_file(frames, path)


def encode_jpeg_folder(
    images_folder: str,
    path: str,
    quality: int = 50,
    fps: float = 25.0,
    gop_size: int = 15,
    batch_size: int = 16,
    intake: str = "auto",
) -> int:
    """One-call ISO-compliant streaming encode of a JPEG folder.

    Bounded memory (one batch + one prefetched batch); picks the
    fastest supported intake — `ycbcr` feeds the JPEGs' own 4:2:0
    planes straight to the device pipeline (half the host->device
    bytes, no RGB round trip), `coeffs` ships entropy-decoded
    coefficients and runs the JPEG IDCT on device, `rgb` is the
    universal fallback.  Returns bytes written."""
    enable_compile_cache()
    from ec504_imageencoder_tpu.io.stream import FolderFrameSource
    from ec504_imageencoder_tpu.models.mpeg1 import (
        FRAME_RATE_CODES,
        MPEG1IntraEncoder,
    )
    from ec504_imageencoder_tpu.syntax import headers

    if intake not in ("auto", "rgb", "ycbcr", "coeffs"):
        raise ValueError(f"unknown intake {intake!r}")
    src = FolderFrameSource(images_folder)
    enc = MPEG1IntraEncoder(
        quality=quality, frame_rate_code=FRAME_RATE_CODES.get(fps, 3),
        gop_size=gop_size,
    )
    staged = src.supports_planes()
    if intake in ("ycbcr", "coeffs") and not staged:
        raise ValueError(
            f"intake {intake!r} needs 3-component 2x2-subsampled JPEGs "
            "and the native staged decoder"
        )
    chunks = []
    if intake == "coeffs":
        g = src.geometry
        for start, (yc, cbc, crc) in src.coeff_batches(batch_size):
            chunks.append(enc.encode_from_coeffs(
                yc, cbc, crc, g["height"], g["width"],
                first_frame_index=start))
    elif staged and intake in ("auto", "ycbcr"):
        for start, (y, cb, cr) in src.plane_batches(batch_size):
            chunks.append(
                enc.encode_from_planes(y, cb, cr, first_frame_index=start))
    else:
        for start, batch in src.batches(batch_size):
            chunks.append(enc.encode(batch, first_frame_index=start))
    data = b"".join(chunks) + headers.sequence_end()
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
