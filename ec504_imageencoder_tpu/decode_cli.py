"""`mpeg-decode`: decode an MPEG-1 all-intra stream back to images.

The reference keeps a latent, never-invoked decode path
(image_processing.c:438-693); this framework realizes it as a working
verifier (models/decoder.py).  This CLI completes the surface: decode a
.mpeg file (elementary or program stream, auto-detected) to PNG/PPM
frames, and optionally report per-frame PSNR against the original input
folder — the round-trip quality check BASELINE.md's config #2 calls for.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


def _write_frame(path: str, rgb: np.ndarray) -> None:
    if path.endswith(".ppm"):
        _write_ppm(path, rgb)
        return
    try:
        from PIL import Image

        Image.fromarray(rgb).save(path)
    except ImportError:  # PPM needs no codec
        alt = os.path.splitext(path)[0] + ".ppm"
        _write_ppm(alt, rgb)
        print(f"PIL unavailable; wrote {alt} instead", file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpeg-decode",
        description="Decode an all-intra MPEG-1 stream (ES or program "
                    "stream) to image frames",
    )
    p.add_argument("stream", help="input .mpeg path")
    p.add_argument("-o", "--outdir", default=None,
                   help="write frame_NNNN images here (default: no files, "
                        "just a summary)")
    p.add_argument("--format", choices=["png", "ppm"], default="png")
    p.add_argument("--color-range", choices=["studio", "full"],
                   default="studio",
                   help="range convention the stream was encoded with")
    p.add_argument("--psnr-ref", default=None, metavar="DIR",
                   help="folder of the original input JPEGs: report "
                        "per-frame and mean PSNR against them")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ec504_imageencoder_tpu.models.decoder import decode_stream, psnr

    with open(args.stream, "rb") as f:
        data = f.read()
    frames = decode_stream(data, color_range=args.color_range)
    if not frames:
        print("no pictures found in stream", file=sys.stderr)
        return 1
    h, w = frames[0].shape[:2]
    print(f"decoded {len(frames)} frames, {w}x{h}")

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        for i, f in enumerate(frames):
            _write_frame(
                os.path.join(args.outdir, f"frame_{i:04d}.{args.format}"), f
            )
        print(f"wrote {len(frames)} frames to {args.outdir}")

    if args.psnr_ref:
        from ec504_imageencoder_tpu.io.jpeg import load_folder

        ref, _names = load_folder(args.psnr_ref)
        n = min(len(ref), len(frames))
        if len(ref) != len(frames):
            print(f"frame count mismatch: stream {len(frames)} vs ref "
                  f"{len(ref)}; comparing first {n}", file=sys.stderr)
        vals = [psnr(ref[i], frames[i]) for i in range(n)]
        for i, v in enumerate(vals):
            print(f"frame {i}: PSNR {v:.2f} dB")
        print(f"mean PSNR: {float(np.mean(vals)):.2f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
