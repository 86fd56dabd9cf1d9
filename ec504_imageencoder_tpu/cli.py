"""Command-line interface.

Covers the reference's entry surface (main.c:15-17 /
mpeg_encode_procedure, encoder.h:20) and extends it with correct mode,
quality, GOP, frame-rate, backend and mesh controls.

    mpeg-encode images/ -o out.mpeg                        # correct mode
    mpeg-encode images/ -o awesome_video.mpeg --mode compat \
        --bitstream-dir bitstreams -q 12                   # reference parity
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpeg-encode",
        description="MPEG-1 intra-frame encoder on JAX/XLA",
    )
    p.add_argument("images", help="folder of input JPEG frames")
    p.add_argument("-o", "--output", default="awesome_video.mpeg",
                   help="output .mpeg path")
    p.add_argument("--mode", choices=["correct", "compat"], default="correct",
                   help="'correct' = ISO-compliant stream; 'compat' = "
                        "bit-exact reproduction of the reference encoder")
    p.add_argument("-q", "--quality", type=int, default=None,
                   help="quality factor 1-100 (default: 12 in compat mode "
                        "to match the reference CLI, else 50)")
    p.add_argument("--bitstream-dir", default=None,
                   help="also write per-image raw YCbCr .bit dumps here "
                        "(reference behavior)")
    p.add_argument("--backend", choices=["jax", "numpy"], default="jax")
    p.add_argument("--gop", type=int, default=15, help="GOP size (correct mode)")
    p.add_argument("--frame-rate-code", type=int, default=3,
                   help="MPEG-1 frame rate code (3 = 25fps)")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device batch (correct mode)")
    p.add_argument("--mesh", default=None,
                   help="use all devices as DATAxROWS mesh, e.g. '4,2'")
    p.add_argument("--workdir", default=None,
                   help="checkpointed encode: write per-GOP segments + "
                        "manifest here and resume any interrupted run")
    p.add_argument("--dct", choices=["auto", "aan", "f32"], default="auto",
                   help="DCT (correct mode): integer AAN or f32 matmul")
    p.add_argument("--color-range", choices=["studio", "full"], default="studio",
                   help="correct mode: 'studio' = BT.601 limited range "
                        "(16-235, what standard MPEG-1 players assume); "
                        "'full' = reference JPEG-style full range")
    p.add_argument("--container", choices=["es", "ps"], default="es",
                   help="correct mode: elementary stream or MPEG-1 program "
                        "stream (pack/PES mux, like the reference's container)")
    p.add_argument("--stream", action="store_true",
                   help="correct mode: bounded-memory intake — decode "
                        "JPEG batches on demand (with lookahead prefetch) "
                        "instead of loading the whole folder upfront")
    p.add_argument("--intake", choices=["auto", "rgb", "ycbcr", "coeffs"],
                   default="auto",
                   help="correct-mode --stream intake: 'ycbcr' feeds the "
                        "JPEGs' own 4:2:0 planes straight to the encoder "
                        "(half the host->device bytes, no RGB round "
                        "trip); 'coeffs' ships dequantized coefficient "
                        "blocks and runs the JPEG IDCT on device (weak "
                        "host, fast link); 'auto' uses ycbcr when the "
                        "JPEGs are 3-component 2x2-subsampled and no "
                        ".bit dumps were requested")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace into DIR")
    p.add_argument("--metrics", action="store_true",
                   help="print per-stage metrics to stderr")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ec504_imageencoder_tpu.io.jpeg import load_folder
    from ec504_imageencoder_tpu.utils.compile_cache import enable_compile_cache
    from ec504_imageencoder_tpu.utils.metrics import EncodeMetrics

    enable_compile_cache()

    quality = args.quality
    metrics = EncodeMetrics()

    use_stream = args.stream and args.mode == "correct"
    if args.intake in ("ycbcr", "coeffs") and (not use_stream or args.workdir
                                               or args.bitstream_dir):
        # fail loudly rather than silently running the RGB intake the
        # user asked to avoid
        raise SystemExit(
            f"--intake {args.intake} requires correct-mode --stream "
            "without --workdir/--bitstream-dir"
        )
    t0 = time.perf_counter()
    if use_stream:
        from ec504_imageencoder_tpu.io.stream import FolderFrameSource

        source = FolderFrameSource(args.images)
        n_frames, res_w, res_h = len(source), source.width, source.height
        frames = None
    else:
        frames, names = load_folder(args.images)
        n_frames, res_h, res_w = len(frames), frames.shape[1], frames.shape[2]
        source = lambda s, e: frames[s:e]
    metrics.add("decode_s", time.perf_counter() - t0)
    metrics.set("frames", n_frames)
    metrics.set("resolution", f"{res_w}x{res_h}")

    profile_ctx = None
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
        profile_ctx = True

    t0 = time.perf_counter()
    if args.mode == "compat":
        from ec504_imageencoder_tpu.models.encoder import encode_compat

        data, dumps = encode_compat(
            frames, 12 if quality is None else quality, backend=args.backend
        )
    else:
        from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
        from ec504_imageencoder_tpu.syntax import headers

        kw = dict(
            quality=50 if quality is None else quality,
            frame_rate_code=args.frame_rate_code,
            gop_size=args.gop,
            backend=args.backend,
            dct_impl=args.dct,
            color_range=args.color_range,
        )
        if args.mesh:
            from ec504_imageencoder_tpu.parallel import mesh as mesh_lib
            from ec504_imageencoder_tpu.parallel.sharded_encoder import (
                ShardedMPEG1Encoder,
            )

            nd, nr = (int(x) for x in args.mesh.split(","))
            enc = ShardedMPEG1Encoder(mesh=mesh_lib.make_mesh(nd, nr), **kw)
        else:
            enc = MPEG1IntraEncoder(**kw)
        if args.metrics:
            enc.metrics = metrics
            if args.backend == "jax":
                import jax

                metrics.set("n_devices", len(jax.devices()))
        if args.workdir:
            from ec504_imageencoder_tpu.runtime.checkpoint import encode_resumable

            encode_resumable(
                source, n_frames, args.workdir,
                args.output, encoder=enc, metrics=metrics,
            )
            data = open(args.output, "rb").read()
        elif use_stream:
            # bounded-memory path: decode batch N+1 while encoding batch N
            staged_ok = (not args.bitstream_dir and source.supports_planes())
            if args.intake in ("ycbcr", "coeffs") and not staged_ok:
                raise SystemExit(
                    f"--intake {args.intake} needs 3-component "
                    "2x2-subsampled JPEGs and the native staged decoder"
                )
            chunks = []
            if args.intake == "coeffs":
                g = source.geometry
                for start, (yc, cbc, crc) in source.coeff_batches(args.batch):
                    chunks.append(enc.encode_from_coeffs(
                        yc, cbc, crc, g["height"], g["width"],
                        first_frame_index=start))
            elif args.intake != "rgb" and staged_ok:
                for start, (y, cb, cr) in source.plane_batches(args.batch):
                    chunks.append(
                        enc.encode_from_planes(y, cb, cr,
                                               first_frame_index=start)
                    )
            else:
                for start, batch in source.batches(args.batch):
                    chunks.append(enc.encode(batch, first_frame_index=start))
            data = b"".join(chunks) + headers.sequence_end()
        else:
            chunks = []
            for start in range(0, n_frames, args.batch):
                chunks.append(
                    enc.encode(frames[start : start + args.batch], first_frame_index=start)
                )
            data = b"".join(chunks) + headers.sequence_end()
        if args.container == "ps":
            from ec504_imageencoder_tpu.syntax import mux

            pics = mux.split_es_pictures(data[: -len(headers.sequence_end())])
            data = mux.mux_program_stream(pics, fps=enc.fps)
        dumps = None
        if args.bitstream_dir:
            from ec504_imageencoder_tpu.ops.color import rgb_to_ycbcr_exact

            dumps = []
            for start in range(0, n_frames, args.batch):
                chunk = source(start, min(start + args.batch, n_frames))
                y, cb, cr = rgb_to_ycbcr_exact(chunk)
                dumps += [
                    headers.raw_plane_dump(
                        res_w, res_h,
                        y[i].reshape(-1), cb[i].reshape(-1), cr[i].reshape(-1),
                    )
                    for i in range(len(chunk))
                ]
    metrics.add("encode_s", time.perf_counter() - t0)

    if profile_ctx:
        import jax

        jax.profiler.stop_trace()

    with open(args.output, "wb") as f:
        f.write(data)
    metrics.set("stream_bytes", len(data))

    if args.bitstream_dir and dumps:
        os.makedirs(args.bitstream_dir, exist_ok=True)
        for i, d in enumerate(dumps):
            with open(os.path.join(args.bitstream_dir, f"image_{i + 1}.bit"), "wb") as f:
                f.write(d)

    print(f"wrote {args.output}: {len(data)} bytes, {n_frames} frames")
    if args.metrics:
        print(metrics.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
